"""ChEES-HMC — chain-massive HMC with cross-chain trajectory adaptation.

Hoffman, Radul & Sountsov, *An Adaptive MCMC Scheme for Setting Trajectory
Lengths in Hamiltonian Monte Carlo* (AISTATS 2021).  This kernel exists
because vectorized NUTS wastes work on accelerators: under ``vmap`` every
chain's U-turn ``while_loop`` runs until the *slowest* chain terminates, so
per-step cost is the max tree depth over the batch.  ChEES-HMC instead gives
**every chain the identical number of leapfrog steps per iteration** (a
Halton-jittered fraction of one learned trajectory length), which is perfect
SIMD on the tensor cores, and adapts that trajectory length by gradient ascent on the
Change-in-the-Estimator-of-the-Expected-Square criterion using statistics
pooled **across the chain batch** — the more chains, the better (and faster)
the adaptation.  No reference equivalent (numpyro has no ChEES kernel); the
closest surface is infer/hmc.py:540's fixed-``trajectory_length`` HMC.

Cross-chain machinery (all inside one XLA program, shardable over a mesh):
- step size: dual averaging on the accept probability pooled over chains
- trajectory length: Adam on the pooled ChEES gradient estimate, computed in
  mass-whitened coordinates with non-finite proposals masked out
- mass matrix: Chan-merge Welford fed a whole chain-batch per iteration

When to prefer it over NUTS: targets where tree depth varies across chains
(hierarchies, funnels, heterogeneous data shards) — vectorized NUTS pays the
max depth over the batch every step, ChEES pays one shared trajectory.  On
very well-conditioned posteriors NUTS's antithetic trajectories can still
deliver more ESS per gradient (measured on the covtype bench: NUTS ~591 vs
ChEES ~230 ESS/s/chip at 512 chains), so the default bench keeps NUTS.
"""

from __future__ import annotations

from collections import namedtuple

import jax
import jax.numpy as jnp
from jax import lax, random, value_and_grad, vmap

from numpyro_tpu.infer.hmc_util import dual_averaging
from numpyro_tpu.infer.ensemble_util import batch_ravel_pytree
from numpyro_tpu.infer.mcmc import MCMCKernel
from numpyro_tpu.infer.util import ParamInfo, initialize_model
from numpyro_tpu.util import identity, is_prng_key

__all__ = ["CheesHMC"]

CheesAdaptState = namedtuple(
    "CheesAdaptState",
    [
        "step_size",
        "inverse_mass_matrix",  # diagonal, shape (D,)
        "trajectory_length",
        "da_state",  # DualAveragingState over log step size
        "tl_state",  # (log_tl_avg?, m, v, t) Adam state over log trajectory length
        "wf_mean",
        "wf_m2",
        "wf_n",
    ],
)

CheesHMCState = namedtuple(
    "CheesHMCState",
    [
        "i",
        "z",  # dict pytree, leaves lead with the chain axis
        "potential_energy",  # (C,)
        "accept_prob",  # (C,)
        "mean_accept_prob",  # (C,)
        "diverging",  # (C,)
        "num_steps",
        "adapt_state",
        "rng_key",  # ONE key shared by the batch; batch draws are shaped
    ],
)

_AdamState = namedtuple("_AdamState", ["x", "m", "v", "t"])


def _halton(i):
    """Van der Corput base-2 sequence at index ``i`` — the shared
    trajectory jitter (bit-reversal of a uint32, no host state)."""
    k = i.astype(jnp.uint32)
    k = ((k & 0x55555555) << 1) | ((k >> 1) & 0x55555555)
    k = ((k & 0x33333333) << 2) | ((k >> 2) & 0x33333333)
    k = ((k & 0x0F0F0F0F) << 4) | ((k >> 4) & 0x0F0F0F0F)
    k = ((k & 0x00FF00FF) << 8) | ((k >> 8) & 0x00FF00FF)
    k = (k << 16) | (k >> 16)
    return (k.astype(jnp.float32) + 0.5) * (2.0**-32)


def _adam_ascent(state, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    x, m, v, t = state
    t = t + 1
    m = b1 * m + (1 - b1) * grad
    v = b2 * v + (1 - b2) * grad**2
    mhat = m / (1 - b1**t)
    vhat = v / (1 - b2**t)
    x = x + lr * mhat / (jnp.sqrt(vhat) + eps)  # ascent
    return _AdamState(x, m, v, t)


def _welford_batch_merge(mean, m2, n, batch):
    """Chan et al. parallel merge of a (C, D) batch into running stats."""
    c = batch.shape[0]
    bmean = batch.mean(0)
    bm2 = ((batch - bmean) ** 2).sum(0)
    delta = bmean - mean
    tot = n + c
    mean = mean + delta * (c / tot)
    m2 = m2 + bm2 + delta**2 * (n * c / tot)
    return mean, m2, tot


class CheesHMC(MCMCKernel):
    """Chain-massive adaptive HMC (ChEES).  Requires
    ``chain_method="vectorized"`` (or "parallel") with at least 2 chains —
    the adaptation statistics are pooled across the chain batch.

    :param model: model callable (or pass ``potential_fn``).
    :param step_size: initial leapfrog step size.
    :param trajectory_length: initial trajectory length (adapted).
    :param max_num_steps: cap on leapfrog steps per iteration.
    :param target_accept_prob: pooled accept-probability target.
    :param tl_learning_rate: Adam learning rate for log trajectory length.
    """

    def __init__(
        self,
        model=None,
        potential_fn=None,
        *,
        step_size=0.1,
        trajectory_length=1.0,
        max_num_steps=1024,
        target_accept_prob=0.651,
        tl_learning_rate=0.025,
        init_strategy=None,
    ):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        from numpyro_tpu.infer.initialization import init_to_uniform

        self._model = model
        self._potential_fn = potential_fn
        self._step_size = step_size
        self._trajectory_length = trajectory_length
        self._max_num_steps = max_num_steps
        self._target_accept_prob = target_accept_prob
        self._tl_lr = tl_learning_rate
        self._init_strategy = (
            init_to_uniform if init_strategy is None else init_strategy
        )
        self._postprocess_fn = None
        self._batch_potential = None
        self._unravel = None
        self._num_warmup = None

    def __getstate__(self):
        # derived closures are unpicklable; they rebuild on the next init()
        state = self.__dict__.copy()
        for key in ("_batch_potential", "_batch_vg", "_unravel", "_da_update",
                    "_postprocess_fn"):
            state[key] = None
        return state

    @property
    def model(self):
        return self._model

    @property
    def sample_field(self):
        return "z"

    @property
    def default_fields(self):
        return ("z", "diverging")

    @property
    def is_ensemble_kernel(self):
        # cross-chain statistics: the driver must hand us the whole batch
        return True

    def get_diagnostics_str(self, state):
        return "{} steps of size {:.2e}. acc. prob={:.2f}".format(
            state.num_steps,
            state.adapt_state.step_size,
            jnp.mean(state.mean_accept_prob),
        )

    def init(
        self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs={}
    ):
        if is_prng_key(rng_key):
            raise ValueError(
                "CheesHMC pools statistics across chains: run it with "
                'num_chains >= 2 and chain_method="vectorized".'
            )
        num_chains = rng_key.shape[0]
        key0 = random.fold_in(rng_key[0], num_chains)
        key_init, key_state = random.split(key0)

        if self._model is not None:
            params_info, potential_fn_gen, self._postprocess_fn, _ = (
                initialize_model(
                    random.split(key_init, num_chains),
                    self._model,
                    dynamic_args=True,
                    init_strategy=self._init_strategy,
                    model_args=model_args,
                    model_kwargs=model_kwargs,
                )
            )
            if init_params is None:
                init_params = params_info.z
            potential_fn = potential_fn_gen(*model_args, **model_kwargs)
        else:
            potential_fn = self._potential_fn
            if init_params is None:
                raise ValueError(
                    "`init_params` must be provided with `potential_fn`."
                )
            if isinstance(init_params, ParamInfo):
                init_params = init_params.z

        z_flat, unravel = batch_ravel_pytree(init_params)
        self._unravel = unravel
        d = z_flat.shape[-1]

        from jax.flatten_util import ravel_pytree

        unravel_one = ravel_pytree(jax.tree.map(lambda x: x[0], init_params))[1]
        flat_potential = lambda x: potential_fn(unravel_one(x))  # noqa: E731
        self._batch_potential = vmap(flat_potential)
        self._batch_vg = vmap(value_and_grad(flat_potential))
        self._num_warmup = num_warmup

        pe = self._batch_potential(z_flat)
        da_init, self._da_update = dual_averaging()
        adapt = CheesAdaptState(
            step_size=jnp.asarray(self._step_size),
            inverse_mass_matrix=jnp.ones(d),
            trajectory_length=jnp.asarray(self._trajectory_length),
            da_state=da_init(jnp.log(10 * jnp.asarray(self._step_size))),
            tl_state=_AdamState(
                jnp.log(jnp.asarray(self._trajectory_length)),
                jnp.zeros(()),
                jnp.zeros(()),
                jnp.zeros((), jnp.int32),
            ),
            wf_mean=jnp.zeros(d),
            wf_m2=jnp.zeros(d),
            wf_n=jnp.zeros(()),
        )
        return CheesHMCState(
            i=jnp.zeros((), jnp.int32),
            z=init_params,
            potential_energy=pe,
            accept_prob=jnp.zeros(num_chains),
            mean_accept_prob=jnp.zeros(num_chains),
            diverging=jnp.zeros(num_chains, bool),
            num_steps=jnp.zeros((), jnp.int32),
            adapt_state=adapt,
            rng_key=key_state,
        )

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def sample(self, state, model_args=(), model_kwargs=None):
        a = state.adapt_state
        zf, _ = batch_ravel_pytree(state.z)
        C, D = zf.shape
        key, key_mom, key_mh = random.split(state.rng_key, 3)

        eps = a.step_size
        inv_mass = a.inverse_mass_matrix
        u = _halton(state.i)
        traj = jnp.nan_to_num(a.trajectory_length, nan=eps)
        num_steps = jnp.clip(
            jnp.ceil(u * traj / eps), 1, self._max_num_steps
        ).astype(jnp.int32)
        del model_args, model_kwargs  # potential is closed over at init

        # p ~ N(0, M) with M = 1 / inv_mass (diagonal)
        p0 = random.normal(key_mom, (C, D)) / jnp.sqrt(inv_mass)

        # leapfrog with one gradient eval per step: carry (z, p_half-ready, grad)
        _, g0 = self._batch_vg(zf)

        def body(_, carry):
            z, p, g = carry
            p_half = p - 0.5 * eps * g
            z = z + eps * p_half * inv_mass
            pe_g = self._batch_vg(z)
            g = pe_g[1]
            p = p_half - 0.5 * eps * g
            return (z, p, g)

        z_prop, p_prop, _ = lax.fori_loop(0, num_steps, body, (zf, p0, g0))
        pe_prop = self._batch_potential(z_prop)
        pe0 = state.potential_energy

        ke0 = 0.5 * jnp.sum(p0**2 * inv_mass, -1)
        ke1 = 0.5 * jnp.sum(p_prop**2 * inv_mass, -1)
        delta = (pe_prop + ke1) - (pe0 + ke0)
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > 1000.0
        accept_prob = jnp.minimum(jnp.exp(-delta), 1.0)
        accept = random.uniform(key_mh, (C,)) < accept_prob

        z_new = jnp.where(accept[:, None], z_prop, zf)
        pe_new = jnp.where(accept, pe_prop, pe0)

        # ---- pooled adaptation (warmup only) --------------------------------
        i = state.i + 1
        in_warmup = i <= self._num_warmup

        # ChEES gradient: d/dT (||z' - mean z'||^2 - ||z - mean z||^2)^2 / 4,
        # computed in MASS-WHITENED coordinates so the criterion (and the
        # optimal trajectory length) is scale-free across dimensions
        scale = jnp.sqrt(inv_mass)  # ~ posterior std per coordinate
        zw = zf / scale
        zpw = z_prop / scale
        zwc = zw - zw.mean(0)
        zpwc = zpw - zpw.mean(0)
        crit = jnp.sum(zpwc**2, -1) - jnp.sum(zwc**2, -1)
        vw = p_prop * scale  # whitened final velocity (= M^{-1} p / std)
        g_i = crit * jnp.sum(zpwc * vw, -1) * u
        # non-finite proposals (overflowed trajectories) carry no signal —
        # mask them out entirely (0 * nan would poison the Adam state)
        good = jnp.isfinite(g_i) & ~diverging
        w = jnp.where(good, accept_prob, 0.0)
        wg = jnp.where(good, w * g_i, 0.0)
        chees_grad = jnp.sum(wg) / (jnp.sum(w) + 1e-6)
        # scale-normalize so tl_learning_rate is problem-independent
        chees_grad = chees_grad / jnp.sqrt(jnp.mean(wg**2) + 1e-12)

        # adapt only when the pooled accept carries signal: early warmup
        # (mass matrix still identity) produces junk gradients that would
        # random-walk T before real adaptation begins
        tl_adapt = in_warmup & (jnp.sum(w) > 0.05 * C)
        tl_state = _adam_ascent(a.tl_state, chees_grad, self._tl_lr)
        log_tl = jnp.clip(
            tl_state.x,
            jnp.log(eps),
            jnp.log(eps * self._max_num_steps),
        )
        tl_state = tl_state._replace(x=log_tl)
        tl_state = jax.tree.map(
            lambda n, o: jnp.where(tl_adapt, n, o), tl_state, a.tl_state
        )
        new_tl = jnp.where(tl_adapt, jnp.exp(tl_state.x), a.trajectory_length)

        # dual averaging on pooled accept prob
        da_state = self._da_update(
            self._target_accept_prob - accept_prob.mean(), a.da_state
        )
        # freeze at the averaged iterate once warmup ends
        new_eps = jnp.exp(
            jnp.where(i < self._num_warmup, da_state.x_t, da_state.x_avg)
        )
        new_eps = jnp.where(in_warmup, new_eps, a.step_size)
        da_state = jax.tree.map(
            lambda n, o: jnp.where(in_warmup, n, o), da_state, a.da_state
        )

        # mass: Welford over the chain batch, after a 10% buffer
        collect = in_warmup & (i > self._num_warmup // 10)
        wf_mean, wf_m2, wf_n = _welford_batch_merge(
            a.wf_mean, a.wf_m2, a.wf_n, z_new
        )
        wf_mean = jnp.where(collect, wf_mean, a.wf_mean)
        wf_m2 = jnp.where(collect, wf_m2, a.wf_m2)
        wf_n = jnp.where(collect, wf_n, a.wf_n)
        var = wf_m2 / jnp.maximum(wf_n - 1, 1)
        shrink = wf_n / (wf_n + 5.0)
        est_inv_mass = shrink * var + 1e-3 * (1 - shrink)
        # refresh the mass matrix in the back half of warmup
        use_est = collect & (wf_n > 2 * C)
        new_inv_mass = jnp.where(use_est, est_inv_mass, a.inverse_mass_matrix)

        adapt = CheesAdaptState(
            step_size=new_eps,
            inverse_mass_matrix=new_inv_mass,
            trajectory_length=new_tl,
            da_state=da_state,
            tl_state=tl_state,
            wf_mean=wf_mean,
            wf_m2=wf_m2,
            wf_n=wf_n,
        )

        n = jnp.where(in_warmup, i, i - self._num_warmup)
        mean_accept = (
            state.mean_accept_prob
            + (accept_prob - state.mean_accept_prob) / jnp.maximum(n, 1)
        )

        return CheesHMCState(
            i=i,
            z=self._unravel(z_new),
            potential_energy=pe_new,
            accept_prob=accept_prob,
            mean_accept_prob=mean_accept,
            diverging=diverging,
            num_steps=num_steps,
            adapt_state=adapt,
            rng_key=key,
        )
