"""Sample-Adaptive MCMC, panel-batched (role parity: numpyro/infer/sa.py,
after Zhu 2019 "Sample Adaptive MCMC").

Redesign notes (accelerator-first, not a translation):

- **Panels everywhere.** The live-point pool for *all* chains is a single
  ``(C, N, D)`` tensor and one transition advances every chain at once —
  the potential is evaluated as one batched call per step, so the hot path
  is a single fused XLA program regardless of the chain count.
- **In-place swap, no pool reshuffling.** The reference materializes the
  augmented ``N+1`` pool and deletes the victim row each step; here the
  victim row is overwritten with the proposal through a one-hot select
  (rejection = no write), which keeps the pool buffer donation-friendly.
- **Rank-one Cholesky batches.** The ``N`` leave-one-out proposal factors
  are produced by three broadcasted rank-one updates over the pool axis —
  O(N·D²) work that XLA tiles onto the tensor cores.
"""

from __future__ import annotations

from collections import namedtuple

import jax
import jax.numpy as jnp
from jax import lax, random, vmap

from numpyro_tpu.distributions.util import cholesky_update
from numpyro_tpu.infer.hmc_core import FlatLayout
from numpyro_tpu.infer.initialization import init_to_uniform
from numpyro_tpu.infer.mcmc import MCMCKernel
from numpyro_tpu.infer.util import initialize_model
from numpyro_tpu.util import identity, is_prng_key

SAAdaptState = namedtuple("SAAdaptState", ["zs", "pes", "loc", "inv_mass_matrix_sqrt"])
SAState = namedtuple(
    "SAState",
    [
        "i",
        "z",
        "potential_energy",
        "accept_prob",
        "mean_accept_prob",
        "diverging",
        "adapt_state",
        "rng_key",
    ],
)

_MAX_DELTA_ENERGY = 1000.0


def _fit_pool(zs, prev_scale, dense):
    """Gaussian moments of each chain's pool: ``zs`` is (C, N, D)."""
    loc = jnp.mean(zs, axis=1)
    dz = zs - loc[:, None, :]
    if dense:
        cov = jnp.einsum("cnd,cne->cde", dz, dz) / zs.shape[1]
        chol = jnp.linalg.cholesky(cov)
        bad = jnp.any(jnp.isnan(chol), axis=(-2, -1), keepdims=True)
        scale = jnp.where(bad, prev_scale, chol)
    else:
        scale = jnp.std(zs, axis=1)
    return loc, scale


def _gauss_draw(scale, eps):
    """Map standard normals through the scale factor (diag or Cholesky)."""
    if scale.ndim == eps.ndim + 1:
        return jnp.einsum("...de,...e->...d", scale, eps)
    return scale * eps


def _gauss_logpdf(loc, scale, x):
    """Batched N(loc, scale scale^T) log-density; diag scale if same rank."""
    d = x.shape[-1]
    diff = x - loc
    if scale.ndim == x.ndim + 1:
        w = lax.linalg.triangular_solve(
            scale, diff[..., None], left_side=True, lower=True
        )[..., 0]
        half_logdet = jnp.sum(
            jnp.log(jnp.diagonal(scale, axis1=-2, axis2=-1)), axis=-1
        )
    else:
        w = diff / scale
        half_logdet = jnp.sum(jnp.log(scale), axis=-1)
    quad = jnp.sum(jnp.square(w), axis=-1)
    return -0.5 * (quad + d * jnp.log(2 * jnp.pi)) - half_logdet


def _swap_out_factors(zs, loc, scale, z_new):
    """Proposal parameters with pool point ``n`` traded for ``z_new``, for
    every ``n`` at once: (C, N, D) locs and (C, N, [D,] D) scale factors.

    Derivation: the pool covariance after the trade differs from the
    current one by three rank-one terms (add the newcomer, drop point n,
    and their cross term), each with pool weight 1/N.
    """
    n_pool = zs.shape[1]
    w = 1.0 / n_pool
    locs = loc[:, None, :] + w * (z_new[:, None, :] - zs)
    if scale.ndim == 3:  # dense factors
        grown = cholesky_update(scale, z_new - loc, w)
        factors = cholesky_update(grown[:, None], zs - loc[:, None, :], -w)
        factors = cholesky_update(factors, z_new[:, None, :] - zs, -(w**2))
    else:
        var = jnp.square(scale) + w * jnp.square(z_new - loc)
        var = var[:, None, :] - w * jnp.square(zs - loc[:, None, :])
        var = var - w**2 * jnp.square(z_new[:, None, :] - zs)
        factors = jnp.sqrt(var)
    return locs, factors


def _row_select(pool, row_idx):
    """Gather one row per chain from a (C, N, ...) panel."""
    return jnp.take_along_axis(
        pool, row_idx.reshape((-1,) + (1,) * (pool.ndim - 1)), axis=1
    )[:, 0]


SAConfig = namedtuple("SAConfig", ["dense", "num_warmup"])


def sa_panel_transition(state, pe_batch, cfg):
    """One SA step for all chains.  ``pe_batch`` maps a (M, D) panel of flat
    positions to (M,) potentials."""
    zs, pes, _, prev_scale = state.adapt_state
    num_chains, n_pool, _ = zs.shape
    # refit from the raw pool every step — rank-one drift never accumulates
    loc, scale = _fit_pool(zs, prev_scale, cfg.dense)

    keys = vmap(lambda k: random.split(k, 4))(state.rng_key)
    key_next, key_prop, key_victim, key_pick = (
        keys[:, 0], keys[:, 1], keys[:, 2], keys[:, 3]
    )

    eps = vmap(lambda k: random.normal(k, loc.shape[-1:]))(key_prop)
    z_new = loc + _gauss_draw(scale, eps)
    pe_new = pe_batch(z_new)
    pe_new = jnp.where(jnp.isnan(pe_new), jnp.inf, pe_new)
    diverging = (pe_new - state.potential_energy) > _MAX_DELTA_ENERGY

    # Rao-Blackwellized trade rule: victim n < N means "pool point n is
    # discarded in favor of the newcomer"; victim N keeps the pool as-is.
    locs, factors = _swap_out_factors(zs, loc, scale, z_new)
    lw_pool = _gauss_logpdf(locs, factors, zs) + pes  # (C, N)
    lw_keep = (_gauss_logpdf(loc, scale, z_new) + pe_new)[:, None]  # (C, 1)
    logits = jnp.concatenate([lw_pool, lw_keep], axis=1)
    logits = jnp.where(jnp.isfinite(logits), logits, -jnp.inf)
    victim = vmap(random.categorical)(key_victim, logits)

    hit = (jnp.arange(n_pool)[None, :] == victim[:, None]) & (
        victim < n_pool
    )[:, None]
    zs = jnp.where(hit[..., None], z_new[:, None, :], zs)
    pes = jnp.where(hit, pe_new[:, None], pes)

    # probability the newcomer survived the trade
    accept_prob = 1.0 - jnp.exp(
        logits[:, -1] - jax.scipy.special.logsumexp(logits, axis=1)
    )

    # the victim's swap-out fit *is* the exact fit of the updated pool
    locs_aug = jnp.concatenate([locs, loc[:, None, :]], axis=1)
    factors_aug = jnp.concatenate([factors, scale[:, None]], axis=1)
    adapt = SAAdaptState(
        zs, pes, _row_select(locs_aug, victim), _row_select(factors_aug, victim)
    )

    pick = vmap(lambda k: random.randint(k, (), 0, n_pool))(key_pick)
    i_new = state.i + 1
    denom = jnp.where(
        state.i < cfg.num_warmup, i_new, i_new - cfg.num_warmup
    )
    mean_accept = state.mean_accept_prob + (
        accept_prob - state.mean_accept_prob
    ) / denom
    return SAState(
        i_new,
        _row_select(zs, pick),
        _row_select(pes, pick),
        accept_prob,
        mean_accept,
        diverging,
        adapt,
        key_next,
    )


class SA(MCMCKernel):
    """Sample Adaptive MCMC: a gradient-free kernel that maintains
    ``adapt_state_size`` live points per chain, proposes from the Gaussian
    fit of the pool, and trades one point per step under a
    Rao-Blackwellized rule.  The pick when the potential is expensive to
    differentiate or non-differentiable.

    :param model: model callable (or pass ``potential_fn``).
    :param potential_fn: flat potential; requires explicit ``init_params``.
    :param adapt_state_size: live points per chain (default ``2 * dim``).
    :param dense_mass: fit a full covariance (True) or a diagonal one.
    :param init_strategy: site initializer for the model path.
    """

    def __init__(
        self,
        model=None,
        potential_fn=None,
        adapt_state_size=None,
        dense_mass=True,
        init_strategy=init_to_uniform,
    ):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        self._model = model
        self._potential_fn = potential_fn
        self._adapt_state_size = adapt_state_size
        self._dense_mass = dense_mass
        self._init_strategy = init_strategy
        self._postprocess_fn = None
        self._potential_fn_gen = None
        self._num_warmup = None
        self._layout = None
        self._batched = None  # panel state (True) vs single-chain pytrees

    @property
    def model(self):
        return self._model

    @property
    def sample_field(self):
        return "z"

    @property
    def default_fields(self):
        return ("z", "diverging")

    def get_diagnostics_str(self, state):
        return "acc. prob={:.2f}".format(state.mean_accept_prob)

    def _resolve_model(self, rng_key, model_args, model_kwargs, init_params):
        if self._model is not None:
            info, pf_gen, self._postprocess_fn, _ = initialize_model(
                rng_key,
                self._model,
                dynamic_args=True,
                init_strategy=self._init_strategy,
                model_args=model_args,
                model_kwargs=model_kwargs,
            )
            if init_params is None:
                init_params = info[0]
            self._potential_fn_gen = pf_gen
            self._potential_fn = pf_gen(*model_args, **(model_kwargs or {}))
        elif init_params is None:
            raise ValueError(
                "Valid value of `init_params` must be provided with `potential_fn`."
            )
        return init_params

    def _pe_batch(self, model_args, model_kwargs):
        pe_fn = self._potential_fn
        if self._potential_fn_gen:
            pe_fn = self._potential_fn_gen(*model_args, **(model_kwargs or {}))
        layout = self._layout
        return vmap(lambda flat: pe_fn(layout.unravel_one(flat)))

    def init(
        self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs={}
    ):
        self._num_warmup = num_warmup
        self._batched = not is_prng_key(rng_key)
        if self._batched:
            keys = vmap(random.split)(rng_key)
            # full per-chain key batch: initialize_model is chain-batched
            # and disperses each chain's starting point
            key_model, rng_key = keys[:, 0], keys[:, 1]
        else:
            key_model, rng_key = random.split(rng_key)
            rng_key = rng_key[None]
        init_params = self._resolve_model(
            key_model, model_args, model_kwargs, init_params
        )

        z0 = init_params if self._batched else jax.tree.map(
            lambda x: jnp.asarray(x)[None], init_params
        )
        proto = jax.tree.map(lambda x: x[0], z0)
        self._layout = layout = FlatLayout(proto)
        dim = layout.dim
        n_pool = self._adapt_state_size or 2 * dim
        if n_pool <= 1:
            raise ValueError("adapt_state_size should be greater than 1.")

        panel = layout.ravel_batch(z0)  # (C, D)
        num_chains = panel.shape[0]
        keys3 = vmap(lambda k: random.split(k, 3))(rng_key)
        rng_key, key_pool, key_pick = keys3[:, 0], keys3[:, 1], keys3[:, 2]
        # disperse the pool around the init point with a unit-scale cloud
        eps = vmap(lambda k: random.normal(k, (n_pool, dim), panel.dtype))(
            key_pool
        )
        zs = panel[:, None, :] + eps
        pe_batch = self._pe_batch(model_args, model_kwargs)
        pes = pe_batch(zs.reshape(-1, dim)).reshape(num_chains, n_pool)
        prev = (
            jnp.broadcast_to(jnp.eye(dim), (num_chains, dim, dim))
            if self._dense_mass
            else jnp.ones((num_chains, dim))
        )
        loc, scale = _fit_pool(zs, prev, self._dense_mass)

        pick = vmap(lambda k: random.randint(k, (), 0, n_pool))(key_pick)
        state = SAState(
            jnp.asarray(0),
            _row_select(zs, pick),
            _row_select(pes, pick),
            jnp.zeros((num_chains,)),
            jnp.zeros((num_chains,)),
            jnp.zeros((num_chains,), bool),
            SAAdaptState(zs, pes, loc, scale),
            rng_key,
        )
        state = state._replace(z=layout.unravel_batch(state.z))
        if not self._batched:
            state = jax.tree.map(lambda x: x[0] if jnp.ndim(x) else x, state)
        return state

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def sample(self, state, model_args, model_kwargs):
        if not self._batched:
            i = state.i
            state = jax.tree.map(lambda x: jnp.asarray(x)[None], state)
            state = state._replace(i=i)
        flat = self._layout.ravel_batch(state.z)
        state = state._replace(z=flat)
        cfg = SAConfig(self._dense_mass, self._num_warmup)
        new = sa_panel_transition(
            state, self._pe_batch(model_args, model_kwargs), cfg
        )
        new = new._replace(z=self._layout.unravel_batch(new.z))
        if not self._batched:
            new = jax.tree.map(lambda x: x[0] if jnp.ndim(x) else x, new)
        return new

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_potential_fn_gen"] = None
        return state
