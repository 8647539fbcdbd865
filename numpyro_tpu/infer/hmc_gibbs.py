"""Gibbs-composed HMC kernels, natively chain-batched.

Role parity with numpyro/infer/hmc_gibbs.py (HMCGibbs / DiscreteHMCGibbs /
HMCECS), but the design differs structurally from the reference:

- **Chain-batched throughout.**  Outer Gibbs state (site values, subsample
  index panels, proxy statistics) carries a leading chain axis; Gibbs
  conditionals, block updates and pseudo-marginal accepts are vmapped over
  chains so thousands of chains advance in one program.  A single chain is
  ``C == 1`` squeezed at the API boundary.
- **Per-chain conditioning channel.**  Conditioning values reach the inner
  HMC's vmapped potential through ``model_kwargs["_per_chain"]`` (see
  ``hmc.py``) instead of being baked into a scalar closure — each chain's
  leapfrog gradient sees *its own* Gibbs values / subsample indices.
- **Exact categorical conditionals.**  Discrete-site updates evaluate all
  candidate values of a site in one vmapped sweep and sample the softmax
  conditional directly, rather than the reference's sequential
  reservoir-style candidate loop (hmc_gibbs.py:150-271).
- **Mask-based block refresh.**  HMCECS subsample blocks are refreshed with
  arithmetic position masks (no pad + dynamic-slice shuffling), which lowers
  to select/iota — the accelerator-friendly form of Tran et al.'s block
  pseudo-marginal update.
"""

from __future__ import annotations

import copy
from collections import namedtuple
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import jacfwd, random, value_and_grad, vmap
from jax.flatten_util import ravel_pytree
from jax.scipy.special import logsumexp

import numpyro_tpu
from numpyro_tpu.contrib.ecs_proxies import (
    block_refresh,
    subsample_estimator,
    subsample_panels,
    taylor_proxy,
)
from numpyro_tpu.handlers import condition, seed, substitute, trace
from numpyro_tpu.infer.hmc import HMC
from numpyro_tpu.infer.initialization import init_to_sample
from numpyro_tpu.infer.mcmc import MCMCKernel
from numpyro_tpu.util import identity, is_prng_key

HMCGibbsState = namedtuple("HMCGibbsState", "z, hmc_state, rng_key")
"""``z``: all latents (Gibbs + HMC sites); ``hmc_state``: inner kernel
state; ``rng_key``: outer Gibbs key(s)."""

HMCECSState = namedtuple(
    "HMCECSState", "z, hmc_state, rng_key, gibbs_state, accept_prob, panels"
)
# ``panels``: recorded subsample data panels for the CURRENT index sets,
# carried so each Gibbs step gathers once (for the proposal) instead of
# twice; ``()`` when the model has no panels yet (fresh init).
HMCECSState.__new__.__defaults__ = ((),)


def _wrap_model(model, *args, **kwargs):
    gibbs_values = kwargs.pop("_gibbs_sites", {})
    with condition(data=gibbs_values), substitute(data=gibbs_values):
        return model(*args, **kwargs)


def _batched(state):
    """Add a leading chain axis to every leaf except the static scalars
    (step index, trajectory length)."""
    hs = state.hmc_state
    i, traj = hs.i, hs.trajectory_length
    out = jax.tree.map(lambda x: jnp.asarray(x)[None], state)
    return out._replace(
        hmc_state=out.hmc_state._replace(i=i, trajectory_length=traj)
    )


def _unbatched(state):
    # static scalar leaves (step index, trajectory length) have no chain
    # axis to strip — leave anything 0-dimensional alone
    return jax.tree.map(lambda x: x[0] if jnp.ndim(x) else x, state)


def _split_keys(keys, n):
    pieces = vmap(lambda k: random.split(k, n))(keys)
    return tuple(pieces[:, j] for j in range(n))


class HMCGibbs(MCMCKernel):
    """Inner HMC/NUTS over continuous sites composed with a user-supplied
    Gibbs conditional over ``gibbs_sites`` (role parity:
    numpyro/infer/hmc_gibbs.py:38-191)."""

    sample_field = "z"

    def __init__(self, inner_kernel, gibbs_fn, gibbs_sites):
        if not isinstance(inner_kernel, HMC):
            raise ValueError("inner_kernel must be a HMC or NUTS sampler.")
        if not callable(gibbs_fn):
            raise ValueError("gibbs_fn must be a callable")
        assert inner_kernel.model is not None, (
            "HMCGibbs does not support models specified via a potential function."
        )
        self.inner_kernel = copy.copy(inner_kernel)
        self.inner_kernel._model = partial(_wrap_model, inner_kernel.model)
        self._gibbs_sites = gibbs_sites
        self._gibbs_fn = gibbs_fn
        self._prototype_trace = None
        self._chain_mode = False  # True once init sees a batch of keys

    @property
    def model(self):
        return self.inner_kernel._model

    def get_diagnostics_str(self, state):
        hs = state.hmc_state
        return "{} steps of size {:.2e}. acc. prob={:.2f}".format(
            hs.num_steps, hs.adapt_state.step_size, hs.mean_accept_prob
        )

    def postprocess_fn(self, args, kwargs):
        def fn(z):
            model_kwargs = {} if kwargs is None else kwargs.copy()
            gibbs_sites = {k: v for k, v in z.items() if k in self._gibbs_sites}
            hmc_sites = {k: v for k, v in z.items() if k not in self._gibbs_sites}
            model_kwargs["_gibbs_sites"] = gibbs_sites
            out = self.inner_kernel.postprocess_fn(args, model_kwargs)(hmc_sites)
            return {**gibbs_sites, **out}

        return fn

    def _prototype(self, rng_key, model_args, model_kwargs):
        if self._prototype_trace is None:
            self._prototype_trace = trace(
                substitute(seed(self.model, rng_key), substitute_fn=init_to_sample())
            ).get_trace(*model_args, **model_kwargs)
        return self._prototype_trace

    def _initial_gibbs_values(self, init_params):
        values = {}
        for name, site in self._prototype_trace.items():
            if name not in self._gibbs_sites:
                continue
            if init_params and name in init_params:
                values[name] = init_params.pop(name)
            else:
                values[name] = site["value"]
        return values

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs={}):
        model_kwargs = {} if model_kwargs is None else model_kwargs.copy()
        self._chain_mode = not is_prng_key(rng_key)
        if not self._chain_mode:
            state = self._init_batched(
                rng_key[None], num_warmup, init_params, model_args, model_kwargs
            )
            return _unbatched(state)
        return self._init_batched(
            rng_key, num_warmup, init_params, model_args, model_kwargs
        )

    def _init_batched(self, keys, num_warmup, init_params, model_args, model_kwargs):
        num_chains = keys.shape[0]
        keys, proto_keys, inner_keys = _split_keys(keys, 3)
        self._prototype(proto_keys[0], model_args, model_kwargs)
        gibbs_values = self._initial_gibbs_values(init_params)
        gibbs_panel = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (num_chains,) + jnp.shape(x)),
            gibbs_values,
        )
        inner_kwargs = model_kwargs.copy()
        inner_kwargs["_gibbs_sites"] = gibbs_values  # shared at init
        hmc_state = self.inner_kernel.init(
            inner_keys, num_warmup, init_params, model_args, inner_kwargs
        )
        z = {**gibbs_panel, **hmc_state.z}
        return HMCGibbsState(z, hmc_state, keys)

    def _chain_potential(self, model_args, model_kwargs):
        """Per-chain potential: (gibbs_values_c, z_hmc_c) -> scalar."""

        def pe(z_gibbs_c, z_hmc_c):
            return self.inner_kernel._potential_fn_gen(
                *model_args, _gibbs_sites=z_gibbs_c, **model_kwargs
            )(z_hmc_c)

        return pe

    def _refresh_hmc_state(self, hmc_state, z_gibbs, model_args, model_kwargs):
        """Recompute pe/grad under new per-chain Gibbs conditioning."""
        pe_fn = self._chain_potential(model_args, model_kwargs)
        if self.inner_kernel._forward_mode_differentiation:
            def one(g, zc):
                return pe_fn(g, zc), jacfwd(partial(pe_fn, g))(zc)
        else:
            def one(g, zc):
                return value_and_grad(partial(pe_fn, g))(zc)

        pe, grad = vmap(one)(z_gibbs, hmc_state.z)
        return hmc_state._replace(z_grad=grad, potential_energy=pe)

    def sample(self, state, model_args, model_kwargs):
        model_kwargs = {} if model_kwargs is None else model_kwargs
        if not self._chain_mode:
            state = _batched(state)
        state = self._sample_batched(state, model_args, model_kwargs)
        if not self._chain_mode:
            state = _unbatched(state)
        return state

    def _sample_batched(self, state, model_args, model_kwargs):
        keys, gibbs_keys = _split_keys(state.rng_key, 2)
        z_gibbs = {
            k: v for k, v in state.z.items() if k not in state.hmc_state.z
        }
        z_hmc = {k: v for k, v in state.z.items() if k in state.hmc_state.z}

        # run the user conditional per chain on constrained hmc values
        def one_chain(key, g, h):
            mk = dict(model_kwargs)
            mk["_gibbs_sites"] = g
            h_constrained = self.inner_kernel.postprocess_fn(model_args, mk)(h)
            return self._gibbs_fn(
                rng_key=key, gibbs_sites=g, hmc_sites=h_constrained
            )

        z_gibbs = vmap(one_chain)(gibbs_keys, z_gibbs, z_hmc)
        hmc_state = self._refresh_hmc_state(
            state.hmc_state, z_gibbs, model_args, model_kwargs
        )
        inner_kwargs = dict(model_kwargs)
        inner_kwargs["_per_chain"] = {"_gibbs_sites": z_gibbs}
        hmc_state = self.inner_kernel.sample(hmc_state, model_args, inner_kwargs)
        z = {**z_gibbs, **hmc_state.z}
        return HMCGibbsState(z, hmc_state, keys)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_prototype_trace"] = None
        return state


# ---------------------------------------------------------------------------
# Discrete-site conditionals


def _site_element_layout(support_sizes):
    """Flatten {site: per-element support size} into host-side arrays."""
    names = sorted(support_sizes)
    sizes = np.concatenate(
        [np.asarray(support_sizes[k]).reshape(-1) for k in names]
    ).astype(np.int32)
    return names, sizes


def _one_hot_set(flat, idx, value):
    """flat.at[idx].set(value) via select (no scatter)."""
    pos = jnp.arange(flat.shape[0])
    return jnp.where(pos == idx, value, flat)


def _element_proposal(pe_at, key, flat, pe, idx, size, smax, mode):
    """Propose a new value for discrete element ``idx`` of one chain.

    Returns ``(flat_prop, pe_prop, log_ratio)`` where ``log_ratio`` is the
    MH log-acceptance-ratio of the proposal (0 for the exact-conditional
    'gibbs' draw, which needs no correction).  Candidate energies are
    evaluated in one vmapped sweep for the conditional modes.

    ``mode``: 'gibbs' (exact conditional), 'modified-gibbs' (never-stay),
    'rw' (uniform), 'modified-rw' (uniform over the other values).
    """
    cur = flat[idx]
    if mode in ("gibbs", "modified-gibbs"):
        cand = jnp.arange(smax)
        z_cand = jnp.where(
            jnp.arange(flat.shape[0])[None, :] == idx,
            cand[:, None].astype(flat.dtype),
            flat[None, :],
        )
        pe_cand = vmap(pe_at)(z_cand)
        logw = jnp.where(cand < size, -pe_cand, -jnp.inf)
        logw = jnp.where(jnp.isnan(logw), -jnp.inf, logw)
        if mode == "gibbs":
            new = random.categorical(key, logw)
            flat_prop = _one_hot_set(flat, idx, new.astype(flat.dtype))
            return flat_prop, pe_cand[new], jnp.zeros(())
        # never-stay proposal: q(z'|z) ∝ w(z') over z'≠z, so the MH ratio is
        # Σ_{k≠z} w / Σ_{k≠z'} w
        logw_others = jnp.where(cand == cur, -jnp.inf, logw)
        prop = random.categorical(key, logw_others)
        log_fwd = logsumexp(logw_others)
        log_bwd = logsumexp(jnp.where(cand == prop, -jnp.inf, logw))
        flat_prop = _one_hot_set(flat, idx, prop.astype(flat.dtype))
        return flat_prop, pe_cand[prop], log_fwd - log_bwd
    if mode == "rw":
        prop = random.randint(key, (), 0, size)
    else:  # modified-rw: uniform over the other values (symmetric)
        raw = random.randint(key, (), 0, size - 1)
        prop = jnp.where(raw >= cur, raw + 1, raw)
    flat_prop = _one_hot_set(flat, idx, prop.astype(flat.dtype))
    pe_prop = pe_at(flat_prop)
    pe_prop = jnp.where(jnp.isnan(pe_prop), jnp.inf, pe_prop)
    return flat_prop, pe_prop, pe - pe_prop


def _discrete_sweep(
    pe_fn, key, z_flat, unravel, pe, sizes_np, *, mode, smax
):
    """One full Metropolis-within-Gibbs sweep over every discrete element of
    one chain, visiting elements in random order."""
    nd = sizes_np.shape[0]
    sizes = jnp.asarray(sizes_np)
    key, perm_key = random.split(key)
    order = random.permutation(perm_key, nd)

    def pe_at(flat):
        return pe_fn(unravel(flat))

    def body(j, carry):
        key, flat, pe = carry
        idx = order[j]
        key, k_prop, k_accept = random.split(key, 3)
        flat_prop, pe_prop, log_ratio = _element_proposal(
            pe_at, k_prop, flat, pe, idx, sizes[idx], smax, mode
        )
        take = jnp.log(random.uniform(k_accept)) < log_ratio
        flat = jnp.where(take, flat_prop, flat)
        return key, flat, jnp.where(take, pe_prop, pe)

    key, flat, pe = jax.lax.fori_loop(0, nd, body, (key, z_flat, pe))
    return flat, pe


class DiscreteHMCGibbs(HMCGibbs):
    """Metropolis-within-Gibbs over auto-detected enumerable discrete sites
    + inner HMC/NUTS over the rest (role parity: hmc_gibbs.py:272-487)."""

    def __init__(self, inner_kernel, *, random_walk=False, modified=False):
        super().__init__(inner_kernel, identity, None)
        self._random_walk = random_walk
        self._modified = modified
        self._mode = {
            (False, False): "gibbs",
            (False, True): "modified-gibbs",
            (True, False): "rw",
            (True, True): "modified-rw",
        }[(random_walk, modified)]

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs={}):
        model_kwargs = {} if model_kwargs is None else model_kwargs.copy()
        proto_key = rng_key if is_prng_key(rng_key) else rng_key[0]
        tr = self._prototype(proto_key, model_args, model_kwargs)
        discrete = {
            name: site
            for name, site in tr.items()
            if site["type"] == "sample"
            and not site["is_observed"]
            and site["fn"].has_enumerate_support
        }
        self._gibbs_sites = [
            name
            for name, site in discrete.items()
            if site["infer"].get("enumerate", "") != "parallel"
        ]
        assert self._gibbs_sites, "Cannot detect any discrete latent variables."
        self._support_sizes = {
            name: np.broadcast_to(
                discrete[name]["fn"].enumerate_support(False).shape[0],
                jnp.shape(discrete[name]["value"]),
            )
            for name in self._gibbs_sites
        }
        return super().init(
            rng_key, num_warmup, init_params, model_args, model_kwargs
        )

    def _sample_batched(self, state, model_args, model_kwargs):
        keys, gibbs_keys = _split_keys(state.rng_key, 2)
        z_gibbs = {
            k: v for k, v in state.z.items() if k not in state.hmc_state.z
        }
        z_hmc = {k: v for k, v in state.z.items() if k in state.hmc_state.z}
        names, sizes_np = _site_element_layout(self._support_sizes)
        smax = int(sizes_np.max())
        pe_fn = self._chain_potential(model_args, model_kwargs)

        def one_chain(key, g, h, pe):
            flat, unravel = ravel_pytree(g)
            flat, pe = _discrete_sweep(
                lambda gg: pe_fn(gg, h),
                key,
                flat,
                unravel,
                pe,
                sizes_np,
                mode=self._mode,
                smax=smax,
            )
            return unravel(flat), pe

        z_gibbs, pe = vmap(one_chain)(
            gibbs_keys, z_gibbs, z_hmc, state.hmc_state.potential_energy
        )

        # gradient under the new conditioning (pe already exact)
        if self.inner_kernel._forward_mode_differentiation:
            grad_fn = lambda g, zc: jacfwd(partial(pe_fn, g))(zc)  # noqa: E731
        else:
            grad_fn = lambda g, zc: jax.grad(partial(pe_fn, g))(zc)  # noqa: E731
        z_grad = vmap(grad_fn)(z_gibbs, z_hmc)
        hmc_state = state.hmc_state._replace(
            z_grad=z_grad, potential_energy=pe
        )
        inner_kwargs = dict(model_kwargs)
        inner_kwargs["_per_chain"] = {"_gibbs_sites": z_gibbs}
        hmc_state = self.inner_kernel.sample(hmc_state, model_args, inner_kwargs)
        z = {**z_gibbs, **hmc_state.z}
        return HMCGibbsState(z, hmc_state, keys)


# ---------------------------------------------------------------------------
# HMCECS


def _wrap_gibbs_state(model, *args, **kwargs):
    msg = {"type": "_gibbs_state", "value": kwargs.pop("_gibbs_state", ())}
    numpyro_tpu.primitives.apply_stack(msg)
    panels = kwargs.pop("_subsample_panels", None)
    if panels is not None:
        # announce the panels to the estimator (for the proxy's pointwise
        # re-evaluations) and replay them in place of in-potential gathers
        numpyro_tpu.primitives.apply_stack(
            {"type": "_subsample_panels", "value": panels}
        )
        with subsample_panels(panels=panels):
            return model(*args, **kwargs)
    return model(*args, **kwargs)


class HMCECS(HMCGibbs):
    """HMC with Energy-Conserving Subsampling — per-chain subsample index
    panels, vmapped block refreshes, and a batched pseudo-marginal accept
    (role parity: numpyro/infer/hmc_gibbs.py:502-687; Dang et al. 2019,
    Tran et al. 2017, Quiroz et al. 2018)."""

    def __init__(
        self,
        inner_kernel,
        *,
        num_blocks=1,
        proxy=None,
        collect_subsample_indices=False,
        panel_mode="auto",
    ):
        if panel_mode not in ("auto", "carry", "bf16", "lean"):
            raise ValueError("panel_mode must be auto|carry|bf16|lean")
        super().__init__(inner_kernel, identity, None)
        self._collect_subsample_indices = collect_subsample_indices
        # subsample data-panel handling: "carry" keeps the gathered
        # (chains, m, ...) panels in the kernel state (one gather per Gibbs
        # step), "bf16" carries them at half width, "lean" carries nothing
        # and re-gathers inside each potential evaluation (the reference's
        # behavior, numpyro/infer/hmc_gibbs.py:690-769); "auto" picks by
        # estimated device memory demand vs the device budget
        self._panel_mode = panel_mode
        self.inner_kernel._model = partial(
            _wrap_gibbs_state, self.inner_kernel._model
        )
        # pristine wrapped model: init() layers the subsample estimator on
        # top of THIS each time, so re-initialization stays idempotent
        self._base_inner_model = self.inner_kernel._model
        self._num_blocks = num_blocks
        self._proxy = proxy

    def postprocess_fn(self, args, kwargs):
        def fn(z):
            model_kwargs = {} if kwargs is None else kwargs.copy()
            gibbs_sites = {k: v for k, v in z.items() if k in self._gibbs_sites}
            hmc_sites = {k: v for k, v in z.items() if k not in self._gibbs_sites}
            model_kwargs["_gibbs_sites"] = gibbs_sites
            return self.inner_kernel.postprocess_fn(args, model_kwargs)(hmc_sites)

        return fn

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs={}):
        model_kwargs = {} if model_kwargs is None else model_kwargs.copy()
        batched = not is_prng_key(rng_key)
        proto_key = rng_key[0] if batched else rng_key
        tr = self._prototype(proto_key, model_args, model_kwargs)
        self._subsample_plate_sizes = {
            name: site["args"]
            for name, site in tr.items()
            if site["type"] == "plate"
            and site["args"][1] is not None
            and site["args"][0] > site["args"][1]
        }
        self._gibbs_sites = list(self._subsample_plate_sizes)
        assert self._gibbs_sites, (
            "Cannot detect any subsample statements in the model."
        )
        if not self._collect_subsample_indices:
            # drop the (chains, subsample) int panels from the collected
            # samples; they remain on last_state.z
            self.collect_exclude_sites = tuple(self._gibbs_sites)
        if self._proxy is not None:
            if any(
                site["type"] == "sample"
                and not site["is_observed"]
                and site["fn"].support.is_discrete
                for site in tr.values()
            ):
                raise RuntimeError(
                    "The likelihood proxy does not support models with "
                    "discrete latent sites."
                )
            # the PRISTINE wrapped model: re-initialization must not hand
            # the proxy the estimator-wrapped model from a previous init —
            # its pointwise evaluations would recurse into the estimator
            import inspect

            n_chains_hint = 1 if is_prng_key(rng_key) else rng_key.shape[0]
            extra_hints = {}
            try:
                sig = inspect.signature(self._proxy)
                if "num_chains" in sig.parameters or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in sig.parameters.values()
                ):
                    extra_hints["num_chains"] = n_chains_hint
            except (TypeError, ValueError):  # builtins / odd callables
                pass
            proxy_fn, proxy_init, self._proxy_update = self._proxy(
                tr,
                self._subsample_plate_sizes,
                self._base_inner_model,
                model_args,
                model_kwargs.copy(),
                num_blocks=self._num_blocks,
                **extra_hints,
            )
            # the statistics mode a taylor_proxy(mode="auto") resolved to
            self._proxy_mode_resolved = getattr(proxy_fn, "mode", None)
            self.inner_kernel._model = subsample_estimator(
                self._base_inner_model,
                self._subsample_plate_sizes,
                proxy_fn,
            )
        else:
            proxy_init, self._proxy_update = None, None

        num_chains = 1 if not batched else rng_key.shape[0]
        proto_idx = {
            name: tr[name]["value"] for name in self._gibbs_sites
        }
        idx_panel = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (num_chains,) + jnp.shape(x)),
            proto_idx,
        )
        if proxy_init is not None:
            # ONE jitted program with the data as traced inputs: eager
            # op-by-op dispatch launches hundreds of tiny programs, and a
            # jit over the data-closing closure would bake the dataset
            # into the program as a constant
            from numpyro_tpu.util import merge_dynamic, split_dynamic

            dyn_i, meta_i = split_dynamic((model_args, model_kwargs))

            @jax.jit
            def _batched_proxy_init(idxp, dyn):
                margs, mkwargs = merge_dynamic(dyn, meta_i)
                return vmap(lambda idx: proxy_init(idx, margs, mkwargs))(idxp)

            gibbs_state = _batched_proxy_init(idx_panel, dyn_i)
        else:
            gibbs_state = ()
            from numpyro_tpu.util import merge_dynamic, split_dynamic

            dyn_i, meta_i = split_dynamic((model_args, model_kwargs))
        # panels for the initial index sets, gathered once (jitted with the
        # data as traced inputs, like proxy init)
        init_panel_keys = vmap(lambda k: random.fold_in(k, 7))(
            rng_key if batched else rng_key[None]
        )
        self._resolve_panel_mode(
            init_panel_keys, idx_panel, dyn_i, meta_i, num_chains
        )

        @jax.jit
        def _init_panels(keys, idxp, dyn):
            margs, mkwargs = merge_dynamic(dyn, meta_i)
            return self._record_panels(keys, idxp, margs, mkwargs)

        if self._panel_mode_resolved == "lean":
            panels = ()
        else:
            panels = _init_panels(init_panel_keys, idx_panel, dyn_i)
        self._has_proxy = proxy_init is not None

        model_kwargs["_gibbs_state"] = jax.tree.map(
            lambda x: x[0], gibbs_state
        ) if self._has_proxy else ()
        state = super().init(
            rng_key, num_warmup, init_params, model_args, model_kwargs
        )
        accept = jnp.zeros(() if not batched else (num_chains,))
        if not batched:
            gibbs_state = jax.tree.map(lambda x: x[0], gibbs_state)
        if not batched:
            panels = jax.tree.map(lambda x: x[0], panels)
        return HMCECSState(
            state.z, state.hmc_state, state.rng_key, gibbs_state, accept,
            panels,
        )

    def sample(self, state, model_args, model_kwargs):
        model_kwargs = {} if model_kwargs is None else model_kwargs
        if not self._chain_mode:
            hg = _batched(
                HMCGibbsState(state.z, state.hmc_state, state.rng_key)
            )
            gibbs_state = jax.tree.map(
                lambda x: jnp.asarray(x)[None], state.gibbs_state
            )
            panels = jax.tree.map(
                lambda x: jnp.asarray(x)[None], state.panels
            )
            state = HMCECSState(
                hg.z, hg.hmc_state, hg.rng_key, gibbs_state,
                jnp.asarray(state.accept_prob)[None], panels,
            )
        state = self._sample_batched(state, model_args, model_kwargs)
        if not self._chain_mode:
            hg = _unbatched(
                HMCGibbsState(state.z, state.hmc_state, state.rng_key)
            )
            state = HMCECSState(
                hg.z, hg.hmc_state, hg.rng_key,
                jax.tree.map(lambda x: x[0], state.gibbs_state),
                state.accept_prob[0],
                jax.tree.map(lambda x: x[0], state.panels),
            )
        return state

    def _chain_potential_ecs(self, model_args, model_kwargs):
        def pe(z_gibbs_c, gibbs_state_c, z_hmc_c, panels_c=None):
            extra = (
                {} if panels_c is None else {"_subsample_panels": panels_c}
            )
            return self.inner_kernel._potential_fn_gen(
                *model_args,
                _gibbs_sites=z_gibbs_c,
                _gibbs_state=gibbs_state_c,
                **extra,
                **model_kwargs,
            )(z_hmc_c)

        return pe

    def _resolve_panel_mode(self, keys, idx_panel, dyn, meta, num_chains):
        """Pick carry/bf16/lean for ``panel_mode="auto"`` from the estimated
        device memory footprint of the carried panels (3 copies — old, refreshed,
        selected — are live inside one compiled Gibbs step) against the
        device budget.  Shapes come from ``jax.eval_shape`` — no gathers."""
        mode = self._panel_mode
        if mode != "auto":
            self._panel_mode_resolved = mode
            return
        from numpyro_tpu.contrib.ecs_proxies import _device_hbm_bytes
        from numpyro_tpu.util import merge_dynamic as _merge

        try:
            one_key = keys[:1]
            one_idx = jax.tree.map(lambda x: x[:1], idx_panel)
            shapes = jax.eval_shape(
                lambda k, i, d: self._record_panels(k, i, *_merge(d, meta)),
                one_key, one_idx, dyn,
            )
            per_chain = sum(
                int(np.prod(s.shape)) * s.dtype.itemsize
                for s in jax.tree.leaves(shapes)
            )
        except Exception:
            per_chain = 0
        est = 3 * num_chains * per_chain
        budget = _device_hbm_bytes()
        if est <= 0.15 * budget:
            self._panel_mode_resolved = "carry"
        elif est / 2 <= 0.15 * budget:
            self._panel_mode_resolved = "bf16"
        else:
            self._panel_mode_resolved = "lean"

    def _record_panels(self, keys, z_gibbs, model_args, model_kwargs):
        """Gather every subsample plate's data panels ONCE for the given
        per-chain index sets — potential evals then replay these instead of
        re-gathering inside the leapfrog loop (measured ~7 replayed gather
        fusions per tree iteration without this)."""
        from numpyro_tpu.handlers import block as _block, seed as _seed

        def one(key, zg):
            out = []
            with _block(), subsample_panels(record=True, out=out):
                _seed(self._base_inner_model, key)(
                    *model_args, _gibbs_sites=zg, **model_kwargs
                )
            return tuple(out)

        panels = vmap(one)(keys, z_gibbs)
        if getattr(self, "_panel_mode_resolved", None) == "bf16":
            panels = jax.tree.map(
                lambda x: (
                    x.astype(jnp.bfloat16)
                    if jnp.issubdtype(x.dtype, jnp.floating)
                    and x.dtype != jnp.bfloat16
                    else x
                ),
                panels,
            )
        return panels

    def _sample_batched(self, state, model_args, model_kwargs):
        keys, refresh_keys, accept_keys, panel_keys = _split_keys(
            state.rng_key, 4
        )
        z_gibbs = {
            k: v for k, v in state.z.items() if k not in state.hmc_state.z
        }

        # propose a block refresh of each chain's subsample indices
        if self._has_proxy:
            def refresh(key, idx, gstate):
                return self._proxy_update(
                    key, idx, gstate, model_args, model_kwargs
                )

            z_gibbs_new, gibbs_state_new = vmap(refresh)(
                refresh_keys, z_gibbs, state.gibbs_state
            )
        else:
            def refresh(key, idx):
                site_keys = random.split(key, len(self._gibbs_sites))
                return {
                    name: block_refresh(
                        k,
                        idx[name],
                        self._subsample_plate_sizes[name][0],
                        self._num_blocks,
                    )[0]
                    for name, k in zip(sorted(idx), site_keys)
                }

            z_gibbs_new = vmap(refresh)(refresh_keys, z_gibbs)
            gibbs_state_new = state.gibbs_state

        # batched pseudo-marginal MH on the likelihood-estimator difference
        lean = getattr(self, "_panel_mode_resolved", "carry") == "lean"
        pe_fn = self._chain_potential_ecs(model_args, model_kwargs)
        pe = state.hmc_state.potential_energy
        if lean:
            # no carried panels: every potential evaluation re-gathers its
            # subsample rows (the reference's memory profile,
            # numpyro/infer/hmc_gibbs.py:690-769)
            panels_new = panels_old = ()
            pe_new = vmap(lambda g, s, zc: pe_fn(g, s, zc))(
                z_gibbs_new, gibbs_state_new, state.hmc_state.z
            )
        else:
            panels_new = self._record_panels(
                panel_keys, z_gibbs_new, model_args, model_kwargs
            )
            pe_new = vmap(pe_fn)(
                z_gibbs_new, gibbs_state_new, state.hmc_state.z, panels_new
            )
            panels_old = state.panels
        accept_prob = jnp.exp(jnp.minimum(0.0, pe - pe_new))
        take = (
            jnp.log(vmap(random.uniform)(accept_keys)) < (pe - pe_new)
        )

        def sel(new, old):
            return jax.tree.map(
                lambda a, b: jnp.where(
                    take.reshape(take.shape + (1,) * (jnp.ndim(a) - 1)), a, b
                ),
                new,
                old,
            )

        z_gibbs = sel(z_gibbs_new, z_gibbs)
        gibbs_state = sel(gibbs_state_new, state.gibbs_state)
        pe = jnp.where(take, pe_new, pe)
        # panels for the SELECTED index sets: select between the proposal's
        # freshly-gathered panels and the carried ones — ONE gather per
        # step total, the whole inner trajectory replays them
        panels = () if lean else sel(panels_new, panels_old)

        # gradient under the selected conditioning
        fwd = self.inner_kernel._forward_mode_differentiation
        diff = jacfwd if fwd else jax.grad
        if lean:
            grad_fn = lambda g, s, zc: diff(  # noqa: E731
                lambda z: pe_fn(g, s, z)
            )(zc)
            z_grad = vmap(grad_fn)(z_gibbs, gibbs_state, state.hmc_state.z)
        else:
            grad_fn = lambda g, s, zc, p: diff(  # noqa: E731
                lambda z: pe_fn(g, s, z, p)
            )(zc)
            z_grad = vmap(grad_fn)(
                z_gibbs, gibbs_state, state.hmc_state.z, panels
            )
        hmc_state = state.hmc_state._replace(
            z_grad=z_grad, potential_energy=pe
        )

        inner_kwargs = dict(model_kwargs)
        inner_kwargs["_per_chain"] = {
            "_gibbs_sites": z_gibbs,
            "_gibbs_state": gibbs_state,
            **({} if lean else {"_subsample_panels": panels}),
        }
        hmc_state = self.inner_kernel.sample(hmc_state, model_args, inner_kwargs)
        z = {**z_gibbs, **hmc_state.z}
        return HMCECSState(
            z, hmc_state, keys, gibbs_state, accept_prob, panels
        )

    @staticmethod
    def taylor_proxy(reference_params, degree=2, mode="auto"):
        """Taylor-expansion control variate around MAP reference params.
        ``mode``: "stats" (carried per-chain panels), "recompute" (nothing
        carried — directional derivatives per eval), or "auto" (by device memory
        budget); see :func:`numpyro_tpu.contrib.ecs_proxies.taylor_proxy`."""
        return taylor_proxy(reference_params, degree, mode=mode)
