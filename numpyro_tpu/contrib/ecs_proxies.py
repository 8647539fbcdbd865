"""Likelihood proxies and block updates for energy-conserving subsampling.

Role parity: numpyro/contrib/ecs_proxies.py (Quiroz et al. 2018 difference
estimator; Tran et al. 2017 block pseudo-marginal).  The implementation is
organized differently from the reference:

- :func:`block_refresh` replaces one random block of a chain's subsample
  index panel with **arithmetic position masks** (iota + select) instead of
  pad/dynamic-slice shuffling — the same proposal distribution in a form
  XLA lowers to pure vector ops.
- Proxy statistics are plain namedtuple panels over the subsample axis and
  are refreshed by recomputing only the replaced block, then mask-merged.
- :class:`subsample_estimator` is the effect handler that swaps the exact
  subsampled likelihood for the bias-corrected difference estimator during
  potential-energy evaluation.

Everything here is written per chain; the HMCECS kernel vmaps these
functions over its chain axis.
"""

from __future__ import annotations

import warnings
from collections import namedtuple

import jax
import jax.numpy as jnp
from jax import random
from jax.flatten_util import ravel_pytree

import numpyro_tpu.primitives
from numpyro_tpu.distributions.transforms import biject_to
from numpyro_tpu.handlers import block, substitute, trace

__all__ = [
    "block_refresh",
    "block_update",
    "subsample_estimator",
    "subsample_panels",
    "taylor_proxy",
]


class subsample_panels(numpyro_tpu.primitives.Messenger):
    """Hoist subsample gathers out of compiled potential evaluations.

    The per-chain random-row gather ``X[idx]`` dominates HMCECS wall time
    when it replays inside the leapfrog while_loop (measured: ~7 gather
    fusions per tree iteration — primal, JVP replays, and AD recompute —
    at ~55 ms per 512-chain gather).  The indices are CONSTANT within a
    trajectory, so the kernel gathers ONCE per Gibbs step in ``record``
    mode and every potential eval replays the stored panels:

    - ``record=True``: perform the enclosing subsampled plates' takes
      eagerly, append each panel to ``out``, and flag the message so the
      plates skip their own take.
    - ``record=False``: substitute ``panels`` (in model call order) and
      flag the message.

    Record and replay traverse the same model, so call order aligns.
    """

    def __init__(self, fn=None, panels=None, record=False, out=None):
        self.record = record
        self.panels = out if record else panels
        self._i = 0
        super().__init__(fn)

    def __enter__(self):
        self._i = 0
        return super().__enter__()

    def postprocess_message(self, msg):
        if msg["type"] != "subsample" or msg.get("_pregathered"):
            return
        if self.record:
            from numpyro_tpu.primitives import _PYRO_STACK, plate as _plate

            for h in _PYRO_STACK:
                if isinstance(h, _plate) and h.subsample_size < h.size:
                    h.postprocess_message(msg)
            self.panels.append(msg["value"])
        else:
            msg["value"] = self.panels[self._i]
            self._i += 1
        msg["_pregathered"] = True

def _device_hbm_bytes():
    """Device memory budget for ``"auto"`` mode selection: the limit the
    runtime reports for the first device.  The CPU backend reports none and
    gets a huge budget, so auto keeps the stats-carrying modes there."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return 1e12
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    if not limit:
        raise RuntimeError(
            f"cannot read the memory limit of {dev.device_kind}, so the "
            '"auto" memory modes cannot be resolved; pass mode= to '
            "taylor_proxy and panel_mode= to HMCECS explicitly"
        )
    return float(limit)


TaylorProxyStats = namedtuple("TaylorProxyStats", "value, grad")
"""Per-plate dicts of reference log-lik statistics at the current
subsample: value (m,), grad (m, P).

No per-point Hessian panel is stored: an (m, P, P) panel costs
m*P^2*4 bytes PER CHAIN (12 MB at covtype shape, ~50 GB at 4096 chains).
The degree-2
per-point quadratic term is instead recomputed at evaluation time as a
second directional derivative along d = params - ref (two nested JVPs —
O(m) memory, ~2 extra subsample passes per potential eval)."""


def block_refresh(rng_key, idx, size, num_blocks):
    """Redraw one random block of a subsample index vector.

    Returns ``(new_idx, in_block, repl, start)`` where ``in_block`` marks
    the refreshed positions, ``repl`` holds the block's replacement draws
    (padded block length) and ``start`` is the block's first position.
    """
    m = idx.shape[0]
    bs = -(-m // num_blocks)  # ceil, static
    kb, ki = random.split(rng_key)
    b = random.randint(kb, (), 0, num_blocks)
    repl = random.randint(ki, (bs,), 0, size)
    pos = jnp.arange(m)
    start = b * bs
    in_block = (pos >= start) & (pos < start + bs)
    new_idx = jnp.where(in_block, repl[jnp.clip(pos - start, 0, bs - 1)], idx)
    return new_idx, in_block, repl, start


def block_update(plate_sizes, num_blocks, rng_key, gibbs_sites, gibbs_state):
    """Proxy-free block update of every subsample plate (one chain)."""
    new = {}
    keys = random.split(rng_key, max(len(gibbs_sites), 1))
    for key, name in zip(keys, sorted(gibbs_sites)):
        new[name], *_ = block_refresh(
            key, gibbs_sites[name], plate_sizes[name][0], num_blocks
        )
    return new, gibbs_state


def _per_site_loglik(fn, value, dim):
    """Reduce a site's log_prob over every axis except the subsample dim."""
    lp = fn.log_prob(value)
    moved = jnp.moveaxis(lp, dim, 0)
    return moved.reshape(moved.shape[0], -1).sum(-1)


class subsample_estimator(numpyro_tpu.primitives.Messenger):
    """Swap the exact likelihood of observed sites inside subsample plates
    for the bias-corrected difference estimator (role parity:
    numpyro/infer/hmc_gibbs.py:690-769 + perturbed_method).

    Active only while a potential-energy evaluation is on the handler stack
    (detected by the unconstraining substitution) — model tracing and
    prediction see the untouched likelihood.
    """

    def __init__(self, fn, plate_sizes, proxy_fn):
        super().__init__(fn)
        self._plate_sizes = plate_sizes
        self._proxy = proxy_fn
        self._reset()

    def _reset(self):
        self._params = None
        self._collected = {}
        self._plates_seen = {}
        self._plate_idx = {}
        self._gibbs_state = None
        self._panels = None

    def _in_potential_eval(self):
        from numpyro_tpu.infer.util import _unconstrain_reparam
        from functools import partial as _partial

        for handler in numpyro_tpu.primitives._PYRO_STACK[::-1]:
            if (
                isinstance(handler, substitute)
                and isinstance(handler.substitute_fn, _partial)
                and handler.substitute_fn.func is _unconstrain_reparam
            ):
                return handler.substitute_fn.args[0]
        return None

    def __call__(self, *args, **kwargs):
        # stash the live (traced) model args: the proxy threads them into
        # its pointwise re-evaluations instead of its construct-time
        # closure (which would bake the dataset as a program constant)
        self._call_args = args
        self._call_kwargs = {
            k: v
            for k, v in kwargs.items()
            if k not in ("_gibbs_sites", "_gibbs_state", "_subsample_panels")
        }
        return super().__call__(*args, **kwargs)

    def __enter__(self):
        self._reset()
        self._params = self._in_potential_eval()
        return super().__enter__()

    def __exit__(self, exc_type, exc_value, tb):
        super().__exit__(exc_type, exc_value, tb)
        if exc_type is not None or self._params is None:
            return
        if numpyro_tpu.get_mask() is False:
            self._reset()
            return
        sub_ll = {}
        for fn, value, dim, plate in self._collected.values():
            sub_ll[plate] = sub_ll.get(plate, 0.0) + _per_site_loglik(
                fn, value, dim
            )
        total_all, total_sub = self._proxy(
            self._params,
            tuple(sub_ll),
            self._gibbs_state,
            {k: v for k, v in self._plate_idx.items() if k in sub_ll},
            panels=self._panels,
            margs=getattr(self, "_call_args", None),
            mkwargs=getattr(self, "_call_kwargs", None),
        )
        estimate = 0.0
        for plate, ll in sub_ll.items():
            n, m = self._plate_sizes[plate]
            diff = ll - total_sub[plate]
            # Quiroz et al. difference estimator with variance correction
            estimate += (
                total_all[plate]
                + (n / m) * diff.sum()
                - 0.5 * (n**2 / m) * jnp.var(diff)
            )
        numpyro_tpu.factor("_subsample_likelihood_estimate", estimate)
        self._reset()

    def process_message(self, msg):
        if self._params is None:
            return
        if msg["type"] == "_gibbs_state":
            self._gibbs_state = msg["value"]
            return
        if msg["type"] == "_subsample_panels":
            self._panels = msg["value"]
            return
        if (
            msg["type"] == "plate"
            and msg["args"][1] is not None
            and msg["args"][0] > msg["args"][1]
        ):
            self._plates_seen[msg["name"]] = True
        elif msg["type"] == "sample" and msg["is_observed"]:
            for frame in msg["cond_indep_stack"]:
                if frame.name in self._plates_seen:
                    if msg["name"] in self._collected:
                        raise RuntimeError(
                            f"site {msg['name']} appears under multiple "
                            "subsample plates; reshape the data so each "
                            "observation belongs to one subsample plate"
                        )
                    # keep the ORIGINAL fn — the message's fn is replaced
                    # by a masked one below
                    self._collected[msg["name"]] = (
                        msg["fn"], msg["value"], frame.dim, frame.name
                    )
                    msg["fn"] = msg["fn"].mask(False)

    def postprocess_message(self, msg):
        if self._params is None:
            return
        # final (post-substitution) subsample index vector per plate — the
        # degree-2 proxy re-derives its quadratic terms at these indices
        if msg["type"] == "plate" and msg["name"] in self._plates_seen:
            self._plate_idx[msg["name"]] = msg["value"]


def taylor_proxy(reference_params, degree=2, mode="auto"):
    """Taylor control variate around reference (MAP) parameters.

    Returns a constructor matching the HMCECS proxy contract:
    ``construct(prototype_trace, plate_sizes, model, args, kwargs,
    num_blocks) -> (proxy_fn, proxy_init, proxy_update)`` with per-chain
    ``proxy_init(idx_dict)`` / ``proxy_update(key, idx_dict, stats)``
    (role parity: numpyro/contrib/ecs_proxies.py:99-254).

    ``mode`` selects the memory/compute trade for the per-point reference
    statistics:

    - ``"stats"``: carry ``(m,)`` value and ``(m, P)`` gradient panels per
      chain in the kernel state, block-merged on each index refresh.  One
      extra subsample pass per refresh; per-eval cost is dot products.
    - ``"recompute"``: carry NOTHING per chain.  Each potential evaluation
      recovers value, first and second directional terms from a single
      nested JVP of the pointwise log-lik along ``d = params - ref``
      (``jvp`` of ``t -> jvp(ll(ref + t d))`` at 0 returns all three).
      ~1 extra subsample-sized pass per eval; removes the
      ``num_chains * m * P`` stats panels entirely.
    - ``"auto"``: pick by estimated device memory demand of the stats panels vs the
      device budget (the kernel threads ``num_chains`` in).
    """
    if degree not in (1, 2):
        raise ValueError("taylor_proxy supports degree 1 or 2 only")
    if mode not in ("stats", "recompute", "auto"):
        raise ValueError("taylor_proxy mode must be stats|recompute|auto")

    def construct(prototype_trace, plate_sizes, model, model_args, model_kwargs,
                  num_blocks=1, num_chains=1, hbm_budget=None):
        def _unconstrain(values):
            return {
                name: (
                    biject_to(prototype_trace[name]["fn"].support).inv(v)
                    if prototype_trace[name]["type"] == "sample"
                    else v
                )
                for name, v in values.items()
            }

        def _constrain(values):
            return {
                name: (
                    biject_to(prototype_trace[name]["fn"].support)(v)
                    if prototype_trace[name]["type"] == "sample"
                    else v
                )
                for name, v in values.items()
            }

        # keep the reference vector HOST-side: it is closed over by every
        # jitted potential, and a device-resident closure becomes a
        # constant that lowering copies from the device to the host.  When
        # the reference params are already host arrays (the recommended
        # way to pass them), the unconstrain+ravel is done entirely in
        # numpy so construct performs NO device round-trip at all.
        import numpy as _np

        unc = _unconstrain(reference_params)
        unc_leaves, unc_treedef = jax.tree.flatten(unc)
        if all(not isinstance(x, jax.Array) for x in unc_leaves):
            # pure-host params: flatten AND unravel entirely in numpy
            # (same leaf order / row-major layout as ravel_pytree) —
            # zero device traffic, no eager ops
            shapes = [_np.shape(x) for x in unc_leaves]
            sizes = [int(_np.prod(s)) if s else 1 for s in shapes]
            ref_flat = (
                _np.concatenate(
                    [
                        _np.ravel(_np.asarray(x, dtype=_np.result_type(float)))
                        for x in unc_leaves
                    ]
                )
                if unc_leaves
                else _np.zeros((0,), _np.result_type(float))
            )

            def unravel(flat):
                out, i = [], 0
                for shp, n in zip(shapes, sizes):
                    out.append(jnp.reshape(flat[i : i + n], shp))
                    i += n
                return jax.tree.unflatten(unc_treedef, out)

        else:
            ref_flat, unravel = ravel_pytree(unc)
            if not isinstance(ref_flat, jax.core.Tracer):
                try:
                    ref_flat = _np.asarray(jax.device_get(ref_flat))
                except Exception:
                    pass  # device pull failed: leave as a device array

        def pointwise_loglik(
            params_flat, idx_dict, panels=None, margs=None, mkwargs=None
        ):
            """{plate: (m,)} per-datapoint log-lik at given indices.

            With ``panels`` the subsample gathers are replayed from the
            recorded panels instead of re-gathering (keeps the proxy's
            JVP re-evaluations gather-free inside leapfrog loops).
            ``margs``/``mkwargs`` override the construct-time model args so
            compiled callers can thread the data as TRACED inputs — the
            closure fallback bakes the dataset into the program as a
            constant."""
            from contextlib import nullcontext

            margs = model_args if margs is None else margs
            mkwargs = model_kwargs if mkwargs is None else mkwargs
            replay = (
                subsample_panels(panels=list(panels))
                if panels is not None
                else nullcontext()
            )
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                params = _constrain(unravel(params_flat))
                with (
                    block(),
                    replay,
                    trace() as tr,
                    substitute(data=idx_dict),
                    substitute(data=params),
                ):
                    model(*margs, **mkwargs)
            out = {}
            for site in tr.values():
                if site["type"] == "sample" and site["is_observed"]:
                    for frame in site["cond_indep_stack"]:
                        if frame.name in idx_dict:
                            ll = _per_site_loglik(
                                site["fn"], site["value"], frame.dim
                            )
                            out[frame.name] = out.get(frame.name, 0.0) + ll
            return out

        def _stats_at(idx_dict, margs=None, mkwargs=None):
            value = pointwise_loglik(ref_flat, idx_dict, None, margs, mkwargs)
            # forward-mode jacobian: P << m, so P forward tangents beat m
            # reverse cotangents in both time and (vmapped-over-chains)
            # memory
            grad = jax.jacfwd(pointwise_loglik)(
                ref_flat, idx_dict, None, margs, mkwargs
            )
            return TaylorProxyStats(value, grad)

        # full-data reference statistics, computed once — as ONE jitted
        # program with the data as traced inputs (not op-by-op dispatch,
        # and not a dataset baked into the program as a constant)
        from numpyro_tpu.util import merge_dynamic, split_dynamic

        import numpy as _np

        # host-side iota: closed over by the jitted full-stats program, so
        # a device-resident arange would be lowering-time device pull (see
        # ref_flat note above)
        full_idx = {k: _np.arange(v[0]) for k, v in plate_sizes.items()}
        dyn0, meta0 = split_dynamic((model_args, model_kwargs))

        @jax.jit
        def _full_stats(dyn):
            margs, mkwargs = merge_dynamic(dyn, meta0)

            def _summed(params_flat):
                lls = pointwise_loglik(
                    params_flat, full_idx, None, margs, mkwargs
                )
                return {k: v.sum() for k, v in lls.items()}

            fv = _summed(ref_flat)
            fg = jax.jacobian(_summed)(ref_flat)
            fh = (
                jax.jacfwd(jax.jacrev(_summed))(ref_flat)
                if degree == 2
                else None
            )
            return fv, fg, fh

        full_value, full_grad, full_hess = jax.device_get(
            _full_stats(dyn0)
        )  # host constants: closed over by every potential eval

        # --- resolve the stats-vs-recompute trade --------------------------
        resolved = mode
        if resolved == "auto":
            m_total = sum(int(m) for _, m in plate_sizes.values())
            p_dim = int(ref_flat.size)
            # old + refreshed + merged copies of the (C, m, P+1) panels are
            # live inside one compiled Gibbs step
            stats_bytes = 3 * num_chains * m_total * (p_dim + 1) * 4
            budget = hbm_budget if hbm_budget else _device_hbm_bytes()
            resolved = "stats" if stats_bytes <= 0.15 * budget else "recompute"

        if resolved == "recompute":

            def proxy_init_r(idx_dict, margs=None, mkwargs=None):
                return ()

            def proxy_update_r(rng_key, idx_dict, stats, margs=None,
                               mkwargs=None):
                keys = random.split(rng_key, max(len(idx_dict), 1))
                new_idx = {}
                for key, name in zip(keys, sorted(idx_dict)):
                    new_idx[name] = block_refresh(
                        key, idx_dict[name], plate_sizes[name][0], num_blocks
                    )[0]
                return new_idx, ()

            def proxy_fn_r(params, plate_names, stats, idx_dict=None,
                           panels=None, margs=None, mkwargs=None):
                if idx_dict is None:
                    raise ValueError(
                        "recompute-mode taylor_proxy requires the subsample "
                        "indices at evaluation time"
                    )
                params_flat, _ = ravel_pytree(params)
                d = params_flat - ref_flat

                def along(t):
                    return pointwise_loglik(
                        ref_flat + t * d, idx_dict, panels, margs, mkwargs
                    )

                def val_and_first(t):
                    return jax.jvp(along, (t,), (jnp.ones(()),))

                (vals, firsts), (_, seconds) = jax.jvp(
                    val_and_first, (jnp.zeros(()),), (jnp.ones(()),)
                )
                total_all, total_sub = {}, {}
                for name in plate_names:
                    sub = vals[name] + firsts[name]
                    full = full_value[name] + full_grad[name] @ d
                    if degree == 2:
                        sub = sub + 0.5 * seconds[name]
                        full = full + 0.5 * d @ full_hess[name] @ d
                    total_sub[name] = sub
                    total_all[name] = full
                return total_all, total_sub

            proxy_fn_r.mode = resolved
            return proxy_fn_r, proxy_init_r, proxy_update_r

        def proxy_init(idx_dict, margs=None, mkwargs=None):
            return _stats_at(idx_dict, margs, mkwargs)

        def proxy_update(rng_key, idx_dict, stats, margs=None, mkwargs=None):
            keys = random.split(rng_key, max(len(idx_dict), 1))
            new_idx, masks, repls, starts = {}, {}, {}, {}
            for key, name in zip(keys, sorted(idx_dict)):
                new_idx[name], masks[name], repls[name], starts[name] = (
                    block_refresh(
                        key, idx_dict[name], plate_sizes[name][0], num_blocks
                    )
                )
            repl_stats = _stats_at(repls, margs, mkwargs)

            def merge(old, new):
                merged = {}
                for name in old:
                    m = old[name].shape[0]
                    pos = jnp.arange(m)
                    sel = jnp.clip(pos - starts[name], 0, repls[name].shape[0] - 1)
                    mask = masks[name].reshape(
                        (m,) + (1,) * (old[name].ndim - 1)
                    )
                    merged[name] = jnp.where(mask, new[name][sel], old[name])
                return merged

            value = merge(stats.value, repl_stats.value)
            grad = merge(stats.grad, repl_stats.grad)
            return new_idx, TaylorProxyStats(value, grad)

        def _second_directional(d, idx_dict, panels=None, margs=None,
                                mkwargs=None):
            """Per-point d^2/dt^2 loglik(ref + t d) — the degree-2 Taylor
            quadratic terms, without any stored (m, P, P) Hessian panel."""

            def along(t):
                return pointwise_loglik(
                    ref_flat + t * d, idx_dict, panels, margs, mkwargs
                )

            def first(t):
                return jax.jvp(along, (t,), (jnp.ones(()),))[1]

            return jax.jvp(first, (jnp.zeros(()),), (jnp.ones(()),))[1]

        def proxy_fn(params, plate_names, stats, idx_dict=None, panels=None,
                     margs=None, mkwargs=None):
            # params arrive already unconstrained (they come from the
            # potential-energy substitution)
            if degree == 2 and idx_dict is None:
                # first-order per-point terms with a second-order full term
                # would break the difference estimator's telescoping
                raise ValueError(
                    "degree-2 taylor_proxy requires the subsample indices "
                    "at evaluation time"
                )
            params_flat, _ = ravel_pytree(params)
            d = params_flat - ref_flat
            quad = (
                _second_directional(d, idx_dict, panels, margs, mkwargs)
                if degree == 2
                else None
            )
            total_all, total_sub = {}, {}
            for name in plate_names:
                sub = stats.value[name] + stats.grad[name] @ d
                full = full_value[name] + full_grad[name] @ d
                if degree == 2:
                    if quad is not None:
                        sub = sub + 0.5 * quad[name]
                    full = full + 0.5 * d @ full_hess[name] @ d
                total_sub[name] = sub
                total_all[name] = full
            return total_all, total_sub

        proxy_fn.mode = resolved
        return proxy_fn, proxy_init, proxy_update

    return construct
