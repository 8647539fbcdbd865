"""Effectful ``scan`` — run handler-aware model code under ``lax.scan``.

Design (reference: numpyro/contrib/control_flow/scan.py:282-502): the scan
body is traced once per step under a ``block`` so inner sites don't hit the
outer stack directly; the recorded per-step trace is carried out of the loop
as a :class:`~numpyro_tpu.ops.pytree.PytreeTrace` (stacked along time by
``lax.scan`` itself), then each stacked site is replayed into the outer
handlers via ``apply_stack``.  Substitution/conditioning/replay from outer
handlers ride in through the ``substitute_stack`` protocol on the
``control_flow`` message.

Time stays the only sequential axis; everything inside one step is one fused
XLA block, so on an accelerator a scanned model is a single compiled loop with no
per-step dispatch.

Enumeration over discrete latents inside ``scan`` (the reference's
``scan_enum``, numpyro/contrib/control_flow/scan.py:122) is funsor-free and
Accelerator-first here: the enumerated Markov chain becomes a stack of per-step
transition factors ``M_t[..., cur, prev]`` which is collapsed over time with
``lax.associative_scan`` over ``logmatmulexp`` — an O(log T)-depth chain of
K x K matmuls that runs on the tensor cores — and the collapsed block enters the
surrounding enumeration scope as a single ``factor`` site.  Supported scope:
``history <= 1`` and one enumerated site per step (the standard HMM layout);
the final carry keeps its enumeration dim and must not feed downstream
factors.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, random

from numpyro_tpu import handlers
from numpyro_tpu.distributions.batch_util import promote_batch_shape
from numpyro_tpu.ops.pytree import PytreeTrace
from numpyro_tpu.primitives import _PYRO_STACK, apply_stack


def _subs_wrapper(subs_map, i, length, site):
    """Adapt an outer substitute/condition map to per-step values."""
    if site["type"] != "sample":
        return None
    value = None
    if isinstance(subs_map, dict) and site["name"] in subs_map:
        value = subs_map[site["name"]]
    elif callable(subs_map):
        rng_key = site["kwargs"].get("rng_key")
        subs_map = (
            handlers.seed(subs_map, rng_seed=rng_key)
            if rng_key is not None
            else subs_map
        )
        value = subs_map(site)
    if value is None:
        return None

    value_ndim = jnp.ndim(value)
    sample_shape = site["kwargs"]["sample_shape"]
    fn_ndim = len(sample_shape + site["fn"].shape())
    if value_ndim == fn_ndim:
        # per-step substitution (e.g. an init strategy applied each step)
        return value
    elif value_ndim == fn_ndim + 1:
        # a whole series was substituted: pick this step's slice
        shape = jnp.shape(value)
        value = jnp.asarray(value)
        if shape[0] == length:
            return value[i]
        elif shape[0] < length:
            rng_key = site["kwargs"]["rng_key"]
            assert rng_key is not None
            return lax.cond(
                i < shape[0],
                (value, i),
                lambda val: val[0][val[1]],
                rng_key,
                lambda val: site["fn"](rng_key=val, sample_shape=sample_shape),
            )
        raise RuntimeError(
            f"Substituted value for site {site['name']} requires length <= "
            f"{length}, got {shape[0]}."
        )
    raise RuntimeError(
        f"Expected ndim {fn_ndim} or {fn_ndim + 1} for site {site['name']}, "
        f"got {value_ndim}.  Nested scan is not supported."
    )


def _promote_scanned_value_shapes(value, fn):
    # fn.batch_shape = (T, 2, 3), value.shape = (T, 3) + event -> value
    # becomes (T, 1, 3) + event so it broadcasts against the stacked fn
    value_batch_ndims = jnp.ndim(value) - fn.event_dim
    fn_batch_ndim = len(fn.batch_shape)
    if fn_batch_ndim > value_batch_ndims:
        prepend = (1,) * (fn_batch_ndim - value_batch_ndims)
        return jnp.reshape(
            value, jnp.shape(value)[:1] + prepend + jnp.shape(value)[1:]
        )
    return value


def _chain_reduce(f0, M, d_cur, d_prev, reverse):
    """Collapse a time-stacked log transition tensor against the initial
    factor: ``logsumexp_{x_0..x_T} [f0(x_0) + sum_t M_t(x_t, x_{t-1})]``.

    ``M`` has time on axis 0 and the current/previous enumeration axes at the
    (negative, step-frame) positions ``d_cur``/``d_prev``; any other axes are
    carried through as batch.  The reduction is an associative scan over
    ``logmatmulexp`` — O(log T) sequential depth, all FLOPs in K x K matmuls.
    """
    from jax.scipy.special import logsumexp

    from numpyro_tpu.distributions.util import logmatmulexp

    need = -d_cur  # rank of one step frame
    if M.ndim - 1 < need:
        M = M.reshape(M.shape[:1] + (1,) * (need - (M.ndim - 1)) + M.shape[1:])
    if f0.ndim < -d_prev:
        f0 = f0.reshape((1,) * (-d_prev - f0.ndim) + f0.shape)
    Mm = jnp.moveaxis(M, (d_cur, d_prev), (-2, -1))
    if reverse:
        Mm = jnp.flip(Mm, axis=0)
    if Mm.shape[0] > 1:
        # combine(earlier, later) = later ∘ earlier
        last = lax.associative_scan(
            lambda a, b: logmatmulexp(b, a), Mm, axis=0
        )[-1]
    else:
        last = Mm[0]
    f0m = jnp.moveaxis(f0, d_prev, -1)[..., None, :]
    return logsumexp(last + f0m, axis=(-2, -1))


def _scan_enum_wrapper(
    f,
    init,
    xs,
    length,
    reverse,
    rng_key=None,
    substitute_stack=None,
    history=1,
    first_available_dim=None,
    enum_boundary=None,
):
    """``scan_enum`` (reference: contrib/control_flow/scan.py:122) without
    funsor: unroll step 0, run the rest under ``lax.scan`` with the carried
    discrete on a recycled dim pair, then eliminate the time block with
    :func:`_chain_reduce` and return the result as one factor site."""
    from jax.scipy.special import logsumexp

    from numpyro_tpu.contrib.enum.enum_messenger import (
        _MARKOV_STACK,
        ENUM_DIM_KEY,
        config_enumerate,
        enum as enum_handler,
    )
    from numpyro_tpu.distributions.util import scale_and_mask
    from numpyro_tpu.primitives import factor as factor_prim

    if length is None:
        length = jnp.shape(jax.tree.flatten(xs)[0][0])[0]
    if substitute_stack is None:
        substitute_stack = []
    if history > 1:
        raise NotImplementedError(
            "enumeration inside scan supports history <= 1; use the "
            "python-loop `markov(range(T), history=h)` form for longer "
            "dependencies"
        )
    history = min(history, length)
    unroll = history  # min(2 * history - 1, length) for history <= 1
    fad = first_available_dim
    d_prev = fad
    d_cur = fad - history
    frame = {"period": history + 1, "slot": 0, "base": None}

    def run_step(i, rng_key, carry, x, slot):
        rng_key, subkey = (
            random.split(rng_key) if rng_key is not None else (None, None)
        )
        fn = handlers.infer_config(
            f, config_fn=lambda msg: {"_scan_current_index": i}
        )
        seeded_fn = handlers.seed(fn, subkey) if subkey is not None else fn
        for subs_type, subs_map in substitute_stack:
            if subs_type == "replay":
                # same treatment as the plain scan wrapper: replaying an
                # outer trace through the scan body is a substitution of
                # its (possibly time-stacked) recorded sample values —
                # sites absent from the trace (e.g. the enumerated Markov
                # site under an ELBO guide replay) pass through untouched
                subs_map = {
                    name: site["value"]
                    for name, site in subs_map.items()
                    if site["type"] == "sample"
                    and not site.get("is_observed", False)
                    and site["value"] is not None
                }
            subs_fn = partial(_subs_wrapper, subs_map, i, length)
            if subs_type == "condition":
                seeded_fn = handlers.condition(seeded_fn, condition_fn=subs_fn)
            else:
                seeded_fn = handlers.substitute(seeded_fn, substitute_fn=subs_fn)
        frame["slot"] = slot
        _MARKOV_STACK.append(frame)
        try:
            with handlers.block(), handlers.trace() as tr:
                enum_fn = enum_handler(
                    config_enumerate(seeded_fn), first_available_dim=fad
                )
                new_carry, y = enum_fn(carry, x)
        finally:
            _MARKOV_STACK.remove(frame)
        return rng_key, new_carry, y, tr

    def step_factor(tr):
        """Broadcast-sum of one step's site log-probs.  Plate axes foreign
        to the enumerated Markov site are independent contributions within
        the step and are summed here — only the chain's own plate axes (a
        per-sequence chain declared inside a plate) ride through the
        logmatmulexp reduction as batch."""
        factors = []
        owner_axes = set()
        n_enum = 0
        for site in tr.values():
            if site["type"] != "sample":
                continue
            d = site.get("infer", {}).get(ENUM_DIM_KEY)
            site_plates = {
                fr.dim for fr in site["cond_indep_stack"] if fr.dim is not None
            }
            if d is not None:
                n_enum += 1
                if d not in (d_prev, d_cur):
                    raise NotImplementedError(
                        "only the carried Markov site may be enumerated "
                        f"inside scan (site {site['name']} got dim {d})"
                    )
                owner_axes |= site_plates
            value = site["value"]
            intermediates = site.get("intermediates")
            lp = (
                site["fn"].log_prob(value, intermediates)
                if intermediates
                else site["fn"].log_prob(value)
            )
            lp = scale_and_mask(lp, site.get("scale"))
            factors.append((lp, site_plates))
        if n_enum > 1:
            raise NotImplementedError(
                "multiple enumerated sites per scan step are not supported; "
                "restructure so one discrete state is carried"
            )
        total = None
        boundary = enum_boundary if enum_boundary is not None else 0
        for lp, site_plates in factors:
            for ax in range(jnp.ndim(lp)):
                dd = ax - jnp.ndim(lp)
                if dd > boundary and dd not in owner_axes and lp.shape[ax] > 1:
                    lp = lp.sum(axis=ax, keepdims=True)
            total = lp if total is None else total + lp
        return jnp.zeros(()) if total is None else total

    # ---- unrolled step 0 (holds x_0 at dim d_prev) -----------------------
    name_hint = "scan"
    if unroll > 0:
        if xs is None:
            x0, xs_rest = None, None
        elif reverse:
            x0 = jax.tree.map(lambda z: z[-1], xs)
            xs_rest = jax.tree.map(lambda z: z[:-1], xs)
        else:
            x0 = jax.tree.map(lambda z: z[0], xs)
            xs_rest = jax.tree.map(lambda z: z[1:], xs)
        rng_key, carry, y0, tr0 = run_step(0, rng_key, init, x0, slot=0)
        f0 = step_factor(tr0)
        for nm, site in tr0.items():
            if site["type"] == "sample":
                name_hint = nm
                break
    else:
        xs_rest, carry, y0, f0 = xs, init, None, None

    # ---- scanned steps: one traced program, recycled dim pair ------------
    n_scan = length - unroll
    if n_scan > 0:

        def body_fn(wrapped, x):
            i, rng_key, carry = wrapped
            rng_key, new_carry, y, tr = run_step(i, rng_key, carry, x, slot=history)
            C = step_factor(tr)
            # current becomes previous: move the enumeration axis back to
            # d_prev by reshape (all other enum axes in the carry are 1)
            new_carry = jax.tree.map(
                lambda a, b: jnp.reshape(a, jnp.shape(b)), new_carry, carry
            )
            return (i + 1, rng_key, new_carry), (C, y)

        wrapped = (jnp.asarray(unroll), rng_key, carry)
        (i_end, rng_key, carry), (Cs, ys) = lax.scan(
            body_fn, wrapped, xs_rest, length=n_scan, reverse=reverse
        )
    else:
        i_end, Cs, ys = jnp.asarray(length), None, None

    # ---- collapse the time block -----------------------------------------
    if history == 0:
        # independent discretes per step: eliminate within each step, then
        # the per-step factors just add up
        chain_lp = Cs
        if chain_lp.ndim >= -d_cur + 1 and chain_lp.shape[d_cur] > 1:
            chain_lp = logsumexp(chain_lp, axis=d_cur, keepdims=True)
        chain_lp = chain_lp.sum(axis=0)
    elif n_scan > 0:
        chain_lp = _chain_reduce(f0, Cs, d_cur, d_prev, reverse)
    else:
        if f0.ndim >= -d_prev and f0.shape[d_prev] > 1:
            f0 = logsumexp(f0, axis=d_prev, keepdims=True)
        chain_lp = f0
    # sum out plate-region axes (independent contributions); keepdims so any
    # *global* enum dims (boundary < d <= -1 - plate region) keep position
    if enum_boundary is not None and chain_lp.ndim > 0:
        for ax in range(chain_lp.ndim):
            d = ax - chain_lp.ndim
            if d > enum_boundary and chain_lp.shape[ax] > 1:
                chain_lp = chain_lp.sum(axis=ax, keepdims=True)

    # package the factor as a real trace site so scan() replays it upward
    with handlers.block(), handlers.trace() as ftr:
        with handlers.seed(rng_seed=0):
            factor_prim(f"_chain_{name_hint}", chain_lp)
    ftr = {
        nm: {**{k: v for k, v in site.items() if k != "stop"},
             "_control_flow_done": True}
        for nm, site in ftr.items()
    }

    # ---- outputs -----------------------------------------------------------
    if y0 is not None and ys is not None:
        if reverse:
            ys = jax.tree.map(
                lambda z, z0: jnp.concatenate(
                    [jnp.reshape(z, (z.shape[0],) + jnp.shape(z0)), z0[None]], 0
                ),
                ys,
                y0,
            )
        else:
            ys = jax.tree.map(
                lambda z, z0: jnp.concatenate(
                    [z0[None], jnp.reshape(z, (z.shape[0],) + jnp.shape(z0))], 0
                ),
                ys,
                y0,
            )
    elif y0 is not None:
        ys = jax.tree.map(lambda z0: z0[None], y0)

    return (i_end, rng_key, carry), (PytreeTrace(dict(ftr)), ys)


def scan_wrapper(
    f,
    init,
    xs,
    length,
    reverse,
    rng_key=None,
    substitute_stack=None,
    enum=False,
    history=1,
    first_available_dim=None,
    enum_boundary=None,
):
    if length is None:
        length = jnp.shape(jax.tree.flatten(xs)[0][0])[0]
    if substitute_stack is None:
        substitute_stack = []
    if enum:
        return _scan_enum_wrapper(
            f,
            init,
            xs,
            length,
            reverse,
            rng_key=rng_key,
            substitute_stack=substitute_stack,
            history=history,
            first_available_dim=first_available_dim,
            enum_boundary=enum_boundary,
        )

    def body_fn(wrapped_carry, x):
        i, rng_key, carry = wrapped_carry
        rng_key, subkey = (
            random.split(rng_key) if rng_key is not None else (None, None)
        )

        with handlers.block():
            # tell the unconstraining substitution which step is running
            fn = handlers.infer_config(
                f, config_fn=lambda msg: {"_scan_current_index": i}
            )
            seeded_fn = handlers.seed(fn, subkey) if subkey is not None else fn
            for subs_type, subs_map in substitute_stack:
                subs_fn = partial(_subs_wrapper, subs_map, i, length)
                if subs_type == "condition":
                    seeded_fn = handlers.condition(seeded_fn, condition_fn=subs_fn)
                elif subs_type == "substitute":
                    seeded_fn = handlers.substitute(
                        seeded_fn, substitute_fn=subs_fn
                    )
                elif subs_type == "replay":
                    # Pull this step's values straight out of the stacked
                    # outer trace instead of pre-tracing the body (which
                    # would need rng keys the replaying caller may not
                    # have — e.g. SteinLoss's log_q_j replay).
                    replay_values = {
                        name: site["value"]
                        for name, site in subs_map.items()
                        if site["type"] == "sample"
                        and not site.get("is_observed", False)
                        and site["value"] is not None
                    }
                    subs_fn = partial(_subs_wrapper, replay_values, i, length)
                    seeded_fn = handlers.substitute(
                        seeded_fn, substitute_fn=subs_fn
                    )

            with handlers.trace() as trace:
                carry, y = seeded_fn(carry, x)

        return (i + 1, rng_key, carry), (PytreeTrace(trace), y)

    wrapped_carry = (jnp.asarray(0), rng_key, init)
    last_carry, (pytree_trace, ys) = lax.scan(
        body_fn, wrapped_carry, xs, length=length, reverse=reverse
    )
    for name, site in pytree_trace.trace.items():
        if site["type"] != "sample":
            continue
        # re-derive batch shapes now that lax.scan stacked the leaves
        site["fn"] = promote_batch_shape(site["fn"])
        site["value"] = _promote_scanned_value_shapes(site["value"], site["fn"])
    return last_carry, (pytree_trace, ys)


def scan(f, init, xs, length=None, reverse=False, history=1):
    """Scan ``f`` over the leading axis of ``xs`` while carrying state,
    recording inner ``sample``/``deterministic`` sites into the enclosing
    handlers (reference: numpyro/contrib/control_flow/scan.py:349).

    :param f: ``(carry, x) -> (carry, y)`` which may call primitives.
    :param init: initial carry.
    :param xs: pytree scanned along the leading axis (or None with length).
    :param length: required when xs is None.
    :param reverse: scan backwards.
    :param history: Markov history for enumeration (enum path pending).
    :return: ``(last_carry, ys)`` as in :func:`jax.lax.scan`.
    """
    if not _PYRO_STACK:
        (length, rng_key, carry), (pytree_trace, ys) = scan_wrapper(
            f, init, xs, length=length, reverse=reverse
        )
        return carry, ys

    initial_msg = {
        "type": "control_flow",
        "fn": scan_wrapper,
        "args": (f, init, xs, length, reverse),
        "kwargs": {"rng_key": None, "substitute_stack": [], "history": history},
        "value": None,
    }
    msg = apply_stack(initial_msg)
    (length, rng_key, carry), (pytree_trace, ys) = msg["value"]

    # replay the stacked sites into the outer handler stack so they are
    # traced/conditioned/scaled exactly like ordinary sites
    for site in pytree_trace.trace.values():
        if site["type"] == "plate":
            continue
        apply_stack(site)

    return carry, ys
