"""JAX substrate utilities.

Accelerator-first re-design of numpyro/util.py: platform/precision toggles, the
sample-collection loop (`fori_collect`), chunked vmap (`soft_vmap`), and
debug-friendly control-flow shims.

Chain-massive design notes:
- `fori_collect` defaults to the fused path — ONE compiled program containing
  the whole (warmup+)sampling loop, with the collection buffer donated and
  updated in place via `lax.dynamic_update_index_in_dim`.  The progress-bar
  path dispatches per-iteration jitted steps (debug/interactive only).
- All loops are `lax` control flow unless `_DISABLE_CONTROL_FLOW_PRIM` is
  set, which swaps in Python loops so kernels can be stepped through.
"""

from __future__ import annotations

import os
import random as pyrandom
from contextlib import contextmanager
from functools import partial
from typing import Any, Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import device_put, jit, lax, vmap

_DISABLE_CONTROL_FLOW_PRIM = False
_CHAIN_RE = "chain"


def set_rng_seed(rng_seed=None):
    """Seed Python + NumPy RNGs (host-side reproducibility for tests)."""
    pyrandom.seed(rng_seed)
    np.random.seed(rng_seed)


def enable_x64(use_x64: bool = True):
    """Toggle 64-bit floats/ints (useful for stiff posteriors)."""
    enabled = use_x64 or bool(os.getenv("JAX_ENABLE_X64", 0))
    jax.config.update("jax_enable_x64", enabled)


def set_platform(platform: str | None = None):
    """Set the default JAX platform (e.g. "cpu", "gpu")."""
    chosen = platform or os.getenv("JAX_PLATFORM_NAME", "cpu")
    jax.config.update("jax_platform_name", chosen)


def set_host_device_count(n: int):
    """Force XLA to expose ``n`` host (CPU) devices — the reference trick
    for testing multi-device code paths without accelerators
    (numpyro/util.py:64-89)."""
    count_flag = f"--xla_force_host_platform_device_count={n}"
    others = [
        flag
        for flag in os.getenv("XLA_FLAGS", "").split()
        if not flag.startswith("--xla_force_host_platform_device_count")
    ]
    os.environ["XLA_FLAGS"] = " ".join([count_flag] + others)


@contextmanager
def optional(condition, context_manager):
    if condition:
        with context_manager:
            yield
    else:
        yield


@contextmanager
def control_flow_prims_disabled():
    """Debug mode: swap lax control flow for Python loops."""
    global _DISABLE_CONTROL_FLOW_PRIM
    previous = _DISABLE_CONTROL_FLOW_PRIM
    try:
        _DISABLE_CONTROL_FLOW_PRIM = True
        yield
    finally:
        _DISABLE_CONTROL_FLOW_PRIM = previous


def _debug_mode():
    return _DISABLE_CONTROL_FLOW_PRIM


def maybe_jit(fn, *args, **kwargs):
    return fn if _debug_mode() else jit(fn, *args, **kwargs)


def cond(pred, true_operand, true_fun, false_operand, false_fun):
    if _debug_mode():
        return true_fun(true_operand) if pred else false_fun(false_operand)
    return lax.cond(
        pred,
        lambda _: true_fun(true_operand),
        lambda _: false_fun(false_operand),
        operand=None,
    )


def while_loop(cond_fun, body_fun, init_val):
    if _debug_mode():
        state = init_val
        while cond_fun(state):
            state = body_fun(state)
        return state
    return lax.while_loop(cond_fun, body_fun, init_val)


def fori_loop(lower, upper, body_fun, init_val):
    if _debug_mode():
        state = init_val
        for i in range(int(lower), int(upper)):
            state = body_fun(i, state)
        return state
    return lax.fori_loop(lower, upper, body_fun, init_val)


def not_jax_tracer(x):
    return not isinstance(x, jax.core.Tracer)


def split_dynamic(tree):
    """Partition a pytree into array leaves (to be traced through jit) and
    everything else (python scalars, strings — kept static).

    Model args must ride through compiled programs as inputs so data never
    becomes a baked XLA constant, but python-scalar args (e.g. a scan
    length) must NOT be traced — models branch on them.  Returns
    ``(dynamic, meta)``; rebuild with :func:`merge_dynamic`.
    """
    leaves, treedef = jax.tree.flatten(tree)
    is_arr = [isinstance(x, (jax.Array, np.ndarray)) for x in leaves]
    dynamic = [x for x, d in zip(leaves, is_arr) if d]
    static = tuple(None if d else x for x, d in zip(leaves, is_arr))
    return dynamic, (treedef, tuple(is_arr), static)


def merge_dynamic(dynamic, meta):
    treedef, is_arr, static = meta
    it = iter(dynamic)
    leaves = [next(it) if d else s for d, s in zip(is_arr, static)]
    return jax.tree.unflatten(treedef, leaves)


def identity(x, *args, **kwargs):
    return x


def cached_by(outer_fn, *keys):
    """Memoize a jitted closure on the enclosing driver object, so repeated
    runs with identical static config reuse the compiled program (mirrors
    numpyro/util.py cached_by)."""

    def _wrapped(fn):
        fn_cache = outer_fn._cache
        hashable_keys = tuple(
            k if isinstance(k, (int, str, bool, type(None), tuple)) or callable(k) else id(k)
            for k in keys
        )
        try:
            fn = fn_cache[hashable_keys]
        except KeyError:
            fn_cache[hashable_keys] = fn
            if len(fn_cache) > 128:
                fn_cache.pop(next(iter(fn_cache)))
        except TypeError:
            pass
        return fn

    return _wrapped


def progress_bar_factory(num_samples, num_chains):
    """tqdm progress bar driven from inside jit via io_callback — used by the
    interactive (per-step dispatch) collection path.

    Design: ONE throttled callback; all bookkeeping (first-tick description,
    increments, final close) happens host-side from the reported iteration
    number, so the compiled program carries a single ``lax.cond``."""
    from jax.experimental import io_callback

    try:
        from tqdm.auto import tqdm
    except ImportError:  # pragma: no cover
        return lambda fn: fn

    stride = max(num_samples // 20, 1)

    bars = {
        c: tqdm(range(num_samples), position=c) for c in range(num_chains)
    }
    for bar in bars.values():
        bar.set_description("Compiling.. ", refresh=True)
    done = set()

    def _host_tick(iter_num, chain):
        iter_num, chain = int(iter_num), int(chain)
        bar = bars[chain]
        if iter_num <= 1:
            bar.set_description(f"Running chain {chain}", refresh=False)
        bar.update(iter_num - bar.n)
        if iter_num >= num_samples:
            done.add(chain)
            if len(done) == num_chains:
                for b in bars.values():
                    b.close()
        return chain

    def _maybe_tick(iter_num, chain):
        due = (
            (iter_num == 1)
            | (iter_num % stride == 0)
            | (iter_num == num_samples)
        )
        return lax.cond(
            due,
            lambda _: io_callback(_host_tick, jnp.array(0), iter_num, chain),
            lambda _: chain,
            operand=None,
        )

    def progress_bar_fori_loop(func):
        def wrapper_progress_bar(i, vals):
            chain, inner = vals
            result = func(i, inner)
            chain = _maybe_tick(i + 1, chain)
            return (chain, result)

        return wrapper_progress_bar

    return progress_bar_fori_loop


def fori_collect(
    lower: int,
    upper: int,
    body_fun: Callable,
    init_val: Any,
    transform: Callable = identity,
    progbar: bool = True,
    return_last_val: bool = False,
    collection_size=None,
    thinning: int = 1,
    body_args: tuple = (),
    **progbar_opts,
):
    """Run ``body_fun`` ``upper`` times, collecting ``transform(state)`` for
    iterations in ``[lower, upper)`` subject to thinning.

    Without a progress bar the whole loop (including warmup below
    ``lower``) is a single compiled ``lax.fori_loop`` program — no per-step
    host dispatch (reference equivalent: numpyro/util.py:277-407 with
    progress_bar=False).

    ``body_args`` is an extra pytree of arguments forwarded to ``body_fun``
    on every call *through the compiled program's inputs* — pass model data
    here instead of closing over it, so it never becomes a constant baked
    into the program (which bloats compilation and recompiles per dataset).
    """
    assert lower <= upper
    assert thinning >= 1
    collection_size = (
        (upper - lower) // thinning if collection_size is None else collection_size
    )
    assert collection_size >= (upper - lower) // thinning
    init_val_transformed = transform(init_val)
    start_idx = lower + (upper - lower) % thinning
    num_chains = progbar_opts.pop("num_chains", 1)

    @partial(maybe_jit, donate_argnums=2)
    def _body_fn(i, val, collection, start_idx, thinning, body_args=()):
        val = body_fun(val, *body_args)
        idx = (i - start_idx) // thinning
        collected = transform(val)
        # clamp idx so the scatter is always in-bounds; mask selects whether
        # the write survives (branchless — fuses into one program)
        write_idx = jnp.clip(idx, 0, collection_size - 1)
        # keep the LAST draw of each stride (reference semantics: every
        # iteration overwrites its slot, so the stride's final value wins)
        do_write = (idx >= 0) & ((i - start_idx) % thinning == thinning - 1)
        collection = jax.tree.map(
            lambda buf, v: buf.at[write_idx].set(
                jnp.where(do_write, v, buf[write_idx])
            ),
            collection,
            collected,
        )
        return val, collection, start_idx, thinning, body_args

    if collection_size == 0:
        # nothing to collect (e.g. warmup-only run): just advance the state
        val = init_val
        if not progbar:
            val, _ = fori_loop(
                0,
                upper,
                lambda i, c: (body_fun(c[0], *c[1]), c[1]),
                (val, body_args),
            )
        else:
            for _ in range(upper):
                val = maybe_jit(body_fun)(val, *body_args)
        empty = jax.tree.map(
            lambda x: jnp.zeros((0,) + jnp.shape(x), dtype=jnp.result_type(x)),
            init_val_transformed,
        )
        return (empty, val) if return_last_val else empty

    collection = jax.tree.map(
        lambda x: jnp.zeros((collection_size,) + jnp.shape(x), dtype=jnp.result_type(x)),
        init_val_transformed,
    )

    if not progbar:
        def loop_body(i, vals):
            return _body_fn(i, *vals)

        last_val, collection, _, _, _ = fori_loop(
            0,
            upper,
            loop_body,
            (init_val, collection, start_idx, thinning, body_args),
        )
    else:
        diagnostics_fn = progbar_opts.pop("diagnostics_fn", None)
        progbar_desc = progbar_opts.pop("progbar_desc", lambda x: "")
        try:
            from tqdm.auto import tqdm

            vals = (
                init_val,
                collection,
                device_put(start_idx),
                device_put(thinning),
                body_args,
            )
            with tqdm(range(upper)) as t:
                for i in t:
                    vals = _body_fn(i, *vals)
                    t.set_description(progbar_desc(i), refresh=False)
                    if diagnostics_fn:
                        t.set_postfix_str(diagnostics_fn(vals[0]), refresh=False)
            last_val, collection, _, _, _ = vals
        except ImportError:  # pragma: no cover
            vals = (init_val, collection, start_idx, thinning, body_args)
            for i in range(upper):
                vals = _body_fn(i, *vals)
            last_val, collection, _, _, _ = vals

    return (collection, last_val) if return_last_val else collection


def soft_vmap(fn, xs, batch_ndims=1, chunk_size=None):
    """vmap over the leading ``batch_ndims`` axes in memory-bounded chunks:
    vmap within a chunk, ``lax.map`` across chunks (reference:
    numpyro/util.py:410-461)."""
    flatten_xs = jax.tree.flatten(xs)[0]
    batch_shape = np.shape(flatten_xs[0])[:batch_ndims]
    for x in flatten_xs[1:]:
        assert np.shape(x)[:batch_ndims] == batch_shape

    # collapse batch dims to a single leading dim
    num_chunks = batch_size = int(np.prod(batch_shape))
    prepend_shape = (batch_size,) if batch_size > 1 else ()
    xs = jax.tree.map(
        lambda x: jnp.reshape(x, prepend_shape + jnp.shape(x)[batch_ndims:]), xs
    )
    fn = vmap(fn) if batch_size > 1 else fn
    if chunk_size is not None and 1 < chunk_size < batch_size:
        pad = chunk_size - (batch_size % chunk_size) if batch_size % chunk_size else 0
        xs = jax.tree.map(
            lambda x: jnp.pad(x, ((0, pad),) + ((0, 0),) * (np.ndim(x) - 1)), xs
        )
        num_chunks = batch_size // chunk_size + int(pad > 0)
        xs = jax.tree.map(
            lambda x: jnp.reshape(x, (num_chunks, chunk_size) + jnp.shape(x)[1:]), xs
        )
        ys = lax.map(fn, xs)
        map_ndims = 2
    else:
        ys = fn(xs)
        map_ndims = int(batch_size > 1)
        pad = 0

    ys = jax.tree.map(
        lambda y: jnp.reshape(y, (-1,) + jnp.shape(y)[map_ndims:])[:batch_size]
        if batch_size > 1
        else y,
        ys,
    )
    return jax.tree.map(
        lambda y: jnp.reshape(y, batch_shape + jnp.shape(y)[1:])
        if batch_size > 1
        else y,
        ys,
    )


def format_shapes(trace, *, compute_log_prob=False, title="Trace Shapes:", last_site=None):
    """Pretty-print site shapes of a model trace (reference numpyro/util.py:464)."""
    if not trace.keys():
        return title
    rows = [[title]]
    rows.append(["Param Sites:"])
    for name, site in trace.items():
        if site["type"] == "param":
            rows.append(
                [name, None]
                + [str(size) for size in getattr(site["value"], "shape", ())]
            )
        if name == last_site:
            break
    rows.append(["Sample Sites:"])
    for name, site in trace.items():
        if site["type"] == "sample":
            batch_shape = getattr(site["fn"], "batch_shape", ())
            event_shape = getattr(site["fn"], "event_shape", ())
            rows.append(
                [f"{name} dist", None]
                + [str(size) for size in batch_shape]
                + ["|", None]
                + [str(size) for size in event_shape]
            )
            shape = getattr(site["value"], "shape", ())
            batch_shape = shape[: len(shape) - len(event_shape)]
            rows.append(
                ["value", None]
                + [str(size) for size in batch_shape]
                + ["|", None]
                + [str(size) for size in event_shape]
            )
            if compute_log_prob in (True,) or (
                callable(compute_log_prob) and compute_log_prob(name, site)
            ):
                log_prob = site["fn"].log_prob(site["value"])
                rows.append(
                    ["log_prob", None]
                    + [str(size) for size in jnp.shape(log_prob)]
                    + ["|", None]
                )
        elif site["type"] == "plate":
            shape = getattr(site["value"], "shape", ())
            rows.append(
                [f"{name} plate", None] + [str(size) for size in shape] + ["|", None]
            )
        if name == last_site:
            break
    return _format_table(rows)


def _format_table(rows):
    """Format a right-aligned shape table."""
    # compute column widths
    column_widths = [0, 0, 0]
    for row in rows:
        widths = [0, 0, 0]
        j = 0
        for cell in row:
            if cell is None:
                j += 1
            else:
                widths[j] += 1
        for j in range(3):
            column_widths[j] = max(column_widths[j], widths[j])

    # justify columns
    for i, row in enumerate(rows):
        cols = [[], [], []]
        j = 0
        for cell in row:
            if cell is None:
                j += 1
            else:
                cols[j].append(cell)
        cols = [
            [""] * (width - len(col)) + col
            if direction == "r"
            else col + [""] * (width - len(col))
            for width, col, direction in zip(column_widths, cols, "rrl")
        ]
        rows[i] = sum(cols, [])

    # compute cell widths
    cell_widths = [0] * len(rows[0])
    for row in rows:
        for j, cell in enumerate(row):
            cell_widths[j] = max(cell_widths[j], len(cell))

    return "\n".join(
        " ".join(cell.rjust(width) for cell, width in zip(row, cell_widths)).rstrip()
        for row in rows
    )


def check_model_guide_match(model_trace, guide_trace):
    """Structural checks that a guide matches its model (shapes, sites)."""
    # site names
    model_sites = {
        name
        for name, site in model_trace.items()
        if site["type"] == "sample" and not site["is_observed"]
    }
    guide_sites = {
        name
        for name, site in guide_trace.items()
        if site["type"] == "sample" and not site["is_observed"]
    }
    extra = guide_sites - model_sites
    if extra:
        import warnings

        warnings.warn(
            f"Found auxiliary vars in the guide but not model: {extra}",
            stacklevel=2,
        )
    missing = model_sites - guide_sites
    for name in missing:
        site = model_trace[name]
        fn = site["fn"]
        # a missing site is fine only if model will sample it
        if getattr(fn, "has_enumerate_support", False):
            continue
    return


def find_stack_level() -> int:
    """Stack level pointing at user code for warnings (best effort)."""
    import inspect

    pkg_dir = os.path.dirname(__file__)
    frame = inspect.currentframe()
    n = 0
    while frame:
        fname = inspect.getfile(frame)
        if fname.startswith(pkg_dir):
            frame = frame.f_back
            n += 1
        else:
            break
    return n


def nested_attrgetter(*collect_fields):
    """attrgetter supporting dotted access into dict-valued fields
    (e.g. ``adapt_state.step_size``)."""

    def _getter(obj):
        results = tuple(_get_nested(obj, field.split(".")) for field in collect_fields)
        return results if len(collect_fields) > 1 else results[0]

    return _getter


def _get_nested(obj, parts):
    for part in parts:
        if isinstance(obj, dict):
            obj = obj[part]
        else:
            obj = getattr(obj, part)
    return obj


def is_prng_key(key):
    from numpyro_tpu.distributions.util import is_prng_key as _impl

    return _impl(key)


@contextmanager
def profiler_trace(log_dir, **kwargs):
    """Capture a ``jax.profiler`` trace (TensorBoard/Perfetto-viewable)
    around a block — the profiling hook promised in SURVEY §5 (the reference
    only points users at jax.profiler in docs)::

        with numpyro_tpu.util.profiler_trace("/tmp/trace"):
            mcmc.run(key, data)
    """
    jax.profiler.start_trace(log_dir, **kwargs)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
