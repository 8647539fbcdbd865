"""Shared numeric helpers for the distributions layer.

Accelerator-first implementations of the utility surface of
numpyro/distributions/util.py — shape promotion, masked scaling, stable
special-function kernels.  The discrete samplers (binomial, von Mises) are
designed batched-first: one whole-array rejection loop with per-lane accept
masks, instead of the reference's per-element vmapped scalar loops — on an
accelerator a vmapped scalar `while_loop` serializes, while the masked-lane form keeps
every iteration a full-width vector op.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, random
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import gammainc, gammaln

# matrix/vector helpers ------------------------------------------------------


def promote_shapes(*args, shape=()):
    """Left-pad arg shapes so they broadcast against each other and ``shape``."""
    if shape == () and len(args) < 2:
        return args
    arg_shapes = [jnp.shape(a) for a in args]
    rank = len(lax.broadcast_shapes(shape, *arg_shapes))
    out = []
    for a, s in zip(args, arg_shapes):
        pad = rank - len(s)
        out.append(a if pad == 0 else jnp.reshape(a, (1,) * pad + s))
    return out


def sum_rightmost(x, dim):
    return jnp.sum(x, axis=tuple(range(-dim, 0))) if dim else x


def scale_and_mask(x, scale=None, mask=None):
    """Scale a log-prob tensor, respecting a boolean mask (0 where masked)."""
    scaled = x if scale is None else x * scale
    return scaled if mask is None else jnp.where(mask, scaled, 0.0)


def matrix_to_tril_vec(x, diagonal=0):
    rows, cols = jnp.tril_indices(x.shape[-1], diagonal)
    return x[..., rows, cols]


def vec_to_tril_matrix(t, diagonal=0):
    from .transforms import vec_to_tril_matrix as _impl

    return _impl(t, diagonal)


def cholesky_of_inverse(matrix):
    """Cholesky of matrix inverse via triangular solve (stable, batched).

    Flipping both axes turns the Cholesky of the reversed matrix into an
    upper-triangular factor of the original, whose transpose-solve against I
    yields chol(M^-1) without ever forming the inverse."""
    flipped = jnp.linalg.cholesky(matrix[..., ::-1, ::-1])
    upper = jnp.swapaxes(flipped[..., ::-1, ::-1], -2, -1)
    eye = jnp.broadcast_to(jnp.identity(matrix.shape[-1]), upper.shape)
    return solve_triangular(upper, eye, lower=True)


def add_diag(matrix, diag):
    """matrix + diag(diag) for batched square matrices."""
    k = matrix.shape[-1]
    bumps = jnp.asarray(diag)[..., None] if jnp.ndim(diag) == 0 else diag
    return matrix.at[..., jnp.arange(k), jnp.arange(k)].add(bumps)


# lazy_property ---------------------------------------------------------------


class lazy_property:
    """Cache an expensive derived quantity (e.g. a Cholesky factor) on first
    access; the cached value participates in pytree flattening when listed in
    ``pytree_data_fields``."""

    def __init__(self, wrapped):
        self.wrapped = wrapped
        functools.update_wrapper(self, wrapped)

    def __get__(self, instance, obj_type=None):
        if instance is None:
            return self
        computed = self.wrapped(instance)
        instance.__dict__[self.wrapped.__name__] = computed
        return computed


def validate_sample(log_prob_fn):
    @functools.wraps(log_prob_fn)
    def wrapper(self, *args, **kwargs):
        out = log_prob_fn(self, *args, **kwargs)
        if self._validate_args:
            sample = kwargs.get("value", args[0] if args else None)
            in_support = self._validate_sample(sample)
            out = jnp.where(in_support, out, -jnp.inf)
        return out

    return wrapper


def is_prng_key(key) -> bool:
    try:
        if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
            return key.shape == ()
        return key.dtype == np.uint32 and key.shape == (2,)
    except AttributeError:
        return False


def assert_one_of(**kwargs):
    given = [name for name, val in kwargs.items() if val is not None]
    if len(given) != 1:
        raise ValueError(
            f"Exactly one of {list(kwargs)} must be specified; got {given}"
        )


# special-function kernels ----------------------------------------------------


def binary_cross_entropy_with_logits(x, y):
    # -y * log sigmoid(x) - (1 - y) * log sigmoid(-x), stably
    return jnp.logaddexp(0.0, -jnp.abs(x)) + jnp.maximum(x, 0.0) - x * y


def clamp_probs(probs):
    eps = jnp.finfo(jnp.result_type(probs, float))
    return jnp.clip(probs, eps.tiny, 1.0 - eps.eps)


def logits_to_probs(logits, is_binary=False):
    fn = jax.nn.sigmoid if is_binary else functools.partial(jax.nn.softmax, axis=-1)
    return fn(logits)


def probs_to_logits(probs, is_binary=False):
    safe = clamp_probs(probs)
    return jnp.log(safe) - jnp.log1p(-safe) if is_binary else jnp.log(safe)


def multigammaln(a, d):
    offsets = 0.5 * jnp.arange(d)
    terms = gammaln(jnp.expand_dims(a, -1) - offsets).sum(-1)
    return terms + 0.25 * d * (d - 1) * jnp.log(jnp.pi)


def betainc(a, b, x):
    return jax.scipy.special.betainc(a, b, x)


def _bisect_inverse(fn, target, lo, hi, iters):
    """Invert a monotone CDF by fixed-count bisection (jit-friendly: the
    trip count is static, the bracket state is whole-array)."""

    def halve(_, bracket):
        lo, hi = bracket
        mid = 0.5 * (lo + hi)
        below = fn(mid) < target
        return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

    lo, hi = lax.fori_loop(0, iters, halve, (lo, hi))
    return 0.5 * (lo + hi)


def betaincinv(a, b, y):
    # jax has no betaincinv; the unit interval brackets the root for free
    a, b, y = jnp.broadcast_arrays(a, b, y)
    return _bisect_inverse(
        lambda x: betainc(a, b, x), y, jnp.zeros_like(y), jnp.ones_like(y), 60
    )


def gammaincinv(a, y):
    a, y = jnp.broadcast_arrays(a, y)
    return _bisect_inverse(
        lambda x: gammainc(a, x), y, jnp.zeros_like(y), jnp.full_like(y, 1e6), 120
    )


def stirling_approx_tail(k):
    """tail(k) = log k! - [0.5 log(2π) + (k+½) log(k+1) - (k+1)].

    Evaluated exactly through ``gammaln`` for small k (where the subtraction
    is well-conditioned) and by the asymptotic series elsewhere — no lookup
    table needed."""
    kp1 = k + 1.0
    exact = gammaln(kp1) - (k + 0.5) * jnp.log(kp1) + kp1 - 0.9189385332046727
    inv_sq = 1.0 / jnp.square(kp1)
    series = (1.0 / 12.0 - (1.0 / 360.0 - inv_sq / 1260.0) * inv_sq) / kp1
    return jnp.where(k < 10, exact, series)


# -- batched binomial sampling ------------------------------------------------
#
# Algorithm parity with the reference (numpyro/distributions/util.py:108-228):
# Hormann's BTRS transformed rejection for np >= 10, geometric-jump inversion
# below.  Design difference: both run as ONE whole-array while_loop with a
# per-lane done mask (lanes destined for the other sampler start out done),
# so no per-element key splitting or vmap-of-while_loop appears anywhere.


def _btrs_batched(key, p, n, shape):
    """Hormann (1993) transformed rejection with squeeze, all lanes at once.

    Lanes with n*p < 10 are born accepted (their value comes from inversion).
    Accept proposal k iff ``v * alpha / g(u) <= f(k) / f(mode)`` where g is
    the dominating density's derivative term; the density ratio is evaluated
    through the symmetric half-term ``lf(j) = (j+½)log(j+1) +
    (n-j+½)log(n-j+1) + tail(j) + tail(n-j)`` so that
    ``log f(k) - log f(m) = lf(m) - lf(k) + (k-m) log odds``.
    """
    use = n * p >= 10.0
    # per-lane envelope constants (Hormann Table 1)
    spread = jnp.sqrt(n * p * (1.0 - p))
    b = 1.15 + 2.53 * spread
    a = -0.0873 + 0.0248 * b + 0.01 * p
    center = n * p + 0.5
    v_cut = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spread
    mode = jnp.floor((n + 1.0) * p)
    log_odds = jnp.log(p) - jnp.log1p(-p)

    def lf(j):
        return (
            (j + 0.5) * jnp.log1p(j)
            + (n - j + 0.5) * jnp.log1p(n - j)
            + stirling_approx_tail(j)
            + stirling_approx_tail(n - j)
        )

    lf_mode = lf(mode)

    def propose(state):
        key, k, pending = state
        key, sub = random.split(key)
        u, v = random.uniform(sub, (2,) + shape)
        u = u - 0.5
        us = 0.5 - jnp.abs(u)
        k_new = jnp.floor((2.0 * a / us + b) * u + center)
        in_range = (k_new >= 0.0) & (k_new <= n)
        # squeeze: cheap accept region needing no log evaluation
        squeeze = (us >= 0.07) & (v <= v_cut)
        log_ratio = lf_mode - lf(k_new) + (k_new - mode) * log_odds
        envelope = jnp.log(v * alpha) - jnp.log(a / jnp.square(us) + b)
        ok = in_range & (squeeze | (envelope <= log_ratio))
        k = jnp.where(pending & ok, k_new, k)
        return key, k, pending & ~ok

    def unsettled(state):
        return jnp.any(state[2])

    init = (key, jnp.zeros(shape, p.dtype), use)
    return lax.while_loop(unsettled, propose, init)[1]


def _inversion_batched(key, p, n, shape):
    """Sum geometric gaps until they pass n; the count of completed gaps is
    Binomial(n, p).  Every lane advances together; finished lanes idle."""
    use = n * p < 10.0
    log_q = jnp.log1p(-p)

    def jump(state):
        key, hops, total, pending = state
        key, sub = random.split(key)
        u = random.uniform(sub, shape)
        gap = jnp.ceil(jnp.log1p(-u) / log_q)
        total = jnp.where(pending, total + gap, total)
        hops = jnp.where(pending & (total <= n), hops + 1.0, hops)
        return key, hops, total, pending & (total <= n)

    def unsettled(state):
        return jnp.any(state[3])

    zeros = jnp.zeros(shape, p.dtype)
    out = lax.while_loop(unsettled, jump, (key, zeros, zeros, use))
    return jnp.clip(out[1], 0.0, n)


@functools.partial(jax.jit, static_argnums=(3,))
def _binomial(key, p, n, shape):
    shape = shape or lax.broadcast_shapes(jnp.shape(p), jnp.shape(n))
    fdtype = jnp.result_type(float)
    p = jnp.broadcast_to(p, shape).astype(fdtype)
    n = jnp.broadcast_to(n, shape).astype(fdtype)

    # work on q = min(p, 1-p); mirror the count back at the end
    flip = p > 0.5
    q = jnp.where(flip, 1.0 - p, p)
    # ~(q > 0) also catches NaN p, which must map to 0 like the reference
    degenerate = ~(q > 0.0) | (n <= 0.0)
    q_safe = jnp.where(degenerate, 0.25, q)
    n_safe = jnp.where(n <= 0.0, 1.0, n)

    key_big, key_small = random.split(key)
    k_big = _btrs_batched(key_big, q_safe, n_safe, shape)
    k_small = _inversion_batched(key_small, q_safe, n_safe, shape)
    k = jnp.where(n_safe * q_safe >= 10.0, k_big, k_small)
    k = jnp.where(degenerate, 0.0, k)
    return jnp.where(flip, n - k, k)


def binomial(key, p, n=1, shape=()):
    return _binomial(key, p, n, shape)


@functools.partial(jax.jit, static_argnums=(2,))
def _categorical(key, p, shape):
    # invert the CDF on uniform draws; fully batched, no host control flow
    shape = shape or p.shape[:-1]
    cdf = jnp.cumsum(p, axis=-1)
    draw = random.uniform(key, shape=shape + (1,)) * cdf[..., -1:]
    return jnp.sum(cdf < draw, axis=-1).astype(jnp.result_type(int))


def categorical(key, p, shape=()):
    return _categorical(key, p, shape)


def multinomial(key, p, n, shape=(), total_count_max=None):
    if total_count_max is None:
        if isinstance(n, jax.core.Tracer):
            raise ValueError(
                "total_count_max is required when total_count is traced"
            )
        n_max = int(np.max(jax.device_get(n)))
    else:
        n_max = total_count_max
    k = jnp.shape(p)[-1]
    shape = shape or lax.broadcast_shapes(jnp.shape(p)[:-1], jnp.shape(n))
    if n_max == 0:
        return jnp.zeros(shape + (k,), dtype=jnp.result_type(int))
    # n_max categorical draws, one-hot summed under a per-lane trial mask
    draws = categorical(key, p, (n_max,) + shape)
    trial_axis = jnp.arange(n_max).reshape((n_max,) + (1,) * len(shape))
    live = trial_axis < jnp.broadcast_to(n, shape)
    onehot = jax.nn.one_hot(draws, k, dtype=p.dtype)
    counts = (onehot * live[..., None].astype(p.dtype)).sum(0)
    return counts.astype(jnp.result_type(int))


def von_mises_centered(key, concentration, shape=(), dtype=jnp.float64):
    """Best-Fisher (1979) wrapped-Cauchy rejection sampler, centered at 0.

    One masked whole-array rejection loop (design note at module top)."""
    shape = shape or jnp.shape(concentration)
    dtype = jnp.result_type(dtype)
    kappa = jnp.broadcast_to(concentration, shape).astype(dtype)

    # envelope parameter: exact formula where stable, 1/kappa fallback for
    # tiny kappa (threshold depends on precision)
    thresholds = {"float16": 1.8e-1, "float32": 2e-2, "float64": 1.2e-4}
    cut = thresholds.get(jnp.dtype(dtype).name, 2e-2)
    r = 1.0 + jnp.sqrt(1.0 + 4.0 * jnp.square(kappa))
    rho = (r - jnp.sqrt(2.0 * r)) / (2.0 * kappa)
    env = jnp.where(
        kappa > cut,
        (1.0 + jnp.square(rho)) / (2.0 * rho),
        1.0 / jnp.clip(kappa, jnp.finfo(dtype).tiny),
    )

    def draw_round(state):
        key, w, pending = state
        key, sub = random.split(key)
        u, v = random.uniform(sub, (2,) + shape, dtype=dtype)
        z = jnp.cos(jnp.pi * u)
        w_new = (1.0 + env * z) / (env + z)
        y = kappa * (env - w_new)
        quick = y * (2.0 - y) >= v
        slow = jnp.log(jnp.clip(y / v, 1e-37)) + 1.0 >= y
        ok = quick | slow
        w = jnp.where(pending & ok, w_new, w)
        return key, w, pending & ~ok

    key, sign_key = random.split(key)
    state = (key, jnp.zeros(shape, dtype), jnp.ones(shape, bool))
    w = lax.while_loop(lambda s: jnp.any(s[2]), draw_round, state)[1]
    signs = random.rademacher(sign_key, shape, dtype=dtype)
    return signs * jnp.arccos(jnp.clip(w, -1.0, 1.0))


def safe_normalize(x, *, p=2):
    """Normalize a vector to unit p-norm, safely at 0.

    Gradient-safe: the zero vector maps to the uniform direction with zero
    gradient (double-where keeps the norm's 0/0 out of the backward pass)."""
    zero = jnp.all(x == 0, axis=-1, keepdims=True)
    x_safe = jnp.where(zero, 1.0, x)
    norm = jnp.linalg.norm(x_safe, p, axis=-1, keepdims=True)
    unit = x_safe / jnp.clip(norm, jnp.finfo(x).tiny)
    fallback = jnp.full_like(x, x.shape[-1] ** (-1.0 / p))
    return jnp.where(zero, fallback, unit)


def cholesky_update(L, x, coef=1):
    """Cholesky factor of ``L @ L.T + coef * outer(x, x)`` via the classic
    rank-one LDL update (Gill–Golub–Murray–Saunders), scanned over columns —
    O(n^2) with the column loop as the only sequential axis
    (reference behavior: numpyro/distributions/util.py:365)."""
    batch_shape = lax.broadcast_shapes(L.shape[:-2], x.shape[:-1])
    n = x.shape[-1]
    L = jnp.broadcast_to(L, batch_shape + (n, n))
    x = jnp.broadcast_to(x, batch_shape + (n,))
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    Lu = L / diag[..., None, :]  # unit-diagonal lower triangular
    D = jnp.square(diag)

    # scan inputs: per-column (d_j, column of Lu, one-hot row selector)
    D_cols = jnp.moveaxis(D, -1, 0)  # (n,) + batch
    Lu_cols = jnp.moveaxis(Lu, -1, 0)  # (n,) + batch + (n,)
    eye = jnp.eye(n, dtype=L.dtype)  # (n, n)

    def body(carry, inputs):
        a, w = carry  # a: batch, w: batch + (n,)
        d_j, L_col, e = inputs
        p = (w * e).sum(-1)  # w[j]
        gamma = d_j + a * jnp.square(p)
        beta = p * a / gamma
        a_new = a * d_j / gamma
        w_new = w - p[..., None] * L_col
        below = (jnp.cumsum(e) > 0) & (e == 0)  # rows strictly below j
        L_col_new = L_col + beta[..., None] * w_new * below
        return (a_new, w_new), (gamma, L_col_new)

    a0 = jnp.full(batch_shape, coef, dtype=x.dtype)
    (_, _), (D_new, Lu_new_cols) = lax.scan(body, (a0, x), (D_cols, Lu_cols, eye))
    D_new = jnp.moveaxis(D_new, 0, -1)
    Lu_new = jnp.moveaxis(Lu_new_cols, 0, -1)
    return Lu_new * jnp.sqrt(D_new)[..., None, :]


def logmatmulexp(x, y):
    """Numerically-stable log(exp(x) @ exp(y)) — a matmul in log space
    (used by BNAF's blockwise Jacobian accumulation and the parallel-scan
    HMM machinery)."""
    row_max = lax.stop_gradient(x.max(-1, keepdims=True))
    col_max = lax.stop_gradient(y.max(-2, keepdims=True))
    centered = jnp.exp(x - row_max) @ jnp.exp(y - col_max)
    return jnp.log(centered) + row_max + col_max
