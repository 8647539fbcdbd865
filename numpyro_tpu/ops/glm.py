"""Fused Bernoulli-logits GLM log-likelihood + gradient — the hot op of the
covtype-class workloads (large-N logistic regression under NUTS/HMCECS).

Why this exists: XLA evaluates ``value_and_grad`` of a logistic-regression
potential as a forward GEMM (X @ w), a backward GEMM (rᵀ @ X) and several
(C, N) float32 intermediates written to and read back from device memory —
for 256 chains at covtype shape that is over 2 GB of traffic per leapfrog
while X itself is 75 MB.  The ``"split"`` mode's GPU kernel computes the
log-likelihood **and** its gradient in one pass over X: each tile of rows
is read once, its (chains, rows) logits block lives only in registers, and
both the nll reduction and the gradient contraction happen before the next
tile streams in.

Integration: ``bernoulli_logits_loglik(w, data)`` is a plain differentiable
scalar function of ``w`` usable inside any model via ``numpyro_tpu.factor``;
it composes with the chain-batched driver because vmap over chains hits a
``custom_vmap`` rule that batches chains into the kernel's row dimension
instead of replaying the data pass per chain.

Precision modes (``prepare_glm_data(..., dtype=...)``):

- ``jnp.float32`` (default): exact-f32 model, evaluated by XLA at the
  ambient matmul precision (the MCMC driver traces under ``"highest"``).
- ``"split"``: the design matrix is stored once in bf16 — that quantized
  matrix IS the model's design matrix, exactly — while ``w`` (which moves
  every leapfrog step) is carried as an f32-accurate bf16 hi+lo pair, so
  the forward logits are two native-bf16 tensor-core products with f32
  accumulation, ~2^-16-relative accurate *in w*.  The potential stays
  smooth in ``w`` (energy-conserving trajectories; naive all-bf16 storage
  breaks this because quantizing w makes the potential piecewise-constant
  at posterior scale) and the MH accept uses an f32-accurate density, so
  NUTS samples the bf16-design posterior exactly.  The gradient pass splits
  the f32 residual the same way.  On CUDA devices this mode runs the Pallas
  kernel below (Triton route); elsewhere XLA evaluates the same model in
  f32 on the quantized matrix.
- ``jnp.bfloat16``: everything bf16, including ``w`` — the potential's
  stair-stepping in ``w`` stalls NUTS at high data concentration (kept for
  diffuse posteriors and experimentation only).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.custom_batching import custom_vmap
from jax.sharding import PartitionSpec as P

__all__ = ["BernoulliLogitsGLMData", "bernoulli_logits_loglik", "prepare_glm_data"]

# rows are padded to a multiple of this (zero rows contribute a constant
# softplus(0) to the nll, corrected exactly, and nothing to the gradient)
_N_PAD = 4096
# kernel tiling: rows per tile, chains per program, and the number of
# programs along N the grid aims for (a few waves over the H100's 132 SMs)
_BLOCK_N = 128
_MAX_BLOCK_C = 64
_TARGET_PROGRAMS = 528
_NUM_WARPS = 4
_NUM_STAGES = 3


class BernoulliLogitsGLMData:
    """Pre-laid-out design matrix for the fused op: X padded to
    (N_pad, D_pad) with the observation vector padded to match.  Build once
    via :func:`prepare_glm_data`; reused across every leapfrog step."""

    def __init__(self, x, y, n, d, dtype):
        self.x = x  # (N_pad, D_pad)
        self.y = y  # (N_pad,) float32
        self.n = n
        self.d = d
        self.dtype = dtype

    def tree_flatten(self):
        return (self.x, self.y), (self.n, self.d, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


jax.tree_util.register_pytree_node(
    BernoulliLogitsGLMData,
    BernoulliLogitsGLMData.tree_flatten,
    BernoulliLogitsGLMData.tree_unflatten,
)


def _d_pad(d):
    # a power of two of at least 16: Triton's dot takes no smaller operand
    return max(16, 1 << (d - 1).bit_length())


def prepare_glm_data(X, y, dtype=jnp.float32):
    """Lay out (N, D) design matrix + (N,) binary obs for the fused op.

    :param dtype: storage/precision mode for X — ``jnp.float32`` (exact-f32
        model), ``"split"`` (bf16-stored design matrix with f32-accurate
        split-precision ``w``; the recommended high-throughput mode — see
        module docstring), or ``jnp.bfloat16`` (all-bf16; stalls NUTS at
        high data concentration, experimentation only).
    """
    N, D = X.shape
    n_pad = _N_PAD * ((N + _N_PAD - 1) // _N_PAD)
    store = jnp.bfloat16 if dtype == "split" else dtype
    x = jnp.zeros((n_pad, _d_pad(D)), dtype=store)
    x = x.at[:N, :D].set(X.astype(store))
    y_pad = jnp.zeros((n_pad,), dtype=jnp.float32)
    y_pad = y_pad.at[:N].set(y.astype(jnp.float32))
    return BernoulliLogitsGLMData(x, y_pad, N, D, dtype)


def split_hi_lo(w):
    """Split f32 ``w`` into bf16 ``(hi, lo)`` with ``hi + lo == w`` to
    ~2^-17 relative.

    REGRESSION TRAP: writing this as ``lo = w - bf16(w).astype(f32)`` gets
    ELIDED by XLA's convert simplifier under jit (the f32->bf16->f32
    round-trip is treated as identity), silently zeroing ``lo`` — the split
    potential then stair-steps at bf16-w resolution and NUTS adaptation
    collapses (step size 1e-4, every tree at the depth cap).
    ``lax.reduce_precision`` is the dedicated, non-elidable rounding op.
    """
    w_hi_f = jax.lax.reduce_precision(w, exponent_bits=8, mantissa_bits=7)
    return w_hi_f.astype(jnp.bfloat16), (w - w_hi_f).astype(jnp.bfloat16)


def _xla_fused(w_pad, data):
    """The op in plain XLA: the reference, and the implementation for the
    f32 and bf16 store modes and for non-CUDA backends."""
    x = data.x.astype(jnp.float32)
    logits = w_pad @ x.T  # (B, N_pad)
    y = data.y
    # padded rows produce logits 0 -> constant softplus(0); corrected below
    nll = jnp.sum(jax.nn.softplus(logits) - y * logits, axis=-1)
    n_pad = x.shape[0]
    nll = nll - (n_pad - data.n) * jnp.log(2.0)
    r = jax.nn.sigmoid(logits) - y
    # padded rows of x are zero -> no gradient contribution
    grad = r @ x
    return -nll, -grad


def _block_c(b):
    return min(_MAX_BLOCK_C, max(16, 1 << (b - 1).bit_length()))


def _split_kernel(whi_ref, wlo_ref, x_ref, y_ref, nll_ref, g_ref, *,
                  tiles_per_prog, num_tiles):
    from jax.experimental import pallas as pl

    # operands are bf16: pin the one-pass tensor-core product so that an
    # ambient default_matmul_precision("highest") cannot leak in
    dot = functools.partial(pl.dot, precision=jax.lax.Precision.DEFAULT)
    w_hi = whi_ref[...]
    w_lo = wlo_ref[...]
    first = pl.program_id(1) * tiles_per_prog
    last = jnp.minimum(first + tiles_per_prog, num_tiles)

    def body(t, carry):
        nll_acc, g_acc = carry
        rows = pl.ds(pl.multiple_of(t * _BLOCK_N, _BLOCK_N), _BLOCK_N)
        x = x_ref[rows, :]  # (BN, D) bf16
        y = y_ref[rows][None, :]  # (1, BN) f32
        # (w_hi + w_lo) · x with f32 accumulation
        logits = dot(w_hi, x, trans_b=True) + dot(w_lo, x, trans_b=True)
        # one exp serves both the nll and the residual
        e = jnp.exp(-jnp.abs(logits))
        nll = jnp.maximum(logits, 0.0) + jnp.log1p(e) - y * logits
        r = jnp.where(logits >= 0, 1.0, e) / (1.0 + e) - y
        # hi/lo residual split by round-to-nearest-even on the raw bits
        # (reduce_precision has no lowering on this route; |r| <= 1 and
        # finite, so no NaN/overflow edge cases)
        bits = jax.lax.bitcast_convert_type(r, jnp.uint32)
        rne = bits + jnp.uint32(0x7FFF) + ((bits >> 16) & jnp.uint32(1))
        r_hi_f = jax.lax.bitcast_convert_type(
            rne & jnp.uint32(0xFFFF0000), jnp.float32
        )
        r_hi = r_hi_f.astype(jnp.bfloat16)
        r_lo = (r - r_hi_f).astype(jnp.bfloat16)
        g = dot(r_hi, x) + dot(r_lo, x)  # (BC, D)
        # per-tile row sums stay near BN * 0.3 in magnitude, and the
        # per-program total near tiles_per_prog times that: no
        # high-magnitude float32 sum happens in the kernel (the MH accept
        # needs the potential's absolute error well below 1)
        return nll_acc + jnp.sum(nll, axis=1), g_acc + g

    bc, d = w_hi.shape
    nll_acc, g_acc = jax.lax.fori_loop(
        first,
        last,
        body,
        (jnp.zeros((bc,), jnp.float32), jnp.zeros((bc, d), jnp.float32)),
    )
    nll_ref[...] = nll_acc
    g_ref[...] = g_acc


def _pallas_split(w_pad, data, interpret=False):
    """Split-precision pass on the Triton route: bf16-stored X, f32-accurate
    hi+lo w.  The grid is (chain block, N range); each program loops over
    its row tiles and writes (programs, C) nll and (programs, C, D) gradient
    partials, which XLA sums."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    b_pad, d_pad = w_pad.shape
    n_pad = data.x.shape[0]
    bc = _block_c(b_pad)
    c_blocks = b_pad // bc
    num_tiles = n_pad // _BLOCK_N
    n_progs = max(1, min(num_tiles, _TARGET_PROGRAMS // c_blocks))
    tiles_per_prog = -(-num_tiles // n_progs)
    n_progs = -(-num_tiles // tiles_per_prog)
    w_hi, w_lo = split_hi_lo(w_pad)
    kernel = functools.partial(
        _split_kernel, tiles_per_prog=tiles_per_prog, num_tiles=num_tiles
    )
    nll_part, g_part = pl.pallas_call(
        kernel,
        grid=(c_blocks, n_progs),
        in_specs=[
            pl.BlockSpec((bc, d_pad), lambda c, s: (c, 0)),
            pl.BlockSpec((bc, d_pad), lambda c, s: (c, 0)),
            pl.BlockSpec((n_pad, d_pad), lambda c, s: (0, 0)),
            pl.BlockSpec((n_pad,), lambda c, s: (0,)),
        ],
        out_specs=[
            pl.BlockSpec((None, bc), lambda c, s: (s, c)),
            pl.BlockSpec((None, bc, d_pad), lambda c, s: (s, c, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_progs, b_pad), jnp.float32),
            jax.ShapeDtypeStruct((n_progs, b_pad, d_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="glm_split_loglik_grad",
    )(w_hi, w_lo, data.x, data.y)
    nll = jnp.sum(nll_part, axis=0) - (n_pad - data.n) * jnp.log(2.0)
    return -nll, -jnp.sum(g_part, axis=0)


def _fused_chains(w, data):
    """(B, D) chains -> (loglik (B,), grad (B, D)) on one device's chains."""
    b, d = w.shape
    d_pad = data.x.shape[1]
    b_pad = _block_c(b) * (-(-b // _block_c(b)))
    w_pad = jnp.zeros((b_pad, d_pad), dtype=jnp.float32)
    w_pad = w_pad.at[:b, :d].set(w)
    if data.dtype == "split":
        # branch on the LOWERING platform (not the default backend): only
        # the selected branch is lowered, so a CPU-targeted jit on a GPU
        # host takes the XLA path
        ll, g = jax.lax.platform_dependent(
            w_pad, data, cuda=_pallas_split, default=_xla_fused
        )
    else:
        ll, g = _xla_fused(w_pad, data)
    return ll[:b], g[:b, :d]


def _fused_batched(w, data):
    """Chain-batched op.  Under a context mesh with a ``chains`` axis (the
    ``chain_method="parallel"`` driver sets one), each device evaluates its
    own chains against a replicated X: a Pallas custom call is opaque to
    GSPMD, which would otherwise gather every chain onto every device."""
    mesh = jax.sharding.get_abstract_mesh()
    n_shards = (
        mesh.shape["chains"] if "chains" in mesh.axis_names else 1
    )
    if n_shards > 1 and w.shape[0] % n_shards == 0:
        spec = P("chains")
        return jax.shard_map(
            _fused_chains,
            mesh=mesh,
            in_specs=(spec, P()),
            out_specs=(spec, spec),
            axis_names={"chains"},
            check_vma=False,
        )(w, data)
    return _fused_chains(w, data)


@custom_vmap
def _fused_single(w, data):
    ll, g = _fused_batched(w[None, :], data)
    return ll[0], g[0]


@_fused_single.def_vmap
def _fused_vmap_rule(axis_size, in_batched, w, data):
    # chains batch into the kernel's row dim: one data pass for ALL chains
    assert in_batched[0]
    ll, g = _fused_batched(w, data)
    return (ll, g), (True, True)


@jax.custom_vjp
def bernoulli_logits_loglik(w, data):
    """Σ_n log Bernoulli(y_n | logits = x_n · w), fused with its gradient.

    Differentiable in ``w`` only; ``data`` must come from
    :func:`prepare_glm_data`.  Use inside a model as
    ``numpyro_tpu.factor("lik", bernoulli_logits_loglik(w, data))``.
    """
    return _fused_single(w, data)[0]


def _ll_fwd(w, data):
    ll, g = _fused_single(w, data)
    return ll, g


def _ll_bwd(g, ct):
    return (ct[..., None] * g if jnp.ndim(ct) else ct * g, None)


bernoulli_logits_loglik.defvjp(_ll_fwd, _ll_bwd)
