"""Fused GLM log-likelihood op: the XLA path that CPU runs, and the CUDA
kernel in Pallas interpret mode (its compiled form is checked on the card
by ``chip_smoke.py``)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import random
from jax.sharding import NamedSharding, PartitionSpec as P

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.infer import MCMC, NUTS
from numpyro_tpu.ops import glm
from numpyro_tpu.ops.glm import bernoulli_logits_loglik, prepare_glm_data

LL_RTOL = 1e-5
G_RTOL, G_ATOL = 1e-3, 1e-3


def _problem(N, D, C, seed=0):
    kx, kw, ky = random.split(random.PRNGKey(seed), 3)
    X = random.normal(kx, (N, D))
    W = random.normal(kw, (C, D)) * 0.3
    y = (random.uniform(ky, (N,)) < 0.5).astype(jnp.float32)
    return X, W, y


def _reference(X, y, W, precision=jax.lax.Precision.HIGHEST, w_dtype=None):
    """float32 loglik and gradient per chain (``w_dtype=bf16``: all-bf16
    operands with float32 accumulation)."""

    def ll(w):
        x, wc = (X, w) if w_dtype is None else (X.astype(w_dtype), w.astype(w_dtype))
        logits = jnp.dot(x, wc, precision=precision, preferred_element_type=jnp.float32)
        return -jnp.sum(jax.nn.softplus(logits) - y * logits)

    return jax.jit(jax.vmap(jax.value_and_grad(ll)))(W)


def _within_tol(ll, g, ll_ref, g_ref):
    ll_ok = np.all(np.abs(ll - ll_ref) <= LL_RTOL * np.abs(ll_ref))
    g_ok = np.all(np.abs(g - g_ref) <= G_ATOL + G_RTOL * np.abs(g_ref))
    return bool(ll_ok and g_ok)


def _kernel_interpret(monkeypatch):
    """Route split mode through the Pallas kernel in interpret mode, as the
    CUDA branch would run it compiled; returns the (chains, D) operand
    shapes of the calls traced."""
    shapes = []

    def kernel(w_pad, data):
        shapes.append(w_pad.shape)
        return glm._pallas_split(w_pad, data, interpret=True)

    monkeypatch.setattr(glm, "_xla_fused", kernel)
    return shapes


def test_matches_direct_loglik_and_grad():
    N, D, C = 5000, 7, 5
    X, W, y = _problem(N, D, C)
    data = prepare_glm_data(X, y)

    def ref_ll(w):
        logits = X @ w
        return -jnp.sum(jax.nn.softplus(logits) - y * logits)

    ll_ref = jax.vmap(ref_ll)(W)
    g_ref = jax.vmap(jax.grad(ref_ll))(W)
    f = jax.jit(
        jax.vmap(jax.value_and_grad(bernoulli_logits_loglik), in_axes=(0, None))
    )
    ll, g = f(W, data)
    np.testing.assert_allclose(ll, ll_ref, rtol=1e-5)
    np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-3)
    # single-chain (unbatched) path
    ll1, g1 = jax.value_and_grad(bernoulli_logits_loglik)(W[0], data)
    np.testing.assert_allclose(ll1, ll_ref[0], rtol=1e-5)
    np.testing.assert_allclose(g1, g_ref[0], rtol=1e-3, atol=1e-3)


def test_split_mode_matches_bf16_design_model():
    """dtype="split" defines the model on the bf16-quantized design matrix
    exactly: the XLA path must match a direct f32 computation on that
    quantized matrix."""
    N, D, C = 5000, 7, 5
    X, W, y = _problem(N, D, C)
    data = prepare_glm_data(X, y, dtype="split")
    assert data.x.dtype == jnp.bfloat16

    Xq = X.astype(jnp.bfloat16).astype(jnp.float32)
    ll_ref, g_ref = _reference(Xq, y, W)
    f = jax.jit(
        jax.vmap(jax.value_and_grad(bernoulli_logits_loglik), in_axes=(0, None))
    )
    ll, g = f(W, data)
    np.testing.assert_allclose(ll, ll_ref, rtol=1e-5)
    np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize(
    "N, D, C",
    [
        (5000, 55, 1),  # one chain, padded to a 16-chain block
        (5000, 55, 5),
        (5000, 55, 33),  # padded to one 64-chain block
        (4096 + 1, 55, 65),  # two chain blocks; a ragged tile range
        (700, 7, 33),  # D padded to 16
    ],
)
def test_kernel_interpret_matches_reference(N, D, C):
    """The kernel body (Triton route, interpret mode) against the float32
    reference on the bf16-quantized design matrix."""
    X, W, y = _problem(N, D, C)
    data = prepare_glm_data(X, y, dtype="split")
    assert data.x.shape[0] % glm._N_PAD == 0 and data.x.shape[0] >= N
    b_pad = glm._block_c(C) * -(-C // glm._block_c(C))
    w_pad = jnp.zeros((b_pad, data.x.shape[1])).at[:C, :D].set(W)
    ll, g = jax.jit(functools.partial(glm._pallas_split, interpret=True))(
        w_pad, data
    )
    Xq = X.astype(jnp.bfloat16).astype(jnp.float32)
    ll_ref, g_ref = _reference(Xq, y, W)
    np.testing.assert_allclose(ll[:C], ll_ref, rtol=LL_RTOL)
    np.testing.assert_allclose(g[:C, :D], g_ref, rtol=G_RTOL, atol=G_ATOL)
    # padded chains (w = 0) see the exact constant loglik N * -log 2 and
    # padded feature columns get no gradient
    np.testing.assert_allclose(ll[C:], -N * np.log(2.0), rtol=LL_RTOL)
    assert float(jnp.abs(g[:, D:]).max()) == 0.0


@pytest.mark.parametrize("batched", [False, True])
def test_kernel_custom_vjp_and_vmap(monkeypatch, batched):
    """The public op with the kernel underneath: the custom_vjp gradient
    equals the reference gradient, and vmap over chains reaches the kernel
    once with every chain batched into its rows."""
    shapes = _kernel_interpret(monkeypatch)
    N, D, C = 3000, 55, 5
    X, W, y = _problem(N, D, C)
    data = prepare_glm_data(X, y, dtype="split")
    Xq = X.astype(jnp.bfloat16).astype(jnp.float32)
    ll_ref, g_ref = _reference(Xq, y, W)
    vg = jax.value_and_grad(bernoulli_logits_loglik)
    if batched:
        ll, g = jax.jit(jax.vmap(vg, in_axes=(0, None)))(W, data)
        assert shapes == [(16, 64)]  # one call, all 5 chains in one block
    else:
        out = [jax.jit(vg)(W[i], data) for i in range(C)]
        ll, g = jnp.stack([o[0] for o in out]), jnp.stack([o[1] for o in out])
    np.testing.assert_allclose(ll, ll_ref, rtol=LL_RTOL)
    np.testing.assert_allclose(g, g_ref, rtol=G_RTOL, atol=G_ATOL)
    # the cotangent scales the gradient (custom_vjp backward rule)
    g2 = jax.grad(lambda w: 2.0 * bernoulli_logits_loglik(w, data))(W[0])
    np.testing.assert_allclose(g2, 2.0 * g_ref[0], rtol=G_RTOL, atol=2 * G_ATOL)


def test_all_bf16_w_fails_tolerance():
    """The tolerances tell the split computation apart from one that rounds
    w to bf16 (what the kernel's hi/lo pair avoids)."""
    N, D, C = 5000, 55, 8
    X, W, y = _problem(N, D, C)
    Xq = X.astype(jnp.bfloat16).astype(jnp.float32)
    ll_ref, g_ref = _reference(Xq, y, W)
    ll_b, g_b = _reference(Xq, y, W, precision=None, w_dtype=jnp.bfloat16)
    assert not _within_tol(ll_b, g_b, ll_ref, g_ref)
    data = prepare_glm_data(X, y, dtype="split")
    b_pad = glm._block_c(C) * -(-C // glm._block_c(C))
    w_pad = jnp.zeros((b_pad, 64)).at[:C, :D].set(W)
    ll_k, g_k = glm._pallas_split(w_pad, data, interpret=True)
    assert _within_tol(ll_k[:C], g_k[:C, :D], ll_ref, g_ref)


@pytest.mark.parametrize(
    "dtype, platform, expect_kernel",
    [
        ("split", "cpu", False),
        ("split", "cuda", True),
        (jnp.float32, "cuda", False),
        (jnp.bfloat16, "cuda", False),
    ],
)
def test_kernel_choice_by_lowering_platform(dtype, platform, expect_kernel):
    """Only split mode lowered for CUDA takes the Triton kernel; on CPU the
    XLA op is the implementation (no interpret-mode kernel anywhere)."""
    X, W, y = _problem(5000, 55, 33)
    data = prepare_glm_data(X, y, dtype=dtype)
    f = jax.jit(
        jax.vmap(jax.value_and_grad(bernoulli_logits_loglik), in_axes=(0, None))
    )
    text = f.trace(W, data).lower(lowering_platforms=(platform,)).as_text()
    calls = [ln for ln in text.splitlines() if "__gpu$xla.gpu.triton" in ln]
    # an interpret-mode kernel would lower to plain HLO loops, not a call
    assert bool(calls) == expect_kernel
    if expect_kernel:
        # 33 chains pad to one 64-chain block, D = 55 pads to 64
        assert len(calls) == 1 and "tensor<64x64xbf16>" in calls[0]


def test_sharded_chains_run_the_kernel_per_shard():
    """Under a ``chains`` mesh (what chain_method="parallel" sets), each
    device evaluates its own chains: the CUDA lowering's kernel sees C/4
    chains, and the sharded result equals the unsharded one."""
    n = 4
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("chains",))
    X, W, y = _problem(3000, 55, 64)
    data = prepare_glm_data(X, y, dtype="split")
    f = jax.vmap(jax.value_and_grad(bernoulli_logits_loglik), in_axes=(0, None))
    ll1, g1 = jax.jit(f)(W, data)
    with jax.set_mesh(mesh):
        Ws = jax.device_put(W, NamedSharding(mesh, P("chains")))
        ll4, g4 = jax.jit(f)(Ws, data)
        text = jax.jit(f).trace(Ws, data).lower(
            lowering_platforms=("cuda",)
        ).as_text()
    assert len(ll4.sharding.device_set) == n
    np.testing.assert_allclose(ll4, ll1, rtol=LL_RTOL)
    np.testing.assert_allclose(g4, g1, rtol=G_RTOL, atol=G_ATOL)
    calls = [ln for ln in text.splitlines() if "__gpu$xla.gpu.triton" in ln]
    assert len(calls) == 1 and "tensor<16x64xbf16>" in calls[0]


def test_parallel_mcmc_evaluates_glm_per_device(monkeypatch):
    """chain_method="parallel" traces under its chain mesh, so the GLM op
    sees each device's chains only, and the run matches the vectorized one
    in distribution (here: bitwise, since per-chain keys do not depend on
    the layout)."""
    shapes = []
    xla = glm._xla_fused

    def spy(w_pad, data):
        shapes.append(w_pad.shape)
        return xla(w_pad, data)

    monkeypatch.setattr(glm, "_xla_fused", spy)
    n_dev = jax.local_device_count()
    X, _, y = _problem(2000, 4, 1)
    data = prepare_glm_data(X, y, dtype="split")

    def model(data):
        w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(4), 1.0).to_event(1))
        numpyro_tpu.factor("lik", bernoulli_logits_loglik(w, data))

    out = {}
    for method in ("parallel", "vectorized"):
        shapes.clear()
        m = MCMC(NUTS(model, max_tree_depth=4), num_warmup=30, num_samples=30,
                 num_chains=2 * n_dev, chain_method=method, progress_bar=False)
        m.run(random.PRNGKey(0), data)
        out[method] = (np.asarray(m.get_samples()["w"]), set(shapes))
        if method == "parallel":
            z = m.last_state.z["w"]
            assert len(z.sharding.device_set) == n_dev
    # two chains per device pad to one 16-chain block; unsharded, 2 * n_dev
    assert out["parallel"][1] == {(16, 16)}
    assert out["vectorized"][1] == {(glm._block_c(2 * n_dev), 16)}
    np.testing.assert_allclose(out["parallel"][0], out["vectorized"][0], rtol=1e-5)


def test_triton_route_interpret_runs():
    """A Triton-route pallas_call runs in interpret mode on the installed
    JAX (the kernel tests above rely on it)."""
    from jax.experimental import pallas as pl

    def add_one(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    x = jnp.arange(16.0)
    out = pl.pallas_call(
        add_one,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        backend="triton",
        interpret=True,
    )(x)
    np.testing.assert_array_equal(out, x + 1.0)


@pytest.mark.slow
def test_fused_model_matches_plain_posterior():
    N, D, C = 2000, 6, 4
    kx, ky = random.split(random.PRNGKey(0), 2)
    X = random.normal(kx, (N, D))
    true_w = jnp.linspace(-1, 1, D)
    y = dist.Bernoulli(logits=X @ true_w).sample(ky).astype(jnp.float32)
    data = prepare_glm_data(X, y)

    def fused_model(data):
        w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(D), 1.0).to_event(1))
        numpyro_tpu.factor("lik", bernoulli_logits_loglik(w, data))

    def plain_model(X, y):
        w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(D), 1.0).to_event(1))
        with numpyro_tpu.plate("N", X.shape[0]):
            numpyro_tpu.sample("y", dist.Bernoulli(logits=X @ w), obs=y)

    m1 = MCMC(
        NUTS(fused_model),
        num_warmup=150,
        num_samples=200,
        num_chains=C,
        chain_method="vectorized",
        progress_bar=False,
    )
    m1.run(random.PRNGKey(1), data)
    m2 = MCMC(
        NUTS(plain_model),
        num_warmup=150,
        num_samples=200,
        num_chains=C,
        chain_method="vectorized",
        progress_bar=False,
    )
    m2.run(random.PRNGKey(1), X, y)
    np.testing.assert_allclose(
        m1.get_samples()["w"].mean(0), m2.get_samples()["w"].mean(0), atol=0.05
    )
    np.testing.assert_allclose(
        m1.get_samples()["w"].std(0), m2.get_samples()["w"].std(0), atol=0.03
    )


def test_split_hi_lo_survives_jit():
    """Regression: the f32->bf16->f32 cast round-trip form of the hi/lo
    split was elided by XLA under jit, zeroing the lo half.  The
    reduce_precision form must keep lo nonzero and hi+lo == w to ~2^-17
    relative, identically eager and jitted."""
    from numpyro_tpu.ops.glm import split_hi_lo

    w = random.normal(random.PRNGKey(0), (8, 16)) * 0.5
    hi_e, lo_e = split_hi_lo(w)
    hi_j, lo_j = jax.jit(split_hi_lo)(w)
    np.testing.assert_array_equal(np.asarray(hi_e), np.asarray(hi_j))
    np.testing.assert_array_equal(np.asarray(lo_e), np.asarray(lo_j))
    assert float(jnp.abs(lo_j.astype(jnp.float32)).max()) > 0.0
    recon = hi_j.astype(jnp.float32) + lo_j.astype(jnp.float32)
    np.testing.assert_allclose(
        np.asarray(recon), np.asarray(w), rtol=2**-16, atol=1e-7
    )
