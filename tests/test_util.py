"""JAX utility shims (pattern: reference test/test_util.py)."""

import numpy as np

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu import handlers
from numpyro_tpu.util import fori_collect, format_shapes, soft_vmap


def test_fori_collect_thinning_and_lower():
    def body(x):
        return x + 1

    out = fori_collect(2, 10, body, jnp.asarray(0), progbar=False)
    np.testing.assert_array_equal(np.asarray(out), np.arange(3, 11))

    out = fori_collect(2, 10, body, jnp.asarray(0), thinning=2, progbar=False)
    np.testing.assert_array_equal(np.asarray(out), [4, 6, 8, 10])

    out, last = fori_collect(
        0, 5, body, jnp.asarray(0), return_last_val=True, progbar=False
    )
    assert int(last) == 5 and np.asarray(out).shape == (5,)


def test_soft_vmap_chunked_matches_vmap():
    xs = {"a": jnp.arange(10.0).reshape(10, 1), "b": jnp.arange(10.0)}

    def fn(x):
        return x["a"].sum() * x["b"]

    full = soft_vmap(fn, xs)
    chunked = soft_vmap(fn, xs, chunk_size=3)
    np.testing.assert_allclose(np.asarray(full), np.asarray(chunked))
    assert np.asarray(chunked).shape == (10,)


def test_soft_vmap_multi_batch_dims():
    xs = jnp.arange(12.0).reshape(3, 4)
    ys = soft_vmap(lambda x: x * 2, xs, batch_ndims=2)
    np.testing.assert_allclose(np.asarray(ys), np.asarray(xs) * 2)


def test_format_shapes():
    def model(x):
        w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(3), 1.0).to_event(1))
        with numpyro_tpu.plate("N", x.shape[0]):
            numpyro_tpu.sample("obs", dist.Normal(x @ w, 1.0), obs=jnp.zeros(5))

    x = jnp.ones((5, 3))
    tr = handlers.trace(handlers.seed(model, random.PRNGKey(0))).get_trace(x)
    out = format_shapes(tr)
    assert "Trace Shapes:" in out and "w dist" in out and "obs dist" in out
    out_lp = format_shapes(tr, compute_log_prob=True)
    assert "log_prob" in out_lp


def test_mcmc_phase_timers_and_profiler_trace(tmp_path):
    """SURVEY §5 aux subsystems: per-phase wall timers + jax.profiler hook."""
    import os

    from numpyro_tpu.infer import MCMC, NUTS
    from numpyro_tpu.util import profiler_trace

    def model(x):
        mu = numpyro_tpu.sample("mu", dist.Normal(0.0, 5.0))
        with numpyro_tpu.plate("N", x.shape[0]):
            numpyro_tpu.sample("x", dist.Normal(mu, 1.0), obs=x)

    x = jnp.ones(20)
    m = MCMC(NUTS(model), num_warmup=20, num_samples=20, progress_bar=False)
    m.warmup(random.PRNGKey(0), x)
    m.run(random.PRNGKey(1), x)
    assert m.last_run_stats["warmup_s"] > 0
    assert m.last_run_stats["sample_s"] > 0

    with profiler_trace(str(tmp_path)):
        m.run(random.PRNGKey(2), x)
    assert len(os.listdir(str(tmp_path))) > 0

