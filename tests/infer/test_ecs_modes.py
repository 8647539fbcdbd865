"""Memory-mode matrix for HMCECS: panel modes (carry / bf16 / lean) and
taylor_proxy stats modes (stats / recompute) must all sample the same
posterior.  The lean+recompute combination carries no per-chain data or
statistics panels at all; carry+stats is what "auto" resolves to at small
scale.  Reference memory profile being reproduced by
"lean": numpyro/infer/hmc_gibbs.py:690-769 (re-gather per evaluation).
"""

import numpy as np
import pytest

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.contrib.ecs_proxies import taylor_proxy
from numpyro_tpu.infer import HMCECS, MCMC, NUTS

N, D = 3000, 4
SUBSAMPLE, BLOCKS = 200, 10


def _data():
    key = random.PRNGKey(0)
    kx, kw, ky = random.split(key, 3)
    x = random.normal(kx, (N, D))
    true_w = jnp.array([0.7, -0.4, 0.2, 0.9])
    y = dist.Bernoulli(logits=x @ true_w).sample(ky).astype(jnp.float32)
    return x, y, true_w


def _model(x, y):
    w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(D), 1.0).to_event(1))
    with numpyro_tpu.plate("N", x.shape[0], subsample_size=SUBSAMPLE):
        xb = numpyro_tpu.subsample(x, event_dim=1)
        yb = numpyro_tpu.subsample(y, event_dim=0)
        numpyro_tpu.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)


def _run(panel_mode, proxy_mode, num_chains=4, seed=1):
    x, y, true_w = _data()
    proxy = taylor_proxy({"w": true_w}, mode=proxy_mode)
    kernel = HMCECS(
        NUTS(_model, max_tree_depth=6),
        num_blocks=BLOCKS,
        proxy=proxy,
        panel_mode=panel_mode,
    )
    m = MCMC(
        kernel,
        num_warmup=200,
        num_samples=300,
        num_chains=num_chains,
        chain_method="vectorized",
        progress_bar=False,
    )
    m.run(random.PRNGKey(seed), x, y)
    return np.asarray(m.get_samples()["w"]), np.asarray(true_w), kernel


@pytest.mark.parametrize(
    "panel_mode,proxy_mode",
    [
        ("carry", "stats"),
        ("bf16", "stats"),
        ("lean", "stats"),
        ("carry", "recompute"),
        ("lean", "recompute"),
    ],
)
def test_mode_recovers_posterior(panel_mode, proxy_mode):
    samples, true_w, _ = _run(panel_mode, proxy_mode)
    err = np.abs(samples.mean(0) - true_w).max()
    assert err < 0.25, (panel_mode, proxy_mode, err)


def test_recompute_and_stats_estimators_agree_pointwise():
    """The recompute-mode proxy must produce the SAME (total_all, total_sub)
    as stats mode at matched indices/params — it is an algebraic
    reformulation, not an approximation."""
    x, y, true_w = _data()
    tr_args = (x, y)
    import numpyro_tpu.handlers as handlers
    from numpyro_tpu.infer.initialization import init_to_sample

    proto = handlers.trace(
        handlers.substitute(
            handlers.seed(_model, random.PRNGKey(0)),
            substitute_fn=init_to_sample(),
        )
    ).get_trace(*tr_args)
    plate_sizes = {"N": (N, SUBSAMPLE)}
    builds = {}
    for mode in ("stats", "recompute"):
        builds[mode] = taylor_proxy({"w": true_w}, mode=mode)(
            proto, plate_sizes, _model, tr_args, {}, num_blocks=BLOCKS
        )
    idx = {"N": jnp.arange(SUBSAMPLE) * 7 % N}
    params = {"w": true_w + 0.03}

    fn_s, init_s, _ = builds["stats"]
    fn_r, init_r, _ = builds["recompute"]
    stats = init_s(idx)
    all_s, sub_s = fn_s(params, ("N",), stats, idx_dict=idx)
    all_r, sub_r = fn_r(params, ("N",), init_r(idx), idx_dict=idx)
    np.testing.assert_allclose(
        np.asarray(all_s["N"]), np.asarray(all_r["N"]), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sub_s["N"]), np.asarray(sub_r["N"]), rtol=1e-4, atol=1e-4
    )


def test_auto_resolves_carry_at_small_scale():
    _, _, kernel = _run("auto", "auto", num_chains=2)
    assert kernel._panel_mode_resolved == "carry"
    assert kernel._proxy_mode_resolved == "stats"


class _FakeAccelerator:
    platform = "gpu"
    device_kind = "Fake accelerator"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "stats, expect",
    [(None, None), ({}, None), ({"bytes_limit": 8e10}, 8e10)],
)
def test_device_budget_from_memory_stats(monkeypatch, stats, expect):
    """An accelerator's budget is its reported memory limit; one that
    reports none raises an error naming the explicit mode arguments
    instead of assuming a size."""
    import jax

    from numpyro_tpu.contrib import ecs_proxies

    monkeypatch.setattr(jax, "devices", lambda: [_FakeAccelerator(stats)])
    if expect is None:
        with pytest.raises(RuntimeError, match="mode=.*panel_mode="):
            ecs_proxies._device_hbm_bytes()
    else:
        assert ecs_proxies._device_hbm_bytes() == expect
