"""Benchmark: effective samples / sec / chip, NUTS on covtype-scale logistic
regression (the reference's headline workload, examples/covtype.py), then
HMCECS on the same data in the same process.

    python bench.py

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "detail": ...}

The dataset is synthetic at the covtype shape (581,012 x 55 + intercept,
Bernoulli logistic regression) — zero-egress environment, and throughput
depends on shape, not values.

What is measured:
- **1000 draws/chain** so the ESS estimate has a trustworthy
  autocorrelation window.
- **Full `max_tree_depth=10` for the sampling phase** (the reference
  default); warmup (which contributes no samples) runs at depth<=6 —
  pre-adaptation trees otherwise bottom out at 1023 leapfrogs each.
- The headline `value` is **warmup-amortized** ESS/s/chip:
  ess_median / (warmup_s + sample_s), both phases timed on a second run of
  the compiled programs.  The first run's wall time, compilation included,
  is in `detail`.
- Correctness is **asserted**, not just reported: the run fails unless the
  posterior mean recovers the generating coefficients to 0.05 (0.1 for the
  subsampled HMCECS leg).

Needs a GPU: on any other platform the run fails instead of measuring it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# Persistent compilation cache, set BEFORE jax initializes:
# JAX_COMPILATION_CACHE_DIR if set, else the repo-local .jax_cache
# (gitignored), a fixed path so later runs find the cached executables.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.diagnostics import effective_sample_size
from numpyro_tpu.infer import HMCECS, MCMC, NUTS
from numpyro_tpu.ops.glm import bernoulli_logits_loglik, prepare_glm_data

# Published dense peaks per device kind (NVIDIA H100 SXM data sheet; rates
# assume the card's full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0},
}

N, D = int(os.environ.get("BENCH_N", 581_012)), 55
# BENCH_MODE=nuts (default): full-data NUTS via the fused GLM likelihood,
# followed by the HMCECS leg (BENCH_EMBED_ECS=0 skips it).
# BENCH_MODE=ecs: the HMCECS leg alone — subsampled likelihood (subsample
# 1000, 100 blocks, Taylor proxy) at chain-massive scale.
MODE = os.environ.get("BENCH_MODE", "nuts")
NUM_CHAINS = int(os.environ.get("BENCH_CHAINS", 256))
ECS_CHAINS = int(os.environ.get("BENCH_ECS_CHAINS", 1024))
# GLM kernel precision: "split" = bf16-stored design matrix with
# f32-accurate split-precision w (see ops/glm.py module docstring) — the
# model sampled is the bf16-quantized design matrix's posterior, exactly.
# Set BENCH_GLM_DTYPE=f32 for the exact-f32 design matrix.
GLM_DTYPE = os.environ.get("BENCH_GLM_DTYPE", "split")
# Cross-chain pooled warmup adaptation (one shared step size + mass matrix
# from all chains' pooled Welford moments): with hundreds-thousands of
# chains estimating the SAME mass matrix, pooling needs far fewer warmup
# steps per chain for equal quality — BENCH_POOLED=1 enables it and
# BENCH_WARMUP should then be lowered.
POOLED = os.environ.get("BENCH_POOLED", "0") == "1"
NUM_WARMUP = int(os.environ.get("BENCH_WARMUP", 300))
NUM_SAMPLES = int(os.environ.get("BENCH_SAMPLES", 1000))
ECS_WARMUP = int(os.environ.get("BENCH_ECS_WARMUP", 100))
ECS_SAMPLES = int(os.environ.get("BENCH_ECS_SAMPLES", 100))
SUBSAMPLE = int(os.environ.get("BENCH_SUBSAMPLE", 1000))
NUM_BLOCKS = int(os.environ.get("BENCH_BLOCKS", 100))
# warmup trees run deep before adaptation settles, so the warmup phase is
# capped at depth 6 (a reference-supported option: max_tree_depth may be a
# (warmup, post-warmup) tuple); POST-WARMUP sampling runs the full default
# depth 10 — the number ESS is harvested from is uncapped.
_depth = os.environ.get("BENCH_DEPTH", "6,10")
MAX_TREE_DEPTH = (
    tuple(int(x) for x in _depth.split(",")) if "," in _depth else int(_depth)
)


def make_data(n=N, seed=0):
    # X is generated host-side and shipped once; true_w stays a HOST numpy
    # array — it feeds taylor_proxy's reference params, and host params
    # keep the proxy's construct free of device round-trips
    rng = np.random.default_rng(seed)
    X_host = rng.standard_normal((n, D - 1), dtype=np.float32)
    true_w = (0.5 * rng.standard_normal(D)).astype(np.float32)
    X = jnp.concatenate(
        [jnp.asarray(X_host), jnp.ones((n, 1))], axis=1
    )  # intercept column
    y = dist.Bernoulli(logits=X @ jnp.asarray(true_w)).sample(
        random.PRNGKey(2 + seed)
    )
    return X, y.astype(jnp.float32), true_w


def model(data):
    w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(D), 1.0).to_event(1))
    numpyro_tpu.factor("lik", bernoulli_logits_loglik(w, data))


def model_ecs(X, y):
    w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(D), 1.0).to_event(1))
    with numpyro_tpu.plate("N", X.shape[0], subsample_size=SUBSAMPLE):
        xb = numpyro_tpu.subsample(X, event_dim=1)
        yb = numpyro_tpu.subsample(y, event_dim=0)
        numpyro_tpu.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)


def _progress(msg):
    # phase timestamps on stderr (the JSON result line on stdout stays the
    # only stdout output)
    print(f"[bench +{time.time() - _T_START:.0f}s] {msg}", file=sys.stderr, flush=True)


_T_START = time.time()


def timed_runs(mcmc, args, extra_fields=()):
    """Run twice: the first run compiles, the second is the steady state.
    The fused NUTS driver times its phases apart; for other kernels the
    second run's wall time covers both phases and lands in sample_s."""
    t0 = time.time()
    mcmc.run(random.PRNGKey(1), *args, extra_fields=extra_fields)
    jax.block_until_ready(mcmc.get_samples()["w"])
    first_wall_s = time.time() - t0
    mcmc.run(random.PRNGKey(1), *args, extra_fields=extra_fields)
    samples = jax.block_until_ready(mcmc.get_samples(group_by_chain=True)["w"])
    stats = mcmc.last_run_stats
    return samples, first_wall_s, stats.get("warmup_s", 0.0), stats["sample_s"]


def summarize(samples, true_w, w_tol, warmup_s, sample_s, first_wall_s):
    ess = np.asarray(jax.device_get(effective_sample_size(samples)))
    ess_median = float(np.median(ess))
    # correctness gate: fail loudly rather than publish a bogus number
    w_err = float(jnp.abs(samples.mean((0, 1)) - true_w).max())
    assert w_err < w_tol, (
        f"posterior means off by {w_err:.4f} (>{w_tol}): bench invalid"
    )
    n_chips = jax.device_count()
    return {
        "ess_per_sec_per_chip": ess_median / (warmup_s + sample_s) / n_chips,
        "sample_phase_ess_per_sec_per_chip": ess_median / sample_s / n_chips,
        "warmup_s": warmup_s,
        "sample_s": sample_s,
        "total_wall_incl_compile_s": first_wall_s,
        "ess_median": ess_median,
        "ess_min": float(ess.min()),
        "max_coef_abs_err": w_err,
    }


def run_nuts(X, y, true_w, peaks):
    data = prepare_glm_data(
        X, y, dtype="split" if GLM_DTYPE == "split" else jnp.float32
    )
    kernel = NUTS(model, max_tree_depth=MAX_TREE_DEPTH, pooled_adaptation=POOLED)
    mcmc = MCMC(
        kernel, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
        num_chains=NUM_CHAINS, chain_method="vectorized", progress_bar=False,
    )
    samples, first_wall_s, warmup_s, sample_s = timed_runs(
        mcmc, (data,), extra_fields=("num_steps",)
    )
    out = summarize(samples, true_w, 0.05, warmup_s, sample_s, first_wall_s)

    # --- roofline accounting (sample phase, counted work only) ----------
    # Each leapfrog is ONE fused value_and_grad pass over the design
    # matrix: the forward hi/lo logits products plus the two-pass (hi/lo)
    # gradient products.  The async harvest advances EVERY chain one
    # leapfrog per iteration with ONE batched call (one X pass serves all
    # chains), so data passes ~= per-chain mean leapfrog count; chains past
    # their target run extra uncounted leapfrogs, so these are LOWER bounds.
    nsteps = np.asarray(
        jax.device_get(mcmc.get_extra_fields(group_by_chain=True)["num_steps"])
    )
    passes = float(nsteps.sum()) / NUM_CHAINS
    n_pad, d_pad = data.x.shape
    bytes_per_pass = data.x.size * data.x.dtype.itemsize
    flops_per_pass = 8.0 * NUM_CHAINS * d_pad * n_pad
    hbm_gbps = passes * bytes_per_pass / sample_s / 1e9
    tflops = passes * flops_per_pass / sample_s / 1e12
    out["roofline"] = {
        "data_passes": passes,
        "hbm_gbps": hbm_gbps,
        "hbm_roofline_frac": hbm_gbps / peaks["hbm_gbps"],
        "tensor_tflops": tflops,
        "tensor_frac_of_bf16_peak": tflops / peaks["bf16_tflops"],
        "peaks": peaks,
    }
    out["workload"] = (
        f"covtype-shape logistic regression, {NUM_CHAINS} async vectorized "
        f"chains, fused GLM likelihood ({GLM_DTYPE})"
    )
    return out


def run_ecs(X, y, true_w):
    # Taylor proxy anchored at the generating coefficients (the reference's
    # covtype recipe anchors at an SVI MAP; on synthetic data the generator
    # IS the MAP up to sampling noise).  Proxy and panel modes default to
    # "auto", resolved from the device's reported memory limit.
    proxy = HMCECS.taylor_proxy(
        {"w": true_w}, mode=os.environ.get("BENCH_ECS_PROXY_MODE", "auto")
    )
    kernel = HMCECS(
        NUTS(model_ecs, max_tree_depth=MAX_TREE_DEPTH),
        num_blocks=NUM_BLOCKS,
        proxy=proxy,
        panel_mode=os.environ.get("BENCH_ECS_PANEL_MODE", "auto"),
    )
    mcmc = MCMC(
        kernel, num_warmup=ECS_WARMUP, num_samples=ECS_SAMPLES,
        num_chains=ECS_CHAINS, chain_method="vectorized", progress_bar=False,
    )
    samples, first_wall_s, warmup_s, sample_s = timed_runs(mcmc, (X, y))
    out = summarize(samples, true_w, 0.1, warmup_s, sample_s, first_wall_s)
    out["panel_mode"] = kernel._panel_mode_resolved
    out["proxy_mode"] = kernel._proxy_mode_resolved
    out["workload"] = (
        f"HMCECS subsample={SUBSAMPLE} blocks={NUM_BLOCKS} Taylor proxy, "
        f"covtype-shape logistic regression, {ECS_CHAINS} chains, "
        f"{ECS_WARMUP}+{ECS_SAMPLES} draws"
    )
    return out


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform}")
    if dev.device_kind not in PEAKS:
        sys.exit(f"bench: no published peaks for {dev.device_kind!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _progress(f"card {card}: mode={MODE} chains={NUM_CHAINS} glm_dtype={GLM_DTYPE}")
    X, y, true_w = make_data()
    jax.block_until_ready(X)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count(), "card": card}
    detail = {"device": device, "data_shape": [N, D],
              "max_tree_depth": str(MAX_TREE_DEPTH)}
    if MODE == "ecs":
        head = run_ecs(X, y, true_w)
    else:
        head = run_nuts(X, y, true_w, PEAKS[dev.device_kind])
        detail.update(num_chains=NUM_CHAINS, num_warmup=NUM_WARMUP,
                      num_samples_per_chain=NUM_SAMPLES, glm_dtype=GLM_DTYPE,
                      pooled_adaptation=POOLED)
        if os.environ.get("BENCH_EMBED_ECS", "1") != "0":
            _progress("NUTS leg done; starting the HMCECS leg")
            detail["ecs"] = run_ecs(X, y, true_w)
    value = head.pop("ess_per_sec_per_chip")
    result = {
        "metric": "warmup-amortized effective samples/sec/chip "
        f"(NUTS depth {MAX_TREE_DEPTH}, {head.pop('workload')})",
        "value": value,
        "unit": "ESS/s/chip",
        "detail": {**detail, **head},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
