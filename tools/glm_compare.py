"""Compare the split-mode GLM likelihood implementations on one GPU.

    python tools/glm_compare.py [--sweep] [--e2e] [--e2e-draws N]

Implementations, all at cell A's shape (581,012 x 55 with intercept,
bf16-stored X, 256 chains):

- ``kernel``: the Pallas kernel (Triton route) that ``dtype="split"`` runs
  on CUDA devices;
- ``xla_fused``: the plain XLA op (``ops.glm._xla_fused``), under the
  MCMC driver's default ``matmul_precision="highest"``;
- ``xla_split``: the kernel's split arithmetic written in ``lax`` with
  bf16 operands and ``preferred_element_type=float32``, which XLA hands to
  cuBLAS.

Per-call times are host-clock means over back-to-back calls ending in
``block_until_ready``.  ``--sweep`` also times kernel tilings.  ``--e2e``
runs a short NUTS cell-A run with each implementation (second run of each,
so compilation is excluded) and reports wall time per phase and leapfrogs.
Every result line carries the card's name and power limit.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (sets the compile-cache rule before jax starts)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax, random  # noqa: E402

from numpyro_tpu.infer import MCMC, NUTS  # noqa: E402
from numpyro_tpu.ops import glm  # noqa: E402


def xla_split(w_pad, data):
    """The split arithmetic in lax: bf16 operands, float32 accumulation."""
    dot = functools.partial(
        lax.dot_general,
        precision=lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    fwd = (((1,), (1,)), ((), ()))
    bwd = (((1,), (0,)), ((), ()))
    w_hi, w_lo = glm.split_hi_lo(w_pad)
    logits = dot(w_hi, data.x, fwd) + dot(w_lo, data.x, fwd)
    y = data.y
    nll = jnp.sum(jax.nn.softplus(logits) - y * logits, axis=-1)
    nll = nll - (data.x.shape[0] - data.n) * jnp.log(2.0)
    r_hi, r_lo = glm.split_hi_lo(jax.nn.sigmoid(logits) - y)
    grad = dot(r_hi, data.x, bwd) + dot(r_lo, data.x, bwd)
    return -nll, -grad


IMPLS = {
    "kernel": glm._pallas_split,
    "xla_fused": glm._xla_fused,
    "xla_split": xla_split,
}


def per_call_seconds(fn, *args, reps=50):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--e2e", action="store_true")
    p.add_argument("--e2e-draws", type=int, default=200)
    p.add_argument("--chains", type=int, default=256)
    args = p.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; jax {jax.__version__}; {dev.device_kind}", flush=True)

    def emit(**rec):
        print(json.dumps({"card": card, **rec}), flush=True)

    X, y, true_w = bench.make_data()
    data = glm.prepare_glm_data(X, y, dtype="split")
    C = args.chains
    w = jnp.asarray(true_w) + 0.05 * random.normal(random.PRNGKey(3), (C, bench.D))
    w_pad = jnp.zeros((C, data.x.shape[1])).at[:, : bench.D].set(w)

    with jax.default_matmul_precision("highest"):
        for name, impl in IMPLS.items():
            f = jax.jit(impl)
            emit(impl=name, per_call_ms=1e3 * per_call_seconds(f, w_pad, data))

    if args.sweep:
        base = {k: getattr(glm, k) for k in (
            "_BLOCK_N", "_MAX_BLOCK_C", "_NUM_WARPS", "_NUM_STAGES",
            "_TARGET_PROGRAMS")}
        configs = [
            {}, {"_BLOCK_N": 64}, {"_BLOCK_N": 256, "_NUM_WARPS": 8},
            {"_NUM_WARPS": 8}, {"_MAX_BLOCK_C": 128, "_NUM_WARPS": 8},
            {"_MAX_BLOCK_C": 32}, {"_NUM_STAGES": 2}, {"_NUM_STAGES": 4},
            {"_TARGET_PROGRAMS": 264}, {"_TARGET_PROGRAMS": 1056},
        ]
        for cfg in configs:
            for k, v in {**base, **cfg}.items():
                setattr(glm, k, v)
            try:
                f = jax.jit(glm._pallas_split)
                ms = 1e3 * per_call_seconds(f, w_pad, data)
                emit(sweep=cfg, per_call_ms=ms)
            except Exception as e:  # a tiling the compiler refuses
                emit(sweep=cfg, error=str(e)[:300])
        for k, v in base.items():
            setattr(glm, k, v)

    if args.e2e:
        kernel = glm._pallas_split
        for name in ("kernel", "xla_fused", "xla_split", "kernel"):
            glm._pallas_split = IMPLS[name] if name != "kernel" else kernel
            mcmc = MCMC(
                NUTS(bench.model, max_tree_depth=(6, 10)),
                num_warmup=args.e2e_draws, num_samples=args.e2e_draws,
                num_chains=C, chain_method="vectorized", progress_bar=False,
            )
            t0 = time.perf_counter()
            mcmc.run(random.PRNGKey(1), data, extra_fields=("num_steps",))
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            mcmc.run(random.PRNGKey(1), data, extra_fields=("num_steps",))
            s = mcmc.get_samples()["w"]
            jax.block_until_ready(s)
            wall = time.perf_counter() - t0
            st = mcmc.last_run_stats
            steps = int(mcmc.get_extra_fields()["num_steps"].sum())
            emit(
                impl=name, e2e_wall_s=wall, first_run_s=first,
                warmup_s=st.get("warmup_s"), sample_s=st.get("sample_s"),
                sample_leapfrogs=steps,
                max_abs_err=float(jnp.abs(s.mean(0) - true_w).max()),
            )
        glm._pallas_split = kernel


if __name__ == "__main__":
    main()
