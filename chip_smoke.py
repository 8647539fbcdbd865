"""Smoke test of the sampler's main path on one NVIDIA GPU.

    python chip_smoke.py              # one card: phases 1-5
    python chip_smoke.py --chips 4    # four cards: the multi-card phase only

Phases (any failure exits non-zero and prints no result):

1. device: JAX must find a GPU (no CPU fallback); prints the JAX version,
   device kind and count, and the card's name and power limit.
2. kernel check: the split-mode GLM likelihood at cell A's shape (581,012 x
   55 with intercept, 256 chains) must run as the compiled Triton kernel and
   agree with the float32 reference on the bf16-quantized design matrix;
   TF32 and all-bf16-``w`` evaluations of the same quantity must fail the
   same tolerances.
3. cell A: ``MCMC(NUTS(model, max_tree_depth=(6, 10)), num_chains=256,
   chain_method="vectorized")`` on bench.py's data, with compile time,
   ``memory_analysis()`` of the fused programs and the posterior-mean gate.
4. HMCECS: bench.py's subsampled configuration at 1024 chains, with the
   memory modes that ``"auto"`` resolved to and the recovery gate.
5. the last line of stdout is the JSON result.

``--chips 4`` runs cell A with ``chain_method="parallel"`` over four cards,
compares it with a one-card run in the same process, checks that each card
holds 64 chains and runs the GLM kernel on 64 chains, and runs
``__graft_entry__.dryrun_multichip(4)``.

Every line before the last is labelled with the card's name and power
limit.  The compile cache follows bench.py's rule: ``JAX_COMPILATION_CACHE_DIR``
if set, else ``<repo>/.jax_cache``.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache"))

import jax  # noqa: E402

# Tolerances of the real-width kernel check.  The loglik keeps the CPU
# test's rtol.  The gradient's cannot keep the CPU test's elementwise
# rtol/atol of 1e-3: the split kernel evaluates the exact gradient at
# w_hi + w_lo, which differs from w by up to 2^-17 relative, and at
# covtype scale the Hessian (~N/4 = 1.5e5) turns that into ~0.5 absolute
# error on every coordinate, including those whose gradient is near 0.
# So the gradient's max abs error is held to 1e-4 of the largest
# gradient coordinate: TF32 (2^-11 relative operands) misses it by ~6x.
LL_RTOL = 1e-5
G_REL_TO_MAX = 1e-4
CELL_A_CHAINS = 256
CELL_A_DRAWS = 200
ECS_CHAINS = 1024
ECS_DRAWS = 100


def card_label():
    """``name, power.limit`` from nvidia-smi, read in a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


LABEL = "?"


def log(msg):
    print(f"[{LABEL}] {msg}", flush=True)


class CompileTimer:
    """Sums JAX's own lowering and backend-compile durations (top-level
    programs only; tracing, which nests, is left out)."""

    EVENTS = (
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def glm_check(n, chains, seed=0):
    """Phase 2: the split-mode kernel against the plain reference."""
    import jax.numpy as jnp
    from jax import lax, random

    import bench
    from numpyro_tpu.ops.glm import bernoulli_logits_loglik, prepare_glm_data

    X, y, true_w = bench.make_data(n, seed)
    data = prepare_glm_data(X, y, dtype="split")
    # chains from near the mode (where the potential's curvature matters) to
    # far out in the tail, as warmup visits them
    scale = jnp.logspace(-3, -0.5, chains)[:, None]
    w = jnp.asarray(true_w) + scale * random.normal(
        random.PRNGKey(seed + 7), (chains, X.shape[1])
    )
    f = jax.jit(
        jax.vmap(jax.value_and_grad(bernoulli_logits_loglik), in_axes=(0, None))
    )
    hlo = f.lower(w, data).compile().as_text()
    kernel_calls = triton_calls(hlo)
    ll, g = jax.block_until_ready(f(w, data))

    Xq = X.astype(jnp.bfloat16).astype(jnp.float32)

    def loglik(w, precision, w_dtype=jnp.float32):
        logits = jnp.dot(
            Xq.astype(w_dtype), w.astype(w_dtype), precision=precision,
            preferred_element_type=jnp.float32,
        )
        return -jnp.sum(jax.nn.softplus(logits) - y * logits)

    def errors(ll_x, g_x):
        ll_rel = float(jnp.max(jnp.abs(ll_x - ll_ref) / jnp.abs(ll_ref)))
        g_abs = float(jnp.max(jnp.abs(g_x - g_ref)))
        ok = ll_rel <= LL_RTOL and g_abs <= g_tol
        return {"ll_max_rel_err": ll_rel, "grad_max_abs_err": g_abs,
                "within_tol": ok}

    ref = jax.jit(jax.vmap(jax.value_and_grad(loglik), in_axes=(0, None)),
                  static_argnums=1)
    ll_ref, g_ref = ref(w, lax.Precision.HIGHEST)
    g_tol = G_REL_TO_MAX * float(jnp.max(jnp.abs(g_ref)))
    tf32 = ref(w, lax.DotAlgorithmPreset.TF32_TF32_F32)
    bf16 = jax.jit(jax.vmap(jax.value_and_grad(
        lambda w: loglik(w, lax.Precision.DEFAULT, jnp.bfloat16))))(w)
    return {
        "kernel": errors(ll, g),
        "tf32": errors(*tf32),
        "bf16_w": errors(*bf16),
        "kernel_calls": kernel_calls,
        "grad_tol": g_tol,
    }


def triton_calls(text):
    """The Triton custom calls of an HLO or StableHLO module's text."""
    return [
        line.strip() for line in text.splitlines()
        if "__gpu$xla.gpu.triton" in line
        and ("custom-call(" in line or "custom_call" in line)
    ]


def lowered_text(prog, args):
    """StableHLO of a jitted program, where shard_map bodies show the
    per-device operand shapes."""
    return prog.trace(*args).lower().as_text()


def glm_block_rows(chains):
    """Rows of the kernel's w operand for ``chains`` chains (padding)."""
    from numpyro_tpu.ops.glm import _block_c

    return _block_c(chains) * -(-chains // _block_c(chains))


def run_cell_a(data, chains, draws, chain_method="vectorized", seed=1):
    from jax import random

    import bench
    from numpyro_tpu.infer import MCMC, NUTS

    mcmc = MCMC(
        NUTS(bench.model, max_tree_depth=(6, 10)),
        num_warmup=draws, num_samples=draws, num_chains=chains,
        chain_method=chain_method, progress_bar=False,
    )
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(seed), data)
    samples = jax.block_until_ready(mcmc.get_samples(group_by_chain=True)["w"])
    return mcmc, samples, time.perf_counter() - t0


def memory_report(sampler):
    out = {}
    for name, (prog, args) in sampler.last_fused_programs.items():
        ma = prog.lower(*args).compile().memory_analysis()
        out[name] = {
            k: getattr(ma, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes",
                "generated_code_size_in_bytes",
            )
        }
    return out


def phase_cell_a(timer):
    import jax.numpy as jnp

    import bench
    from numpyro_tpu.ops.glm import prepare_glm_data

    X, y, true_w = bench.make_data()
    data = prepare_glm_data(X, y, dtype="split")
    c0 = timer.seconds
    mcmc, samples, wall = run_cell_a(data, CELL_A_CHAINS, CELL_A_DRAWS)
    err = float(jnp.abs(samples.mean((0, 1)) - true_w).max())
    st = mcmc.last_run_stats
    log(f"cell A: {X.shape[0]} x {X.shape[1]}, {CELL_A_CHAINS} chains, "
        f"{CELL_A_DRAWS}+{CELL_A_DRAWS} draws: wall {wall:.3f} s, of which "
        f"lower+compile {timer.seconds - c0:.3f} s; warmup phase "
        f"{st['warmup_s']:.3f} s, sample phase {st['sample_s']:.3f} s")
    for name, ma in memory_report(mcmc.sampler).items():
        log(f"cell A memory_analysis {name}: {json.dumps(ma)}")
    log(f"cell A posterior-mean max abs error {err:.5f} (gate < 0.05)")
    if not err < 0.05:
        raise AssertionError(f"cell A recovery error {err} >= 0.05")


def phase_ecs(timer):
    import jax.numpy as jnp
    from jax import random

    import bench
    from numpyro_tpu.contrib.ecs_proxies import _device_hbm_bytes
    from numpyro_tpu.infer import HMCECS, MCMC, NUTS

    X, y, true_w = bench.make_data()
    limit = jax.devices()[0].memory_stats()["bytes_limit"]
    budget = _device_hbm_bytes()
    if budget != float(limit):
        raise AssertionError(f"auto budget {budget} != memory_stats {limit}")
    kernel = HMCECS(
        NUTS(bench.model_ecs, max_tree_depth=(6, 10)),
        num_blocks=bench.NUM_BLOCKS,
        proxy=HMCECS.taylor_proxy({"w": true_w}, mode="auto"),
        panel_mode="auto",
    )
    mcmc = MCMC(kernel, num_warmup=ECS_DRAWS, num_samples=ECS_DRAWS,
                num_chains=ECS_CHAINS, chain_method="vectorized",
                progress_bar=False)
    c0, t0 = timer.seconds, time.perf_counter()
    mcmc.run(random.PRNGKey(1), X, y)
    samples = jax.block_until_ready(mcmc.get_samples(group_by_chain=True)["w"])
    wall = time.perf_counter() - t0
    err = float(jnp.abs(samples.mean((0, 1)) - true_w).max())
    log(f"HMCECS: subsample {bench.SUBSAMPLE}, {bench.NUM_BLOCKS} blocks, "
        f"Taylor proxy, {ECS_CHAINS} chains, {ECS_DRAWS}+{ECS_DRAWS} draws: "
        f"wall {wall:.3f} s, of which lower+compile {timer.seconds - c0:.3f} s")
    log(f"HMCECS auto modes from memory_stats bytes_limit {limit}: "
        f"panel_mode={kernel._panel_mode_resolved} "
        f"proxy mode={kernel._proxy_mode_resolved}")
    log(f"HMCECS posterior-mean max abs error {err:.5f} (gate < 0.1)")
    if not err < 0.1:
        raise AssertionError(f"HMCECS recovery error {err} >= 0.1")


def phase_multi(n_cards, timer):
    """Cell A sharded over ``n_cards`` against one card, in one process."""
    import numpy as np
    import jax.numpy as jnp

    import __graft_entry__
    import bench
    from numpyro_tpu.diagnostics import effective_sample_size
    from numpyro_tpu.ops.glm import bernoulli_logits_loglik, prepare_glm_data

    X, y, true_w = bench.make_data()
    data = prepare_glm_data(X, y, dtype="split")
    runs = {}
    for method in ("parallel", "vectorized"):
        c0 = timer.seconds
        mcmc, samples, wall = run_cell_a(
            data, CELL_A_CHAINS, CELL_A_DRAWS, chain_method=method
        )
        s = np.asarray(samples, dtype=np.float64)
        ess = np.asarray(effective_sample_size(s))
        runs[method] = (mcmc, s.mean((0, 1)), s.std((0, 1)), ess)
        log(f"cell A {method}: wall {wall:.3f} s, of which "
            f"lower+compile {timer.seconds - c0:.3f} s; min ESS {ess.min():.1f}")

    mcmc, mean_p, sd_p, ess_p = runs["parallel"]
    _, mean_v, sd_v, ess_v = runs["vectorized"]
    # Monte-Carlo standard errors of the two estimates of each mean and sd
    se_mean = np.sqrt(sd_p**2 / ess_p + sd_v**2 / ess_v)
    se_sd = np.sqrt(sd_p**2 / (2 * ess_p) + sd_v**2 / (2 * ess_v))
    z_mean = float(np.max(np.abs(mean_p - mean_v) / se_mean))
    z_sd = float(np.max(np.abs(sd_p - sd_v) / se_sd))
    log(f"parallel vs one card: max |d mean| / MCSE = {z_mean:.3f}, "
        f"max |d sd| / MCSE = {z_sd:.3f} (limit 5 each, over {X.shape[1]} "
        "coefficients)")
    if not (z_mean < 5 and z_sd < 5):
        raise AssertionError("parallel posterior disagrees with one card")

    per_card = CELL_A_CHAINS // n_cards
    z_state = mcmc.last_state.z["w"]
    shards = sorted(
        (sh.device.id, sh.data.shape[0]) for sh in z_state.addressable_shards
    )
    log(f"chain state shards (device, chains): {shards}")
    if len({d for d, _ in shards}) != n_cards or any(
        c != per_card for _, c in shards
    ):
        raise AssertionError(f"chain state is not {per_card} per card")

    prog, args = mcmc.sampler.last_fused_programs["sample"]
    with mcmc._mesh_context():
        calls = triton_calls(lowered_text(prog, args))
    want = f"tensor<{glm_block_rows(per_card)}x{data.x.shape[1]}xbf16>"
    log(f"sample program: {len(calls)} GLM kernel call(s), w operand "
        f"{want}: {all(want in c for c in calls)}")
    if not calls or not all(want in c for c in calls):
        raise AssertionError(f"GLM kernel does not run on {per_card} chains")

    # the loglik alone, sharded the same way, agrees with one card
    mesh = mcmc._chain_mesh
    w = jnp.asarray(true_w) + 0.01 * jnp.ones((CELL_A_CHAINS, X.shape[1]))
    f = jax.vmap(jax.value_and_grad(bernoulli_logits_loglik), in_axes=(0, None))
    ll1, g1 = jax.jit(f)(w, data)
    with jax.set_mesh(mesh):
        w_sh = jax.device_put(
            w, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("chains"))
        )
        ll4, g4 = jax.jit(f)(w_sh, data)
    d_ll = float(jnp.max(jnp.abs(ll4 - ll1) / jnp.abs(ll1)))
    log(f"sharded loglik vs one card: max rel diff {d_ll:.3e}")
    if not d_ll <= LL_RTOL:
        raise AssertionError("sharded loglik disagrees with one card")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        __graft_entry__.dryrun_multichip(n_cards)
    log(out.getvalue().strip())
    log(f"dryrun_multichip({n_cards}) passed")


def main():
    global LABEL
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = p.parse_args()

    # --- phase 1: device -------------------------------------------------
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {devices[0].platform})")
    if len(devices) < args.chips:
        sys.exit(f"chip_smoke: --chips {args.chips} but {len(devices)} GPU(s)")
    LABEL = card_label()
    dev = devices[0]
    log(f"jax {jax.__version__}; device_kind {dev.device_kind}; "
        f"device count {len(devices)}; nvidia-smi name,power.limit: {LABEL}")
    timer = CompileTimer()

    if args.chips == 1:
        # --- phase 2: kernel check at real width -------------------------
        r = glm_check(581_012, CELL_A_CHAINS)
        log(f"GLM split kernel: {len(r['kernel_calls'])} Triton call(s) in "
            "the compiled program")
        for name in ("kernel", "tf32", "bf16_w"):
            e = r[name]
            log(f"GLM {name}: loglik max rel err {e['ll_max_rel_err']:.3e} "
                f"(tol {LL_RTOL}); grad max abs err "
                f"{e['grad_max_abs_err']:.3e} (tol {r['grad_tol']:.3e} = "
                f"{G_REL_TO_MAX} x max |grad|): "
                f"{'within' if e['within_tol'] else 'outside'} tolerance")
        if not r["kernel_calls"]:
            raise AssertionError("split mode did not run the Triton kernel")
        if not r["kernel"]["within_tol"]:
            raise AssertionError("GLM kernel outside tolerance")
        if r["tf32"]["within_tol"] or r["bf16_w"]["within_tol"]:
            raise AssertionError("the check cannot tell TF32/bf16-w apart")
        # --- phases 3 and 4 ------------------------------------------------
        phase_cell_a(timer)
        phase_ecs(timer)
    else:
        phase_multi(args.chips, timer)

    # --- phase 5: result ----------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main()
