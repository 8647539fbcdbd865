"""HMC / NUTS kernels on the chain-batched engine.

Unlike the reference (numpyro/infer/hmc.py:540-948, which defines a
single-chain kernel and vmaps it over chains), these kernels are *natively
chain-batched*: ``init``/``sample`` operate on ``(C, …)`` state panels and a
transition for all chains is one masked ``lax.while_loop`` in
:mod:`numpyro_tpu.infer.hmc_core`.  A single chain is just ``C == 1`` with
the batch axis squeezed at the API boundary.

``HMC.fused_run`` additionally exposes the whole warmup+sampling run as ONE
compiled program with asynchronous cross-chain transition overlap — the
MCMC driver uses it for the default vectorized path.
"""

from __future__ import annotations

import math
from collections import namedtuple

import jax
import jax.numpy as jnp
from jax import random
from jax.flatten_util import ravel_pytree

from numpyro_tpu.infer import hmc_core as core
from numpyro_tpu.infer.mcmc import MCMCKernel
from numpyro_tpu.infer.util import ParamInfo, initialize_model
from numpyro_tpu.util import identity, is_prng_key, merge_dynamic, split_dynamic

__all__ = ["HMC", "NUTS", "HMCState", "hmc", "momentum_generator"]

HMCState = namedtuple(
    "HMCState",
    [
        "i",
        "z",
        "z_grad",
        "potential_energy",
        "energy",
        "r",
        "trajectory_length",
        "num_steps",
        "accept_prob",
        "mean_accept_prob",
        "diverging",
        "adapt_state",
        "rng_key",
    ],
)
"""Public kernel state (field parity: numpyro/infer/hmc.py:31-48).  In
batched mode every array leaf carries a leading chain axis; ``i`` is a
scalar (chains are transition-synchronous under the per-step API)."""


def momentum_generator(prototype_r, mass_matrix_sqrt, rng_key):
    """Draw r ~ N(0, M) in pytree form (compat helper for external kernels;
    the engine itself samples momenta in flat panels)."""
    if isinstance(mass_matrix_sqrt, dict):
        out = {}
        for names, block_sqrt in zip(
            mass_matrix_sqrt, random.split(rng_key, len(mass_matrix_sqrt))
        ):
            out.update(
                momentum_generator(
                    {k: prototype_r[k] for k in names},
                    mass_matrix_sqrt[names],
                    block_sqrt,
                )
            )
        return out
    flat, unravel = ravel_pytree(prototype_r)
    eps = random.normal(rng_key, jnp.shape(flat))
    if jnp.ndim(mass_matrix_sqrt) == 1:
        return unravel(mass_matrix_sqrt * eps)
    if jnp.ndim(mass_matrix_sqrt) == 2:
        return unravel(mass_matrix_sqrt @ eps)
    raise ValueError("mass_matrix_sqrt must be 1- or 2-dimensional")


def _expand0(tree):
    return jax.tree.map(lambda x: jnp.asarray(x)[None], tree)


def _squeeze0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def hmc(potential_fn=None, potential_fn_gen=None, kinetic_fn=None, algo="NUTS"):
    """Functional (init_kernel, sample_kernel) factory (surface parity:
    numpyro/infer/hmc.py:113-538; internals are the chain-batched engine).

    Only the Euclidean kinetic energy is supported natively; a custom
    ``kinetic_fn`` raises (the flat-panel engine owns the mass-matrix ops).
    """
    if kinetic_fn is not None:
        raise NotImplementedError(
            "custom kinetic_fn is not supported by the chain-batched engine;"
            " the Euclidean kinetic energy is built in"
        )
    if algo not in ("HMC", "NUTS"):
        raise ValueError("`algo` must be one of `HMC`, `NUTS`.")
    if (potential_fn is None) == (potential_fn_gen is None):
        raise ValueError(
            "Exactly one of `potential_fn` or `potential_fn_gen` must be given."
        )

    # static context shared between init and sample, filled by init_kernel
    ctx = {}

    def _pe_grad(model_args, model_kwargs):
        """Batched potential+grad; ``model_kwargs['_per_chain']`` is a pytree
        of chain-batched auxiliary conditioning (e.g. Gibbs site values or
        subsample index panels) vmapped alongside the position panel — this
        is how the Gibbs-composed kernels get *per-chain* conditioning
        through one fused program."""
        model_kwargs = dict(model_kwargs or {})
        per_chain = model_kwargs.pop("_per_chain", None)
        layout, forward_mode = ctx["layout"], ctx["forward_mode"]
        if per_chain is None:
            pe_fn = potential_fn
            if potential_fn_gen is not None:
                pe_fn = potential_fn_gen(*model_args, **model_kwargs)
            return core.batched_potential(pe_fn, layout, forward_mode)

        def one(flat, pc):
            pe_fn = potential_fn_gen(*model_args, **model_kwargs, **pc)

            def pe_flat(f):
                return pe_fn(layout.unravel_one(f))

            if forward_mode:
                return pe_flat(flat), jax.jacfwd(pe_flat)(flat)
            return jax.value_and_grad(pe_flat)(flat)

        def pe_grad(panel):
            if layout.dim == 0:
                c = panel.shape[0]
                return jnp.zeros((c,), panel.dtype), panel
            return jax.vmap(one)(panel, per_chain)

        return pe_grad

    def init_kernel(
        init_params,
        num_warmup,
        *,
        step_size=1.0,
        inverse_mass_matrix=None,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        num_steps=None,
        trajectory_length=2 * math.pi,
        max_tree_depth=10,
        find_heuristic_step_size=False,
        forward_mode_differentiation=False,
        regularize_mass_matrix=True,
        refine_step_size=True,
        pooled_adaptation=False,
        model_args=(),
        model_kwargs=None,
        rng_key=None,
    ):
        if isinstance(init_params, ParamInfo):
            z, pe, z_grad = init_params
        else:
            z, pe, z_grad = init_params, None, None
        rng_key = random.PRNGKey(0) if rng_key is None else rng_key
        batched = not is_prng_key(rng_key)
        keys = rng_key if batched else rng_key[None]
        num_chains = keys.shape[0]

        if batched:
            z_proto = _squeeze0(z)
        else:
            z_proto = z
            z = _expand0(z)
            pe = None if pe is None else jnp.asarray(pe)[None]
            z_grad = None if z_grad is None else _expand0(z_grad)
        # unbatched init_params with batched keys: broadcast over chains
        leaves = jax.tree.leaves(z)
        if batched and leaves and any(
            jnp.shape(x)[:1] != (num_chains,) for x in leaves
        ):
            z_proto = z
            z = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (num_chains,) + jnp.shape(x)), z
            )
            pe, z_grad = None, None

        layout = core.FlatLayout(z_proto)
        ctx.update(
            layout=layout,
            blocks=core.build_mass_blocks(layout, dense_mass),
            forward_mode=forward_mode_differentiation,
            batched=batched,
            num_warmup=num_warmup,
            max_tree_depth=(
                max_tree_depth
                if isinstance(max_tree_depth, tuple)
                else (max_tree_depth, max_tree_depth)
            ),
            trajectory_length=trajectory_length,
            fixed_num_steps=num_steps,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            target_accept_prob=target_accept_prob,
            regularize_mass_matrix=regularize_mass_matrix,
            refine_step_size=refine_step_size,
            pooled_adaptation=pooled_adaptation,
            init_step_size=step_size,
            init_inverse_mass_matrix=inverse_mass_matrix,
        )
        pe_grad = _pe_grad(model_args, model_kwargs)
        z_flat = layout.ravel_batch(z)
        if pe is None or z_grad is None:
            pe, grad_flat = pe_grad(z_flat)
        else:
            grad_flat = layout.ravel_batch(z_grad)

        wa_init, wa_update = core.build_warmup(
            pe_grad,
            ctx["blocks"],
            num_warmup,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            target_accept_prob=target_accept_prob,
            regularize_mass_matrix=regularize_mass_matrix,
            find_step_size=adapt_step_size and refine_step_size,
            pool_chains=pooled_adaptation,
        )
        # NB: wa_update is deliberately NOT kept in ctx — it closes over this
        # call's pe_grad (and through it the init-time model args, which may
        # be tracers when init runs under jit); sample_kernel rebuilds it
        # from its own call-time pe_grad instead
        adapt = wa_init(
            keys, z_flat, pe, grad_flat, step_size,
            inverse_mass_matrix=inverse_mass_matrix,
        )
        keys = adapt.rng_key
        c = num_chains
        zero_i = jnp.zeros((c,), jnp.int32)
        zero_f = jnp.zeros((c,), z_flat.dtype)
        state = HMCState(
            jnp.zeros((), jnp.int32),
            layout.unravel_batch(z_flat),
            layout.unravel_batch(grad_flat),
            pe,
            pe,
            None,
            trajectory_length,
            zero_i,
            zero_f,
            zero_f,
            jnp.zeros((c,), bool),
            adapt._replace(rng_key=None),
            keys,
        )
        if not batched:
            state = state._replace(
                z=_squeeze0(state.z),
                z_grad=_squeeze0(state.z_grad),
                **{
                    f: jax.tree.map(lambda x: x[0], getattr(state, f))
                    for f in (
                        "potential_energy", "energy", "num_steps",
                        "accept_prob", "mean_accept_prob", "diverging",
                        "adapt_state", "rng_key",
                    )
                },
            )
        return jax.device_put(state)

    def sample_kernel(state, model_args=(), model_kwargs=None):
        """One transition for every chain: momentum refresh -> trajectory ->
        proposal -> warmup adaptation while ``i < num_warmup``."""
        layout, blocks = ctx["layout"], ctx["blocks"]
        batched = ctx["batched"]
        num_warmup = ctx["num_warmup"]
        if not batched:
            state = state._replace(
                z=_expand0(state.z),
                z_grad=_expand0(state.z_grad),
                **{
                    f: jax.tree.map(lambda x: jnp.asarray(x)[None], getattr(state, f))
                    for f in (
                        "potential_energy", "energy", "num_steps",
                        "accept_prob", "mean_accept_prob", "diverging",
                        "adapt_state", "rng_key",
                    )
                },
            )
        pe_grad = _pe_grad(model_args, model_kwargs)
        z_flat = layout.ravel_batch(state.z)
        grad_flat = layout.ravel_batch(state.z_grad)
        trans_keys, adapt_keys = core.split_keys(state.rng_key, 2)
        adapt = state.adapt_state._replace(rng_key=adapt_keys)
        i = state.i

        if algo == "NUTS":
            wa_depth, post_depth = ctx["max_tree_depth"]
            depth_cap = jnp.where(i < num_warmup, wa_depth, post_depth)
            out = core.nuts_transition(
                pe_grad, blocks, trans_keys, z_flat,
                state.potential_energy, grad_flat,
                adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt,
                adapt.step_size, depth_cap,
                k_slots=max(*ctx["max_tree_depth"], 1),
            )
        else:
            out = core.hmc_transition(
                pe_grad, blocks, trans_keys, z_flat,
                state.potential_energy, grad_flat,
                adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt,
                adapt.step_size,
                trajectory_length=ctx["trajectory_length"],
                num_steps=ctx["fixed_num_steps"],
            )

        if num_warmup > 0:
            _, wa_update = core.build_warmup(
                pe_grad,
                blocks,
                num_warmup,
                adapt_step_size=ctx["adapt_step_size"],
                adapt_mass_matrix=ctx["adapt_mass_matrix"],
                target_accept_prob=ctx["target_accept_prob"],
                regularize_mass_matrix=ctx["regularize_mass_matrix"],
                find_step_size=ctx["adapt_step_size"] and ctx["refine_step_size"],
                pool_chains=ctx["pooled_adaptation"],
            )
            adapt = jax.lax.cond(
                i < num_warmup,
                lambda a: wa_update(
                    i, a, out.accept_prob, out.z, out.pe, out.grad
                ),
                lambda a: a,
                adapt,
            )
        i_new = i + 1
        n = jnp.where(i < num_warmup, i_new, i_new - num_warmup)
        mean_accept = state.mean_accept_prob + (
            out.accept_prob - state.mean_accept_prob
        ) / n
        new_state = HMCState(
            i_new,
            layout.unravel_batch(out.z),
            layout.unravel_batch(out.grad),
            out.pe,
            out.energy,
            None,
            state.trajectory_length,
            out.num_steps,
            out.accept_prob,
            mean_accept,
            out.diverging,
            adapt._replace(rng_key=None),
            out.key,
        )
        if not batched:
            new_state = new_state._replace(
                z=_squeeze0(new_state.z),
                z_grad=_squeeze0(new_state.z_grad),
                **{
                    f: jax.tree.map(lambda x: x[0], getattr(new_state, f))
                    for f in (
                        "potential_energy", "energy", "num_steps",
                        "accept_prob", "mean_accept_prob", "diverging",
                        "adapt_state", "rng_key",
                    )
                },
            )
        return new_state

    return init_kernel, sample_kernel


class HMC(MCMCKernel):
    """Hamiltonian Monte Carlo with a fixed trajectory length (constructor
    parity: numpyro/infer/hmc.py:540-822).  Chain-massive by construction —
    a batch of rng keys runs all chains inside one fused program, with
    per-chain trajectory lengths masked in a single loop."""

    _algo = "HMC"
    # the driver may trace init() under jit with model data as inputs
    jit_init = True

    def __init__(
        self,
        model=None,
        potential_fn=None,
        kinetic_fn=None,
        step_size=1.0,
        inverse_mass_matrix=None,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        num_steps=None,
        trajectory_length=2 * math.pi,
        init_strategy=None,
        find_heuristic_step_size=False,
        forward_mode_differentiation=False,
        regularize_mass_matrix=True,
        refine_step_size=True,
        pooled_adaptation=False,
    ):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        from numpyro_tpu.infer.initialization import init_to_uniform

        self._model = model
        self._potential_fn = potential_fn
        if kinetic_fn is not None:
            raise NotImplementedError(
                "custom kinetic_fn is not supported by the chain-batched engine"
            )
        self._step_size = float(step_size) if isinstance(step_size, int) else step_size
        self._inverse_mass_matrix = inverse_mass_matrix
        self._adapt_step_size = adapt_step_size
        self._adapt_mass_matrix = adapt_mass_matrix
        self._dense_mass = dense_mass
        self._target_accept_prob = target_accept_prob
        self._num_steps = num_steps
        self._trajectory_length = (
            float(trajectory_length)
            if isinstance(trajectory_length, int)
            else trajectory_length
        )
        self._max_tree_depth = 10
        self._init_strategy = init_to_uniform if init_strategy is None else init_strategy
        self._find_heuristic_step_size = find_heuristic_step_size
        self._forward_mode_differentiation = forward_mode_differentiation
        self._regularize_mass_matrix = regularize_mass_matrix
        self._refine_step_size = refine_step_size
        self._pooled_adaptation = pooled_adaptation
        self._init_fn = None
        self._sample_fn = None
        self._potential_fn_gen = None
        self._postprocess_fn = None

    @property
    def model(self):
        return self._model

    @property
    def sample_field(self):
        return "z"

    @property
    def default_fields(self):
        return ("z", "diverging")

    def get_diagnostics_str(self, state):
        return "{} steps of size {:.2e}. acc. prob={:.2f}".format(
            state.num_steps, state.adapt_state.step_size, state.mean_accept_prob
        )

    def _setup(self, rng_key, model_args, model_kwargs, init_params):
        if self._model is not None:
            init_params_, potential_fn_gen, postprocess_fn, _ = initialize_model(
                rng_key,
                self._model,
                dynamic_args=True,
                init_strategy=self._init_strategy,
                model_args=model_args,
                model_kwargs=model_kwargs,
                forward_mode_differentiation=self._forward_mode_differentiation,
            )
            if init_params is None:
                init_params = init_params_
            self._potential_fn_gen = potential_fn_gen
            if self._postprocess_fn is None:
                self._postprocess_fn = postprocess_fn
            self._init_fn, self._sample_fn = hmc(
                potential_fn_gen=potential_fn_gen, algo=self._algo
            )
        else:
            self._init_fn, self._sample_fn = hmc(
                potential_fn=self._potential_fn, algo=self._algo
            )
        return init_params

    def _structured_dense_mass(self, init_params):
        dense = self._dense_mass
        if self._model is not None and not isinstance(dense, bool):
            assert isinstance(dense, list)
        return dense

    def init(
        self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs={}
    ):
        if is_prng_key(rng_key):
            rng_key, rng_key_init_model = random.split(rng_key)
        else:
            splits = jax.vmap(random.split)(rng_key)
            rng_key, rng_key_init_model = splits[:, 0], splits[:, 1]
        init_params = self._setup(
            rng_key_init_model, model_args, model_kwargs, init_params
        )
        if self._potential_fn and init_params is None:
            raise ValueError(
                "Valid value of `init_params` must be provided with `potential_fn`."
            )
        return self._init_fn(
            init_params,
            num_warmup,
            step_size=self._step_size,
            inverse_mass_matrix=self._inverse_mass_matrix,
            adapt_step_size=self._adapt_step_size,
            adapt_mass_matrix=self._adapt_mass_matrix,
            dense_mass=self._structured_dense_mass(init_params),
            target_accept_prob=self._target_accept_prob,
            num_steps=self._num_steps,
            trajectory_length=self._trajectory_length,
            max_tree_depth=self._max_tree_depth,
            find_heuristic_step_size=self._find_heuristic_step_size,
            forward_mode_differentiation=self._forward_mode_differentiation,
            regularize_mass_matrix=self._regularize_mass_matrix,
            refine_step_size=self._refine_step_size,
            pooled_adaptation=self._pooled_adaptation,
            model_args=model_args,
            model_kwargs=model_kwargs,
            rng_key=rng_key,
        )

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def sample(self, state, model_args, model_kwargs):
        return self._sample_fn(state, model_args, model_kwargs)

    # ---- fused whole-run program (driver fast path) --------------------

    FUSED_FIELDS = (
        "z", "energy", "diverging", "num_steps", "accept_prob",
        "mean_accept_prob", "adapt_state.step_size",
    )

    @property
    def supports_fused_run(self):
        return True

    def fused_run(
        self,
        rng_key,
        num_warmup,
        num_samples,
        *,
        thinning=1,
        init_params=None,
        model_args=(),
        model_kwargs=None,
        collect_fields=("z", "diverging"),
        progress=None,
    ):
        """Warmup + sampling for all chains as ONE compiled program with
        asynchronous transition overlap (see hmc_core.build_fused_run).

        Returns ``(fields, last_state)`` where every collected field has
        shape ``(num_chains, num_collected, ...)``.  ``progress`` is an
        optional callback ``progress(phase, done, total)`` invoked after
        every chunk (the chunked host loop gives natural reporting points —
        no io_callback needed).
        """
        model_kwargs = {} if model_kwargs is None else model_kwargs
        assert not is_prng_key(rng_key), "fused_run expects a batch of keys"
        splits = jax.vmap(random.split)(rng_key)
        keys, init_model_keys = splits[:, 0], splits[:, 1]
        init_params = self._setup(
            init_model_keys, model_args, model_kwargs, init_params
        )
        if isinstance(init_params, ParamInfo):
            z, pe, z_grad = init_params
        else:
            z, pe, z_grad = init_params, None, None
        num_chains = keys.shape[0]
        leaves = jax.tree.leaves(z)
        if leaves and any(jnp.shape(x)[:1] != (num_chains,) for x in leaves):
            z = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (num_chains,) + jnp.shape(x)), z
            )
            pe, z_grad = None, None
        z_proto = _squeeze0(z)
        layout = core.FlatLayout(z_proto)
        blocks = core.build_mass_blocks(
            layout, self._structured_dense_mass(init_params)
        )
        max_depth = (
            self._max_tree_depth
            if isinstance(self._max_tree_depth, tuple)
            else (self._max_tree_depth, self._max_tree_depth)
        )

        def _build_run(dynamic):
            # the potential is (re)built inside the trace so model data
            # rides in as program inputs, never as baked XLA constants
            # (python-scalar args stay static via split_dynamic)
            if self._potential_fn_gen is not None:
                margs, mkwargs = merge_dynamic(dynamic, arg_meta)
                pe_fn = self._potential_fn_gen(*margs, **mkwargs)
            else:
                pe_fn = self._potential_fn
            pe_grad = core.batched_potential(
                pe_fn, layout, self._forward_mode_differentiation
            )
            run = core.build_fused_run(
                pe_grad,
                blocks,
                algo=self._algo,
                num_warmup=num_warmup,
                num_samples=num_samples,
                thinning=thinning,
                max_depth=max_depth[1],
                warmup_max_depth=max_depth[0],
                trajectory_length=self._trajectory_length,
                fixed_num_steps=self._num_steps,
                adapt_step_size=self._adapt_step_size,
                adapt_mass_matrix=self._adapt_mass_matrix,
                target_accept_prob=self._target_accept_prob,
                regularize_mass_matrix=self._regularize_mass_matrix,
                find_step_size=self._adapt_step_size and self._refine_step_size,
                pool_chains=self._pooled_adaptation,
            )
            return pe_grad, run

        # --- the run as a suite of jitted programs (init, warmup steps,
        # sampling start, harvest, finish).  Without a progress bar each
        # phase is one program call; with one, warmup and sampling advance
        # in chunks so the bar has update points.  All state stays on
        # device between calls.
        import time as _time
        from functools import partial as _partial

        if progress is None:
            warm_chunk, samp_chunk = max(num_warmup, 1), max(num_samples, 1)
        else:
            warm_chunk, samp_chunk = 5, 20

        def program_init(keys, z_tree, pe, z_grad_tree, dynamic):
            pe_grad, run = _build_run(dynamic)
            z_flat = layout.ravel_batch(z_tree)
            if z_grad_tree is None:
                pe_now, grad_flat = pe_grad(z_flat)
            else:
                pe_now, grad_flat = pe, layout.ravel_batch(z_grad_tree)
            return run.warm_init(
                keys, z_flat, pe_now, grad_flat, self._step_size,
                inverse_mass_matrix=self._inverse_mass_matrix,
            )

        def program_warm(n, ws, i0, dynamic):
            _, run = _build_run(dynamic)
            return run.warm_steps(ws, i0, n)

        def program_start(ws, dynamic):
            _, run = _build_run(dynamic)
            return run.sample_start(ws)

        def program_sample(ss, target, dynamic):
            _, run = _build_run(dynamic)
            return run.sample_until(ss, target)

        def program_finish(ss, dynamic):
            _, run = _build_run(dynamic)
            return run.sample_finish(ss)

        if pe is None or z_grad is None:
            pe, z_grad = None, None
        arg_dyn, arg_meta = split_dynamic((model_args, model_kwargs))
        # cache the jitted programs per run configuration: model data are
        # traced inputs, so re-running on fresh data of the same shapes
        # reuses the compiled executables (the reference's `jit_model_args`
        # recompile-avoidance, on by default: numpyro/infer/mcmc.py:290-294)
        cache_key = (
            num_warmup, num_samples, thinning, self._algo, arg_meta, num_chains,
        )
        cache = getattr(self, "_fused_cache", None)
        if cache is None:
            cache = self._fused_cache = {}
        if cache_key not in cache:
            rem = num_warmup % warm_chunk
            cache[cache_key] = {
                "init": jax.jit(program_init),
                "warm": jax.jit(_partial(program_warm, warm_chunk)),
                "warm_rem": jax.jit(_partial(program_warm, rem)) if rem else None,
                "start": jax.jit(program_start),
                "sample": jax.jit(program_sample),
                "finish": jax.jit(program_finish),
            }
        progs = cache[cache_key]

        # (jitted program, abstract arguments) of each program's first call
        # in this run, for ahead-of-time inspection:
        # ``prog.lower(*args).compile().memory_analysis()``.  Only sharded
        # placements are kept: single-device arrays stay free to move.
        self.last_fused_programs = {}

        def abstract(x):
            if not isinstance(x, jax.Array):
                return x
            sharding = x.sharding
            if isinstance(sharding, jax.sharding.SingleDeviceSharding):
                sharding = None
            return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding)

        def call(name, *args):
            if name not in self.last_fused_programs:
                self.last_fused_programs[name] = (
                    progs[name], jax.tree.map(abstract, args)
                )
            return progs[name](*args)

        warm_times, sample_times = [], []
        t0 = _time.time()
        ws = jax.block_until_ready(call("init", keys, z, pe, z_grad, arg_dyn))
        init_s = _time.time() - t0
        done = 0
        while done < num_warmup:
            step = min(warm_chunk, num_warmup - done)
            t1 = _time.time()
            ws = call("warm" if step == warm_chunk else "warm_rem", ws, done, arg_dyn)
            jax.block_until_ready(ws)
            warm_times.append(_time.time() - t1)
            done += step
            if progress is not None:
                progress("warmup", done, num_warmup)
        warmup_s = _time.time() - t0

        t0 = _time.time()
        ss = call("start", ws, arg_dyn)
        target = 0
        while target < num_samples:
            target = min(target + samp_chunk, num_samples)
            t1 = _time.time()
            ss = jax.block_until_ready(call("sample", ss, target, arg_dyn))
            sample_times.append(_time.time() - t1)
            if progress is not None:
                progress("sample", target, num_samples)
        out = jax.block_until_ready(call("finish", ss, arg_dyn))
        self.last_fused_stats = {
            "warmup_s": warmup_s,
            "sample_s": _time.time() - t0,
            "init_s": init_s,
            # per-chunk times let callers separate compile (first chunk)
            # from steady state without a second full run
            "warm_chunk_times": warm_times,
            "sample_chunk_times": sample_times,
        }
        n_collect = out["samples_z"].shape[1]
        # unpack the flat z panel back into site pytrees per (chain, draw)
        flat2 = out["samples_z"].reshape(num_chains * n_collect, -1)
        z_samples = jax.tree.map(
            lambda x: x.reshape((num_chains, n_collect) + x.shape[1:]),
            layout.unravel_batch(flat2),
        )
        step_size = jnp.broadcast_to(
            out["adapt"].step_size[:, None], (num_chains, n_collect)
        )
        fields = {
            "z": z_samples,
            "adapt_state.step_size": step_size,
            **out["extras"],
        }
        fields = {k: fields[k] for k in collect_fields}
        z_unr = layout.unravel_batch(out["z"])
        g_unr = layout.unravel_batch(out["grad"])
        last_state = HMCState(
            jnp.asarray(num_warmup + num_samples, jnp.int32),
            z_unr,
            g_unr,
            out["pe"],
            out["pe"],
            None,
            self._trajectory_length,
            jnp.zeros((num_chains,), jnp.int32),
            out["mean_accept_prob"],
            out["mean_accept_prob"],
            jnp.zeros((num_chains,), bool),
            out["adapt"]._replace(rng_key=None),
            out["keys"],
        )
        return fields, last_state

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_init_fn"] = None
        state["_sample_fn"] = None
        state["_postprocess_fn"] = None
        state["_potential_fn_gen"] = None
        state["_fused_cache"] = None
        return state


class NUTS(HMC):
    """No-U-Turn Sampler (constructor parity: numpyro/infer/hmc.py:825-948)
    on the vectorized-checkpoint iterative tree engine."""

    _algo = "NUTS"

    def __init__(
        self,
        model=None,
        potential_fn=None,
        kinetic_fn=None,
        step_size=1.0,
        inverse_mass_matrix=None,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        trajectory_length=None,
        max_tree_depth=10,
        init_strategy=None,
        find_heuristic_step_size=False,
        forward_mode_differentiation=False,
        regularize_mass_matrix=True,
        refine_step_size=True,
        pooled_adaptation=False,
    ):
        super().__init__(
            model=model,
            potential_fn=potential_fn,
            kinetic_fn=kinetic_fn,
            step_size=step_size,
            inverse_mass_matrix=inverse_mass_matrix,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            dense_mass=dense_mass,
            target_accept_prob=target_accept_prob,
            trajectory_length=trajectory_length,
            init_strategy=init_strategy,
            find_heuristic_step_size=find_heuristic_step_size,
            forward_mode_differentiation=forward_mode_differentiation,
            regularize_mass_matrix=regularize_mass_matrix,
            refine_step_size=refine_step_size,
            pooled_adaptation=pooled_adaptation,
        )
        self._max_tree_depth = max_tree_depth
