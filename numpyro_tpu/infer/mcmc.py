"""MCMC driver.

Fresh accelerator-first re-design of numpyro/infer/mcmc.py.  The architectural shift
vs the reference (which is chain-sequential, one-chain-per-device pmap):

- **vectorized is the default chain method**: all chains advance inside ONE
  fused XLA program (kernel init/sample vmapped over the chain axis).
- **parallel = vectorized + GSPMD sharding**: the batched chain state is
  placed with a NamedSharding over the mesh axis ``"chains"`` and the same
  jitted program runs SPMD across devices — XLA inserts the collectives;
  no pmap, no per-device Python.
- the whole (warmup + sampling) loop is a single compiled program
  (fori_collect with donated buffers); the per-step-dispatch progress-bar
  path exists for interactive use.
"""

from __future__ import annotations

import contextlib
from abc import ABC, abstractmethod

import numpy as np

import jax
import jax.numpy as jnp
from jax import jit, local_device_count, random, vmap
from jax.sharding import NamedSharding, PartitionSpec as P

from numpyro_tpu.diagnostics import print_summary
from numpyro_tpu.util import (
    fori_collect,
    identity,
    is_prng_key,
    merge_dynamic,
    nested_attrgetter,
    split_dynamic,
)

__all__ = ["MCMCKernel", "MCMC"]


class MCMCKernel(ABC):
    """Kernel interface (reference: numpyro/infer/mcmc.py:32-158)."""

    _cache = {}

    def postprocess_fn(self, model_args, model_kwargs):
        return identity

    @abstractmethod
    def init(
        self, rng_key, num_warmup, init_params, model_args, model_kwargs
    ):
        raise NotImplementedError

    @abstractmethod
    def sample(self, state, model_args, model_kwargs):
        raise NotImplementedError

    @property
    def sample_field(self):
        raise NotImplementedError

    @property
    def default_fields(self):
        return (self.sample_field,)

    def get_diagnostics_str(self, state):
        return ""

    @property
    def is_ensemble_kernel(self):
        return False


def _get_value_from_state(state, field):
    return nested_attrgetter(field)(state)


def _collect_fn(collect_fields, remove_sites):
    def collect(x):
        if collect_fields:
            fields = nested_attrgetter(*collect_fields)(x)
            if remove_sites and isinstance(
                fields[0] if isinstance(fields, tuple) else fields, dict
            ):
                if isinstance(fields, tuple):
                    site_values = {
                        k: v for k, v in fields[0].items() if k not in remove_sites
                    }
                    return (site_values,) + fields[1:]
                return {k: v for k, v in fields.items() if k not in remove_sites}
            return fields
        return x

    return collect


class MCMC:
    """MCMC driver (reference surface: numpyro/infer/mcmc.py:224-801).

    :param chain_method: ``"vectorized"`` (default — all chains in one fused
        program), ``"parallel"`` (vectorized + sharded over the device mesh
        axis ``"chains"``), ``"sequential"``, or a callable vmap/pmap-like
        transform mapped over the chain axis.
    :param jit_model_args: accepted for reference API parity but always on:
        model data rides through every compiled program as traced inputs,
        so re-running on new data of the same shapes never recompiles.
    :param matmul_precision: matmul precision the sampler program is traced
        under.  Defaults to ``"highest"`` because on NVIDIA GPUs since
        Ampere XLA's default runs float32 matmuls in TF32, which keeps ~10
        mantissa bits: the log density and its gradient then carry
        ~1e-3-relative errors, enough to break energy conservation along a
        trajectory and bias the Metropolis correction on data-heavy
        models.  Set to ``"default"`` to reclaim tensor-core throughput
        when the model's geometry tolerates it.  Kernels that already take
        bf16 operands (``ops.glm`` split mode) pin their own precision.
    """

    def __init__(
        self,
        sampler,
        *,
        num_warmup,
        num_samples,
        num_chains=1,
        thinning=1,
        postprocess_fn=None,
        chain_method="vectorized",
        progress_bar=False,
        jit_model_args=False,
        matmul_precision="highest",
    ):
        self.sampler = sampler
        self._sample_field = sampler.sample_field
        self._default_fields = sampler.default_fields
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        if not isinstance(thinning, int) or thinning < 1:
            raise ValueError("thinning must be a positive integer")
        self.thinning = thinning
        self.postprocess_fn = postprocess_fn
        if chain_method not in ["parallel", "vectorized", "sequential"] and not callable(
            chain_method
        ):
            raise ValueError(
                "Only supporting the following methods to draw chains:"
                ' "sequential", "parallel", "vectorized", or a callable'
            )
        self.chain_method = chain_method
        self.progress_bar = progress_bar
        self._jit_model_args = jit_model_args
        self._matmul_precision = matmul_precision
        self._states = None
        self._states_flat = None
        # HMCState returned by last run
        self._last_state = None
        # HMCState returned by last warmup
        self._warmup_state = None
        # HMCState = postprocessed values of the last run
        self._cache = {}
        self._collection_params = {}
        # wall-clock per phase ({"warmup_s": ..., "sample_s": ...}), the
        # per-phase timers promised in SURVEY §5
        self.last_run_stats = {}
        self._set_collection_params()

    def _set_collection_params(
        self, lower=None, upper=None, phase=None
    ):
        self._collection_params["lower"] = (
            self.num_warmup if lower is None else lower
        )
        self._collection_params["upper"] = (
            self.num_warmup + self.num_samples if upper is None else upper
        )
        self._collection_params["phase"] = phase

    @property
    def post_warmup_state(self):
        """Set this to ``.last_state`` to skip warmup on the next run."""
        return self._warmup_state

    @post_warmup_state.setter
    def post_warmup_state(self, state):
        self._warmup_state = state

    @property
    def last_state(self):
        return self._last_state

    def warmup(
        self,
        rng_key,
        *args,
        extra_fields=(),
        collect_warmup=False,
        init_params=None,
        **kwargs,
    ):
        """Run warmup only; sets ``post_warmup_state``."""
        self._warmup_state = None
        if collect_warmup:
            self._set_collection_params(0, self.num_warmup, phase="warmup")
        else:
            self._set_collection_params(
                self.num_warmup, self.num_warmup, phase="warmup"
            )
        self.run(
            rng_key, *args, extra_fields=extra_fields, init_params=init_params, **kwargs
        )
        self._warmup_state = self._last_state
        self._set_collection_params()

    def _single_chain_mcmc(
        self, init, args, kwargs, collect_fields, remove_sites
    ):
        """Run one (possibly internally-batched) chain: init + fori_collect.

        Traced under the configured matmul precision so every matmul in the
        compiled sampler program (model likelihood, mass-matrix ops) uses it.
        """
        with jax.default_matmul_precision(self._matmul_precision):
            return self._single_chain_mcmc_inner(
                init, args, kwargs, collect_fields, remove_sites
            )

    def _single_chain_mcmc_inner(
        self, init, args, kwargs, collect_fields, remove_sites
    ):
        rng_key, init_state, init_params = init
        # model data rides through every compiled program as inputs (a
        # baked constant embeds the dataset in the program and recompiles on
        # every new dataset); python-scalar args stay static so models may
        # branch on them
        dyn, meta = split_dynamic((args, kwargs))
        if init_state is None:
            if getattr(self.sampler, "jit_init", False) and not self.progress_bar:
                # trace the whole init (incl. model initialization and the
                # step-size search) with the data as program inputs
                init_state = jit(
                    lambda rng, ip, d: self.sampler.init(
                        rng,
                        self.num_warmup,
                        ip,
                        *merge_dynamic(d, meta),
                    )
                )(rng_key, init_params, dyn)
            else:
                init_state = self.sampler.init(
                    rng_key,
                    self.num_warmup,
                    init_params,
                    model_args=args,
                    model_kwargs=kwargs,
                )
        postprocess_fn = (
            self.sampler.postprocess_fn(args, kwargs)
            if self.postprocess_fn is None
            else self.postprocess_fn
        )

        lower_idx = self._collection_params["lower"]
        upper_idx = self._collection_params["upper"]
        phase = self._collection_params["phase"]

        collect_fn = _collect_fn(collect_fields, remove_sites)

        def step_fn(state, dynamic):
            a, kw = merge_dynamic(dynamic, meta)
            return self.sampler.sample(state, a, kw)

        collection, last_state = fori_collect(
            lower_idx,
            upper_idx,
            step_fn,
            init_state,
            transform=collect_fn,
            progbar=self.progress_bar,
            return_last_val=True,
            thinning=self.thinning,
            collection_size=None,
            body_args=(dyn,),
            progbar_desc=lambda i: (
                "warmup" if i < self.num_warmup else "sample"
            ),
            diagnostics_fn=(
                self.sampler.get_diagnostics_str if self.progress_bar else None
            ),
        )
        return collection, last_state, postprocess_fn

    def run(self, rng_key, *args, extra_fields=(), init_params=None, **kwargs):
        """Run warmup + sampling and collect fields (reference:
        infer/mcmc.py:626-757).  Wall time of the phase (including device
        sync) lands in ``self.last_run_stats``."""
        import time as _time

        _t0 = _time.time()
        self._chain_pad = 0
        self._chain_mesh = None
        init_state = self._warmup_state
        if init_state is not None:
            # resuming from a warmed-up state: no warmup steps to skip
            self._set_collection_params(0, self.num_samples, phase="sample")
        self._args = args
        self._kwargs = kwargs

        if is_prng_key(rng_key):
            if self.num_chains > 1:
                rng_key = random.split(rng_key, self.num_chains)
        else:
            assert rng_key.shape[0] == self.num_chains, (
                "The batch dim of rng_key must equal num_chains"
            )

        # which fields to collect
        collect_fields = tuple(
            set(
                (self._sample_field,)
                + tuple(self._default_fields)
                + tuple(extra_fields)
            )
        )
        # kernels may exclude bulky bookkeeping sites from collection
        # (e.g. HMCECS per-chain subsample index panels: 1.6 GB at the
        # 4096-chain x 100-draw north-star config); they stay available on
        # ``last_state``
        remove_sites = tuple(
            getattr(self.sampler, "collect_exclude_sites", ()) or ()
        )
        # sort so sample_field is first
        collect_fields = (self._sample_field,) + tuple(
            sorted(f for f in collect_fields if f != self._sample_field)
        )

        # Fused fast path: HMC/NUTS vectorized chains run warmup + sampling
        # as ONE compiled program with asynchronous transition overlap —
        # chains never idle waiting for the slowest tree (hmc_core).
        if self._can_fuse(collect_fields, init_state):
            if self.chain_method == "parallel":
                rng_key = self._shard_over_chains(
                    rng_key, allow_pad=init_state is None
                )
            progress = None
            bar = None
            if self.progress_bar:
                try:
                    from tqdm.auto import tqdm

                    bar = tqdm(total=self.num_warmup + self.num_samples)

                    def progress(phase, done, total):
                        base = 0 if phase == "warmup" else self.num_warmup
                        bar.n = base + done
                        bar.set_description(phase, refresh=False)
                        bar.refresh()

                except ImportError:  # pragma: no cover
                    pass
            try:
                with (
                    jax.default_matmul_precision(self._matmul_precision),
                    self._mesh_context(),
                ):
                    fields, last_state = self.sampler.fused_run(
                        rng_key,
                        self.num_warmup,
                        self.num_samples,
                        thinning=self.thinning,
                        init_params=init_params,
                        model_args=args,
                        model_kwargs=kwargs,
                        collect_fields=collect_fields,
                        progress=progress,
                    )
            finally:
                if bar is not None:
                    bar.close()
            self._last_state = self._strip_chain_pad(last_state)
            fields = self._strip_chain_pad(fields)
            self._postprocess_states(fields, None, collect_fields, by_field=True)
            jax.block_until_ready(
                _get_value_from_state(last_state, self._sample_field)
            )
            self.last_run_stats["total_s"] = _time.time() - _t0
            self.last_run_stats.update(
                getattr(self.sampler, "last_fused_stats", {})
            )
            return

        if self.num_chains == 1:
            states_flat, last_state, postprocess_fn = self._single_chain_mcmc(
                (rng_key, init_state, init_params),
                args,
                kwargs,
                collect_fields,
                remove_sites,
            )
            states = jax.tree.map(lambda x: x[jnp.newaxis, ...], states_flat)
        else:
            if self.chain_method == "sequential":
                chain_outputs = []
                keys = rng_key
                for i in range(self.num_chains):
                    init_state_i = (
                        jax.tree.map(lambda x: x[i], init_state)
                        if init_state is not None
                        else None
                    )
                    init_params_i = (
                        jax.tree.map(lambda x: x[i], init_params)
                        if init_params is not None
                        else None
                    )
                    out = self._single_chain_mcmc(
                        (keys[i], init_state_i, init_params_i),
                        args,
                        kwargs,
                        collect_fields,
                        remove_sites,
                    )
                    chain_outputs.append(out)
                postprocess_fn = chain_outputs[0][2]
                states = jax.tree.map(
                    lambda *xs: jnp.stack(xs), *[c[0] for c in chain_outputs]
                )
                last_state = jax.tree.map(
                    lambda *xs: jnp.stack(xs), *[c[1] for c in chain_outputs]
                )
                states_flat = jax.tree.map(
                    lambda x: jnp.reshape(
                        jnp.swapaxes(x, 0, 1), (-1,) + x.shape[2:]
                    ),
                    states,
                )
                self._last_state = last_state
                self._states = states
                self._states_flat = None
                self._postprocess_states(states, postprocess_fn, collect_fields)
                jax.block_until_ready(
                    _get_value_from_state(last_state, self._sample_field)
                )
                phase = (
                    "warmup"
                    if self._collection_params.get("phase") == "warmup"
                    else "sample"
                )
                self.last_run_stats[f"{phase}_s"] = _time.time() - _t0
                return
            elif self.chain_method == "parallel":
                # chain-massive SPMD: vectorized program + sharded chain axis.
                # Keys are placed over the mesh axis "chains"; GSPMD then
                # partitions every (C, ...) tensor in the program.
                rng_key = self._shard_over_chains(
                    rng_key, allow_pad=init_state is None
                )
            elif callable(self.chain_method):
                # user-supplied vmap/pmap-like transform mapped over the
                # chain axis (reference: numpyro/infer/mcmc.py:282-287)
                if init_state is not None:
                    raise ValueError(
                        "post_warmup_state is not supported with a callable "
                        "chain_method"
                    )
                states, last_state = self._mapped_chain_mcmc(
                    self.chain_method,
                    rng_key,
                    init_params,
                    args,
                    kwargs,
                    collect_fields,
                    remove_sites,
                )
                self._last_state = last_state
                postprocess_fn = (
                    self.sampler.postprocess_fn(args, kwargs)
                    if self.postprocess_fn is None
                    else self.postprocess_fn
                )
                self._postprocess_states(states, postprocess_fn, collect_fields)
                jax.block_until_ready(
                    _get_value_from_state(last_state, self._sample_field)
                )
                self.last_run_stats["total_s"] = _time.time() - _t0
                return
            # vectorized (and parallel) path: batched keys through one program
            with self._mesh_context():
                states, last_state, postprocess_fn = self._single_chain_mcmc(
                    (rng_key, init_state, init_params),
                    args,
                    kwargs,
                    collect_fields,
                    remove_sites,
                )
            # collected shape: (num_samples_per_chain, num_chains, ...)
            states = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), states)
            states = self._strip_chain_pad(states)
            last_state = self._strip_chain_pad(last_state)

        self._last_state = last_state
        self._states = states
        self._states_flat = None
        self._postprocess_states(states, postprocess_fn, collect_fields)
        jax.block_until_ready(
            _get_value_from_state(last_state, self._sample_field)
        )
        phase = "warmup" if self._collection_params.get("phase") == "warmup" else "sample"
        self.last_run_stats[f"{phase}_s"] = _time.time() - _t0

    def _mapped_chain_mcmc(
        self, transform, keys, init_params, args, kwargs, collect_fields,
        remove_sites,
    ):
        """Run one chain per lane of a user vmap/pmap-like transform."""
        collect_fn = _collect_fn(collect_fields, remove_sites)
        lower = self._collection_params["lower"]
        upper = self._collection_params["upper"]

        def one_chain(key, params_i):
            state = self.sampler.init(
                key, self.num_warmup, params_i, args, kwargs
            )
            return fori_collect(
                lower,
                upper,
                lambda s: self.sampler.sample(s, args, kwargs),
                state,
                transform=collect_fn,
                progbar=False,
                return_last_val=True,
                thinning=self.thinning,
            )

        if init_params is None:
            collection, last_state = transform(
                lambda k: one_chain(k, None)
            )(keys)
        else:
            collection, last_state = transform(one_chain)(keys, init_params)
        return collection, last_state

    def _can_fuse(self, collect_fields, init_state):
        return (
            getattr(self.sampler, "supports_fused_run", False)
            and self.num_chains >= 2
            and self.chain_method in ("vectorized", "parallel")
            and init_state is None
            and self._collection_params["lower"] == self.num_warmup
            and self._collection_params["upper"]
            == self.num_warmup + self.num_samples
            and set(collect_fields) <= set(self.sampler.FUSED_FIELDS)
        )

    def _shard_over_chains(self, rng_key, allow_pad=True):
        """Shard the chain axis over every local device.

        When ``num_chains`` is not a multiple of the device count, the chain
        axis is PADDED to the next multiple so all devices stay busy, and the
        extra chains are dropped at collection (``_strip_chain_pad``) —
        running 1023 chains on 8 devices costs one extra chain per device,
        not a 8x single-device fallback.  Padded chains get *distinct* keys
        (``fold_in`` of the duplicated ones) so cross-chain statistics
        (pooled adaptation) are never double-weighted by bitwise-replica
        chains.  ``allow_pad=False`` (resume from an existing, unpadded
        kernel state) skips both padding and the stripping bookkeeping —
        the key batch must then match the state batch exactly.
        """
        import warnings

        n_dev = local_device_count()
        if n_dev <= 1:
            return rng_key
        pad = (-self.num_chains) % n_dev
        if pad and not allow_pad:
            warnings.warn(
                f"num_chains={self.num_chains} is not divisible by device "
                f"count {n_dev} and the run resumes from an existing state, "
                "so the chain axis cannot be padded; running unsharded.",
                stacklevel=2,
            )
            return rng_key
        if pad:
            warnings.warn(
                f"num_chains={self.num_chains} is not divisible by device "
                f"count {n_dev}; padding the chain axis to "
                f"{self.num_chains + pad} (extras dropped at collection). "
                "Pick num_chains as a multiple of the device count to avoid "
                "the padded work.",
                stacklevel=2,
            )
            pad_keys = vmap(lambda k: random.fold_in(k, self.num_chains))(
                rng_key[:pad]
            )
            rng_key = jnp.concatenate([rng_key, pad_keys], axis=0)
            self._chain_pad = pad
        mesh = jax.sharding.Mesh(np.array(jax.devices()), ("chains",))
        self._chain_mesh = mesh
        sharding = NamedSharding(mesh, P("chains"))
        return jax.device_put(rng_key, sharding)

    def _mesh_context(self):
        """Trace under the chain mesh of a sharded run, so ops that GSPMD
        cannot partition (Pallas custom calls) can ``shard_map`` themselves
        over ``"chains"``."""
        mesh = getattr(self, "_chain_mesh", None)
        return jax.set_mesh(mesh) if mesh is not None else contextlib.nullcontext()

    def _strip_chain_pad(self, tree):
        """Drop padded chains from the chain-batched leaves of a collected
        tree.  Every array leaf of the vectorized program's output carries
        the chain batch at dim 0 (vmap ``out_axes=0`` — collected fields are
        swapped to chain-major before stripping), so leaves whose leading
        dim equals the padded count are exactly the chain-batched ones;
        ``_chain_pad`` is reset at the start of every run and never set on
        resumed runs, so the predicate cannot fire on stale sizes."""
        pad = getattr(self, "_chain_pad", 0)
        if not pad:
            return tree
        padded_c = self.num_chains + pad

        def strip(x):
            if jnp.ndim(x) >= 1 and jnp.shape(x)[0] == padded_c:
                return x[: self.num_chains]
            return x

        return jax.tree.map(strip, tree)

    def _postprocess_states(
        self, states, postprocess_fn, collect_fields, by_field=False
    ):
        """Constrain the sample field and recover deterministic sites —
        vmapped over (chains, samples) in one program."""
        # states: dict keyed by field (fused path, by_field=True), or a
        # tuple aligned with collect_fields, or a bare single-field value
        if by_field:
            states_by_field = states
            if postprocess_fn is None:
                postprocess_fn = self.sampler.postprocess_fn(
                    self._args, self._kwargs
                )
        elif isinstance(states, tuple):
            states_by_field = dict(zip(collect_fields, states))
        else:
            states_by_field = {collect_fields[0]: states}

        site_values = states_by_field[self._sample_field]
        # applies to dict site panels AND flat packed panels (e.g. the TFP
        # kernel bridge collects a raveled z and unravels in postprocess)
        if site_values is not None and postprocess_fn is not identity:
            # jit with the model data as inputs, not baked-in constants
            if self.postprocess_fn is None:
                dyn, meta = split_dynamic((self._args, self._kwargs))

                def _pp(sites, dynamic):
                    a, kw = merge_dynamic(dynamic, meta)
                    return vmap(vmap(self.sampler.postprocess_fn(a, kw)))(sites)

                constrained = jit(_pp)(site_values, dyn)
            else:
                constrained = vmap(vmap(postprocess_fn))(site_values)
            states_by_field[self._sample_field] = constrained

        self._states = states_by_field
        self._states_flat = jax.tree.map(
            lambda x: jnp.reshape(x, (-1,) + jnp.shape(x)[2:]), states_by_field
        )

    def get_samples(self, group_by_chain=False):
        """Posterior samples in constrained space."""
        states = self._states if group_by_chain else self._states_flat
        return states[self._sample_field]

    def get_extra_fields(self, group_by_chain=False):
        states = self._states if group_by_chain else self._states_flat
        return {k: v for k, v in states.items() if k != self._sample_field}

    def print_summary(self, prob=0.90, exclude_deterministic=True):
        states = self._states[self._sample_field]
        if isinstance(states, dict):
            state_sample_field = states
        else:
            state_sample_field = {self._sample_field: states}
        if isinstance(state_sample_field, dict):
            samples = {
                k: v
                for k, v in state_sample_field.items()
                if not k.startswith("_")
            }
        print_summary(samples, prob=prob)
        extra_fields = self.get_extra_fields()
        if "diverging" in extra_fields:
            print(
                "Number of divergences: {}".format(
                    jnp.sum(extra_fields["diverging"])
                )
            )

    def transfer_states_to_host(self):
        """Move collected states to host memory (frees device memory)."""
        self._states = jax.device_get(self._states)
        self._states_flat = jax.device_get(self._states_flat)
        self._last_state = jax.device_get(self._last_state)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cache"] = {}
        return state
