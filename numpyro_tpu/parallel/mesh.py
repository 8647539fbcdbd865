"""Device-mesh helpers: the SPMD replacement for the reference's
pmap-based chain parallelism (numpyro/infer/mcmc.py:707, SURVEY §2.8).

Design: chains are a first-class sharded batch axis.  The sampler program is
written once over a (num_chains, ...) batch; these helpers lay the batch out
over a mesh so XLA GSPMD partitions it across devices (and hosts),
inserting the collectives.  The optional ``data`` axis shards the
likelihood's observation dimension (the reference's documented recipe at
numpyro/infer/mcmc.py:239-265, made explicit).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "chain_mesh",
    "chain_data_mesh",
    "shard_chain_state",
    "shard_data",
    "cross_chain_diagnostics",
]


def chain_mesh(devices=None):
    """1-D mesh over all devices: axis ``chains``."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), ("chains",))


def chain_data_mesh(num_chain_shards=None, num_data_shards=None, devices=None):
    """2-D mesh ``(chains, data)``: chains on one mesh dimension, the
    sharded likelihood's data axis on the other.  The shape follows the
    algorithm: on cards joined all to all (NVLink) every placement of the
    two axes has the same link rate."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if num_chain_shards is None and num_data_shards is None:
        num_data_shards = 1
        num_chain_shards = n
    elif num_chain_shards is None:
        num_chain_shards = n // num_data_shards
    elif num_data_shards is None:
        num_data_shards = n // num_chain_shards
    assert num_chain_shards * num_data_shards == n, (
        f"mesh {num_chain_shards}x{num_data_shards} != {n} devices"
    )
    return Mesh(
        np.array(devices).reshape(num_chain_shards, num_data_shards),
        ("chains", "data"),
    )


def shard_chain_state(state, mesh):
    """Place a (num_chains, ...)-batched pytree with its leading axis over
    the ``chains`` mesh axis."""
    sharding = NamedSharding(mesh, P("chains"))

    def _shard(x):
        if jnp.ndim(x) >= 1:
            return jax.device_put(x, sharding)
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(_shard, state)


def shard_data(data, mesh, axis=0):
    """Shard an observation array along ``axis`` over the ``data`` mesh axis
    (replicated over ``chains``).  XLA turns the likelihood reduction into a
    cross-device psum."""
    spec = [None] * jnp.ndim(data)
    spec[axis] = "data"
    return jax.device_put(data, NamedSharding(mesh, P(*spec)))


def cross_chain_diagnostics(samples_by_chain):
    """Device-side split-R̂ and ESS on (possibly sharded) (C, N, ...) sample
    buffers.  Plain ``jnp`` reductions — under a GSPMD-sharded chain axis
    XLA inserts the cross-device collectives (multichip behavior is
    validated by the dryrun_multichip entry and the sharded-chain tests,
    not by this docstring)."""
    from numpyro_tpu.diagnostics import effective_sample_size, split_gelman_rubin

    return jax.tree.map(
        lambda x: (split_gelman_rubin(x), effective_sample_size(x)),
        samples_by_chain,
    )


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, **kwargs):
    """Initialize multi-process JAX (one process per host).

    The reference never addresses multi-host (SURVEY §2.8); here it is one
    call before building meshes — afterwards ``jax.devices()`` spans every
    process and the mesh helpers above shard across hosts transparently.
    Without a coordinator (the ``coordinator_address`` argument or the
    ``COORDINATOR_ADDRESS`` environment variable), or when already
    initialized, this is a no-op.
    """
    import os

    # NB: probe via jax.distributed, NOT jax.process_count() — the latter
    # initializes the XLA backend, which silently turns the subsequent
    # distributed.initialize into a no-op single-process setup
    if jax.distributed.is_initialized():
        return  # already initialized
    if coordinator_address is None and "COORDINATOR_ADDRESS" not in os.environ:
        return  # single process
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:
        # the backend was already initialized by an earlier jax call
        import warnings

        warnings.warn(f"initialize_distributed skipped: {e}", stacklevel=2)


def pooled_step_size(adapt_state, mesh=None):
    """Cross-chain pooled step size: the harmonic mean over the chain axis.

    Mechanically a plain ``jnp.mean`` — when the chain axis is
    GSPMD-sharded, XLA lowers it to a cross-device reduction (the behavior
    exercised by ``tests/parallel/test_pooled_adaptation.py::
    test_pooled_adaptation_sharded_chains`` and the no-all-gather
    assertions in ``tests/parallel/test_ecs_sharded_data.py``).  The
    production pooling path is ``NUTS(pooled_adaptation=True)``
    (``infer/hmc_core.py``); this helper serves ad-hoc experiments."""
    ss = getattr(adapt_state, "step_size", adapt_state)
    return 1.0 / jnp.mean(1.0 / ss)
