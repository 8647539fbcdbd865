"""Worker for the 2-process jax.distributed test (SURVEY §5 multi-host).

Spawned twice by test_multihost.py; each process owns 4 virtual CPU devices
and the pair forms one 8-device (4, 2) chains×data mesh. Drives the library's
own helpers end-to-end: initialize_distributed, chain_data_mesh, a sharded
chain-axis collective (the pooled-adaptation reduction), and the
layout-invariant per-chain key derivation.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

process_id = int(sys.argv[1])
coordinator = sys.argv[2]

from numpyro_tpu.parallel.mesh import (  # noqa: E402
    chain_data_mesh,
    initialize_distributed,
)

initialize_distributed(
    coordinator_address=coordinator, num_processes=2, process_id=process_id
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

mesh = chain_data_mesh(num_chain_shards=4, num_data_shards=2)

# ---- layout-invariant per-chain key derivation ---------------------------
# every process derives the FULL key batch from the seed alone — no
# process_id / device layout enters the derivation, so any process can
# reproduce any chain's stream bit-for-bit
keys = random.split(random.PRNGKey(7), 8)
digest = np.asarray(keys).astype(np.uint64).sum()
print(f"KEYDIGEST {digest}")

# ---- cross-process chain-axis collective ----------------------------------
# chains 0-3 live on process 0, chains 4-7 on process 1; the jnp.mean over
# the chain axis must psum across DCN (gloo here)
sharding = NamedSharding(mesh, P("chains"))
local_rows = np.arange(4 * 3, dtype=np.float32).reshape(4, 3) + 12 * process_id
state = jax.make_array_from_process_local_data(sharding, local_rows)
assert state.shape == (8, 3)

pooled = jax.jit(lambda x: jnp.mean(x, axis=0), out_shardings=NamedSharding(mesh, P()))(state)
expected = (np.arange(12, dtype=np.float32).reshape(4, 3).mean(0) + np.arange(12, 24, dtype=np.float32).reshape(4, 3).mean(0)) / 2
np.testing.assert_allclose(np.asarray(pooled), expected, rtol=1e-6)

# ---- sharded-data log-density reduction -----------------------------------
# the data axis lives within each process (mesh columns), so every process
# holds a full replica; the reduction stays on the device interconnect in a real multi-host run
data = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("data")), np.arange(50, dtype=np.float32)
)
total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(data)
np.testing.assert_allclose(float(np.asarray(total)), 1225.0)

print("DISTOK")
