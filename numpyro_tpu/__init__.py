"""numpyro_tpu — an accelerator-native probabilistic-programming inference engine.

Brand-new implementation of NumPyro's capabilities (effect-handler model DSL,
distributions with constraints/transforms, iterative-NUTS/HMC, SVI/autoguides,
enumeration) architected chain-massive: thousands of
vectorized chains per device in one XLA program, sharded across device meshes
via jax.sharding, with device-side adaptation and diagnostics.
"""

from numpyro_tpu import distributions
from numpyro_tpu.distributions.distribution import (
    enable_validation,
    validation_enabled,
)
from numpyro_tpu.primitives import (
    deterministic,
    factor,
    get_mask,
    module,
    mutable,
    param,
    plate,
    plate_stack,
    prng_key,
    sample,
    subsample,
)
from numpyro_tpu.util import (
    enable_x64,
    set_host_device_count,
    set_platform,
)
from numpyro_tpu import checkpoint, diagnostics, handlers, infer, ops, optim
from numpyro_tpu.diagnostics import print_summary
from numpyro_tpu.infer.inspect import get_dependencies, render_model

__version__ = "0.1.0"

__all__ = [
    "compat",
    "__version__",
    "deterministic",
    "diagnostics",
    "distributions",
    "enable_validation",
    "enable_x64",
    "factor",
    "get_mask",
    "handlers",
    "infer",
    "module",
    "mutable",
    "optim",
    "param",
    "plate",
    "plate_stack",
    "print_summary",
    "checkpoint",
    "render_model",
    "get_dependencies",
    "ops",
    "prng_key",
    "sample",
    "set_host_device_count",
    "set_platform",
    "subsample",
    "validation_enabled",
]
