"""Masked dense layer (stax-style) — the building block of MADE-type
autoregressive networks (reference: numpyro/nn/masked_dense.py).  The mask
is applied to the weight matrix so each output only sees permitted inputs;
the masked matmul still runs as one dense matmul."""

from jax import random
from jax.nn.initializers import glorot_normal, normal
import jax.numpy as jnp


def MaskedDense(mask, bias=True, W_init=glorot_normal(), b_init=normal()):
    """Return a stax-style ``(init_fn, apply_fn)`` pair computing
    ``inputs @ (W * mask) + b``."""

    def init_fun(rng_key, input_shape):
        k1, k2 = random.split(rng_key)
        W = W_init(k1, mask.shape)
        if bias:
            b = b_init(k2, mask.shape[-1:])
            params = (W, b)
        else:
            params = W
        return input_shape[:-1] + mask.shape[-1:], params

    def apply_fun(params, inputs, **kwargs):
        if bias:
            W, b = params
            return jnp.dot(inputs, W * mask) + b
        return jnp.dot(inputs, params * mask)

    return init_fun, apply_fun
