"""Normalizing-flow transforms: IAF and BNAF
(reference: numpyro/distributions/flows.py).  Both wrap autoregressive nets;
the forward pass is fused dense math on the tensor cores, and every forward also
yields the log-Jacobian as an intermediate so ``log_prob`` never re-runs the
network."""

from jax import lax
import jax.numpy as jnp

from numpyro_tpu.distributions.constraints import real_vector
from numpyro_tpu.distributions.transforms import Transform

__all__ = ["InverseAutoregressiveTransform", "BlockNeuralAutoregressiveTransform"]


class _NeuralFlow(Transform):
    """Shared machinery for net-backed vector flows: intermediates carry the
    per-coordinate log-Jacobian, and equality is identity of the wrapped net
    plus hyperparameters."""

    domain = real_vector
    codomain = real_vector

    def __call__(self, x):
        y, _ = self.call_with_intermediates(x)
        return y

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        if intermediates is None:
            _, intermediates = self.call_with_intermediates(x)
        return intermediates.sum(-1)

    def __eq__(self, other):
        if type(other) is not type(self):
            return False
        # aux layout: (data_fields, aux_fields, aux_values); the wrapped net
        # is always the first aux field and compares by identity
        mine = self._pytree_flatten()[1][2]
        theirs = other._pytree_flatten()[1][2]
        return mine[0] is theirs[0] and mine[1:] == theirs[1:]


class InverseAutoregressiveTransform(_NeuralFlow):
    """Inverse Autoregressive Flow (Kingma et al., arXiv:1606.04934, Eq 10):
    ``y = mu(x) + sigma(x) * x`` with a MADE conditioner.  The log-scale is
    windowed to ``[min_clip, max_clip]`` with a straight-through gradient."""

    pytree_aux_fields = ("arn", "log_scale_min_clip", "log_scale_max_clip")

    def __init__(self, autoregressive_nn, log_scale_min_clip=-5.0, log_scale_max_clip=3.0):
        self.arn = autoregressive_nn
        self.log_scale_min_clip = log_scale_min_clip
        self.log_scale_max_clip = log_scale_max_clip

    def _shift_and_logscale(self, x):
        shift, raw = self.arn(x)
        windowed = jnp.clip(raw, self.log_scale_min_clip, self.log_scale_max_clip)
        # straight-through: clip the value, keep the unclipped gradient
        return shift, raw + lax.stop_gradient(windowed - raw)

    def call_with_intermediates(self, x):
        shift, log_scale = self._shift_and_logscale(x)
        return x * jnp.exp(log_scale) + shift, log_scale

    def _inverse(self, y):
        # Autoregressivity makes the inverse triangular: coordinate d of x
        # depends only on x[:d], so d sweeps converge exactly.
        def sweep(_, x):
            shift, log_scale = self._shift_and_logscale(x)
            return (y - shift) * jnp.exp(-log_scale)

        return lax.fori_loop(0, y.shape[-1], sweep, jnp.zeros_like(y))


class BlockNeuralAutoregressiveTransform(_NeuralFlow):
    """Block Neural Autoregressive Flow (De Cao, Titov & Aziz).  No analytic
    inverse — use for guides, not likelihoods."""

    pytree_aux_fields = ("bn_arn",)

    def __init__(self, bn_arn):
        self.bn_arn = bn_arn

    def call_with_intermediates(self, x):
        return self.bn_arn(x)

    def _inverse(self, y):
        raise NotImplementedError(
            "BlockNeuralAutoregressiveTransform has no analytic inverse."
        )
