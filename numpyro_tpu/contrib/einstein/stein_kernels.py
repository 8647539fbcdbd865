"""Stein kernels for SteinVI/SVGD.

Reference surface: numpyro/contrib/einstein/stein_kernels.py:57-465.  Each
kernel exposes ``compute(rng_key, particles, particle_info, loss_fn) ->
k(x, y)`` over flattened particle vectors; all pairwise math is batched
(C, C) vector/matrix work — the median-bandwidth heuristic is one sort over the
pairwise-distance matrix.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import random, vmap


def median_bandwidth(particles, factor_fn):
    """Median pairwise squared distance scaled by factor_fn(num_particles)."""
    diffs = particles[:, None, :] - particles[None, :, :]
    sq = jnp.sum(diffs**2, axis=-1)
    n = particles.shape[0]
    med = jnp.median(sq)
    bandwidth = jnp.abs(med) * factor_fn(n) + 1e-5
    return bandwidth


class SteinKernel:
    """Base kernel interface.  ``mode`` ∈ {"norm", "vector", "matrix"}
    controls the kernel's output structure."""

    @property
    def mode(self):
        return self._mode

    def compute(self, rng_key, particles, particle_info, loss_fn):
        raise NotImplementedError

    def init(self, rng_key, particles_shape):
        pass


class RBFKernel(SteinKernel):
    """Gaussian RBF with the median heuristic (Liu & Wang 2016)."""

    def __init__(
        self,
        mode="norm",
        matrix_mode="norm_diag",
        bandwidth_factor=lambda n: 1 / jnp.log(n),
    ):
        assert mode in ("norm", "vector", "matrix")
        assert matrix_mode in ("norm_diag", "vector_diag")
        self._mode = mode
        self.matrix_mode = matrix_mode
        self.bandwidth_factor = bandwidth_factor

    def compute(self, rng_key, particles, particle_info, loss_fn):
        bandwidth = median_bandwidth(particles, self.bandwidth_factor)

        def kernel(x, y):
            reduce = jnp.sum if self._mode == "norm" else lambda v: v
            kv = jnp.exp(-reduce((x - y) ** 2) / bandwidth)
            if self._mode == "matrix":
                if self.matrix_mode == "norm_diag":
                    return kv * jnp.identity(x.shape[0])
                return jnp.diag(kv)
            return kv

        return kernel


class IMQKernel(SteinKernel):
    """Inverse multi-quadratic (c^2 + ||x-y||^2)^beta (Gorham & Mackey)."""

    def __init__(self, mode="norm", const=1.0, expon=-0.5):
        assert mode in ("norm", "vector")
        assert const > 0.0
        assert -1.0 < expon < 0.0
        self._mode = mode
        self.const = const
        self.expon = expon

    def compute(self, rng_key, particles, particle_info, loss_fn):
        def kernel(x, y):
            reduce = jnp.sum if self._mode == "norm" else lambda v: v
            return (self.const**2 + reduce((x - y) ** 2)) ** self.expon

        return kernel


class LinearKernel(SteinKernel):
    """x·y + 1 (Liu & Wang 2018)."""

    def __init__(self, mode="norm"):
        self._mode = "norm"

    def compute(self, rng_key, particles, particle_info, loss_fn):
        def kernel(x, y):
            return x @ y + 1

        return kernel


class RandomFeatureKernel(SteinKernel):
    """Random Fourier feature kernel (Liu & Wang 2018)."""

    def __init__(self, mode="norm", bandwidth_subset=None,
                 bandwidth_factor=lambda n: 1 / jnp.log(n)):
        assert bandwidth_subset is None or bandwidth_subset > 0
        self._mode = "norm"
        self.bandwidth_subset = bandwidth_subset
        self.bandwidth_factor = bandwidth_factor
        self._random_weights = None
        self._random_biases = None

    def init(self, rng_key, particles_shape):
        rng_key, w_key, b_key = random.split(rng_key, 3)
        self._random_weights = random.normal(w_key, shape=particles_shape)
        self._random_biases = random.uniform(
            b_key, shape=particles_shape, maxval=2 * np.pi
        )

    def compute(self, rng_key, particles, particle_info, loss_fn):
        if self._random_weights is None:
            self.init(rng_key, particles.shape)
        if self._random_weights.shape != particles.shape:
            self.init(rng_key, particles.shape)
        bandwidth = median_bandwidth(particles, self.bandwidth_factor)

        def feature(x, w, b):
            return jnp.sqrt(2) * jnp.cos((x @ w + b) / bandwidth)

        def kernel(x, y):
            ws = (
                self._random_weights
                if self.bandwidth_subset is None
                else self._random_weights[: self.bandwidth_subset]
            )
            bs = (
                self._random_biases
                if self.bandwidth_subset is None
                else self._random_biases[: self.bandwidth_subset]
            )
            return jnp.sum(
                vmap(lambda w, b: feature(x, w, b) * feature(y, w, b))(ws, bs)
            )

        return kernel


class MixtureKernel(SteinKernel):
    """Weighted sum of base kernels (Ai et al. 2018)."""

    def __init__(self, ws, kernel_fns, mode="norm"):
        assert len(ws) == len(kernel_fns) > 0
        self.ws = ws
        self.kernel_fns = kernel_fns
        self._mode = kernel_fns[0].mode

    def compute(self, rng_key, particles, particle_info, loss_fn):
        kernels = [
            kf.compute(rng_key, particles, particle_info, loss_fn)
            for kf in self.kernel_fns
        ]

        def kernel(x, y):
            res = self.ws[0] * kernels[0](x, y)
            for w, k in zip(self.ws[1:], kernels[1:]):
                res = res + w * k(x, y)
            return res

        return kernel


class GraphicalKernel(SteinKernel):
    """Blockwise (per-site) kernels combined into a block-diagonal matrix
    kernel (Wang, Zeng & Liu 2018)."""

    def __init__(self, mode="matrix", local_kernel_fns=None, default_kernel_fn=None):
        self._mode = "matrix"
        self.local_kernel_fns = local_kernel_fns or {}
        self.default_kernel_fn = default_kernel_fn or RBFKernel()

    def compute(self, rng_key, particles, particle_info, loss_fn):
        local_kernels = []
        for pk, (start, end) in particle_info.items():
            kf = self.local_kernel_fns.get(pk, self.default_kernel_fn)
            fn = kf.compute(
                rng_key, particles[:, start:end], {pk: (0, end - start)}, loss_fn
            )
            local_kernels.append((fn, kf.mode, start, end))

        def kernel(x, y):
            blocks = []
            for fn, mode, start, end in local_kernels:
                v = fn(x[start:end], y[start:end])
                if mode == "norm":
                    v = v * jnp.identity(end - start)
                elif mode == "vector":
                    v = jnp.diag(v)
                blocks.append(v)
            from jax.scipy.linalg import block_diag

            return block_diag(*blocks)

        return kernel


class ProbabilityProductKernel(SteinKernel):
    """Gaussian probability-product kernel over (loc, scale) guide particles
    (Jebara et al. 2004)."""

    def __init__(self, guide, scale=1.0, mode="norm"):
        self._mode = "norm"
        self.guide = guide
        self.scale = scale
        self._bias_name = f"{guide.prefix}_loc_bias"

    def compute(self, rng_key, particles, particle_info, loss_fn):
        loc_idx = jnp.concatenate(
            [
                jnp.arange(start, end)
                for name, (start, end) in particle_info.items()
                if name.endswith("_loc")
            ]
        )
        scale_idx = jnp.concatenate(
            [
                jnp.arange(start, end)
                for name, (start, end) in particle_info.items()
                if name.endswith("_scale")
            ]
        )

        def kernel(x, y):
            loc_x, scale_x = x[loc_idx], jnp.exp(x[scale_idx])
            loc_y, scale_y = y[loc_idx], jnp.exp(y[scale_idx])
            quad = (
                (loc_x / scale_x**2 + loc_y / scale_y**2) ** 2
                / (1 / scale_x**2 + 1 / scale_y**2)
                - (loc_x / scale_x) ** 2
                - (loc_y / scale_y) ** 2
            )
            return jnp.exp(0.5 * jnp.sum(quad))

        return kernel


class RadialGaussNewtonKernel(SteinKernel):
    """Radial kernel with a Gauss-Newton metric averaged over particles
    (Maken et al. 2022; Detommaso et al. 2018)."""

    def __init__(self):
        self._mode = "norm"

    def compute(self, rng_key, particles, particle_info, loss_fn):
        import jax

        def jac(p):
            return jax.jacfwd(loss_fn)(p)

        Js = vmap(jac)(particles)
        M = jnp.mean(vmap(lambda J: jnp.outer(J, J))(Js), axis=0)
        M = M + 1e-5 * jnp.eye(M.shape[-1])
        d = particles.shape[-1]

        def kernel(x, y):
            diff = x - y
            quad = diff @ M @ diff
            return jnp.exp(-quad / (2.0 * d))

        return kernel
