"""Gaussian copula distributions — couple the last batch axis of a
univariate marginal through a correlation structure.

Role parity: numpyro/distributions/copula.py:13-140.  The density is
evaluated through the probability-integral transform: marginal cdf →
standard-normal quantiles → correlated-Gaussian density, with the
independent standard-normal density divided back out.  Unlike the
reference (which builds a full MultivariateNormal internally), only the
Cholesky factor is kept and the copula term is computed directly from
one triangular solve — the MVN's mean/covariance machinery is
never materialized.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import ndtr, ndtri

from . import constraints
from .continuous import Beta
from .distribution import Distribution
from .util import clamp_probs, lazy_property, validate_sample

__all__ = ["GaussianCopula", "GaussianCopulaBeta"]


class GaussianCopula(Distribution):
    """Joint distribution with ``marginal_dist`` marginals (coupled along
    their last batch axis) and Gaussian-copula dependence.

    :param marginal_dist: univariate distribution for each coordinate.
    :param correlation_matrix: correlation matrix of the coupling.
    :param correlation_cholesky: Cholesky-factor alternative.
    """

    arg_constraints = {"correlation_matrix": constraints.corr_matrix, "correlation_cholesky": constraints.corr_cholesky}  # noqa: E501
    reparametrized_params = ["correlation_matrix", "correlation_cholesky"]
    pytree_data_fields = ("marginal_dist", "scale_tril")

    def __init__(self, marginal_dist, correlation_matrix=None, correlation_cholesky=None, *, validate_args=None):  # noqa: E501
        if marginal_dist.event_shape != ():
            raise ValueError("`marginal_dist` needs to be a univariate distribution.")
        if (correlation_matrix is None) == (correlation_cholesky is None):
            raise ValueError(
                "exactly one of correlation_matrix / correlation_cholesky is required"
            )
        # canonicalize to the Cholesky factor once; everything downstream
        # (sampling, density, both public properties) derives from it
        if correlation_cholesky is None:
            correlation_cholesky = jnp.linalg.cholesky(correlation_matrix)
        self.marginal_dist = marginal_dist
        self.scale_tril = correlation_cholesky
        dim = jnp.shape(correlation_cholesky)[-1]
        batch = lax.broadcast_shapes(marginal_dist.batch_shape[:-1], jnp.shape(correlation_cholesky)[:-2])  # noqa: E501
        super().__init__(batch_shape=batch, event_shape=(dim,), validate_args=validate_args)  # noqa: E501

    def _to_quantiles(self, value):
        """Per-coordinate standard-normal quantiles of the marginal cdf."""
        return ndtri(clamp_probs(self.marginal_dist.cdf(value)))

    def sample(self, key, sample_shape=()):
        import jax.random as random

        eps = random.normal(key, sample_shape + self.batch_shape + self.event_shape)
        correlated = jnp.einsum("...ij,...j->...i", self.scale_tril, eps)
        return self.marginal_dist.icdf(ndtr(correlated))

    @validate_sample
    def log_prob(self, value):
        q = self._to_quantiles(value)
        # copula term: N(q; 0, LL^T) / prod_i N(q_i; 0, 1), via one
        # triangular solve — the diagonal normalizers cancel except logdet
        tril = jnp.broadcast_to(
            self.scale_tril, q.shape[:-1] + self.scale_tril.shape[-2:]
        )
        white = solve_triangular(tril, q[..., None], lower=True)[..., 0]
        half_quad_delta = 0.5 * ((q**2).sum(-1) - (white**2).sum(-1))
        logdet = jnp.log(jnp.diagonal(self.scale_tril, axis1=-2, axis2=-1)).sum(-1)
        return self.marginal_dist.log_prob(value).sum(-1) + half_quad_delta - logdet

    @property
    def mean(self):
        return jnp.broadcast_to(self.marginal_dist.mean, self.shape())

    @property
    def variance(self):
        return jnp.broadcast_to(self.marginal_dist.variance, self.shape())

    @constraints.dependent_property(is_discrete=False, event_dim=1)
    def support(self):
        return constraints.independent(self.marginal_dist.support, 1)

    @lazy_property
    def correlation_matrix(self):
        tril = self.scale_tril
        return jnp.einsum("...ik,...jk->...ij", tril, tril)

    @lazy_property
    def correlation_cholesky(self):
        return self.scale_tril


class GaussianCopulaBeta(GaussianCopula):
    """Beta marginals under a Gaussian copula."""

    arg_constraints = {"concentration1": constraints.positive, "concentration0": constraints.positive, "correlation_matrix": constraints.corr_matrix, "correlation_cholesky": constraints.corr_cholesky}  # noqa: E501
    support = constraints.independent(constraints.unit_interval, 1)
    pytree_data_fields = ("concentration1", "concentration0")

    def __init__(self, concentration1, concentration0, correlation_matrix=None, correlation_cholesky=None, *, validate_args=False):  # noqa: E501
        self.concentration1, self.concentration0 = concentration1, concentration0
        marginals = Beta(concentration1, concentration0)
        super().__init__(marginals, correlation_matrix, correlation_cholesky, validate_args=validate_args)  # noqa: E501
