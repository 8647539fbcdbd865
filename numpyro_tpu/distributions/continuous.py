"""Continuous distributions.

Accelerator-first implementations with the same API surface as
numpyro/distributions/continuous.py.  Samplers use jax.random primitives
(threefry counter-based — identical draws regardless of chain layout, the
property the chain-massive engine relies on for reproducibility across
shardings); log-densities are closed-form jnp, batched over arbitrary
leading axes so a (num_chains, ...) prefix compiles to one fused kernel.

Architecture note: the scalar location-scale families (Normal, Cauchy,
Laplace, Gumbel, Logistic, StudentT, SoftLaplace) derive from one
``_LocScale`` base that owns the affine bookkeeping; each family only
supplies its *standardized* kernel (z-density, z-cdf, z-quantile, z-moments).
The half-distributions share a fold-at-zero base the same way.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, random
from jax.nn import sigmoid, softplus
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import (
    betainc,
    betaln,
    digamma,
    gammainc,
    gammaln,
    log_ndtr,
    logit,
    multigammaln,
    ndtr,
    ndtri,
    xlog1py,
    xlogy,
)

from . import constraints
from .distribution import Distribution, TransformedDistribution
from .transforms import (
    AffineTransform,
    ExpTransform,
    PowerTransform,
)
from .util import (
    add_diag,
    betaincinv,
    clamp_probs,
    gammaincinv,
    lazy_property,
    matrix_to_tril_vec,
    promote_shapes,
    validate_sample,
    vec_to_tril_matrix,
)

__all__ = [
    "AsymmetricLaplace",
    "Beta",
    "Cauchy",
    "Chi2",
    "Dirichlet",
    "Exponential",
    "Gamma",
    "GaussianRandomWalk",
    "Gumbel",
    "HalfCauchy",
    "HalfNormal",
    "InverseGamma",
    "Kumaraswamy",
    "Laplace",
    "LKJ",
    "LKJCholesky",
    "Logistic",
    "LogNormal",
    "LogUniform",
    "LowRankMultivariateNormal",
    "MultivariateNormal",
    "MultivariateStudentT",
    "Normal",
    "Pareto",
    "StudentT",
    "Uniform",
    "Weibull",
    "Wishart",
    "WishartCholesky",
]

_LOG_SQRT_2PI = 0.9189385332046727  # log sqrt(2*pi)
_LOG_2 = 0.6931471805599453
_HALF_PI2 = jnp.pi * jnp.pi / 6.0


# ---------------------------------------------------------------------------
# Location-scale machinery


class _LocScale(Distribution):
    """x = loc + scale * z for a fixed standardized kernel z.

    Subclasses define the z-law through ``_z_*`` hooks; the base owns every
    affine consequence (sampling, density shift, cdf/icdf, moments,
    entropy)."""

    arg_constraints = dict(loc=constraints.real, scale=constraints.positive)
    support = constraints.real
    reparametrized_params = ["loc", "scale"]

    # standardized moments; override per family (None -> nan)
    _z_mean = 0.0
    _z_var = 1.0

    def __init__(self, loc=0.0, scale=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale)

    def _standardize(self, x):
        return (x - self.loc) / self.scale

    def sample(self, key, sample_shape=()):
        target = sample_shape + self.batch_shape + self.event_shape
        return self.loc + self.scale * self._z_sample(key, target)

    @validate_sample
    def log_prob(self, value):
        return self._z_log_density(self._standardize(value)) - jnp.log(self.scale)

    def cdf(self, value):
        return self._z_cdf(self._standardize(value))

    def icdf(self, q):
        return self.loc + self.scale * self._z_icdf(q)

    @property
    def mean(self):
        zm = self._z_mean
        m = self.loc + self.scale * zm if zm is not None else jnp.nan
        return jnp.broadcast_to(m, self.batch_shape)

    @property
    def variance(self):
        zv = self._z_var
        v = jnp.square(self.scale) * zv if zv is not None else jnp.nan
        return jnp.broadcast_to(v, self.batch_shape)

    def _z_entropy(self):
        raise NotImplementedError

    def entropy(self):
        return jnp.broadcast_to(
            self._z_entropy() + jnp.log(self.scale), self.batch_shape
        )


class Normal(_LocScale):
    def _z_sample(self, key, shape):
        return random.normal(key, shape)

    def _z_log_density(self, z):
        return -0.5 * jnp.square(z) - _LOG_SQRT_2PI

    def _z_cdf(self, z):
        return ndtr(z)

    def _z_icdf(self, q):
        return ndtri(q)

    def log_cdf(self, value):
        return log_ndtr(self._standardize(value))

    def _z_entropy(self):
        return 0.5 + _LOG_SQRT_2PI


class Cauchy(_LocScale):
    _z_mean = None
    _z_var = None

    def _z_sample(self, key, shape):
        return random.cauchy(key, shape)

    def _z_log_density(self, z):
        return -jnp.log(jnp.pi) - jnp.log1p(jnp.square(z))

    def _z_cdf(self, z):
        return 0.5 + jnp.arctan(z) / jnp.pi

    def _z_icdf(self, q):
        return jnp.tan(jnp.pi * (q - 0.5))

    def _z_entropy(self):
        return jnp.log(4.0 * jnp.pi)


class Laplace(_LocScale):
    _z_var = 2.0

    def _z_sample(self, key, shape):
        return random.laplace(key, shape)

    def _z_log_density(self, z):
        return -jnp.abs(z) - _LOG_2

    def _z_cdf(self, z):
        return 0.5 - 0.5 * jnp.sign(z) * jnp.expm1(-jnp.abs(z))

    def _z_icdf(self, q):
        half = q - 0.5
        return -jnp.sign(half) * jnp.log1p(-2.0 * jnp.abs(half))

    def _z_entropy(self):
        return 1.0 + _LOG_2


class Gumbel(_LocScale):
    _z_mean = float(np.euler_gamma)
    _z_var = float(_HALF_PI2)

    def _z_sample(self, key, shape):
        return random.gumbel(key, shape)

    def _z_log_density(self, z):
        return -z - jnp.exp(-z)

    def _z_cdf(self, z):
        return jnp.exp(-jnp.exp(-z))

    def _z_icdf(self, q):
        return -jnp.log(-jnp.log(q))

    def _z_entropy(self):
        return 1.0 + float(np.euler_gamma)


class Logistic(_LocScale):
    _z_var = float(jnp.pi**2 / 3.0)

    def _z_sample(self, key, shape):
        return random.logistic(key, shape)

    def _z_log_density(self, z):
        return -z - 2.0 * softplus(-z)

    def _z_cdf(self, z):
        return sigmoid(z)

    def _z_icdf(self, q):
        return logit(q)

    def _z_entropy(self):
        return 2.0


class SoftLaplace(_LocScale):
    """Smooth log-convex density with Laplace-like tails (infinitely
    differentiable — well-suited to HMC).  Kernel: f(z) = 1/(π cosh z)."""

    _z_var = float(jnp.pi**2 / 4.0)

    def __init__(self, loc, scale, *, validate_args=None):
        super().__init__(loc, scale, validate_args=validate_args)

    def _z_sample(self, key, shape):
        tiny = jnp.finfo(jnp.result_type(float)).tiny
        u = random.uniform(key, shape, minval=tiny)
        return self._z_icdf(u)

    def _z_log_density(self, z):
        # f(z) = 1/(π cosh z):  log 2 − log π − log(2 cosh z)
        return _LOG_2 - jnp.log(jnp.pi) - jnp.logaddexp(z, -z)

    def _z_cdf(self, z):
        return jnp.arctan(jnp.exp(z)) * (2.0 / jnp.pi)

    def _z_icdf(self, q):
        return jnp.log(jnp.tan(jnp.pi * q / 2.0))


class StudentT(_LocScale):
    arg_constraints = dict(
        df=constraints.positive, loc=constraints.real, scale=constraints.positive
    )
    reparametrized_params = ["df", "loc", "scale"]

    def __init__(self, df, loc=0.0, scale=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, df=df, loc=loc, scale=scale)

    @property
    def _z_mean(self):
        return jnp.where(self.df > 1.0, 0.0, jnp.nan)

    @property
    def _z_var(self):
        heavy = jnp.where(self.df > 2.0, self.df / (self.df - 2.0), jnp.inf)
        return jnp.where(self.df > 1.0, heavy, jnp.nan)

    def _z_sample(self, key, shape):
        k_eps, k_mix = random.split(key)
        eps = random.normal(k_eps, shape)
        denom = random.chisquare(k_mix, self.df, shape)
        return eps * jnp.sqrt(self.df / denom)

    def _z_log_density(self, z):
        half_df = 0.5 * self.df
        log_norm = 0.5 * jnp.log(self.df) + betaln(half_df, 0.5)
        return -(half_df + 0.5) * jnp.log1p(jnp.square(z) / self.df) - log_norm

    def _z_cdf(self, z):
        tail_x = self.df / (self.df + jnp.square(z))
        tail = 0.5 * betainc(0.5 * self.df, 0.5, tail_x)
        return jnp.where(z < 0, tail, 1.0 - tail)

    def icdf(self, q):
        raise NotImplementedError

    def _z_entropy(self):
        half_df = 0.5 * self.df
        half_up = half_df + 0.5
        return (
            half_up * (digamma(half_up) - digamma(half_df))
            + 0.5 * jnp.log(self.df)
            + betaln(half_df, 0.5)
        )


# ---------------------------------------------------------------------------
# Half (folded-at-zero) distributions


class _FoldedAtZero(Distribution):
    """|X| for a zero-centred symmetric loc-scale X; subclass sets _full_cls."""

    arg_constraints = dict(scale=constraints.positive)
    support = constraints.positive
    reparametrized_params = ["scale"]

    def __init__(self, scale=1.0, *, validate_args=None):
        self._mirror = self._full_cls(0.0, scale)
        self.scale = scale
        super().__init__(jnp.shape(scale), validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        return jnp.abs(self._mirror.sample(key, sample_shape))

    @validate_sample
    def log_prob(self, value):
        return _LOG_2 + self._mirror.log_prob(value)

    def cdf(self, value):
        return 2.0 * self._mirror.cdf(value) - 1.0

    def icdf(self, q):
        return self._mirror.icdf(0.5 * (1.0 + q))


class HalfCauchy(_FoldedAtZero):
    _full_cls = Cauchy
    pytree_data_fields = ("_mirror", "scale")

    @property
    def mean(self):
        return jnp.full(self.batch_shape, jnp.inf)

    @property
    def variance(self):
        return jnp.full(self.batch_shape, jnp.inf)


class HalfNormal(_FoldedAtZero):
    _full_cls = Normal
    pytree_data_fields = ("_mirror", "scale")

    @property
    def mean(self):
        return self.scale * math.sqrt(2.0 / math.pi)

    @property
    def variance(self):
        return jnp.square(self.scale) * (1.0 - 2.0 / jnp.pi)

    def entropy(self):
        return 0.5 + 0.5 * jnp.log(0.5 * jnp.pi) + jnp.log(self.scale)


# ---------------------------------------------------------------------------
# Interval / positive-support families


class Uniform(Distribution):
    arg_constraints = dict(
        low=constraints.dependent(is_discrete=False, event_dim=0),
        high=constraints.dependent(is_discrete=False, event_dim=0),
    )
    reparametrized_params = ["low", "high"]
    pytree_data_fields = ("low", "high", "_support")

    def __init__(self, low=0.0, high=1.0, *, validate_args=None):
        self._support = constraints.interval(low, high)
        self._init_broadcast(validate_args, low=low, high=high)

    @property
    def support(self):
        return self._support

    def _width(self):
        return self.high - self.low

    def sample(self, key, sample_shape=()):
        u = random.uniform(key, shape=sample_shape + self.batch_shape)
        return self.low + u * self._width()

    @validate_sample
    def log_prob(self, value):
        # broadcast against the live parameter shapes, not the cached
        # batch_shape: under vmap_over the per-lane params are sliced while
        # the aux batch_shape is stale
        live = lax.broadcast_shapes(jnp.shape(self.low), jnp.shape(self.high))
        out = lax.broadcast_shapes(jnp.shape(value), live)
        return jnp.broadcast_to(-jnp.log(self._width()), out)

    def cdf(self, value):
        return jnp.clip((value - self.low) / self._width(), 0.0, 1.0)

    def icdf(self, value):
        return self.low + value * self._width()

    @property
    def mean(self):
        return jnp.broadcast_to(0.5 * (self.high + self.low), self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(jnp.square(self._width()) / 12.0, self.batch_shape)

    def entropy(self):
        return jnp.broadcast_to(jnp.log(self._width()), self.batch_shape)


class Exponential(Distribution):
    arg_constraints = dict(rate=constraints.positive)
    support = constraints.positive
    reparametrized_params = ["rate"]

    def __init__(self, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, rate=rate)

    def sample(self, key, sample_shape=()):
        target = sample_shape + self.batch_shape + self.event_shape
        return random.exponential(key, shape=target) / self.rate

    @validate_sample
    def log_prob(self, value):
        return jnp.log(self.rate) - self.rate * value

    def cdf(self, value):
        return -jnp.expm1(-self.rate * value)

    def icdf(self, q):
        return -jnp.log1p(-q) / self.rate

    @property
    def mean(self):
        return jnp.broadcast_to(jnp.reciprocal(self.rate), self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(jnp.reciprocal(jnp.square(self.rate)), self.batch_shape)

    def entropy(self):
        return jnp.broadcast_to(1.0 - jnp.log(self.rate), self.batch_shape)


class Gamma(Distribution):
    arg_constraints = dict(
        concentration=constraints.positive, rate=constraints.positive
    )
    support = constraints.positive
    reparametrized_params = ["concentration", "rate"]

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, rate=rate)

    def sample(self, key, sample_shape=()):
        target = sample_shape + self.batch_shape + self.event_shape
        return random.gamma(key, self.concentration, shape=target) / self.rate

    @validate_sample
    def log_prob(self, value):
        a, beta = self.concentration, self.rate
        return xlogy(a - 1.0, value) - beta * value + xlogy(a, beta) - gammaln(a)

    @property
    def mean(self):
        return jnp.broadcast_to(self.concentration / self.rate, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(
            self.concentration / jnp.square(self.rate), self.batch_shape
        )

    def cdf(self, x):
        return gammainc(self.concentration, self.rate * x)

    def icdf(self, q):
        return gammaincinv(self.concentration, q) / self.rate

    def entropy(self):
        a = self.concentration
        ent = a - jnp.log(self.rate) + gammaln(a) + (1.0 - a) * digamma(a)
        return jnp.broadcast_to(ent, self.batch_shape)


class Chi2(Gamma):
    arg_constraints = dict(df=constraints.positive)
    reparametrized_params = ["df"]

    def __init__(self, df, *, validate_args=None):
        self.df = df
        super().__init__(0.5 * df, 0.5, validate_args=validate_args)


class InverseGamma(TransformedDistribution):
    arg_constraints = dict(
        concentration=constraints.positive, rate=constraints.positive
    )
    reparametrized_params = ["concentration", "rate"]
    support = constraints.positive
    pytree_data_fields = ("concentration", "rate")

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        gamma = Gamma(concentration, rate)
        self.concentration = gamma.concentration
        self.rate = gamma.rate
        super().__init__(gamma, PowerTransform(-1.0), validate_args=validate_args)

    @property
    def mean(self):
        a = self.concentration
        return jnp.where(a > 1.0, self.rate / (a - 1.0), jnp.inf)

    @property
    def variance(self):
        a = self.concentration
        spread = jnp.square(self.rate / (a - 1.0)) / (a - 2.0)
        return jnp.where(a > 2.0, spread, jnp.inf)

    def entropy(self):
        a, b = self.concentration, self.rate
        return a + jnp.log(b) + gammaln(a) - (1.0 + a) * digamma(a)

    def cdf(self, x):
        return 1.0 - self.base_dist.cdf(jnp.reciprocal(x))


class Beta(Distribution):
    arg_constraints = dict(
        concentration1=constraints.positive, concentration0=constraints.positive
    )
    reparametrized_params = ["concentration1", "concentration0"]
    support = constraints.unit_interval

    def __init__(self, concentration1, concentration0, *, validate_args=None):
        self._init_broadcast(
            validate_args,
            concentration1=concentration1,
            concentration0=concentration0,
        )

    def sample(self, key, sample_shape=()):
        draw = random.beta(
            key,
            self.concentration1,
            self.concentration0,
            shape=sample_shape + self.batch_shape,
        )
        return clamp_probs(draw)

    @validate_sample
    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        return xlogy(a - 1.0, value) + xlog1py(b - 1.0, -value) - betaln(a, b)

    @property
    def mean(self):
        a, b = self.concentration1, self.concentration0
        return jnp.broadcast_to(a / (a + b), self.batch_shape)

    @property
    def variance(self):
        a, b = self.concentration1, self.concentration0
        s = a + b
        return jnp.broadcast_to((a / s) * (b / s) / (s + 1.0), self.batch_shape)

    def cdf(self, value):
        return betainc(self.concentration1, self.concentration0, value)

    def icdf(self, q):
        return betaincinv(self.concentration1, self.concentration0, q)

    def entropy(self):
        a, b = self.concentration1, self.concentration0
        s = a + b
        return (
            betaln(a, b)
            + (s - 2.0) * digamma(s)
            - (a - 1.0) * digamma(a)
            - (b - 1.0) * digamma(b)
        )


class Dirichlet(Distribution):
    arg_constraints = dict(
        concentration=constraints.independent(constraints.positive, 1)
    )
    reparametrized_params = ["concentration"]
    support = constraints.simplex

    def __init__(self, concentration, *, validate_args=None):
        if jnp.ndim(concentration) == 0:
            raise ValueError("concentration must be at least one-dimensional")
        self._init_broadcast(
            validate_args,
            event_shape=jnp.shape(concentration)[-1:],
            event_dims={"concentration": 1},
            concentration=concentration,
        )

    def sample(self, key, sample_shape=()):
        draws = random.dirichlet(
            key, self.concentration, shape=sample_shape + self.batch_shape
        )
        eps = jnp.finfo(draws.dtype)
        return jnp.clip(draws, eps.tiny, 1.0 - eps.eps)

    @validate_sample
    def log_prob(self, value):
        alpha = self.concentration
        log_norm = gammaln(alpha).sum(-1) - gammaln(alpha.sum(-1))
        return xlogy(alpha - 1.0, value).sum(-1) - log_norm

    @property
    def mean(self):
        return self.concentration / self.concentration.sum(-1, keepdims=True)

    @property
    def variance(self):
        a = self.concentration
        tot = a.sum(-1, keepdims=True)
        return a * (tot - a) / (jnp.square(tot) * (tot + 1.0))

    def entropy(self):
        a = self.concentration
        tot = a.sum(-1)
        k = a.shape[-1]
        log_norm = gammaln(a).sum(-1) - gammaln(tot)
        return (
            log_norm
            + (tot - k) * digamma(tot)
            - ((a - 1.0) * digamma(a)).sum(-1)
        )


class LogNormal(TransformedDistribution):
    arg_constraints = dict(loc=constraints.real, scale=constraints.positive)
    support = constraints.positive
    reparametrized_params = ["loc", "scale"]
    pytree_data_fields = ("loc", "scale")

    def __init__(self, loc=0.0, scale=1.0, *, validate_args=None):
        gaussian = Normal(loc, scale)
        self.loc, self.scale = gaussian.loc, gaussian.scale
        super().__init__(gaussian, ExpTransform(), validate_args=validate_args)

    @property
    def mean(self):
        return jnp.exp(self.loc + 0.5 * jnp.square(self.scale))

    @property
    def variance(self):
        s2 = jnp.square(self.scale)
        return jnp.expm1(s2) * jnp.exp(2.0 * self.loc + s2)

    def entropy(self):
        return 0.5 + _LOG_SQRT_2PI + self.loc + jnp.log(self.scale)

    def cdf(self, x):
        return self.base_dist.cdf(jnp.log(x))


class LogUniform(TransformedDistribution):
    arg_constraints = dict(low=constraints.positive, high=constraints.positive)
    reparametrized_params = ["low", "high"]
    pytree_data_fields = ("low", "high", "_support")

    def __init__(self, low, high, *, validate_args=None):
        flat = Uniform(jnp.log(low), jnp.log(high))
        self.low, self.high = promote_shapes(low, high)
        self._support = constraints.interval(self.low, self.high)
        super().__init__(flat, ExpTransform(), validate_args=validate_args)

    @property
    def support(self):
        return self._support

    def _log_span(self):
        return jnp.log(self.high) - jnp.log(self.low)

    @property
    def mean(self):
        return (self.high - self.low) / self._log_span()

    @property
    def variance(self):
        span = self._log_span()
        sq_avg = 0.5 * (self.high + self.low) * (self.high - self.low) / span
        return sq_avg - jnp.square((self.high - self.low) / span)

    def entropy(self):
        return 0.5 * jnp.log(self.low * self.high) + jnp.log(self._log_span())

    def cdf(self, x):
        return self.base_dist.cdf(jnp.log(x))


class AsymmetricLaplace(Distribution):
    arg_constraints = dict(
        loc=constraints.real,
        scale=constraints.positive,
        asymmetry=constraints.positive,
    )
    support = constraints.real
    reparametrized_params = ["loc", "scale", "asymmetry"]

    def __init__(self, loc=0.0, scale=1.0, asymmetry=1.0, *, validate_args=None):
        self._init_broadcast(
            validate_args, loc=loc, scale=scale, asymmetry=asymmetry
        )

    @lazy_property
    def left_scale(self):
        return self.scale * self.asymmetry

    @lazy_property
    def right_scale(self):
        return self.scale / self.asymmetry

    def log_prob(self, value):
        if self._validate_args:
            self._validate_sample(value)
        gap = value - self.loc
        side_scale = jnp.where(gap < 0.0, self.left_scale, self.right_scale)
        return -jnp.abs(gap) / side_scale - jnp.log(
            self.left_scale + self.right_scale
        )

    def sample(self, key, sample_shape=()):
        target = sample_shape + self.batch_shape + self.event_shape
        exp_l, exp_r = random.exponential(key, shape=(2,) + target)
        return self.loc + self.right_scale * exp_r - self.left_scale * exp_l

    @property
    def mean(self):
        drift = self.right_scale - self.left_scale
        return jnp.broadcast_to(self.loc + drift, self.batch_shape)

    @property
    def variance(self):
        l, r = self.left_scale, self.right_scale
        tot = l + r
        # var of a two-sided exponential mixture with weights l/tot, r/tot
        mix = (l / tot) * (r / tot) * jnp.square(tot)
        return jnp.broadcast_to(
            jnp.square(l) * l / tot + jnp.square(r) * r / tot + mix,
            self.batch_shape,
        )

    def cdf(self, value):
        gap = value - self.loc
        ksq = jnp.square(self.asymmetry)
        left_mass = ksq / (1.0 + ksq)
        upper = 1.0 - jnp.exp(-jnp.abs(gap) / self.right_scale) / (1.0 + ksq)
        lower = left_mass * jnp.exp(-jnp.abs(gap) / self.left_scale)
        return jnp.where(gap >= 0.0, upper, lower)

    def icdf(self, value):
        ksq = jnp.square(self.asymmetry)
        left_mass = ksq / (1.0 + ksq)
        below = self.loc + self.left_scale * jnp.log(value / left_mass)
        above = self.loc - self.right_scale * jnp.log((1.0 - value) * (1.0 + ksq))
        return jnp.where(value <= left_mass, below, above)


class Pareto(TransformedDistribution):
    arg_constraints = dict(scale=constraints.positive, alpha=constraints.positive)
    reparametrized_params = ["scale", "alpha"]
    pytree_data_fields = ("scale", "alpha")

    def __init__(self, scale, alpha, *, validate_args=None):
        self.scale, self.alpha = promote_shapes(scale, alpha)
        batch = lax.broadcast_shapes(jnp.shape(scale), jnp.shape(alpha))
        chain = [
            ExpTransform(),
            AffineTransform(loc=0, scale=jnp.broadcast_to(scale, batch)),
        ]
        super().__init__(
            Exponential(jnp.broadcast_to(alpha, batch)),
            chain,
            validate_args=validate_args,
        )

    @property
    def mean(self):
        heavy = self.alpha * self.scale / (self.alpha - 1.0)
        return jnp.where(self.alpha > 1.0, heavy, jnp.inf)

    @property
    def variance(self):
        a = self.alpha
        heavy = jnp.square(self.scale / (a - 1.0)) * a / (a - 2.0)
        return jnp.where(a > 2.0, heavy, jnp.inf)

    @property
    def support(self):
        return constraints.greater_than(self.scale)

    def entropy(self):
        return 1.0 + jnp.log(self.scale / self.alpha) + jnp.reciprocal(self.alpha)

    def cdf(self, value):
        return 1.0 - jnp.power(self.scale / value, self.alpha)

    def icdf(self, q):
        return self.scale * jnp.power(1.0 - q, -jnp.reciprocal(self.alpha))


class Weibull(Distribution):
    arg_constraints = dict(
        scale=constraints.positive, concentration=constraints.positive
    )
    support = constraints.positive
    reparametrized_params = ["scale", "concentration"]

    def __init__(self, scale, concentration, *, validate_args=None):
        self._init_broadcast(
            validate_args, concentration=concentration, scale=scale
        )

    def sample(self, key, sample_shape=()):
        return random.weibull_min(
            key,
            scale=self.scale,
            concentration=self.concentration,
            shape=sample_shape + self.batch_shape,
        )

    @validate_sample
    def log_prob(self, value):
        k = self.concentration
        scaled = value / self.scale
        return (
            jnp.log(k / self.scale)
            + xlogy(k - 1.0, scaled)
            - jnp.power(scaled, k)
        )

    def cdf(self, value):
        return -jnp.expm1(-jnp.power(value / self.scale, self.concentration))

    def _scaled_gamma(self, order):
        return jnp.exp(gammaln(1.0 + order / self.concentration))

    @property
    def mean(self):
        return self.scale * self._scaled_gamma(1.0)

    @property
    def variance(self):
        g1, g2 = self._scaled_gamma(1.0), self._scaled_gamma(2.0)
        return jnp.square(self.scale) * (g2 - jnp.square(g1))

    def entropy(self):
        k = self.concentration
        return float(np.euler_gamma) * (1.0 - 1.0 / k) + jnp.log(self.scale / k) + 1.0


class Kumaraswamy(Distribution):
    arg_constraints = dict(
        concentration1=constraints.positive, concentration0=constraints.positive
    )
    reparametrized_params = ["concentration1", "concentration0"]
    support = constraints.unit_interval
    # number of KL-style reparam gradient terms; mirrors reference knob
    KL_KUMARASWAMY_BETA_TAYLOR_ORDER = 10

    def __init__(self, concentration1, concentration0, *, validate_args=None):
        self._init_broadcast(
            validate_args,
            concentration1=concentration1,
            concentration0=concentration0,
        )

    def sample(self, key, sample_shape=()):
        u = clamp_probs(random.uniform(key, sample_shape + self.batch_shape))
        # inverse CDF: (1 - u^{1/b})^{1/a}, evaluated in log space
        inner = jnp.log1p(-jnp.power(u, 1.0 / self.concentration0))
        draw = jnp.exp(inner / self.concentration1)
        eps = jnp.finfo(u)
        return jnp.clip(draw, eps.tiny, 1.0 - eps.eps)

    @validate_sample
    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        return (
            jnp.log(a * b)
            + xlogy(a - 1.0, value)
            + xlog1py(b - 1.0, -jnp.power(value, a))
        )

    def _raw_moment(self, order):
        return self.concentration0 * jnp.exp(
            betaln(1.0 + order / self.concentration1, self.concentration0)
        )

    @property
    def mean(self):
        return self._raw_moment(1.0)

    @property
    def variance(self):
        return self._raw_moment(2.0) - jnp.square(self._raw_moment(1.0))
# ---------------------------------------------------------------------------
# Multivariate families
#
# Shared linear-algebra shorthands: matrix transpose, triangular log-det,
# matrix-vector product on trailing dims.


def _mT(x):
    return jnp.swapaxes(x, -1, -2)


def _tril_logdet(tril):
    """sum log diag — half log-det of tril @ trilᵀ."""
    return jnp.log(jnp.diagonal(tril, axis1=-2, axis2=-1)).sum(-1)


def _mat_vec(m, v):
    return (m @ v[..., None])[..., 0]


def _batch_mahalanobis(bL, bx):
    """Batched squared Mahalanobis distance: x^T (L L^T)^{-1} x.

    Solves L y = x with a triangular solve over arbitrary broadcast batch
    shapes — the MVN hot path, maps to batched trsm on the tensor cores.
    """
    if bL.shape[:-1] == bx.shape:
        solve_bL_bx = solve_triangular(bL, bx[..., None], lower=True)
        return jnp.sum(solve_bL_bx**2, axis=(-1, -2))

    # When a single L is shared across a large sample batch (the MVN
    # posterior-predictive hot path), solve all samples in one trsm call:
    # reshape samples to columns of a matrix.
    if bL.ndim == 2:
        y = solve_triangular(bL, bx.reshape(-1, bx.shape[-1]).T, lower=True)
        return jnp.sum(y**2, axis=0).reshape(bx.shape[:-1])

    # general broadcasting case: align batch dims, let XLA's batched
    # triangular solve handle it (broadcast_to is fused, not materialized,
    # when it feeds a batched solve)
    out_shape = jnp.broadcast_shapes(bx.shape[:-1], bL.shape[:-2])
    n = bx.shape[-1]
    bx_b = jnp.broadcast_to(bx, out_shape + (n,))
    bL_b = jnp.broadcast_to(bL, out_shape + (n, n))
    y = solve_triangular(bL_b, bx_b[..., None], lower=True)
    return jnp.sum(y**2, axis=(-1, -2))


class MultivariateNormal(Distribution):
    arg_constraints = {
        "loc": constraints.real_vector,
        "covariance_matrix": constraints.positive_definite,
        "precision_matrix": constraints.positive_definite,
        "scale_tril": constraints.lower_cholesky,
    }
    support = constraints.real_vector
    reparametrized_params = [
        "loc",
        "covariance_matrix",
        "precision_matrix",
        "scale_tril",
    ]
    pytree_data_fields = ("loc", "scale_tril")

    def __init__(
        self,
        loc=0.0,
        covariance_matrix=None,
        precision_matrix=None,
        scale_tril=None,
        validate_args=None,
    ):
        if jnp.ndim(loc) == 0:
            (loc,) = promote_shapes(loc, shape=(1,))
        # align loc (..., D) against (..., D, D) matrices via a dummy axis
        col = loc[..., jnp.newaxis]
        if covariance_matrix is not None:
            col, self.covariance_matrix = promote_shapes(col, covariance_matrix)
            self.scale_tril = jnp.linalg.cholesky(self.covariance_matrix)
        elif precision_matrix is not None:
            from .util import cholesky_of_inverse

            col, self.precision_matrix = promote_shapes(col, precision_matrix)
            self.scale_tril = cholesky_of_inverse(self.precision_matrix)
        elif scale_tril is not None:
            col, self.scale_tril = promote_shapes(col, scale_tril)
        else:
            raise ValueError(
                "One of covariance_matrix, precision_matrix, scale_tril must be specified."
            )
        self.loc = col[..., 0]
        batch = lax.broadcast_shapes(
            jnp.shape(col)[:-2], jnp.shape(self.scale_tril)[:-2]
        )
        super().__init__(
            batch_shape=batch,
            event_shape=jnp.shape(self.scale_tril)[-1:],
            validate_args=validate_args,
        )

    def sample(self, key, sample_shape=()):
        white = random.normal(
            key, shape=sample_shape + self.batch_shape + self.event_shape
        )
        return self.loc + _mat_vec(self.scale_tril, white)

    @validate_sample
    def log_prob(self, value):
        quad = _batch_mahalanobis(self.scale_tril, value - self.loc)
        dim = self.scale_tril.shape[-1]
        return -0.5 * (quad + dim * jnp.log(2.0 * jnp.pi)) - _tril_logdet(
            self.scale_tril
        )

    @lazy_property
    def covariance_matrix(self):
        return self.scale_tril @ _mT(self.scale_tril)

    @lazy_property
    def precision_matrix(self):
        eye = jnp.broadcast_to(
            jnp.eye(self.scale_tril.shape[-1]), self.scale_tril.shape
        )
        root_inv = solve_triangular(self.scale_tril, eye, lower=True)
        return _mT(root_inv) @ root_inv

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.shape())

    @property
    def variance(self):
        return jnp.broadcast_to(
            jnp.square(self.scale_tril).sum(-1), self.batch_shape + self.event_shape
        )

    def entropy(self):
        dim = self.event_shape[-1]
        gauss = 0.5 * dim * (1.0 + jnp.log(2.0 * jnp.pi))
        return jnp.broadcast_to(
            gauss + _tril_logdet(self.scale_tril), self.batch_shape
        )


class MultivariateStudentT(Distribution):
    arg_constraints = {
        "df": constraints.positive,
        "loc": constraints.real_vector,
        "scale_tril": constraints.lower_cholesky,
    }
    support = constraints.real_vector
    reparametrized_params = ["df", "loc", "scale_tril"]

    def __init__(self, df, loc=0.0, scale_tril=None, *, validate_args=None):
        if jnp.ndim(loc) == 0:
            (loc,) = promote_shapes(loc, shape=(1,))
        self._init_broadcast(
            validate_args,
            event_shape=jnp.shape(scale_tril)[-1:],
            event_dims={"loc": 1, "scale_tril": 2},
            df=df,
            loc=loc,
            scale_tril=scale_tril,
        )

    def sample(self, key, sample_shape=()):
        k_gauss, k_mix = random.split(key)
        batched = sample_shape + self.batch_shape
        white = random.normal(k_gauss, shape=batched + self.event_shape)
        mix = random.chisquare(k_mix, self.df, shape=batched)
        heavy = white * jnp.sqrt(self.df / mix)[..., None]
        return self.loc + _mat_vec(self.scale_tril, heavy)

    @validate_sample
    def log_prob(self, value):
        dim = self.scale_tril.shape[-1]
        quad = _batch_mahalanobis(self.scale_tril, value - self.loc)
        half_sum = 0.5 * (self.df + dim)
        return (
            gammaln(half_sum)
            - gammaln(0.5 * self.df)
            - 0.5 * dim * jnp.log(self.df * jnp.pi)
            - _tril_logdet(self.scale_tril)
            - half_sum * jnp.log1p(quad / self.df)
        )

    @property
    def mean(self):
        df_col = jnp.expand_dims(self.df, -1)
        return jnp.broadcast_to(
            jnp.where(df_col > 1.0, self.loc, jnp.nan), self.shape()
        )

    @property
    def variance(self):
        df_col = jnp.expand_dims(self.df, -1)
        cov_diag = jnp.square(self.scale_tril).sum(-1)
        heavy = jnp.where(df_col > 2.0, cov_diag * df_col / (df_col - 2.0), jnp.inf)
        return jnp.broadcast_to(
            jnp.where(df_col > 1.0, heavy, jnp.nan),
            self.batch_shape + self.event_shape,
        )


class LowRankMultivariateNormal(Distribution):
    """MVN with covariance = cov_factor @ cov_factor.T + diag(cov_diag).

    log_prob uses the Woodbury identity / matrix-determinant lemma so cost is
    O(D K^2) not O(D^3) — a matmul-dominant form that rides the tensor cores.
    """

    arg_constraints = {
        "loc": constraints.real_vector,
        "cov_factor": constraints.independent(constraints.real, 2),
        "cov_diag": constraints.independent(constraints.positive, 1),
    }
    support = constraints.real_vector
    reparametrized_params = ["loc", "cov_factor", "cov_diag"]

    def __init__(self, loc, cov_factor, cov_diag, *, validate_args=None):
        if jnp.ndim(loc) < 1:
            raise ValueError("`loc` must be at least one-dimensional.")
        dim = jnp.shape(loc)[-1:]
        if jnp.ndim(cov_factor) < 2 or jnp.shape(cov_factor)[-2:-1] != dim:
            raise ValueError("`cov_factor` must have shape (..., D, K)")
        if jnp.shape(cov_diag)[-1:] != dim:
            raise ValueError("`cov_diag` must have shape (..., D)")
        loc_col, factor, diag_col = promote_shapes(
            loc[..., None], cov_factor, cov_diag[..., None]
        )
        self.loc = loc_col[..., 0]
        self.cov_factor = factor
        self.cov_diag = diag_col[..., 0]
        batch = lax.broadcast_shapes(
            jnp.shape(loc_col), jnp.shape(factor), jnp.shape(diag_col)
        )[:-2]
        super().__init__(
            batch_shape=batch, event_shape=dim, validate_args=validate_args
        )

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.shape())

    @lazy_property
    def variance(self):
        marginal = jnp.square(self.cov_factor).sum(-1) + self.cov_diag
        return jnp.broadcast_to(marginal, self.batch_shape + self.event_shape)

    @lazy_property
    def _whitened_factor(self):
        """W^T D^{-1}: the K x D workhorse of every Woodbury formula here."""
        return _mT(self.cov_factor) / self.cov_diag[..., None, :]

    @lazy_property
    def _capacitance_tril(self):
        # K x K: chol(I + W^T D^{-1} W)
        cap = self._whitened_factor @ self.cov_factor
        cap = add_diag(cap, jnp.ones(cap.shape[-1], dtype=cap.dtype))
        return jnp.linalg.cholesky(cap)

    @lazy_property
    def scale_tril(self):
        return jnp.linalg.cholesky(self.covariance_matrix)

    @lazy_property
    def covariance_matrix(self):
        return add_diag(self.cov_factor @ _mT(self.cov_factor), self.cov_diag)

    @lazy_property
    def precision_matrix(self):
        # Woodbury: D^-1 - D^-1 W (I + W^T D^-1 W)^-1 W^T D^-1
        half = solve_triangular(
            self._capacitance_tril, self._whitened_factor, lower=True
        )
        inv_diag = jnp.reciprocal(self.cov_diag)
        diag_mat = inv_diag[..., None] * jnp.identity(
            self.loc.shape[-1], dtype=inv_diag.dtype
        )
        return diag_mat - _mT(half) @ half

    def sample(self, key, sample_shape=()):
        k_low, k_diag = random.split(key)
        batched = sample_shape + self.batch_shape
        eps_low = random.normal(k_low, batched + self.cov_factor.shape[-1:])
        eps_diag = random.normal(k_diag, batched + self.event_shape)
        return (
            self.loc
            + _mat_vec(self.cov_factor, eps_low)
            + jnp.sqrt(self.cov_diag) * eps_diag
        )

    def _half_log_det(self):
        # matrix-determinant lemma: log|C| = log|cap| + log|D|
        return _tril_logdet(self._capacitance_tril) + 0.5 * jnp.log(
            self.cov_diag
        ).sum(-1)

    @validate_sample
    def log_prob(self, value):
        gap = value - self.loc
        projected = _mat_vec(self._whitened_factor, gap)
        # solve_triangular does not broadcast batch dims: align the factor
        # with the (possibly sample-batched) right-hand side
        cap = jnp.broadcast_to(
            self._capacitance_tril,
            projected.shape[:-1] + self._capacitance_tril.shape[-2:],
        )
        correction = solve_triangular(cap, projected[..., None], lower=True)[..., 0]
        quad = (jnp.square(gap) / self.cov_diag).sum(-1) - jnp.square(
            correction
        ).sum(-1)
        dim = self.loc.shape[-1]
        return -0.5 * (dim * jnp.log(2.0 * jnp.pi) + quad) - self._half_log_det()

    def entropy(self):
        dim = self.loc.shape[-1]
        gauss = 0.5 * dim * (1.0 + jnp.log(2.0 * jnp.pi))
        return jnp.broadcast_to(gauss + self._half_log_det(), self.batch_shape)


class GaussianRandomWalk(Distribution):
    """A length-T Gaussian random walk as one event — the canonical long-
    latent time-series prior (stochastic volatility).  log_prob is the sum of
    increment normals: O(T), fully vectorized, no scan."""

    arg_constraints = {"scale": constraints.positive}
    support = constraints.real_vector
    reparametrized_params = ["scale"]
    pytree_aux_fields = ("num_steps",)

    def __init__(self, scale=1.0, num_steps=1, *, validate_args=None):
        if not (isinstance(num_steps, int) and num_steps > 0):
            raise AssertionError(
                "`num_steps` argument should be a positive integer."
            )
        self.scale = scale
        self.num_steps = num_steps
        super().__init__(
            jnp.shape(scale), (num_steps,), validate_args=validate_args
        )

    def sample(self, key, sample_shape=()):
        steps = random.normal(
            key, shape=sample_shape + self.batch_shape + self.event_shape
        )
        return jnp.expand_dims(self.scale, -1) * jnp.cumsum(steps, axis=-1)

    @validate_sample
    def log_prob(self, value):
        # increments (incl. the first step from 0) are iid N(0, scale)
        increments = jnp.diff(
            value, axis=-1, prepend=jnp.zeros_like(value[..., :1])
        )
        z = increments / jnp.expand_dims(self.scale, -1)
        per_step = -0.5 * jnp.square(z) - _LOG_SQRT_2PI - jnp.expand_dims(
            jnp.log(jnp.broadcast_to(self.scale, self.batch_shape)), -1
        )
        return per_step.sum(-1)

    @property
    def mean(self):
        return jnp.zeros(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        growth = jnp.arange(1, self.num_steps + 1)
        return jnp.broadcast_to(
            jnp.expand_dims(jnp.square(self.scale), -1) * growth,
            self.batch_shape + self.event_shape,
        )


class LKJCholesky(Distribution):
    """LKJ prior over Cholesky factors of correlation matrices.

    Sampling uses the onion method (fully batched); density matches the
    reference (numpyro/distributions/continuous.py:1090).
    """

    arg_constraints = {"concentration": constraints.positive}
    support = constraints.corr_cholesky
    reparametrized_params = ["concentration"]
    pytree_data_fields = (
        "concentration",
        "_beta_concentration0",
        "_beta_concentration1",
    )
    pytree_aux_fields = ("dimension", "sample_method")

    def __init__(
        self, dimension=2, concentration=1.0, sample_method="onion", *, validate_args=None
    ):
        if dimension < 2:
            raise ValueError("Dimension must be greater than or equal to 2.")
        self.dimension = dimension
        self.concentration = concentration

        # per-row Beta parameters (Lewandowski, Kurowicka & Joe 2009)
        rows = dimension - 1
        marginal = concentration + 0.5 * (dimension - 2)
        ladder = 0.5 * jnp.arange(rows)
        if sample_method == "onion":
            self._beta_concentration0 = jnp.expand_dims(marginal, -1) - ladder
            self._beta_concentration1 = ladder + 0.5
        elif sample_method == "cvine":
            ladder_tril = matrix_to_tril_vec(
                jnp.broadcast_to(ladder, (rows, rows)), diagonal=0
            )
            both = jnp.expand_dims(marginal, -1) - ladder_tril
            self._beta_concentration0 = both
            self._beta_concentration1 = both
        else:
            raise ValueError("`method` should be one of 'cvine' or 'onion'.")
        self.sample_method = sample_method
        super().__init__(
            jnp.shape(concentration),
            (dimension, dimension),
            validate_args=validate_args,
        )

    def _onion(self, key, size):
        k_radius, k_dir = random.split(key)
        d = self.dimension
        # beta draws give the squared norm of each new row's off-diag part
        radius_sq = random.beta(
            k_radius,
            self._beta_concentration1,
            self._beta_concentration0,
            shape=size + self._beta_concentration0.shape,
        )
        # directions: normalized gaussians, packed row-by-row in a tril
        raw = random.normal(k_dir, shape=size + (d * (d - 1) // 2,))
        tril = vec_to_tril_matrix(raw, diagonal=0)
        directions = tril / jnp.linalg.norm(tril, axis=-1, keepdims=True)
        # first row normalizes an empty slice -> nan; zero it
        directions = jnp.nan_to_num(directions)
        body = jnp.sqrt(radius_sq)[..., None] * directions

        # embed into D x D below the diagonal, then fill the diagonal so
        # each row has unit norm
        pad = [(0, 0)] * (body.ndim - 2) + [(1, 0), (0, 1)]
        body = jnp.pad(body, pad)
        diag = jnp.sqrt(jnp.clip(1.0 - jnp.square(body).sum(-1), 0.0))
        return body + diag[..., None] * jnp.identity(d)

    def _cvine(self, key):  # pragma: no cover - onion is the default
        raise NotImplementedError

    def sample(self, key, sample_shape=()):
        return self._onion(key, sample_shape + self.batch_shape)

    @validate_sample
    def log_prob(self, value):
        diag = jnp.diagonal(value, axis1=-2, axis2=-1)[..., 1:]
        # unnormalized: sum over rows i>=2 of (D - i + 2(eta - 1)) log L_ii
        row = jnp.arange(2, self.dimension + 1, dtype=diag.dtype)
        eta = jnp.expand_dims(jnp.asarray(self.concentration), -1)
        exponent = self.dimension - row + 2.0 * (eta - 1.0)
        unnorm = (exponent * jnp.log(diag)).sum(-1)

        # normalization (reference formula, LKJ 2009 Thm 5)
        rows = self.dimension - 1
        alpha = self.concentration + 0.5 * rows
        log_norm = (
            0.5 * rows * jnp.log(jnp.pi)
            + multigammaln(alpha - 0.5, rows)
            - rows * gammaln(alpha)
        )
        return unnorm - log_norm

    @property
    def mean(self):
        return jnp.broadcast_to(
            jnp.identity(self.dimension),
            self.batch_shape + (self.dimension, self.dimension),
        )


class LKJ(TransformedDistribution):
    """LKJ prior over full correlation matrices."""

    arg_constraints = {"concentration": constraints.positive}
    reparametrized_params = ["concentration"]
    support = constraints.corr_matrix
    pytree_aux_fields = ("dimension", "sample_method")

    def __init__(
        self, dimension=2, concentration=1.0, sample_method="onion", *, validate_args=None
    ):
        from .transforms import CorrMatrixCholeskyTransform

        self.dimension = dimension
        self.concentration = concentration
        self.sample_method = sample_method
        super().__init__(
            LKJCholesky(dimension, concentration, sample_method),
            CorrMatrixCholeskyTransform().inv,
            validate_args=validate_args,
        )

    @property
    def mean(self):
        return jnp.broadcast_to(
            jnp.identity(self.dimension),
            self.batch_shape + (self.dimension, self.dimension),
        )


class Wishart(TransformedDistribution):
    arg_constraints = {
        "concentration": constraints.dependent(is_discrete=False),
        "scale_matrix": constraints.positive_definite,
        "rate_matrix": constraints.positive_definite,
        "scale_tril": constraints.lower_cholesky,
    }
    support = constraints.positive_definite
    reparametrized_params = ["scale_matrix", "rate_matrix", "scale_tril"]

    def __init__(
        self,
        concentration,
        scale_matrix=None,
        rate_matrix=None,
        scale_tril=None,
        *,
        validate_args=None,
    ):
        from .transforms import CholeskyTransform

        super().__init__(
            WishartCholesky(concentration, scale_matrix, rate_matrix, scale_tril),
            CholeskyTransform().inv,
            validate_args=validate_args,
        )

    @property
    def concentration(self):
        return self.base_dist.concentration

    @property
    def scale_tril(self):
        return self.base_dist.scale_tril

    @property
    def mean(self):
        root = self.scale_tril
        return self.concentration[..., None, None] * (root @ _mT(root))


class WishartCholesky(Distribution):
    """Cholesky factor of a Wishart via the Bartlett decomposition."""

    arg_constraints = {
        "concentration": constraints.dependent(is_discrete=False),
        "scale_matrix": constraints.positive_definite,
        "rate_matrix": constraints.positive_definite,
        "scale_tril": constraints.lower_cholesky,
    }
    support = constraints.lower_cholesky
    reparametrized_params = ["scale_matrix", "rate_matrix", "scale_tril"]
    pytree_data_fields = ("concentration", "scale_tril")

    def __init__(
        self,
        concentration,
        scale_matrix=None,
        rate_matrix=None,
        scale_tril=None,
        *,
        validate_args=None,
    ):
        if scale_matrix is not None:
            root = jnp.linalg.cholesky(scale_matrix)
        elif rate_matrix is not None:
            from .util import cholesky_of_inverse

            root = cholesky_of_inverse(rate_matrix)
        elif scale_tril is not None:
            root = scale_tril
        else:
            raise ValueError(
                "One of scale_matrix, rate_matrix, scale_tril must be specified."
            )
        self._init_broadcast(
            validate_args,
            event_shape=jnp.shape(root)[-2:],
            event_dims={"scale_tril": 2},
            concentration=concentration,
            scale_tril=root,
        )

    def sample(self, key, sample_shape=()):
        k_offdiag, k_diag = random.split(key)
        d = self.event_shape[-1]
        batched = sample_shape + self.batch_shape
        # Bartlett: A lower-triangular with N(0,1) below diag, sqrt(chi2) on diag
        below = vec_to_tril_matrix(
            random.normal(k_offdiag, batched + (d * (d - 1) // 2,)), diagonal=-1
        )
        dof_ladder = (
            jnp.expand_dims(jnp.asarray(self.concentration), -1) - jnp.arange(d)
        )
        diag_sq = random.chisquare(k_diag, dof_ladder, shape=batched + (d,))
        bartlett = below + jnp.sqrt(diag_sq)[..., None] * jnp.identity(d)
        return self.scale_tril @ bartlett

    @validate_sample
    def log_prob(self, value):
        d = self.event_shape[-1]
        df = self.concentration
        # Wishart density of W = L Lᵀ, plus the L -> W Jacobian
        # log|W| and log|S|^{1/2} from triangular diagonals
        value_logdiag = jnp.log(jnp.diagonal(value, axis1=-2, axis2=-1))
        w_logdet = 2.0 * value_logdiag.sum(-1)
        s_half_logdet = _tril_logdet(self.scale_tril)
        # trace(S^{-1} W) = || L_S^{-1} L ||_F^2
        whitened = solve_triangular(
            jnp.broadcast_to(self.scale_tril, value.shape), value, lower=True
        )
        trace_term = jnp.square(whitened).sum((-2, -1))
        wishart_ld = (
            0.5 * (df - d - 1.0) * w_logdet
            - 0.5 * trace_term
            - 0.5 * df * d * jnp.log(2.0)
            - df * s_half_logdet
            - multigammaln(0.5 * df, d)
        )
        row = jnp.arange(1, d + 1, dtype=value_logdiag.dtype)
        jacobian = d * jnp.log(2.0) + ((d - row + 1.0) * value_logdiag).sum(-1)
        return wishart_ld + jacobian

    @property
    def mean(self):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Additional continuous families (reference: numpyro/distributions/continuous.py
# — EulerMaruyama :327, GaussianStateSpace :558, Gompertz :818, MatrixNormal
# :1443, CAR :1698, RelaxedBernoulliLogits :2268, SoftLaplace :2287,
# BetaProportion :2535, AsymmetricLaplaceQuantile :2565, ZeroSumNormal :2627,
# Levy :2978, CirculantNormal :3076).  Implemented accelerator-first: dense linear
# algebra, lax.scan for recurrences, FFT diagonalization for circulant
# covariance — no sparse host paths.
# ---------------------------------------------------------------------------


class Gompertz(Distribution):
    """Gompertz distribution: CDF ``1 - exp(-con * expm1(rate * x))``."""

    arg_constraints = dict(
        concentration=constraints.positive, rate=constraints.positive
    )
    support = constraints.positive
    reparametrized_params = ["concentration", "rate"]

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, rate=rate)

    def sample(self, key, sample_shape=()):
        u = random.uniform(key, shape=sample_shape + self.batch_shape)
        return self.icdf(u)

    @validate_sample
    def log_prob(self, value):
        grown = value * self.rate
        hazard = jnp.log(self.concentration * self.rate) + grown
        return hazard - self.concentration * jnp.expm1(grown)

    def cdf(self, value):
        return -jnp.expm1(-self.concentration * jnp.expm1(value * self.rate))

    def icdf(self, q):
        return jnp.log1p(-jnp.log1p(-q) / self.concentration) / self.rate

    @property
    def mean(self):
        from jax.scipy.special import expi

        c = self.concentration
        return -jnp.exp(c) * expi(-c) / self.rate


class Levy(Distribution):
    """Lévy distribution (alpha-stable with alpha=1/2, beta=1)."""

    arg_constraints = dict(loc=constraints.positive, scale=constraints.positive)

    def __init__(self, loc, scale, *, validate_args=None):
        self._support = constraints.greater_than(loc)
        self._init_broadcast(validate_args, loc=loc, scale=scale)

    @constraints.dependent_property(is_discrete=False)
    def support(self):
        return self._support

    @validate_sample
    def log_prob(self, value):
        gap = value - self.loc
        return (
            0.5 * jnp.log(self.scale / (2.0 * jnp.pi))
            - 0.5 * self.scale / gap
            - 1.5 * jnp.log(gap)
        )

    def sample(self, key, sample_shape=()):
        u = random.uniform(key, shape=sample_shape + self.batch_shape)
        return self.icdf(u)

    def icdf(self, q):
        folded = ndtri(1.0 - 0.5 * q)
        return self.loc + self.scale / jnp.square(folded)

    def cdf(self, value):
        standardized = self.scale / (value - self.loc)
        return 2.0 * (1.0 - ndtr(jnp.sqrt(standardized)))

    @property
    def mean(self):
        return jnp.full(self.batch_shape, jnp.inf)

    @property
    def variance(self):
        return jnp.full(self.batch_shape, jnp.inf)


class BetaProportion(Beta):
    """Beta reparameterized by variate mean and precision (Ferrari &
    Cribari-Neto 2004)."""

    arg_constraints = dict(
        mean=constraints.open_interval(0.0, 1.0),
        concentration=constraints.positive,
    )
    reparametrized_params = ["mean", "concentration"]
    support = constraints.unit_interval
    pytree_data_fields = ("concentration",)

    def __init__(self, mean, concentration, *, validate_args=None):
        self.concentration = jnp.asarray(concentration)
        super().__init__(
            concentration * mean,
            concentration * (1.0 - mean),
            validate_args=validate_args,
        )


class AsymmetricLaplaceQuantile(Distribution):
    """AsymmetricLaplace parameterized by the quantile (Bayesian quantile
    regression parameterization)."""

    arg_constraints = dict(
        loc=constraints.real,
        scale=constraints.positive,
        quantile=constraints.open_interval(0.0, 1.0),
    )
    reparametrized_params = ["loc", "scale", "quantile"]
    support = constraints.real
    pytree_data_fields = ("loc", "scale", "quantile", "_ald")

    def __init__(self, loc=0.0, scale=1.0, quantile=0.5, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale, quantile=quantile)
        kappa = jnp.sqrt(quantile / (1.0 - quantile))
        self._ald = AsymmetricLaplace(
            loc=loc, scale=scale * kappa / quantile, asymmetry=kappa
        )

    def log_prob(self, value):
        if self._validate_args:
            self._validate_sample(value)
        return self._ald.log_prob(value)

    def sample(self, key, sample_shape=()):
        return self._ald.sample(key, sample_shape=sample_shape)

    @property
    def mean(self):
        return self._ald.mean

    @property
    def variance(self):
        return self._ald.variance

    def cdf(self, value):
        return self._ald.cdf(value)

    def icdf(self, value):
        return self._ald.icdf(value)


class RelaxedBernoulliLogits(TransformedDistribution):
    """Continuous relaxation of Bernoulli (Concrete distribution)."""

    arg_constraints = dict(temperature=constraints.positive, logits=constraints.real)
    support = constraints.unit_interval

    def __init__(self, temperature, logits, *, validate_args=None):
        from .transforms import SigmoidTransform

        self.temperature, self.logits = promote_shapes(temperature, logits)
        inv_temp = jnp.reciprocal(temperature)
        super().__init__(
            Logistic(logits * inv_temp, inv_temp),
            [SigmoidTransform()],
            validate_args=validate_args,
        )


def RelaxedBernoulli(temperature, probs=None, logits=None, *, validate_args=None):
    from .util import assert_one_of, probs_to_logits

    assert_one_of(probs=probs, logits=logits)
    if probs is not None:
        logits = probs_to_logits(probs, is_binary=True)
    return RelaxedBernoulliLogits(temperature, logits, validate_args=validate_args)


class ZeroSumNormal(TransformedDistribution):
    """Normal with one or more event axes constrained to sum to zero
    (PyMC-style, via an orthonormal Householder basis — see ZeroSumTransform)."""

    arg_constraints = dict(scale=constraints.positive)
    reparametrized_params = ["scale"]

    def __init__(self, scale, event_shape, *, validate_args=None):
        from .transforms import ZeroSumTransform

        ndim = len(event_shape)
        reduced = tuple(size - 1 for size in event_shape)
        self.scale = scale
        super().__init__(
            Normal(0, scale).expand(reduced).to_event(ndim),
            ZeroSumTransform(ndim),
            validate_args=validate_args,
        )

    @constraints.dependent_property(is_discrete=False)
    def support(self):
        return constraints.zero_sum(len(self.event_shape))

    @property
    def mean(self):
        return jnp.zeros(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        shrink = 1.0
        for size in self.event_shape:
            shrink = shrink * (1.0 - 1.0 / size)
        return jnp.broadcast_to(
            jnp.square(self.scale) * shrink, self.batch_shape + self.event_shape
        )


class MatrixNormal(Distribution):
    """Matrix-variate normal with row/column scale Cholesky factors:
    vec(X) ~ MVN(vec(loc), kron(V, U)) with U = R Rᵀ, V = C Cᵀ."""

    arg_constraints = {
        "loc": constraints.real_vector,
        "scale_tril_row": constraints.lower_cholesky,
        "scale_tril_column": constraints.lower_cholesky,
    }
    support = constraints.real_matrix
    reparametrized_params = ["loc", "scale_tril_row", "scale_tril_column"]

    def __init__(self, loc, scale_tril_row, scale_tril_column, validate_args=None):
        self._init_broadcast(
            validate_args,
            event_shape=jnp.shape(loc)[-2:],
            event_dims={"loc": 2, "scale_tril_row": 2, "scale_tril_column": 2},
            loc=loc,
            scale_tril_row=scale_tril_row,
            scale_tril_column=scale_tril_column,
        )

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.shape())

    def sample(self, key, sample_shape=()):
        white = random.normal(
            key, shape=sample_shape + self.batch_shape + self.event_shape
        )
        return self.loc + self.scale_tril_row @ white @ _mT(self.scale_tril_column)

    @validate_sample
    def log_prob(self, values):
        n, p = self.event_shape
        log_norm = (
            p * _tril_logdet(self.scale_tril_row)
            + n * _tril_logdet(self.scale_tril_column)
            + 0.5 * n * p * jnp.log(2.0 * jnp.pi)
        )

        def whiten(tril, rhs):
            batch = lax.broadcast_shapes(tril.shape[:-2], rhs.shape[:-2])
            tril = jnp.broadcast_to(tril, batch + tril.shape[-2:])
            rhs = jnp.broadcast_to(rhs, batch + rhs.shape[-2:])
            return solve_triangular(tril, rhs, lower=True)

        gap = values - self.loc
        row_white = whiten(self.scale_tril_row, gap)
        both_white = whiten(self.scale_tril_column, _mT(row_white))
        return -0.5 * jnp.square(both_white).sum((-2, -1)) - log_norm


class CAR(Distribution):
    """Conditional autoregressive distribution — MVN whose precision is
    structured by a site-adjacency matrix (dense path; precision-based
    log_prob needs no Cholesky of the full covariance)."""

    arg_constraints = {
        "loc": constraints.real_vector,
        "correlation": constraints.open_interval(-1, 1),
        "conditional_precision": constraints.positive,
        "adj_matrix": constraints.dependent(is_discrete=False, event_dim=2),
    }
    support = constraints.real_vector
    reparametrized_params = [
        "loc",
        "correlation",
        "conditional_precision",
        "adj_matrix",
    ]
    pytree_aux_fields = ("is_sparse",)
    pytree_data_fields = ("loc", "correlation", "conditional_precision", "adj_matrix")

    def __init__(
        self,
        loc,
        correlation,
        conditional_precision,
        adj_matrix,
        *,
        is_sparse=False,
        validate_args=None,
    ):
        if is_sparse:
            raise NotImplementedError(
                "numpyro_tpu CAR uses the dense adjacency path: sparse "
                "gather/scatter does not map onto dense matmuls; pass a dense "
                "(batched) adjacency matrix."
            )
        if jnp.ndim(loc) == 0:
            (loc,) = promote_shapes(loc, shape=(1,))
        self.is_sparse = False
        self._init_broadcast(
            validate_args,
            event_shape=jnp.shape(adj_matrix)[-1:],
            event_dims={"loc": 1, "adj_matrix": 2},
            loc=loc,
            correlation=correlation,
            conditional_precision=conditional_precision,
            adj_matrix=adj_matrix,
        )

    def sample(self, key, sample_shape=()):
        mvn = MultivariateNormal(self.mean, precision_matrix=self.precision_matrix)
        return mvn.sample(key, sample_shape=sample_shape)

    @validate_sample
    def log_prob(self, value):
        centered = value - self.loc
        adj = self.adj_matrix
        degree = adj.sum(axis=-1)
        # symmetric normalization D^{-1/2} A D^{-1/2} for the eigen-spectrum
        d_rsqrt = jnp.power(degree, -0.5)
        spectrum = jnp.linalg.eigvalsh(
            adj * (d_rsqrt[..., None, :] * d_rsqrt[..., None])
        )
        n = degree.shape[-1]
        rho = jnp.expand_dims(self.correlation, -1)
        log_det = (
            n * jnp.log(self.conditional_precision)
            + jnp.log1p(-rho * spectrum).sum(-1)
            + jnp.log(degree).sum(-1)
        )
        neighbor_sum = jnp.einsum("...ij,...j->...i", adj, centered)
        quad = self.conditional_precision * (
            centered * (degree * centered - rho * neighbor_sum)
        ).sum(-1)
        return 0.5 * (log_det - quad - n * jnp.log(2.0 * jnp.pi))

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.shape())

    @lazy_property
    def precision_matrix(self):
        degree = self.adj_matrix.sum(axis=-1)
        tau = jnp.expand_dims(self.conditional_precision, (-2, -1))
        rho = jnp.expand_dims(self.correlation, (-2, -1))
        eye = jnp.broadcast_to(
            jnp.eye(self.adj_matrix.shape[-1]), self.adj_matrix.shape
        )
        return tau * (degree[..., None] * eye - rho * self.adj_matrix)

    @staticmethod
    def infer_shapes(loc, correlation, conditional_precision, adj_matrix):
        return (
            lax.broadcast_shapes(
                loc[:-1], correlation, conditional_precision, adj_matrix[:-2]
            ),
            adj_matrix[-1:],
        )


class EulerMaruyama(Distribution):
    """Euler–Maruyama discretization of an SDE: the whole trajectory is one
    event; log_prob is a product of conditional Gaussian transition terms
    (fully vectorized — no sequential scan needed for density evaluation)."""

    arg_constraints = {"t": constraints.ordered_vector}
    pytree_data_fields = ("t", "init_dist")
    pytree_aux_fields = ("sde_fn",)

    def __init__(self, t, sde_fn, init_dist, *, validate_args=None):
        if not isinstance(init_dist, Distribution):
            raise TypeError("init_dist must be a Distribution instance")
        self.t = t
        self.sde_fn = sde_fn
        self.init_dist = init_dist
        batch = lax.broadcast_shapes(jnp.shape(t)[:-1], init_dist.batch_shape)
        event = (jnp.shape(t)[-1],) + init_dist.event_shape
        super().__init__(batch, event, validate_args=validate_args)

    @constraints.dependent_property(is_discrete=False)
    def support(self):
        return constraints.independent(constraints.real, self.event_dim)

    def _drift_diffusion(self, states, times, n_map_dims):
        """sde_fn mapped over n_map_dims leading axes of (states, times)."""
        fn = self.sde_fn
        for _ in range(n_map_dims):
            fn = jax.vmap(fn)
        return fn(states, times)

    def sample(self, key, sample_shape=()):
        batch = sample_shape + self.batch_shape
        n_steps = self.event_shape[0]

        def advance(state, inputs):
            noise, t_now, dt = inputs
            drift, diffusion = self.sde_fn(state, t_now)
            nxt = state + dt * drift + jnp.sqrt(dt) * diffusion * noise
            return nxt, nxt

        k_path, k_start = random.split(key)
        noise = random.normal(
            k_path, shape=batch + (n_steps - 1,) + self.event_shape[1:]
        )
        start = self.init_dist.expand(batch).sample(k_start)

        def one_path(x0, eps, t_head, dt):
            return lax.scan(advance, x0, (eps, t_head, dt))[1]

        grid = jnp.broadcast_to(self.t, batch + (n_steps,))
        if batch:

            def flat(a):
                return a.reshape((-1,) + a.shape[len(batch):])

            path = jax.vmap(one_path)(
                flat(start),
                flat(noise),
                flat(grid)[..., :-1],
                jnp.diff(flat(grid), axis=-1),
            )
            path = jnp.concatenate([flat(start)[:, None], path], axis=1)
            return path.reshape(batch + self.event_shape)
        path = one_path(start, noise, self.t[:-1], jnp.diff(self.t))
        return jnp.concatenate([start[None], path], axis=0)

    @validate_sample
    def log_prob(self, value):
        batch = lax.broadcast_shapes(
            value.shape[: value.ndim - self.event_dim], self.batch_shape
        )
        value = jnp.broadcast_to(value, batch + self.event_shape)
        n_steps = self.event_shape[0]
        grid = jnp.broadcast_to(self.t, batch + (n_steps,))

        # split the trajectory into transition pairs along the time axis
        time_axis = len(batch)
        prev = jax.lax.slice_in_dim(value, 0, n_steps - 1, axis=time_axis)
        curr = jax.lax.slice_in_dim(value, 1, n_steps, axis=time_axis)
        head_t = jax.lax.slice_in_dim(grid, 0, n_steps - 1, axis=-1)

        drift, diffusion = self._drift_diffusion(prev, head_t, len(batch) + 1)
        # drift/diffusion may be lower-rank than the state (scalar SDEs):
        # right-pad their shapes to align
        def align(a):
            missing = curr.ndim - a.ndim
            keep = len(batch) + 1
            return a.reshape(a.shape[:keep] + (1,) * missing + a.shape[keep:])

        drift, diffusion = align(drift), align(diffusion)
        dt = jnp.diff(self.t, axis=-1)
        dt = dt.reshape(dt.shape + (1,) * (self.event_dim - 1))
        step_mean = prev + dt * drift
        step_sd = jnp.sqrt(dt) * diffusion
        trans_ld = (
            Normal(step_mean, step_sd).to_event(self.event_dim).log_prob(curr)
        )
        x0 = jax.lax.index_in_dim(value, 0, axis=time_axis, keepdims=False)
        return trans_ld + self.init_dist.log_prob(x0)


class GaussianStateSpace(Distribution):
    """Linear-Gaussian state space model z_t = A z_{t-1} + eps_t, treated as
    one event of shape (num_steps, dim).  Because the map eps -> z is
    unit-Jacobian (lower-unitriangular block structure), log_prob is the
    innovations' MVN density — evaluated fully in parallel, no scan."""

    arg_constraints = {
        "covariance_matrix": constraints.positive_definite,
        "precision_matrix": constraints.positive_definite,
        "scale_tril": constraints.lower_cholesky,
        "transition_matrix": constraints.real_matrix,
    }
    support = constraints.real_matrix
    pytree_aux_fields = ("num_steps",)
    pytree_data_fields = ("transition_matrix", "scale_tril")

    def __init__(
        self,
        num_steps,
        transition_matrix,
        covariance_matrix=None,
        precision_matrix=None,
        scale_tril=None,
        *,
        validate_args=None,
    ):
        assert isinstance(num_steps, int) and num_steps > 0
        assert transition_matrix.ndim == 2
        self.num_steps = num_steps
        self.transition_matrix = transition_matrix
        # normalize innovation-noise parameterization to scale_tril
        noise = MultivariateNormal(
            covariance_matrix=covariance_matrix,
            precision_matrix=precision_matrix,
            scale_tril=scale_tril,
        )
        self.scale_tril = noise.scale_tril
        super().__init__(
            noise.batch_shape,
            (num_steps, transition_matrix.shape[-1]),
            validate_args=validate_args,
        )

    def _innovations(self, value):
        history = value[..., :-1, :]
        pushed = jnp.einsum("ij,...tj->...ti", self.transition_matrix, history)
        return jnp.concatenate(
            [value[..., :1, :], value[..., 1:, :] - pushed], axis=-2
        )

    def sample(self, key, sample_shape=()):
        white = random.normal(
            key, sample_shape + self.batch_shape + self.event_shape
        )
        noise_tril = (
            self.scale_tril
            if self.scale_tril.ndim == 2
            else self.scale_tril[..., None, :, :].squeeze(-3)
        )
        eps = jnp.einsum("...ij,...tj->...ti", noise_tril, white)

        def advance(state, shock):
            nxt = _mat_vec(self.transition_matrix, state) + shock
            return nxt, nxt

        # scan over time (the only sequential axis)
        shocks = jnp.moveaxis(eps, -2, 0)
        first = shocks[0]
        _, rest = lax.scan(advance, first, shocks[1:])
        path = jnp.concatenate([first[None], rest], axis=0)
        return jnp.moveaxis(path, 0, -2)

    @validate_sample
    def log_prob(self, value):
        innov = self._innovations(value)
        noise = MultivariateNormal(
            jnp.zeros(self.event_shape[-1]), scale_tril=self.scale_tril
        )
        return noise.log_prob(innov).sum(-1)

    @property
    def mean(self):
        return jnp.zeros(self.batch_shape + self.event_shape)

    @lazy_property
    def covariance_matrix(self):
        return self.scale_tril @ _mT(self.scale_tril)

    @property
    def variance(self):
        def push(carry, _):
            return self.transition_matrix @ carry, carry

        _, roots = lax.scan(push, self.scale_tril, jnp.arange(self.num_steps))
        marginal = jnp.diagonal(roots @ _mT(roots), axis1=-1, axis2=-2)
        return marginal.cumsum(axis=0).swapaxes(0, -2)


class CirculantNormal(Distribution):
    """Multivariate normal with positive-definite circulant covariance,
    diagonalized by the discrete Fourier transform: sampling and log_prob run
    in O(n log n) via rFFT — the natural stationary-covariance layout
    (reference: numpyro/distributions/continuous.py:3076, Wood & Chan 1994)."""

    arg_constraints = {
        "loc": constraints.real_vector,
        "covariance_row": constraints.positive_definite_circulant_vector,
        "covariance_rfft": constraints.independent(constraints.positive, 1),
    }
    support = constraints.real_vector
    pytree_data_fields = ("loc", "covariance_rfft")

    def __init__(self, loc, covariance_row=None, covariance_rfft=None, *, validate_args=None):
        assert jnp.ndim(loc) > 0
        n = jnp.shape(loc)[-1]
        from .util import assert_one_of

        assert_one_of(
            covariance_row=covariance_row, covariance_rfft=covariance_rfft
        )
        if covariance_rfft is None:
            assert covariance_row.shape[-1] == n
            loc, covariance_row = promote_shapes(loc, covariance_row)
            covariance_rfft = jnp.fft.rfft(covariance_row).real
            self.covariance_row = covariance_row
        else:
            batch = lax.broadcast_shapes(
                jnp.shape(loc)[:-1], jnp.shape(covariance_rfft)[:-1]
            )
            loc = jnp.broadcast_to(loc, batch + (n,))
            covariance_rfft = jnp.broadcast_to(
                covariance_rfft, batch + (n // 2 + 1,)
            )
        self.loc = loc
        self.covariance_rfft = covariance_rfft
        batch = lax.broadcast_shapes(
            jnp.shape(loc)[:-1], jnp.shape(covariance_rfft)[:-1]
        )
        super().__init__(batch, (n,), validate_args=validate_args)

    def _spectrum(self):
        """(eigenvalues of the covariance, rFFT bin weights, n).

        Real-FFT packing: interior bins represent a conjugate pair (weight
        2); DC — and Nyquist when n is even — appear once (weight 1)."""
        (n,) = self.event_shape
        lam = jnp.maximum(self.covariance_rfft, 0.0)
        weights = jnp.full(lam.shape[-1:], 2.0).at[0].set(1.0)
        if n % 2 == 0:
            weights = weights.at[-1].set(1.0)
        return lam, weights, n

    def sample(self, key, sample_shape=()):
        lam, _, n = self._spectrum()
        white = random.normal(key, sample_shape + self.batch_shape + (n,))
        # color white noise in the Fourier domain:
        # C^{1/2} = F* diag(sqrt(λ)) F / sqrt(n)
        colored = jnp.fft.irfft(jnp.fft.rfft(white) * jnp.sqrt(lam), n=n)
        return self.loc + colored

    @validate_sample
    def log_prob(self, value):
        lam, weights, n = self._spectrum()
        lam = jnp.maximum(lam, jnp.finfo(lam.dtype).tiny)
        power = jnp.square(jnp.abs(jnp.fft.rfft(value - self.loc)))
        quad = (weights * power / lam).sum(-1) / n
        half_log_det = 0.5 * (weights * jnp.log(lam)).sum(-1)
        return -0.5 * (n * jnp.log(2.0 * jnp.pi) + quad) - half_log_det

    @lazy_property
    def covariance_row(self):
        return jnp.fft.irfft(self.covariance_rfft, n=self.event_shape[-1])

    @lazy_property
    def covariance_matrix(self):
        (n,) = self.event_shape
        lag = (jnp.arange(n)[:, None] - jnp.arange(n)[None, :]) % n
        return self.covariance_row[..., lag]

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.shape())

    @lazy_property
    def variance(self):
        return jnp.broadcast_to(self.covariance_row[..., :1], self.shape())

    @staticmethod
    def infer_shapes(loc=(), covariance_row=None, covariance_rfft=None):
        from .util import assert_one_of

        assert_one_of(
            covariance_row=covariance_row, covariance_rfft=covariance_rfft
        )
        for cov in [covariance_rfft, covariance_row]:
            if cov is not None:
                return jnp.broadcast_shapes(loc[:-1], cov[:-1]), loc[-1:]

    def entropy(self):
        lam, weights, n = self._spectrum()
        lam = jnp.maximum(lam, jnp.finfo(lam.dtype).tiny)
        half_log_det = 0.5 * (weights * jnp.log(lam)).sum(-1)
        return 0.5 * n * (1.0 + jnp.log(2.0 * jnp.pi)) + half_log_det
