"""Discrete distributions.

Accelerator-first implementations with the API surface of
numpyro/distributions/discrete.py, reorganised so each probs/logits twin pair
shares one base class (the canonical parameterization is whichever the user
gave; the other is a cached lazy view).  ``enumerate_support`` returns the
full support stacked along a fresh leading dim — the contract the
enumeration engine (sum-product over reserved negative dims) builds on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random
from jax.nn import softmax, softplus
from jax.scipy.special import betaln, expit, gammainc, gammaln, logsumexp, xlog1py, xlogy

from . import constraints
from .distribution import Distribution
from .util import (
    binary_cross_entropy_with_logits,
    binomial,
    categorical,
    clamp_probs,
    lazy_property,
    multinomial,
    promote_shapes,
    validate_sample,
)

__all__ = [
    "Bernoulli",
    "BernoulliLogits",
    "BernoulliProbs",
    "Binomial",
    "BinomialLogits",
    "BinomialProbs",
    "Categorical",
    "CategoricalLogits",
    "CategoricalProbs",
    "DiscreteUniform",
    "Geometric",
    "GeometricLogits",
    "GeometricProbs",
    "Multinomial",
    "MultinomialLogits",
    "MultinomialProbs",
    "NegativeBinomial2",
    "OrderedLogistic",
    "Poisson",
    "ZeroInflatedPoisson",
]

_NN_INT = constraints.nonnegative_integer


def _sigmoid_pair(logits):
    """probs from bernoulli logits."""
    return expit(logits)


def _logit(probs):
    safe = clamp_probs(probs)
    return jnp.log(safe) - jnp.log1p(-safe)


def _log_simplex(probs):
    floor = jnp.finfo(jnp.result_type(probs, float)).min
    return jnp.clip(jnp.log(probs), floor)


def _enum_range(count, batch_shape, expand, start=0):
    """Support values stacked on a fresh leading axis of length ``count``."""
    vals = (start + jnp.arange(count)).reshape((-1,) + (1,) * len(batch_shape))
    if expand:
        vals = jnp.broadcast_to(vals, (int(count),) + batch_shape)
    return vals


def _homogeneous_int(param, what):
    """Static scalar value of a (possibly array) parameter, or raise."""
    if isinstance(param, jax.core.Tracer):
        raise NotImplementedError(
            f"enumerate_support requires a static {what}, got a traced value"
        )
    arr = np.asarray(param)
    if arr.min() != arr.max():
        raise NotImplementedError(
            f"Inhomogeneous {what} not supported by `enumerate_support`."
        )
    return int(arr.max())


def _log_binom_coeff(n, k):
    """log C(n, k) through the beta function: 1/((n+1) B(n-k+1, k+1))."""
    n = jnp.asarray(n, dtype=jnp.result_type(float))
    return -jnp.log1p(n) - betaln(n - k + 1.0, k + 1.0)


def _twin_factory(probs_cls, logits_cls, name):
    """The pyro-style dispatching constructor shared by every twin pair."""

    def make(probs=None, logits=None, *, validate_args=None, **kw):
        if (probs is None) == (logits is None):
            raise ValueError("One of `probs` or `logits` must be specified.")
        cls, param = (
            (probs_cls, probs) if probs is not None else (logits_cls, logits)
        )
        return cls(param, validate_args=validate_args, **kw)

    make.__name__ = make.__qualname__ = name
    return make


# -- Bernoulli ---------------------------------------------------------------


class _BernoulliBase(Distribution):
    support = constraints.boolean
    has_enumerate_support = True

    def sample(self, key, sample_shape=()):
        flips = random.bernoulli(key, self.probs, sample_shape + self.batch_shape)
        return flips.astype(jnp.result_type(flips, int))

    @property
    def mean(self):
        return jnp.broadcast_to(self.probs, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(self.probs * (1.0 - self.probs), self.batch_shape)

    def enumerate_support(self, expand=True):
        return _enum_range(2, self.batch_shape, expand)


class BernoulliProbs(_BernoulliBase):
    arg_constraints = dict(probs=constraints.unit_interval)

    def __init__(self, probs, *, validate_args=None):
        self._init_broadcast(validate_args, probs=probs)

    @validate_sample
    def log_prob(self, value):
        heads = value * 1.0  # float0-safe under enumeration + grad
        return xlogy(heads, self.probs) + xlog1py(1.0 - heads, -self.probs)

    @lazy_property
    def logits(self):
        return _logit(self.probs)

    def entropy(self):
        p = clamp_probs(self.probs)
        return -p * jnp.log(p) - (1.0 - p) * jnp.log1p(-p)


class BernoulliLogits(_BernoulliBase):
    arg_constraints = dict(logits=constraints.real)

    def __init__(self, logits=None, *, validate_args=None):
        self._init_broadcast(validate_args, logits=logits)

    @validate_sample
    def log_prob(self, value):
        return -binary_cross_entropy_with_logits(self.logits, value)

    @lazy_property
    def probs(self):
        return _sigmoid_pair(self.logits)

    def entropy(self):
        p = expit(self.logits)
        return p * softplus(-self.logits) + (1.0 - p) * softplus(self.logits)


Bernoulli = _twin_factory(BernoulliProbs, BernoulliLogits, "Bernoulli")


# -- Binomial ----------------------------------------------------------------


class _BinomialBase(Distribution):
    has_enumerate_support = True
    pytree_aux_fields = ("total_count",)

    def sample(self, key, sample_shape=()):
        draws = binomial(
            key, self.probs, n=self.total_count,
            shape=sample_shape + self.batch_shape,
        )
        return draws.astype(jnp.result_type(int))

    @property
    def mean(self):
        return jnp.broadcast_to(self.total_count * self.probs, self.batch_shape)

    @property
    def variance(self):
        spread = self.total_count * self.probs * (1.0 - self.probs)
        return jnp.broadcast_to(spread, self.batch_shape)

    @property
    def support(self):
        return constraints.integer_interval(0, self.total_count)

    def enumerate_support(self, expand=True):
        n = _homogeneous_int(self.total_count, "total_count")
        return _enum_range(n + 1, self.batch_shape, expand)


class BinomialProbs(_BinomialBase):
    arg_constraints = dict(probs=constraints.unit_interval, total_count=_NN_INT)
    pytree_data_fields = ("probs",)

    def __init__(self, probs, total_count=1, *, validate_args=None):
        self._init_broadcast(validate_args, probs=probs, total_count=total_count)

    @validate_sample
    def log_prob(self, value):
        heads = value * 1.0
        tails = self.total_count - heads
        return (
            _log_binom_coeff(self.total_count, value)
            + xlogy(heads, self.probs)
            + xlog1py(tails, -self.probs)
        )

    @lazy_property
    def logits(self):
        return _logit(self.probs)


class BinomialLogits(_BinomialBase):
    arg_constraints = dict(logits=constraints.real, total_count=_NN_INT)
    pytree_data_fields = ("logits",)

    def __init__(self, logits, total_count=1, *, validate_args=None):
        self._init_broadcast(validate_args, logits=logits, total_count=total_count)

    @validate_sample
    def log_prob(self, value):
        # k·log p + (n-k)·log q  ==  k·logit − n·softplus(logit)
        kernel = value * self.logits - self.total_count * softplus(self.logits)
        return _log_binom_coeff(self.total_count, value) + kernel

    @lazy_property
    def probs(self):
        return _sigmoid_pair(self.logits)


def Binomial(total_count=1, probs=None, logits=None, *, validate_args=None):
    if (probs is None) == (logits is None):
        raise ValueError("One of `probs` or `logits` must be specified.")
    if probs is not None:
        return BinomialProbs(probs, total_count, validate_args=validate_args)
    return BinomialLogits(logits, total_count, validate_args=validate_args)


# -- Categorical -------------------------------------------------------------


class _CategoricalBase(Distribution):
    has_enumerate_support = True

    def _n_cats(self):
        return self.enumerate_support(expand=False).shape[0]

    @validate_sample
    def log_prob(self, value):
        table = self._log_pmf
        batch = lax.broadcast_shapes(jnp.shape(value), self.batch_shape)
        table = jnp.broadcast_to(table, batch + table.shape[-1:])
        idx = jnp.broadcast_to(value, batch)[..., None].astype(int)
        return jnp.take_along_axis(table, idx, axis=-1)[..., 0]

    @property
    def mean(self):
        return jnp.full(self.batch_shape, jnp.nan)

    @property
    def variance(self):
        return jnp.full(self.batch_shape, jnp.nan)

    def entropy(self):
        table = self._log_pmf
        return -(jnp.exp(table) * table).sum(-1)


class CategoricalProbs(_CategoricalBase):
    arg_constraints = dict(probs=constraints.simplex)

    def __init__(self, probs, *, validate_args=None):
        if jnp.ndim(probs) == 0:
            raise ValueError("`probs` must carry a category axis.")
        self._init_broadcast(
            validate_args, event_dims={"probs": 1}, probs=probs
        )

    def sample(self, key, sample_shape=()):
        return categorical(key, self.probs, shape=sample_shape + self.batch_shape)

    @lazy_property
    def _log_pmf(self):
        return _log_simplex(self.probs)

    @lazy_property
    def logits(self):
        return _log_simplex(self.probs)

    @property
    def support(self):
        return constraints.integer_interval(0, jnp.shape(self.probs)[-1] - 1)

    def enumerate_support(self, expand=True):
        return _enum_range(self.probs.shape[-1], self.batch_shape, expand)

    def entropy(self):
        p = clamp_probs(self.probs)
        return -(p * jnp.log(p)).sum(-1)


class CategoricalLogits(_CategoricalBase):
    arg_constraints = dict(logits=constraints.real_vector)

    def __init__(self, logits, *, validate_args=None):
        if jnp.ndim(logits) == 0:
            raise ValueError("`logits` must carry a category axis.")
        self._init_broadcast(
            validate_args, event_dims={"logits": 1}, logits=logits
        )

    def sample(self, key, sample_shape=()):
        return random.categorical(
            key, self.logits, axis=-1, shape=sample_shape + self.batch_shape
        )

    @lazy_property
    def _log_pmf(self):
        return self.logits - logsumexp(self.logits, axis=-1, keepdims=True)

    @lazy_property
    def probs(self):
        return softmax(self.logits, axis=-1)

    @property
    def support(self):
        return constraints.integer_interval(0, jnp.shape(self.logits)[-1] - 1)

    def enumerate_support(self, expand=True):
        return _enum_range(self.logits.shape[-1], self.batch_shape, expand)


Categorical = _twin_factory(CategoricalProbs, CategoricalLogits, "Categorical")


# -- DiscreteUniform ---------------------------------------------------------


class DiscreteUniform(Distribution):
    arg_constraints = dict(
        low=constraints.dependent(is_discrete=True, event_dim=0),
        high=constraints.dependent(is_discrete=True, event_dim=0),
    )
    has_enumerate_support = True
    pytree_data_fields = ("low", "high", "_support")

    def __init__(self, low=0, high=1, *, validate_args=None):
        self._support = constraints.integer_interval(low, high)
        self._init_broadcast(validate_args, low=low, high=high)

    @property
    def support(self):
        return self._support

    def _span(self):
        return self.high - self.low + 1

    def sample(self, key, sample_shape=()):
        return random.randint(
            key, sample_shape + self.batch_shape, self.low, self.high + 1
        )

    @validate_sample
    def log_prob(self, value):
        out_shape = lax.broadcast_shapes(jnp.shape(value), self.batch_shape)
        return jnp.broadcast_to(-jnp.log(self._span()), out_shape)

    def cdf(self, value):
        frac = (jnp.floor(value) + 1 - self.low) / self._span()
        return jnp.clip(frac, 0.0, 1.0)

    def icdf(self, value):
        return self.low + value * self._span() - 1

    @property
    def mean(self):
        return 0.5 * (self.low + self.high)

    @property
    def variance(self):
        return (jnp.square(self._span()) - 1.0) / 12.0

    def enumerate_support(self, expand=True):
        lo = _homogeneous_int(self.low, "low")
        hi = _homogeneous_int(self.high, "high")
        return _enum_range(hi - lo + 1, self.batch_shape, expand, start=lo)

    def entropy(self):
        return jnp.broadcast_to(jnp.log(self._span()), self.batch_shape)


# -- Multinomial -------------------------------------------------------------


class _MultinomialBase(Distribution):
    pytree_aux_fields = ("total_count", "total_count_max")

    def sample(self, key, sample_shape=()):
        return multinomial(
            key,
            self.probs,
            jnp.asarray(self.total_count),
            shape=sample_shape + self.batch_shape,
            total_count_max=self.total_count_max,
        )

    @validate_sample
    def log_prob(self, value):
        n = jnp.asarray(self.total_count, dtype=jnp.result_type(float))
        log_coeff = gammaln(n + 1.0) - gammaln(value + 1.0).sum(-1)
        return log_coeff + self._count_kernel(value)

    @property
    def mean(self):
        return jnp.asarray(self.total_count)[..., None] * self.probs

    @property
    def variance(self):
        n = jnp.asarray(self.total_count)[..., None]
        return n * self.probs * (1.0 - self.probs)

    @property
    def support(self):
        return constraints.multinomial(self.total_count)


class MultinomialProbs(_MultinomialBase):
    arg_constraints = dict(probs=constraints.simplex, total_count=_NN_INT)
    pytree_data_fields = ("probs",)

    def __init__(self, probs, total_count=1, *, total_count_max=None, validate_args=None):
        if jnp.ndim(probs) == 0:
            raise ValueError("`probs` must carry a category axis.")
        self.total_count_max = total_count_max
        self._init_broadcast(
            validate_args,
            event_shape=jnp.shape(probs)[-1:],
            event_dims={"probs": 1},
            probs=probs,
            total_count=total_count,
        )

    def _count_kernel(self, value):
        return xlogy(value * 1.0, self.probs).sum(-1)

    @lazy_property
    def logits(self):
        return _log_simplex(self.probs)


class MultinomialLogits(_MultinomialBase):
    arg_constraints = dict(logits=constraints.real_vector, total_count=_NN_INT)
    pytree_data_fields = ("logits",)

    def __init__(self, logits, total_count=1, *, total_count_max=None, validate_args=None):
        if jnp.ndim(logits) == 0:
            raise ValueError("`logits` must carry a category axis.")
        self.total_count_max = total_count_max
        self._init_broadcast(
            validate_args,
            event_shape=jnp.shape(logits)[-1:],
            event_dims={"logits": 1},
            logits=logits,
            total_count=total_count,
        )

    def _count_kernel(self, value):
        norm = jnp.asarray(self.total_count) * logsumexp(self.logits, axis=-1)
        return (value * self.logits).sum(-1) - norm

    @lazy_property
    def probs(self):
        return softmax(self.logits, axis=-1)


def Multinomial(
    total_count=1, probs=None, logits=None, *, total_count_max=None, validate_args=None
):
    if (probs is None) == (logits is None):
        raise ValueError("One of `probs` or `logits` must be specified.")
    if probs is not None:
        return MultinomialProbs(
            probs, total_count,
            total_count_max=total_count_max, validate_args=validate_args,
        )
    return MultinomialLogits(
        logits, total_count,
        total_count_max=total_count_max, validate_args=validate_args,
    )


# -- Poisson -----------------------------------------------------------------


class Poisson(Distribution):
    arg_constraints = dict(rate=constraints.positive)
    support = _NN_INT
    pytree_aux_fields = ("is_sparse",)

    def __init__(self, rate, *, is_sparse=False, validate_args=None):
        self.is_sparse = is_sparse
        self._init_broadcast(validate_args, rate=rate)

    def sample(self, key, sample_shape=()):
        return random.poisson(key, self.rate, shape=sample_shape + self.batch_shape)

    @validate_sample
    def log_prob(self, value):
        counts = jnp.asarray(value, dtype=jnp.result_type(float)) * 1.0
        return xlogy(counts, self.rate) - gammaln(counts + 1.0) - self.rate

    @property
    def mean(self):
        return jnp.broadcast_to(self.rate, self.batch_shape)

    variance = mean

    def cdf(self, value):
        return 1.0 - gammainc(jnp.floor(value) + 1.0, self.rate)


# -- Geometric ---------------------------------------------------------------


class _GeometricBase(Distribution):
    support = _NN_INT

    def sample(self, key, sample_shape=()):
        # inverse-CDF: failures before first success
        u = random.uniform(
            key, sample_shape + self.batch_shape, jnp.result_type(self.probs)
        )
        gaps = jnp.log1p(-u) / jnp.log1p(-self.probs)
        return jnp.floor(gaps).astype(jnp.result_type(int))

    @property
    def mean(self):
        p = self.probs
        return jnp.asarray((1.0 - p) / p, jnp.result_type(float))

    @property
    def variance(self):
        p = self.probs
        return jnp.asarray((1.0 - p) / jnp.square(p), jnp.result_type(float))


class GeometricProbs(_GeometricBase):
    arg_constraints = dict(probs=constraints.unit_interval)

    def __init__(self, probs, *, validate_args=None):
        self._init_broadcast(validate_args, probs=probs)

    @validate_sample
    def log_prob(self, value):
        # guard the p=1, k=0 corner where xlog1py(0, -1) would be nan
        safe_p = jnp.where((self.probs == 1) & (value == 0), 0.0, self.probs)
        return xlog1py(value, -safe_p) + jnp.log(self.probs)

    @lazy_property
    def logits(self):
        return _logit(self.probs)


class GeometricLogits(_GeometricBase):
    arg_constraints = dict(logits=constraints.real)

    def __init__(self, logits, *, validate_args=None):
        self._init_broadcast(validate_args, logits=logits)

    @validate_sample
    def log_prob(self, value):
        return self.logits - (value + 1.0) * softplus(self.logits)

    @lazy_property
    def probs(self):
        return _sigmoid_pair(self.logits)


Geometric = _twin_factory(GeometricProbs, GeometricLogits, "Geometric")


# -- OrderedLogistic ---------------------------------------------------------


class OrderedLogistic(CategoricalProbs):
    """Categorical over ordered categories from a latent ``predictor`` and a
    vector of ``cutpoints``."""

    arg_constraints = dict(
        predictor=constraints.real, cutpoints=constraints.ordered_vector
    )

    def __init__(self, predictor, cutpoints, *, validate_args=None):
        if jnp.ndim(predictor) == 0:
            (predictor,) = promote_shapes(predictor, shape=(1,))
        else:
            predictor = predictor[..., None]
        predictor, self.cutpoints = promote_shapes(predictor, cutpoints)
        self.predictor = predictor[..., 0]
        # category mass = successive differences of the cumulative sigmoid,
        # with implicit boundary columns at 0 and 1
        cum = expit(self.cutpoints - predictor)
        edge_lo = jnp.zeros_like(cum[..., :1])
        edge_hi = jnp.ones_like(cum[..., :1])
        cum = jnp.concatenate([edge_lo, cum, edge_hi], axis=-1)
        super().__init__(jnp.diff(cum, axis=-1), validate_args=validate_args)

    @staticmethod
    def infer_shapes(predictor, cutpoints):
        return lax.broadcast_shapes(predictor, cutpoints[:-1]), ()

    def entropy(self):
        raise NotImplementedError


# -- NegativeBinomial2 -------------------------------------------------------


class NegativeBinomial2(Distribution):
    """Gamma-Poisson mixture parameterized by mean and concentration."""

    arg_constraints = dict(mean=constraints.positive, concentration=constraints.positive)
    support = _NN_INT
    pytree_data_fields = ("_mu", "concentration")

    def __init__(self, mean, concentration, *, validate_args=None):
        self._mu, self.concentration = promote_shapes(mean, concentration)
        batch = lax.broadcast_shapes(jnp.shape(mean), jnp.shape(concentration))
        super().__init__(batch, validate_args=validate_args)

    @property
    def mean(self):
        return jnp.broadcast_to(self._mu, self.batch_shape)

    @property
    def variance(self):
        return self.mean * (1.0 + self._mu / self.concentration)

    def sample(self, key, sample_shape=()):
        from .continuous import Gamma

        k_mix, k_obs = random.split(key)
        lam = Gamma(self.concentration, self.concentration / self._mu).sample(
            k_mix, sample_shape
        )
        return random.poisson(k_obs, lam)

    @validate_sample
    def log_prob(self, value):
        a, mu = self.concentration, self._mu
        log_coeff = -jnp.log(a + value) - betaln(a, value + 1.0)
        log_ratio = jnp.log(mu) - jnp.log(a + mu)
        return log_coeff + a * (jnp.log(a) - jnp.log(a + mu)) + value * log_ratio


# -- Zero inflation ----------------------------------------------------------


class ZeroInflatedPoisson(Distribution):
    arg_constraints = dict(gate=constraints.unit_interval, rate=constraints.positive)
    support = _NN_INT

    def __init__(self, gate, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, gate=gate, rate=rate)

    def sample(self, key, sample_shape=()):
        k_gate, k_obs = random.split(key)
        shape = sample_shape + self.batch_shape
        zeroed = random.bernoulli(k_gate, self.gate, shape)
        counts = random.poisson(k_obs, self.rate, shape)
        return jnp.where(zeroed, 0, counts)

    @validate_sample
    def log_prob(self, value):
        pois = xlogy(value * 1.0, self.rate) - gammaln(value + 1.0) - self.rate
        nonzero_lp = jnp.log1p(-self.gate) + pois
        at_zero = jnp.logaddexp(
            jnp.log(self.gate), jnp.log1p(-self.gate) - self.rate
        )
        return jnp.where(value == 0, at_zero, nonzero_lp)

    @property
    def mean(self):
        return (1.0 - self.gate) * self.rate

    @property
    def variance(self):
        return (1.0 - self.gate) * self.rate * (1.0 + self.rate * self.gate)


class ZeroInflatedProbs(Distribution):
    """Mix a point mass at zero (probability ``gate``) into any discrete
    scalar-event base distribution
    (reference: numpyro/distributions/discrete.py:758)."""

    arg_constraints = dict(gate=constraints.unit_interval)
    pytree_data_fields = ("base_dist", "gate")

    def __init__(self, base_dist, gate, *, validate_args=None):
        if base_dist.event_shape:
            raise ValueError(
                "ZeroInflatedProbs expected empty base_dist.event_shape "
                f"but got {base_dist.event_shape}"
            )
        assert base_dist.support.is_discrete
        batch = lax.broadcast_shapes(jnp.shape(gate), base_dist.batch_shape)
        (self.gate,) = promote_shapes(gate, shape=batch)
        self.base_dist = base_dist.expand(batch)
        super().__init__(batch, validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        k_gate, k_obs = random.split(key)
        zeroed = random.bernoulli(
            k_gate, self.gate, sample_shape + self.batch_shape
        )
        draws = self.base_dist.sample(k_obs, sample_shape=sample_shape)
        return jnp.where(zeroed, 0, draws)

    @validate_sample
    def log_prob(self, value):
        nonzero_lp = jnp.log1p(-self.gate) + self.base_dist.log_prob(value)
        at_zero = jnp.log(self.gate + jnp.exp(nonzero_lp))
        return jnp.where(value == 0, at_zero, nonzero_lp)

    @constraints.dependent_property(is_discrete=True, event_dim=0)
    def support(self):
        return self.base_dist.support

    @lazy_property
    def mean(self):
        return (1.0 - self.gate) * self.base_dist.mean

    @lazy_property
    def variance(self):
        second_moment = (
            jnp.square(self.base_dist.mean) + self.base_dist.variance
        )
        return (1.0 - self.gate) * second_moment - jnp.square(self.mean)

    @property
    def has_enumerate_support(self):
        return self.base_dist.has_enumerate_support

    def enumerate_support(self, expand=True):
        return self.base_dist.enumerate_support(expand=expand)


class ZeroInflatedLogits(ZeroInflatedProbs):
    """ZeroInflatedProbs with the gate given as logits, evaluated stably in
    log space (reference: numpyro/distributions/discrete.py:814)."""

    arg_constraints = dict(gate_logits=constraints.real)

    def __init__(self, base_dist, gate_logits, *, validate_args=None):
        batch = lax.broadcast_shapes(
            jnp.shape(gate_logits), base_dist.batch_shape
        )
        (self.gate_logits,) = promote_shapes(gate_logits, shape=batch)
        super().__init__(
            base_dist, _sigmoid_pair(gate_logits), validate_args=validate_args
        )

    @validate_sample
    def log_prob(self, value):
        log_gate = -softplus(-self.gate_logits)
        shifted = self.base_dist.log_prob(value) - self.gate_logits
        return jnp.where(
            value == 0, softplus(shifted) + log_gate, shifted + log_gate
        )


def ZeroInflatedDistribution(
    base_dist, *, gate=None, gate_logits=None, validate_args=None
):
    """Generic zero-inflated wrapper
    (reference: numpyro/distributions/discrete.py:832)."""
    from .util import assert_one_of

    assert_one_of(gate=gate, gate_logits=gate_logits)
    if gate is not None:
        return ZeroInflatedProbs(base_dist, gate, validate_args=validate_args)
    return ZeroInflatedLogits(base_dist, gate_logits, validate_args=validate_args)


def ZeroInflatedNegativeBinomial2(
    mean, concentration, *, gate=None, gate_logits=None, validate_args=None
):
    return ZeroInflatedDistribution(
        NegativeBinomial2(mean, concentration, validate_args=validate_args),
        gate=gate,
        gate_logits=gate_logits,
        validate_args=validate_args,
    )
