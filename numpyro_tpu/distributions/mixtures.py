"""Finite mixture distributions.

Role parity: numpyro/distributions/mixtures.py:158,263.  ``log_prob`` is a
logsumexp contraction over the component axis; component selection when
sampling is a one-hot contraction (a matmul-friendly select — no gather in
the hot path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import random
from jax.scipy.special import logsumexp

from . import constraints  # noqa: F401  (re-exported surface)
from .discrete import CategoricalLogits, CategoricalProbs
from .distribution import Distribution
from .util import validate_sample

__all__ = ["Mixture", "MixtureGeneral", "MixtureSameFamily"]


def Mixture(mixing_distribution, component_distributions, *, validate_args=None):
    """Dispatch to :class:`MixtureSameFamily` (one batched component
    distribution) or :class:`MixtureGeneral` (a list of components)."""
    cls = (
        MixtureSameFamily
        if isinstance(component_distributions, Distribution)
        else MixtureGeneral
    )
    return cls(
        mixing_distribution, component_distributions, validate_args=validate_args
    )


def _require_categorical(mixing_distribution):
    if not isinstance(mixing_distribution, (CategoricalLogits, CategoricalProbs)):
        raise ValueError(
            "The mixing distribution must be a Categorical distribution; got "
            f"{type(mixing_distribution)}"
        )
    return jnp.shape(mixing_distribution.probs)[-1]


class _MixtureBase(Distribution):
    """Shared mixture algebra over an abstract stacked-component view.

    Subclasses provide ``component_log_probs`` / ``component_sample`` and
    stacked ``component_mean`` / ``component_variance`` along the component
    axis (``mixture_dim``); everything else is weighted-moment arithmetic
    here.
    """

    @property
    def mixture_size(self):
        return self._mixture_size

    @property
    def mixing_distribution(self):
        return self._mixing_distribution

    @property
    def mixture_dim(self):
        return -self.event_dim - 1

    def component_log_probs(self, value):
        raise NotImplementedError

    def component_sample(self, key, sample_shape=()):
        raise NotImplementedError

    @property
    def component_mean(self):
        raise NotImplementedError

    @property
    def component_variance(self):
        raise NotImplementedError

    def cdf(self, samples):
        raise NotImplementedError

    def _weights_for_events(self):
        """Mixing probabilities broadcastable against stacked components."""
        w = self.mixing_distribution.probs
        return w.reshape(w.shape + (1,) * self.event_dim)

    @property
    def mean(self):
        return jnp.sum(
            self._weights_for_events() * self.component_mean,
            axis=self.mixture_dim,
        )

    @property
    def variance(self):
        w = self._weights_for_events()
        # law of total variance: E[var | k] + var[mean | k]
        within = jnp.sum(w * self.component_variance, axis=self.mixture_dim)
        centered = self.component_mean - jnp.expand_dims(
            self.mean, self.mixture_dim
        )
        between = jnp.sum(w * centered**2, axis=self.mixture_dim)
        return within + between

    def sample_with_intermediates(self, key, sample_shape=()):
        key_comp, key_pick = random.split(key)
        stacked = self.component_sample(key_comp, sample_shape=sample_shape)
        picks = self.mixing_distribution.expand(
            sample_shape + self.batch_shape
        ).sample(key_pick)
        # one-hot contraction over the component axis (no gather)
        onehot = jax.nn.one_hot(picks, self.mixture_size)
        onehot = onehot.reshape(onehot.shape + (1,) * self.event_dim)
        onehot = jnp.moveaxis(onehot, -1 - self.event_dim, self.mixture_dim)
        chosen = jnp.sum(stacked * onehot, axis=self.mixture_dim)
        return chosen.astype(stacked.dtype), [picks]

    def sample(self, key, sample_shape=()):
        return self.sample_with_intermediates(key, sample_shape)[0]

    @validate_sample
    def log_prob(self, value, intermediates=None):
        del intermediates
        return logsumexp(self.component_log_probs(value), axis=-1)

    def _log_weights(self):
        return jax.nn.log_softmax(self.mixing_distribution.logits, axis=-1)


class MixtureSameFamily(_MixtureBase):
    """Mixture whose components are one distribution batched along its last
    batch axis."""

    arg_constraints = {}
    pytree_data_fields = ("_mixing_distribution", "_component_distribution")
    pytree_aux_fields = ("_mixture_size",)

    def __init__(
        self, mixing_distribution, component_distribution, *, validate_args=None
    ):
        k = _require_categorical(mixing_distribution)
        if not isinstance(component_distribution, Distribution):
            raise ValueError(
                "The component distribution need to be a "
                "numpyro_tpu.distributions.Distribution. "
                f"However, it is of type {type(component_distribution)}"
            )
        if component_distribution.batch_shape[-1] != k:
            raise ValueError(
                "Component distribution batch shape last dimension "
                f"(size={component_distribution.batch_shape[-1]}) "
                f"needs to correspond to the mixture_size={k}!"
            )
        self._mixing_distribution = mixing_distribution
        self._component_distribution = component_distribution
        self._mixture_size = k
        super().__init__(
            component_distribution.batch_shape[:-1],
            component_distribution.event_shape,
            validate_args=validate_args,
        )

    @property
    def component_distribution(self):
        return self._component_distribution

    @property
    def support(self):
        return self._component_distribution.support

    @property
    def is_discrete(self):
        return self._component_distribution.is_discrete

    @property
    def component_mean(self):
        return self._component_distribution.mean

    @property
    def component_variance(self):
        return self._component_distribution.variance

    def cdf(self, samples):
        per_component = self._component_distribution.cdf(
            jnp.expand_dims(samples, self.mixture_dim)
        )
        return jnp.sum(per_component * self.mixing_distribution.probs, axis=-1)

    def component_sample(self, key, sample_shape=()):
        shape = sample_shape + self.batch_shape + (self.mixture_size,)
        return self._component_distribution.expand(shape).sample(key)

    def component_log_probs(self, value):
        lps = self._component_distribution.log_prob(
            jnp.expand_dims(value, self.mixture_dim)
        )
        return self._log_weights() + lps


class MixtureGeneral(_MixtureBase):
    """Mixture of an explicit list of (possibly heterogeneous) component
    distributions sharing batch/event shape and support."""

    arg_constraints = {}
    pytree_data_fields = ("_mixing_distribution", "_component_distributions")
    pytree_aux_fields = ("_mixture_size", "_support")

    def __init__(
        self,
        mixing_distribution,
        component_distributions,
        *,
        support=None,
        validate_args=None,
    ):
        k = _require_categorical(mixing_distribution)
        self._mixing_distribution = mixing_distribution
        self._mixture_size = k
        try:
            components = list(component_distributions)
        except TypeError:
            raise ValueError(
                "The 'component_distributions' argument must be a list of "
                "Distribution objects"
            )
        if any(not isinstance(d, Distribution) for d in components):
            raise ValueError(
                "All elements of 'component_distributions' must be instances "
                "of numpyro_tpu.distributions.Distribution subclasses"
            )
        if len(components) != k:
            raise ValueError(
                "The number of elements in 'component_distributions' needs "
                "to match the mixture_size of the mixing_distribution "
                f"({len(components)} != {k})"
            )
        self._component_distributions = components
        if support is None:
            support = components[0].support
            if any(d.support is not support for d in components[1:]):
                raise ValueError(
                    "All component distributions must have the same support "
                    "(or pass `support` explicitly)."
                )
        self._support = support
        super().__init__(
            components[0].batch_shape,
            components[0].event_shape,
            validate_args=validate_args,
        )

    @property
    def component_distributions(self):
        return self._component_distributions

    @property
    def support(self):
        return self._support

    @property
    def is_discrete(self):
        return self._support.is_discrete

    def _stack(self, values):
        return jnp.stack(values, axis=self.mixture_dim)

    @property
    def component_mean(self):
        return self._stack([d.mean for d in self._component_distributions])

    @property
    def component_variance(self):
        return self._stack([d.variance for d in self._component_distributions])

    def cdf(self, samples):
        stacked = self._stack(
            [d.cdf(samples) for d in self._component_distributions]
        )
        return jnp.sum(stacked * self.mixing_distribution.probs, axis=-1)

    def component_sample(self, key, sample_shape=()):
        shape = sample_shape + self.batch_shape
        return self._stack(
            [
                d.expand(shape).sample(k)
                for k, d in zip(
                    random.split(key, self.mixture_size),
                    self._component_distributions,
                )
            ]
        )

    def component_log_probs(self, value):
        lps = jnp.stack(
            [d.log_prob(value) for d in self._component_distributions], axis=-1
        )
        return self._log_weights() + lps
