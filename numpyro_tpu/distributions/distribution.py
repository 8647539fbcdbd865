"""Distribution base class + structural combinators.

Accelerator-native re-design of the distribution layer (reference:
numpyro/distributions/distribution.py).  Key properties kept because they are
what make a JAX-first PPL work, re-implemented fresh:

- every Distribution subclass is auto-registered as a JAX pytree
  (``__init_subclass__``) so distribution objects flow through
  jit/vmap/scan/pjit boundaries — parameters are leaves, shapes are aux data.
- batch_shape/event_shape algebra identical in semantics to
  torch.distributions, so models written against the reference port 1:1.
- combinators (Independent / Expanded / Masked / Transformed / Folded) share a
  single delegating wrapper base (`_Decorated`) rather than re-declaring the
  forwarding boilerplate per class.

Chain-massive note: distributions are *constructed inside traced model code*,
so none of this Python machinery exists at runtime — XLA sees only the fused
log_prob/sample math, batched over the leading chain axis.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Protocol, runtime_checkable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, tree_util
from jax.scipy.special import logsumexp

from . import constraints
from .transforms import ComposeTransform, Transform
from .util import lazy_property, promote_shapes, sum_rightmost, validate_sample

_VALIDATION_ENABLED = False


def not_jax_tracer(x) -> bool:
    return not isinstance(x, jax.core.Tracer)


def enable_validation(is_validate: bool = True) -> None:
    """Globally toggle distribution argument/sample validation."""
    global _VALIDATION_ENABLED
    _VALIDATION_ENABLED = is_validate
    Distribution.set_default_validate_args(is_validate)


@contextmanager
def validation_enabled(is_validate: bool = True):
    old = _VALIDATION_ENABLED
    enable_validation(is_validate)
    try:
        yield
    finally:
        enable_validation(old)


COERCIONS = []  # hook: enumeration machinery may intercept construction


@runtime_checkable
class DistributionLike(Protocol):
    """Structural (duck) type of anything the inference machinery accepts
    as a distribution: native :class:`Distribution`, a TFP bridge wrapper,
    or any user object exposing the same surface (reference:
    numpyro/distributions/distribution.py:575).  ``runtime_checkable`` so
    ``isinstance(obj, DistributionLike)`` works for type-checking consumers.
    """

    @property
    def batch_shape(self) -> tuple:
        ...

    @property
    def event_shape(self) -> tuple:
        ...

    @property
    def event_dim(self) -> int:
        ...

    def sample(self, key, sample_shape=()):
        ...

    def log_prob(self, value):
        ...

    @property
    def mean(self):
        ...

    @property
    def variance(self):
        ...

    def cdf(self, value):
        ...

    def icdf(self, q):
        ...


class DistributionMeta(type):
    def __call__(cls, *args, **kwargs):
        for hook in COERCIONS:
            if (hit := hook(cls, args, kwargs)) is not None:
                return hit
        return super().__call__(*args, **kwargs)


class Distribution(metaclass=DistributionMeta):
    """Base class with pytree flattening, shape algebra and combinators."""

    arg_constraints: dict = {}
    support = None
    has_enumerate_support = False
    reparametrized_params: list = []
    _validate_args = False

    # pytree protocol: which attributes are traced data vs static aux
    pytree_data_fields: tuple = ()
    pytree_aux_fields: tuple = ("_batch_shape", "_event_shape")

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        tree_util.register_pytree_node(
            cls, cls.tree_flatten, cls.tree_unflatten
        )

    @classmethod
    def gather_pytree_data_fields(cls) -> tuple:
        bases = [b for b in cls.__mro__ if issubclass(b, Distribution)]
        all_fields = set()
        for b in bases:
            all_fields.update(b.__dict__.get("pytree_data_fields", ()))
            # default: arg_constraints keys not marked dependent
            all_fields.update(
                k
                for k, v in b.__dict__.get("arg_constraints", {}).items()
                if not isinstance(v, constraints._Dependent)
            )
        # an explicit aux declaration WINS over constraint-derived data
        # membership: a field must be either traced (child) or static (aux),
        # never both — dual membership makes flatten emit a child that
        # unflatten silently discards (breaking tree.map/vmap_over specs)
        all_fields -= set(cls.gather_pytree_aux_fields())
        return tuple(sorted(all_fields))

    @classmethod
    def gather_pytree_aux_fields(cls) -> tuple:
        bases = [b for b in cls.__mro__ if issubclass(b, Distribution)]
        all_fields = set()
        for b in bases:
            all_fields.update(b.__dict__.get("pytree_aux_fields", ()))
        return tuple(sorted(all_fields))

    @classmethod
    def _storable_data_fields(cls):
        """Data fields that live in instance __dict__.  Plain properties
        (derived values like BetaProportion.mean) are excluded; lazy
        properties are read from __dict__ so flattening never triggers
        their computation."""
        fields = []
        for k in cls.gather_pytree_data_fields():
            attr = getattr(cls, k, None)
            if isinstance(attr, property):
                continue
            fields.append(k)
        return tuple(fields)

    def tree_flatten(self):
        data_fields = type(self)._storable_data_fields()
        aux_fields = type(self).gather_pytree_aux_fields()
        data = tuple(self.__dict__.get(k) for k in data_fields)
        aux = tuple(getattr(self, k, None) for k in aux_fields)
        return data, (data_fields, aux_fields, aux)

    @classmethod
    def tree_unflatten(cls, aux_data, params):
        data_fields, aux_fields, aux = aux_data
        self = cls.__new__(cls)
        # write into __dict__ directly: descriptors (lazy_property) must not
        # intercept reconstruction
        for k, v in zip(data_fields, params):
            self.__dict__[k] = v
        for k, v in zip(aux_fields, aux):
            if not isinstance(getattr(cls, k, None), property):
                self.__dict__[k] = v
        return self

    @staticmethod
    def set_default_validate_args(value: bool):
        Distribution._validate_args = value

    def __init__(self, batch_shape=(), event_shape=(), *, validate_args=None):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)
        if validate_args is not None:
            self._validate_args = validate_args
        if self._validate_args:
            self._assert_param_constraints()

    def _init_broadcast(
        self, validate_args=None, event_shape=(), event_dims=None, **params
    ):
        """Declarative parameter setup shared by the concrete families:
        promote the named parameters against each other, bind them as
        attributes, and initialise with the broadcast batch shape.

        ``event_dims`` maps a parameter name to how many of its trailing
        dims are event (not batch) dims — those dims are excluded from the
        batch-shape computation and the parameter is only left-padded.
        """
        event_dims = event_dims or {}
        batch_shapes = [
            jnp.shape(v)[: jnp.ndim(v) - event_dims.get(name, 0)]
            for name, v in params.items()
        ]
        batch = lax.broadcast_shapes(*batch_shapes) if batch_shapes else ()
        for name, v in params.items():
            ed = event_dims.get(name, 0)
            target = batch + (jnp.shape(v)[jnp.ndim(v) - ed :] if ed else ())
            (v,) = promote_shapes(v, shape=target)
            setattr(self, name, v)
        Distribution.__init__(
            self, batch, tuple(event_shape), validate_args=validate_args
        )
        return batch

    def _assert_param_constraints(self):
        for name, constraint in self.arg_constraints.items():
            if isinstance(constraint, constraints._Dependent):
                continue
            descriptor = getattr(type(self), name, None)
            if isinstance(descriptor, lazy_property) and name not in self.__dict__:
                continue  # don't force a lazy param just to validate it
            value = getattr(self, name)
            if value is None:
                continue
            ok = constraint(value)
            if not_jax_tracer(ok) and not np.all(np.asarray(ok)):
                raise ValueError(
                    f"{type(self).__name__}: invalid {name} parameter"
                )

    @property
    def batch_shape(self) -> tuple:
        return self._batch_shape

    @property
    def event_shape(self) -> tuple:
        return self._event_shape

    @property
    def event_dim(self) -> int:
        return len(self._event_shape)

    @property
    def has_rsample(self) -> bool:
        return set(self.arg_constraints).issubset(self.reparametrized_params)

    def rsample(self, key, sample_shape=()):
        if self.has_rsample:
            return self.sample(key, sample_shape)
        raise NotImplementedError(
            f"{type(self).__name__} is not fully reparametrized"
        )

    def shape(self, sample_shape=()) -> tuple:
        return (*sample_shape, *self._batch_shape, *self._event_shape)

    def sample(self, key, sample_shape=()):
        raise NotImplementedError(f"{type(self).__name__}.sample")

    def sample_with_intermediates(self, key, sample_shape=()):
        """Sample returning latent intermediates (used by TransformedDistribution
        to avoid recomputing inner values in log_prob during tracing)."""
        return self.sample(key, sample_shape), []

    def __call__(self, *args, **kwargs):
        """Sampler entry point used by the effect-handler stack."""
        key = kwargs.pop("rng_key")
        if kwargs.pop("sample_intermediates", False):
            return self.sample_with_intermediates(key, *args, **kwargs)
        return self.sample(key, *args, **kwargs)

    def log_prob(self, value):
        raise NotImplementedError(f"{type(self).__name__}.log_prob")

    @property
    def mean(self):
        raise NotImplementedError(f"{type(self).__name__}.mean")

    @property
    def variance(self):
        raise NotImplementedError(f"{type(self).__name__}.variance")

    def cdf(self, value):
        raise NotImplementedError(f"{type(self).__name__}.cdf")

    def icdf(self, q):
        raise NotImplementedError(f"{type(self).__name__}.icdf")

    def entropy(self):
        raise NotImplementedError(f"{type(self).__name__}.entropy")

    def enumerate_support(self, expand=True):
        raise NotImplementedError(f"{type(self).__name__}.enumerate_support")

    def _validate_sample(self, value):
        ok = self.support(value)
        if not_jax_tracer(ok) and not np.all(np.asarray(ok)):
            warnings.warn(
                f"Out-of-support values provided to log_prob of "
                f"{type(self).__name__}",
                stacklevel=2,
            )
        return ok

    # -- combinators --------------------------------------------------------

    def expand(self, batch_shape):
        requested = tuple(batch_shape)
        if requested == self._batch_shape:
            return self
        return ExpandedDistribution(self, requested)

    def expand_by(self, sample_shape):
        return self.expand((*sample_shape, *self._batch_shape))

    def to_event(self, reinterpreted_batch_ndims=None):
        if reinterpreted_batch_ndims is None:
            reinterpreted_batch_ndims = len(self._batch_shape)
        if reinterpreted_batch_ndims == 0:
            return self
        return Independent(self, reinterpreted_batch_ndims)

    def mask(self, mask):
        return self if mask is True else MaskedDistribution(self, mask)

    @property
    def is_discrete(self):
        return self.support.is_discrete

    @classmethod
    def infer_shapes(cls, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError

    def __repr__(self):
        return (
            f"{type(self).__name__}(batch_shape={self.batch_shape}, "
            f"event_shape={self.event_shape})"
        )


class _Decorated(Distribution):
    """Shared delegation base for combinators wrapping one `base_dist`.

    Subclasses override only the behavior their decoration actually changes;
    everything else forwards to the wrapped distribution.
    """

    arg_constraints = {}
    pytree_data_fields = ("base_dist",)

    @property
    def has_enumerate_support(self):
        return self.base_dist.has_enumerate_support

    @property
    def has_rsample(self):
        return self.base_dist.has_rsample

    @property
    def support(self):
        return self.base_dist.support

    @property
    def mean(self):
        return self.base_dist.mean

    @property
    def variance(self):
        return self.base_dist.variance

    def sample(self, key, sample_shape=()):
        return self.base_dist.sample(key, sample_shape)

    def rsample(self, key, sample_shape=()):
        return self.base_dist.rsample(key, sample_shape)

    def enumerate_support(self, expand=True):
        return self.base_dist.enumerate_support(expand=expand)


class ExpandedDistribution(_Decorated):
    """Broadcast a distribution to a larger batch shape (free at trace time)."""

    pytree_aux_fields = ("_fresh_axes",)

    def __init__(self, base_dist, batch_shape=()):
        # collapse nested expands so the wrapper stays one level deep
        requested = tuple(batch_shape)
        while isinstance(base_dist, ExpandedDistribution):
            requested = self._target_shape(base_dist.batch_shape, requested)
            base_dist = base_dist.base_dist
        self.base_dist = base_dist
        target = self._target_shape(base_dist.batch_shape, requested)
        # axes (negative, batch-relative) that need FRESH randomness when
        # sampling: new leading axes plus size-1 base axes grown to size > 1
        pad = len(target) - len(base_dist.batch_shape)
        fresh = []
        for pos, size in enumerate(target):
            rel = pos - len(target)  # negative batch-axis index
            base_size = (
                base_dist.batch_shape[pos - pad] if pos >= pad else None
            )
            if base_size is None or (base_size == 1 and size != 1):
                fresh.append((rel, size))
        self._fresh_axes = tuple(fresh)
        super().__init__(target, base_dist.event_shape)

    @staticmethod
    def _target_shape(existing, requested):
        if len(requested) < len(existing):
            raise ValueError(
                f"Cannot broadcast distribution of shape {existing} "
                f"to shape {requested}"
            )
        pad = len(requested) - len(existing)
        out = list(requested)
        for pos, base_size in enumerate(existing):
            req = requested[pad + pos]
            if base_size not in (1, req) and req != 1:
                raise ValueError(
                    f"Cannot broadcast distribution of shape {existing} "
                    f"to shape {requested}"
                )
            out[pad + pos] = max(base_size, req)
        return tuple(out)

    def _sample(self, sample_fn, key, sample_shape=()):
        # draw the fresh axes as an extra sample block (the base sampler
        # only accepts a sample_shape prefix); fresh axes that replace a
        # size-1 base axis are swapped into place (negative indices address
        # the right-aligned base batch), and the leftover size-1 axes
        # disappear in the final reshape
        fresh_sizes = tuple(size for _, size in self._fresh_axes)
        raw = sample_fn(key, sample_shape + fresh_sizes)
        lead = len(sample_shape)
        pad = len(self.batch_shape) - len(self.base_dist.batch_shape)
        for j, (rel, _) in enumerate(self._fresh_axes):
            if rel + len(self.batch_shape) >= pad:  # grown size-1 base axis
                raw = jnp.swapaxes(raw, lead + j, rel - self.event_dim)
        return raw.reshape(sample_shape + self.batch_shape + self.event_shape)

    def sample(self, key, sample_shape=()):
        return self._sample(self.base_dist.sample, key, sample_shape)

    def rsample(self, key, sample_shape=()):
        return self._sample(self.base_dist.rsample, key, sample_shape)

    def log_prob(self, value):
        lead = max(jnp.ndim(value) - self.event_dim, 0)
        out = lax.broadcast_shapes(self.batch_shape, jnp.shape(value)[:lead])
        return jnp.broadcast_to(self.base_dist.log_prob(value), out)

    def cdf(self, value):
        # elementwise under broadcasting, so delegate straight to the base
        return self.base_dist.cdf(value)

    def icdf(self, q):
        return self.base_dist.icdf(q)

    def enumerate_support(self, expand=True):
        samples = self.base_dist.enumerate_support(expand=False)
        enum_shape = samples.shape[:1]
        samples = samples.reshape(enum_shape + (1,) * len(self.batch_shape))
        if expand:
            samples = samples.expand(enum_shape + self.batch_shape)  # pragma: no cover
        return samples

    @property
    def mean(self):
        return jnp.broadcast_to(self.base_dist.mean, self.shape())

    @property
    def variance(self):
        return jnp.broadcast_to(self.base_dist.variance, self.shape())

    def entropy(self):
        return jnp.broadcast_to(self.base_dist.entropy(), self.batch_shape)


class Independent(_Decorated):
    """Reinterpret rightmost batch dims of a distribution as event dims."""

    pytree_aux_fields = ("reinterpreted_batch_ndims",)

    def __init__(self, base_dist, reinterpreted_batch_ndims, *, validate_args=None):
        if reinterpreted_batch_ndims > len(base_dist.batch_shape):
            raise ValueError(
                "reinterpreted_batch_ndims exceeds batch shape ndims "
                f"({reinterpreted_batch_ndims} > {len(base_dist.batch_shape)})"
            )
        joint = base_dist.batch_shape + base_dist.event_shape
        split = len(joint) - reinterpreted_batch_ndims - base_dist.event_dim
        self.base_dist = base_dist
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims
        super().__init__(joint[:split], joint[split:], validate_args=validate_args)

    @property
    def support(self):
        return constraints.independent(
            self.base_dist.support, self.reinterpreted_batch_ndims
        )

    @property
    def reparametrized_params(self):
        return self.base_dist.reparametrized_params

    def log_prob(self, value):
        per_site = self.base_dist.log_prob(value)
        return sum_rightmost(per_site, self.reinterpreted_batch_ndims)

    def entropy(self):
        per_site = self.base_dist.entropy()
        return sum_rightmost(per_site, self.reinterpreted_batch_ndims)

    def expand(self, batch_shape):
        inner = tuple(batch_shape) + self.event_shape[: self.reinterpreted_batch_ndims]
        return self.base_dist.expand(inner).to_event(
            self.reinterpreted_batch_ndims
        )


class MaskedDistribution(_Decorated):
    """Zero out log_prob where mask is False (used by plates/handlers)."""

    pytree_data_fields = ("_mask",)
    # a Python-bool mask is STATIC (log_prob branches on it in Python), so
    # it travels in aux, not as a traced leaf; `_mask` then flattens as None
    pytree_aux_fields = ("_mask_is_bool", "_mask_static")

    def __init__(self, base_dist, mask):
        self._mask_is_bool = isinstance(mask, bool)
        if self._mask_is_bool:
            self._mask_static = mask
            self._mask = None
        else:
            self._mask_static = None
            shape = lax.broadcast_shapes(
                jnp.shape(mask), tuple(base_dist.batch_shape)
            )
            self._mask = jnp.broadcast_to(mask.astype(bool), shape)
            if base_dist.batch_shape != shape:
                base_dist = base_dist.expand(shape)
        self.base_dist = base_dist
        super().__init__(base_dist.batch_shape, base_dist.event_shape)

    def _substitute_feasible(self, value):
        """Swap masked-out entries for in-support fillers so the (unused)
        masked log_prob cannot propagate nan through its gradient."""
        try:
            filler = self.base_dist.support.feasible_like(value)
        except (ValueError, NotImplementedError):
            return value
        keep = self._mask
        if self.event_dim:
            keep = jnp.reshape(keep, jnp.shape(keep) + (1,) * self.event_dim)
        return jnp.where(keep, value, filler)

    def log_prob(self, value):
        if self._mask_is_bool:
            if self._mask_static:
                return self.base_dist.log_prob(value)
            lead = max(jnp.ndim(value) - self.event_dim, 0)
            return jnp.zeros(
                lax.broadcast_shapes(self.batch_shape, jnp.shape(value)[:lead])
            )
        value = self._substitute_feasible(value)
        return jnp.where(self._mask, self.base_dist.log_prob(value), 0.0)


def _pushforward(base_dist, transforms):
    """Resolve the (expanded / event-reinterpreted) base distribution and the
    output batch/event split for `base_dist` pushed through `transforms`."""
    chain = ComposeTransform(transforms)
    out_shape = chain.forward_shape(base_dist.shape())
    needed = chain.inverse_shape(out_shape)
    if needed != base_dist.shape():
        cut = len(needed) - base_dist.event_dim
        base_dist = base_dist.expand(needed[:cut])
    extra_event = chain.domain.event_dim - base_dist.event_dim
    if extra_event > 0:
        base_dist = base_dist.to_event(extra_event)
    split = len(out_shape) - chain.codomain.event_dim
    return base_dist, out_shape[:split], out_shape[split:]


class TransformedDistribution(Distribution):
    """Pushforward of a base distribution through bijective transforms."""

    arg_constraints = {}
    pytree_data_fields = ("base_dist", "transforms")

    def __init__(self, base_distribution, transforms, *, validate_args=None):
        if isinstance(transforms, Transform):
            transforms = [transforms]
        if not isinstance(transforms, list) or not all(
            isinstance(t, Transform) for t in transforms
        ):
            raise ValueError("transforms must be a Transform or list thereof")
        if isinstance(base_distribution, TransformedDistribution):
            transforms = base_distribution.transforms + transforms
            base_distribution = base_distribution.base_dist
        self.transforms = transforms
        self.base_dist, batch_shape, event_shape = _pushforward(
            base_distribution, transforms
        )
        super().__init__(batch_shape, event_shape, validate_args=validate_args)

    @property
    def has_rsample(self):
        return self.base_dist.has_rsample

    @property
    def support(self):
        last = self.transforms[-1].codomain
        extra = self.event_dim - last.event_dim
        return constraints.independent(last, extra) if extra else last

    def _push(self, x):
        for t in self.transforms:
            x = t(x)
        return x

    def sample(self, key, sample_shape=()):
        return self._push(self.base_dist.sample(key, sample_shape))

    def rsample(self, key, sample_shape=()):
        return self._push(self.base_dist.rsample(key, sample_shape))

    def sample_with_intermediates(self, key, sample_shape=()):
        x = self.base_dist.sample(key, sample_shape)
        intermediates = []
        for transform in self.transforms:
            x_tmp = x
            x, t_inter = transform.call_with_intermediates(x)
            intermediates.append([x_tmp, t_inter])
        return x, intermediates

    def _inverse_chain(self, value, intermediates):
        """Pairs (x, y, cached) for each transform, walking codomain->domain."""
        chain = []
        y = value
        for idx in range(len(self.transforms) - 1, -1, -1):
            t = self.transforms[idx]
            if intermediates is None:
                x, cached = t.inv(y), None
            else:
                x, cached = intermediates[idx]
            chain.append((t, x, y, cached))
            y = x
        return chain, y

    @validate_sample
    def log_prob(self, value, intermediates=None):
        if intermediates is not None and len(intermediates) != len(
            self.transforms
        ):
            raise ValueError("intermediates length mismatch")
        chain, base_value = self._inverse_chain(value, intermediates)
        # walk the jacobians, tracking how many of the current event dims
        # each transform is batched over
        event_dim = self.event_dim
        total = 0.0
        for t, x, y, cached in chain:
            extra = event_dim - t.codomain.event_dim
            total = total - sum_rightmost(
                t.log_abs_det_jacobian(x, y, cached), extra
            )
            event_dim = t.domain.event_dim + extra
        return total + sum_rightmost(
            self.base_dist.log_prob(base_value),
            event_dim - self.base_dist.event_dim,
        )

    @property
    def mean(self):
        raise NotImplementedError(
            "mean of a generic pushforward is unavailable"
        )

    @property
    def variance(self):
        raise NotImplementedError(
            "variance of a generic pushforward is unavailable"
        )


class FoldedDistribution(TransformedDistribution):
    """|X| for a real-valued X (e.g. half-* distributions on arbitrary loc)."""

    support = constraints.positive

    def __init__(self, base_dist, *, validate_args=None):
        if base_dist.event_shape:
            raise ValueError("Only univariate distributions can be folded.")
        from .transforms import AbsTransform

        super().__init__(base_dist, AbsTransform(), validate_args=validate_args)

    @validate_sample
    def log_prob(self, value):
        # p(|X| = v) = p(X = v) + p(X = -v): stack the two signs on a fresh
        # leading axis and logsumexp it away
        signs = jnp.array([1.0, -1.0]).reshape(
            (2,) + (1,) * max(len(self.batch_shape), jnp.ndim(value))
        )
        return logsumexp(self.base_dist.log_prob(signs * value), axis=0)


class Delta(Distribution):
    arg_constraints = {
        "v": constraints.dependent(is_discrete=False),
        "log_density": constraints.real,
    }
    reparametrized_params = ["v", "log_density"]
    pytree_data_fields = ("v", "log_density")

    def __init__(self, v=0.0, log_density=0.0, event_dim=0, *, validate_args=None):
        vshape = jnp.shape(v)
        if event_dim > len(vshape):
            raise ValueError(
                f"Expected event_dim <= v.dim(), actual {event_dim} vs "
                f"{len(vshape)}"
            )
        split = len(vshape) - event_dim
        self.v = v
        (self.log_density,) = promote_shapes(log_density, shape=vshape[:split])
        super().__init__(vshape[:split], vshape[split:], validate_args=validate_args)

    @property
    def support(self):
        return constraints.independent(constraints.real, self.event_dim)

    def sample(self, key, sample_shape=()):
        return jnp.broadcast_to(self.v, self.shape(sample_shape))

    @validate_sample
    def log_prob(self, value):
        hit = jnp.where(value == self.v, 0.0, -jnp.inf)
        return sum_rightmost(hit, self.event_dim) + self.log_density

    @property
    def mean(self):
        return self.v

    @property
    def variance(self):
        return jnp.zeros(self.shape())


class Unit(Distribution):
    """Trivial nonnormalized distribution over the empty event — the carrier
    of a bare ``log_factor`` (used by the ``factor`` primitive)."""

    arg_constraints = {"log_factor": constraints.real}
    support = constraints.real
    pytree_data_fields = ("log_factor",)

    def __init__(self, log_factor, *, validate_args=None):
        self.log_factor = log_factor
        # size-zero event so sampled values are empty arrays
        super().__init__(
            jnp.shape(log_factor), (0,), validate_args=validate_args
        )

    def sample(self, key, sample_shape=()):
        return jnp.empty(self.shape(sample_shape))

    def log_prob(self, value):
        out = lax.broadcast_shapes(self.batch_shape, jnp.shape(value)[:-1])
        return jnp.broadcast_to(self.log_factor, out)


class ImproperUniform(Distribution):
    """Improper (unnormalized) flat prior over an arbitrary support —
    log_prob is identically 0 inside the support."""

    arg_constraints = {}
    pytree_aux_fields = ("support",)

    def __init__(self, support, batch_shape, event_shape, *, validate_args=None):
        self.support = constraints.independent(
            support, len(event_shape) - support.event_dim
        )
        super().__init__(batch_shape, event_shape, validate_args=validate_args)

    @validate_sample
    def log_prob(self, value):
        lead = jnp.ndim(value) - self.event_dim
        return jnp.zeros(
            lax.broadcast_shapes(jnp.shape(value)[:lead], self.batch_shape)
        )

    def _validate_sample(self, value):
        ok = super()._validate_sample(value)
        lead = jnp.ndim(value) - self.event_dim
        if lead < jnp.ndim(ok):
            ok = ok.all(tuple(range(lead - jnp.ndim(ok), 0)))
        return ok

    def sample(self, key, sample_shape=()):
        raise NotImplementedError(
            "ImproperUniform has no sampler; use an init strategy or "
            ".mask(False) over a proper prior instead"
        )
