"""Bijective transforms + the ``biject_to`` constraint registry.

Accelerator-native re-design of the transform layer of NumPyro
(reference: numpyro/distributions/transforms.py:64-1780).  A ``Transform``
maps a constrained domain to a codomain bijectively and reports
``log_abs_det_jacobian``; ``biject_to(constraint)`` returns a transform whose
codomain is that constraint — HMC/SVI run in the unconstrained preimage.

Everything here is shape-polymorphic pure jnp so a single transform instance
vectorizes over an arbitrary chain/batch prefix — the chain-massive engine
applies these to ``(num_chains, ...)`` arrays inside one XLA program.

Organisation note: the built-in constraint→transform table at the bottom is
declarative (one table, one loop) rather than a decorator per constraint.
"""

from __future__ import annotations

import math
import weakref

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import sigmoid, softplus
from jax.scipy.special import logit

from . import constraints

__all__ = [
    "biject_to",
    "AbsTransform",
    "AffineTransform",
    "CholeskyTransform",
    "ComplexTransform",
    "ComposeTransform",
    "CorrCholeskyTransform",
    "CorrMatrixCholeskyTransform",
    "ExpTransform",
    "IdentityTransform",
    "IndependentTransform",
    "L1BallTransform",
    "LowerCholeskyTransform",
    "LowerCholeskyAffine",
    "OrderedTransform",
    "PackRealFastFourierCoefficientsTransform",
    "PermuteTransform",
    "PowerTransform",
    "RealFastFourierTransform",
    "RecursiveLinearTransform",
    "ReshapeTransform",
    "ScaledUnitLowerCholeskyTransform",
    "SigmoidTransform",
    "SimplexToOrderedTransform",
    "SoftplusLowerCholeskyTransform",
    "SoftplusTransform",
    "StickBreakingTransform",
    "Transform",
    "UnpackTransform",
    "ZeroSumTransform",
]


def _clipped_expit(x):
    eps = jnp.finfo(jnp.result_type(x, float))
    return jnp.clip(sigmoid(x), eps.tiny, 1.0 - eps.eps)


def sum_rightmost(x, dim):
    """Sum the rightmost ``dim`` dimensions of ``x``."""
    return x.sum(tuple(range(-dim, 0))) if dim else x


def _same_params(a, b, names):
    """Structural equality by np.array_equal over the named attributes."""
    if type(a) is not type(b):
        return False
    return all(np.array_equal(getattr(a, n), getattr(b, n)) for n in names)


class Transform:
    """Base transform.  Every subclass is auto-registered as a JAX pytree so
    transforms (and distributions containing them) can cross jit/vmap/scan
    boundaries: declare traced attributes in ``pytree_data_fields`` and
    static attributes in ``pytree_aux_fields`` (mirrors the Distribution
    flatten protocol; reference registers transforms as pytrees too,
    numpyro/distributions/transforms.py:64)."""

    domain = constraints.real
    codomain = constraints.real
    _inv = None
    pytree_data_fields: tuple = ()
    pytree_aux_fields: tuple = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        jax.tree_util.register_pytree_node(
            cls, cls._pytree_flatten, cls._pytree_unflatten
        )

    @classmethod
    def _gather_fields(cls, attr):
        fields = []
        for base in cls.__mro__:
            for f in base.__dict__.get(attr, ()):
                if f not in fields:
                    fields.append(f)
        return tuple(fields)

    def _pytree_flatten(self):
        data_fields = type(self)._gather_fields("pytree_data_fields")
        aux_fields = type(self)._gather_fields("pytree_aux_fields")
        data = tuple(getattr(self, f, None) for f in data_fields)
        aux = tuple(getattr(self, f, None) for f in aux_fields)
        return data, (data_fields, aux_fields, aux)

    @classmethod
    def _pytree_unflatten(cls, aux_data, params):
        data_fields, aux_fields, aux = aux_data
        self = cls.__new__(cls)
        for f, v in zip(data_fields, params):
            setattr(self, f, v)
        for f, v in zip(aux_fields, aux):
            setattr(self, f, v)
        return self

    @property
    def inv(self):
        # cache the inverse view weakly so t.inv.inv is t
        cached = self._inv() if self._inv is not None else None
        if cached is None:
            cached = _InverseTransform(self)
            self._inv = weakref.ref(cached)
        return cached

    def __call__(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        raise NotImplementedError

    def call_with_intermediates(self, x):
        return self(x), None

    def forward_shape(self, shape):
        """Output event+batch shape given input shape."""
        return shape

    def inverse_shape(self, shape):
        return shape

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class _InverseTransform(Transform):
    pytree_data_fields = ("_transform",)

    def __init__(self, transform):
        super().__init__()
        self._transform = transform

    @property
    def domain(self):
        return self._transform.codomain

    @property
    def codomain(self):
        return self._transform.domain

    @property
    def inv(self):
        return self._transform

    def __call__(self, x):
        return self._transform._inverse(x)

    def _inverse(self, y):
        return self._transform(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return -self._transform.log_abs_det_jacobian(y, x, None)

    def forward_shape(self, shape):
        return self._transform.inverse_shape(shape)

    def inverse_shape(self, shape):
        return self._transform.forward_shape(shape)

    def __eq__(self, other):
        return type(self) is type(other) and self._transform == other._transform


class IdentityTransform(Transform):
    def __call__(self, x):
        return x

    def _inverse(self, y):
        return y

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.zeros_like(x)


class AbsTransform(Transform):
    domain = constraints.real
    codomain = constraints.positive

    def __call__(self, x):
        return jnp.abs(x)

    def _inverse(self, y):
        return y


class AffineTransform(Transform):
    """y = loc + scale * x"""

    pytree_data_fields = ("loc", "scale")
    pytree_aux_fields = ("domain",)

    def __init__(self, loc, scale, domain=constraints.real):
        self.loc = loc
        self.scale = scale
        self.domain = domain

    @property
    def codomain(self):
        dom = self.domain
        if dom is constraints.real:
            return constraints.real
        if isinstance(dom, constraints.independent):
            inner = AffineTransform(self.loc, self.scale, dom.base_constraint)
            return constraints.independent(
                inner.codomain, dom.reinterpreted_batch_ndims
            )
        # the bounded cases assume scale > 0 for constraint propagation
        if dom is constraints.positive:
            return constraints.greater_than(self(0.0))
        if isinstance(dom, constraints.greater_than):
            return constraints.greater_than(self(dom.lower_bound))
        if isinstance(dom, constraints.less_than):
            return constraints.less_than(self(dom.upper_bound))
        if isinstance(dom, constraints.interval):
            return constraints.interval(self(dom.lower_bound), self(dom.upper_bound))
        raise NotImplementedError

    def __call__(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.broadcast_to(jnp.log(jnp.abs(self.scale)), jnp.shape(x))

    def forward_shape(self, shape):
        return lax.broadcast_shapes(
            shape, jnp.shape(self.loc), jnp.shape(self.scale)
        )

    inverse_shape = forward_shape

    def __eq__(self, other):
        return _same_params(self, other, ("loc", "scale"))


class ExpTransform(Transform):
    pytree_aux_fields = ("domain",)
    domain = constraints.real
    codomain = constraints.positive

    def __init__(self, domain=constraints.real):
        self.domain = domain

    @property
    def codomain(self):
        dom = self.domain
        if dom is constraints.real:
            return constraints.positive
        if isinstance(dom, constraints.greater_than):
            return constraints.greater_than(jnp.exp(dom.lower_bound))
        if isinstance(dom, constraints.interval):
            return constraints.interval(
                jnp.exp(dom.lower_bound), jnp.exp(dom.upper_bound)
            )
        raise NotImplementedError

    def __call__(self, x):
        return jnp.exp(x)

    def _inverse(self, y):
        return jnp.log(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x


class SigmoidTransform(Transform):
    codomain = constraints.unit_interval

    def __call__(self, x):
        return _clipped_expit(x)

    def _inverse(self, y):
        return logit(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # log sigmoid'(x) = log σ(x) + log σ(-x)
        return -softplus(x) - softplus(-x)


class SoftplusTransform(Transform):
    """y = log(1 + exp(x)); smooth map onto the positive reals with better
    behavior than exp far from 0 (no overflow, unit slope asymptotically)."""

    domain = constraints.real
    codomain = constraints.softplus_positive

    def __call__(self, x):
        return softplus(x)

    def _inverse(self, y):
        # log(exp(y) - 1) computed stably
        return y + jnp.log(-jnp.expm1(-y))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return -softplus(-x)


class PowerTransform(Transform):
    pytree_data_fields = ("exponent",)
    domain = constraints.positive
    codomain = constraints.positive

    def __init__(self, exponent):
        self.exponent = exponent

    def __call__(self, x):
        return jnp.power(x, self.exponent)

    def _inverse(self, y):
        return jnp.power(y, jnp.reciprocal(self.exponent))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.log(jnp.abs(self.exponent * y / x))

    def forward_shape(self, shape):
        return lax.broadcast_shapes(shape, jnp.shape(self.exponent))

    inverse_shape = forward_shape

    def __eq__(self, other):
        return _same_params(self, other, ("exponent",))


class ComposeTransform(Transform):
    pytree_data_fields = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def domain(self):
        # thread event_dim backwards through the chain
        needed = self.parts[-1].domain.event_dim
        for part in reversed(self.parts[:-1]):
            needed = part.domain.event_dim + max(
                needed - part.codomain.event_dim, 0
            )
        head = self.parts[0].domain
        if head.event_dim < needed:
            return constraints.independent(head, needed - head.event_dim)
        return head

    @property
    def codomain(self):
        produced = self.parts[0].codomain.event_dim
        for part in self.parts[1:]:
            produced = part.codomain.event_dim + max(
                produced - part.domain.event_dim, 0
            )
        tail = self.parts[-1].codomain
        if tail.event_dim < produced:
            return constraints.independent(tail, produced - tail.event_dim)
        return tail

    def __call__(self, x):
        for part in self.parts:
            x = part(x)
        return x

    def _inverse(self, y):
        for part in reversed(self.parts):
            y = part.inv(y)
        return y

    def call_with_intermediates(self, x):
        stages = []
        for part in self.parts[:-1]:
            out, inter = part.call_with_intermediates(x)
            stages.append([x, inter])
            x = out
        out, inter = self.parts[-1].call_with_intermediates(x)
        stages.append([x, inter])
        return out, stages

    def _stages(self, x, y, intermediates):
        """Yield (part, x_i, y_i, inter_i) for each link in the chain."""
        if intermediates is None:
            inputs, here = [], x
            for part in self.parts[:-1]:
                inputs.append((here, None))
                here = part(here)
            inputs.append((here, None))
        else:
            if len(intermediates) != len(self.parts):
                raise ValueError("intermediates length mismatch")
            inputs = [(pair[0], pair[1]) for pair in intermediates]
        outputs = [pair[0] for pair in inputs[1:]] + [y]
        for part, (x_i, inter_i), y_i in zip(self.parts, inputs, outputs):
            yield part, x_i, y_i, inter_i

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        total = 0.0
        event_dim = self.domain.event_dim
        for part, x_i, y_i, inter_i in self._stages(x, y, intermediates):
            term = part.log_abs_det_jacobian(x_i, y_i, intermediates=inter_i)
            extra = event_dim - part.domain.event_dim
            total = total + sum_rightmost(term, extra)
            event_dim = part.codomain.event_dim + extra
        return total

    def forward_shape(self, shape):
        for part in self.parts:
            shape = part.forward_shape(shape)
        return shape

    def inverse_shape(self, shape):
        for part in reversed(self.parts):
            shape = part.inverse_shape(shape)
        return shape

    def __eq__(self, other):
        return type(self) is type(other) and self.parts == other.parts


class IndependentTransform(Transform):
    """Reinterpret rightmost batch dims of a transform as event dims."""

    pytree_data_fields = ("base_transform",)
    pytree_aux_fields = ("reinterpreted_batch_ndims",)

    def __init__(self, base_transform, reinterpreted_batch_ndims):
        self.base_transform = base_transform
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def domain(self):
        return constraints.independent(
            self.base_transform.domain, self.reinterpreted_batch_ndims
        )

    @property
    def codomain(self):
        return constraints.independent(
            self.base_transform.codomain, self.reinterpreted_batch_ndims
        )

    def __call__(self, x):
        return self.base_transform(x)

    def _inverse(self, y):
        return self.base_transform._inverse(y)

    def call_with_intermediates(self, x):
        return self.base_transform.call_with_intermediates(x)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        per_element = self.base_transform.log_abs_det_jacobian(
            x, y, intermediates
        )
        return sum_rightmost(per_element, self.reinterpreted_batch_ndims)

    def forward_shape(self, shape):
        return self.base_transform.forward_shape(shape)

    def inverse_shape(self, shape):
        return self.base_transform.inverse_shape(shape)

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.base_transform == other.base_transform
            and self.reinterpreted_batch_ndims == other.reinterpreted_batch_ndims
        )


class StickBreakingTransform(Transform):
    """R^{K-1} -> K-simplex via stick breaking (logistic sticks)."""

    domain = constraints.real_vector
    codomain = constraints.simplex

    @staticmethod
    def _stick_offset(k_minus_1, dtype):
        # shift by log(K - k) so zero maps to the uniform simplex point
        return jnp.log(jnp.arange(k_minus_1, 0, -1, dtype=dtype))

    def __call__(self, x):
        fracs = _clipped_expit(
            x - self._stick_offset(x.shape[-1], jnp.result_type(x, float))
        )
        leftover = jnp.cumprod(1.0 - fracs, axis=-1)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, 1)]
        fracs_ext = jnp.pad(fracs, pad, constant_values=1.0)
        leftover_ext = jnp.pad(leftover, pad, constant_values=1.0)
        return fracs_ext * jnp.roll(leftover_ext, shift=1, axis=-1)

    def _inverse(self, y):
        head = y[..., :-1]
        leftover = jnp.clip(
            1.0 - jnp.cumsum(head, axis=-1), jnp.finfo(y.dtype).tiny
        )
        prev_leftover = jnp.concatenate(
            [jnp.ones_like(head[..., :1]), leftover[..., :-1]], -1
        )
        # logit of the stick fraction, then undo the offset
        raw = jnp.log(head) - jnp.log(prev_leftover - head)
        return raw + self._stick_offset(y.shape[-1] - 1, y.dtype)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        shifted = x - self._stick_offset(
            x.shape[-1], jnp.result_type(x, float)
        )
        leftover = 1.0 - jnp.cumsum(y[..., :-1], axis=-1)
        prev_leftover = jnp.concatenate(
            [
                jnp.ones_like(x[..., :1]),
                jnp.clip(leftover[..., :-1], jnp.finfo(x.dtype).tiny),
            ],
            -1,
        )
        # |dy_k / dx_k| = sigmoid'(x_k) * prod_{j<k}(1 - z_j)
        per_stick = (
            -softplus(shifted) - softplus(-shifted) + jnp.log(prev_leftover)
        )
        return per_stick.sum(-1)

    def forward_shape(self, shape):
        if not shape:
            raise ValueError("Too few dimensions on input")
        return shape[:-1] + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        if not shape:
            raise ValueError("Too few dimensions on input")
        return shape[:-1] + (shape[-1] - 1,)


class OrderedTransform(Transform):
    """R^K -> ordered vectors: y_1 = x_1, y_k = y_{k-1} + exp(x_k)."""

    domain = constraints.real_vector
    codomain = constraints.ordered_vector

    def __call__(self, x):
        gaps = jnp.exp(x[..., 1:])
        return jnp.cumsum(jnp.concatenate([x[..., :1], gaps], axis=-1), axis=-1)

    def _inverse(self, y):
        log_gaps = jnp.log(jnp.diff(y, axis=-1))
        return jnp.concatenate([y[..., :1], log_gaps], axis=-1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x[..., 1:].sum(-1)


class SimplexToOrderedTransform(Transform):
    """Simplex -> ordered cutpoints via logit of the CDF (anchor point)."""

    pytree_data_fields = ("anchor_point",)
    domain = constraints.simplex
    codomain = constraints.ordered_vector

    def __init__(self, anchor_point=0.0):
        self.anchor_point = anchor_point

    def __call__(self, x):
        cdf = jnp.cumsum(x[..., :-1], axis=-1)
        return logit(cdf) + jnp.expand_dims(self.anchor_point, -1)

    def _inverse(self, y):
        cdf = sigmoid(y - jnp.expand_dims(self.anchor_point, -1))
        pad = [(0, 0)] * (cdf.ndim - 1)
        upper = jnp.pad(cdf, pad + [(0, 1)], constant_values=1.0)
        lower = jnp.pad(cdf, pad + [(1, 0)], constant_values=0.0)
        return upper - lower

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # d logit(s)/ds = 1/(s(1-s)) at s = cumsum(x[:-1])
        cdf = jnp.cumsum(x[..., :-1], axis=-1)
        return -(jnp.log(cdf) + jnp.log1p(-cdf)).sum(-1)

    def forward_shape(self, shape):
        return shape[:-1] + (shape[-1] - 1,)

    def inverse_shape(self, shape):
        return shape[:-1] + (shape[-1] + 1,)

    def __eq__(self, other):
        return _same_params(self, other, ("anchor_point",))
# ---------------------------------------------------------------------------
# Triangular-matrix machinery


def _tril_size_to_dim(n, diagonal=0):
    """Invert N = D(D+1)/2 (with optional diagonal offset folded in)."""
    d = round(math.sqrt(0.25 + 2 * n) - 0.5)
    return d - diagonal


def _matrix_forward_shape(shape, offset=0):
    # (..., N) -> (..., D, D) where N = D*(D+1)/2 + offset*D
    if not shape:
        raise ValueError("Too few dimensions on input")
    n = shape[-1]
    d = _tril_size_to_dim(n)
    if d * (d + 1) // 2 != n:
        raise ValueError("Input is not a flattened lower-diagonal number")
    d = d - offset
    return shape[:-1] + (d, d)


def _matrix_inverse_shape(shape, offset=0):
    if len(shape) < 2:
        raise ValueError("Too few dimensions on input")
    if shape[-2] != shape[-1]:
        raise ValueError("Input is not square")
    d = shape[-1] + offset
    return shape[:-2] + (d * (d + 1) // 2,)


def vec_to_tril_matrix(x, diagonal=0):
    """Unpack a (..., N) vector into a (..., D, D) lower-triangular matrix."""
    d = _tril_size_to_dim(x.shape[-1], diagonal)
    rows, cols = jnp.tril_indices(d, diagonal)
    out = jnp.zeros(x.shape[:-1] + (d, d), dtype=x.dtype)
    return out.at[..., rows, cols].set(x)


def matrix_to_tril_vec(x, diagonal=0):
    rows, cols = jnp.tril_indices(x.shape[-1], diagonal)
    return x[..., rows, cols]


def _embed_diag(vals):
    """(..., D) -> (..., D, D) diagonal matrices, batched."""
    return vals[..., None] * jnp.eye(vals.shape[-1], dtype=vals.dtype)


class CorrCholeskyTransform(Transform):
    r"""R^{D(D-1)/2} -> Cholesky factors of correlation matrices.

    Signed-stick-breaking construction (tanh rows, unit-norm rows), the
    standard unconstrained parameterization for LKJCholesky-distributed
    latents.
    """

    domain = constraints.real_vector
    codomain = constraints.corr_cholesky

    def __call__(self, x):
        # 1. vector to strictly-lower triangular of tanh values
        t = vec_to_tril_matrix(jnp.tanh(x), diagonal=-1)
        # 2. row-wise stick breaking onto the sphere:
        # r_ij = t_ij * sqrt(prod_{k<j} (1 - t_ik^2))
        budget = jnp.cumprod(1.0 - jnp.square(t), axis=-1)
        budget_before = jnp.pad(
            budget[..., :-1],
            [(0, 0)] * (t.ndim - 1) + [(1, 0)],
            constant_values=1.0,
        )
        r = t * jnp.sqrt(jnp.clip(budget_before, 0.0))
        # diagonal completes each row to unit norm
        diag = jnp.sqrt(jnp.clip(1.0 - jnp.square(r).sum(-1), 0.0))
        return r + _embed_diag(diag)

    def _inverse(self, y):
        # z_ij = y_ij / sqrt(1 - sum_{k<j} y_ik^2)
        used = jnp.cumsum(jnp.square(y), axis=-1) - jnp.square(y)
        room = jnp.sqrt(jnp.clip(1.0 - used, jnp.finfo(y.dtype).tiny))
        return jnp.arctanh(matrix_to_tril_vec(y / room, diagonal=-1))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # tanh part: sum log(1 - tanh^2 x) = sum 2(log2 - x - softplus(-2x))
        tanh_part = -2.0 * (x + softplus(-2.0 * x) - math.log(2.0)).sum(-1)
        # sphere part: half log of the per-entry remaining budget, summed
        # over the strictly-lower triangle
        used = jnp.cumsum(jnp.square(y), axis=-1) - jnp.square(y)
        room = jnp.clip(1.0 - used, jnp.finfo(y.dtype).tiny)
        d = y.shape[-1]
        below_diag = jnp.tril(jnp.ones((d, d), dtype=bool), k=-1)
        sphere_part = 0.5 * jnp.where(below_diag, jnp.log(room), 0.0).sum((-2, -1))
        return sphere_part + tanh_part

    def forward_shape(self, shape):
        return _matrix_forward_shape(shape, offset=-1)

    def inverse_shape(self, shape):
        return _matrix_inverse_shape(shape, offset=-1)


class CholeskyTransform(Transform):
    """positive-definite matrix -> its lower Cholesky factor."""

    domain = constraints.positive_definite
    codomain = constraints.lower_cholesky

    def __call__(self, x):
        return jnp.linalg.cholesky(x)

    def _inverse(self, y):
        return y @ jnp.swapaxes(y, -2, -1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # log det of dL/dX for X = L L^T
        d = x.shape[-1]
        diag = jnp.diagonal(y, axis1=-2, axis2=-1)
        weights = -jnp.arange(d, 0, -1, dtype=x.dtype)
        return (weights * jnp.log(diag)).sum(-1) - d * math.log(2.0)


class CorrMatrixCholeskyTransform(CholeskyTransform):
    domain = constraints.corr_matrix
    codomain = constraints.corr_cholesky

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        d = x.shape[-1]
        diag = jnp.diagonal(y, axis1=-2, axis2=-1)
        weights = -jnp.arange(d - 1, -1, -1, dtype=x.dtype)
        return (weights * jnp.log(diag)).sum(-1)


class LowerCholeskyTransform(Transform):
    """R^{D(D+1)/2} -> lower-Cholesky matrices (exp on the diagonal)."""

    domain = constraints.real_vector
    codomain = constraints.lower_cholesky

    def _diag_transform(self, x):
        return jnp.exp(x)

    def _diag_inverse(self, y):
        return jnp.log(y)

    def _split(self, x):
        d = _tril_size_to_dim(x.shape[-1])
        return x[..., :-d], x[..., -d:], d

    def __call__(self, x):
        below, raw_diag, _ = self._split(x)
        return vec_to_tril_matrix(below, diagonal=-1) + _embed_diag(
            self._diag_transform(raw_diag)
        )

    def _inverse(self, y):
        below = matrix_to_tril_vec(y, diagonal=-1)
        raw_diag = self._diag_inverse(jnp.diagonal(y, axis1=-2, axis2=-1))
        return jnp.concatenate([below, raw_diag], axis=-1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        _, raw_diag, _ = self._split(x)
        return raw_diag.sum(-1)

    def forward_shape(self, shape):
        return _matrix_forward_shape(shape)

    def inverse_shape(self, shape):
        return _matrix_inverse_shape(shape)


class SoftplusLowerCholeskyTransform(LowerCholeskyTransform):
    codomain = constraints.softplus_lower_cholesky

    def _diag_transform(self, x):
        return softplus(x)

    def _diag_inverse(self, y):
        return y + jnp.log(-jnp.expm1(-y))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        _, raw_diag, _ = self._split(x)
        return -softplus(-raw_diag).sum(-1)


class ScaledUnitLowerCholeskyTransform(LowerCholeskyTransform):
    r"""LKJCholesky-friendly parameterization: L = diag(s) @ L_unit where
    L_unit has unit row norms; better-conditioned than plain exp-diagonal for
    covariance Cholesky factors."""

    codomain = constraints.scaled_unit_lower_cholesky

    def __call__(self, x):
        below, log_scales, d = self._split(x)
        # unit-row-norm lower cholesky from unconstrained strictly-lower part
        rows = vec_to_tril_matrix(below, diagonal=-1) + jnp.eye(d, dtype=x.dtype)
        rows = rows / jnp.linalg.norm(rows, axis=-1, keepdims=True)
        return rows * jnp.exp(log_scales)[..., None]

    def _inverse(self, y):
        scales = jnp.linalg.norm(y, axis=-1)
        rows = y / scales[..., None]
        rows = rows / jnp.diagonal(rows, axis1=-2, axis2=-1)[..., None]
        return jnp.concatenate(
            [matrix_to_tril_vec(rows, diagonal=-1), jnp.log(scales)], axis=-1
        )

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # numeric per-event jacobian determinant: this transform only
        # parameterizes guide covariances (no HMC hot path)
        def one(v):
            jac = jax.jacfwd(lambda u: matrix_to_tril_vec(self(u)))(v)
            return jnp.linalg.slogdet(jac)[1]

        for _ in range(x.ndim - 1):
            one = jax.vmap(one)
        return one(x)


class L1BallTransform(Transform):
    """R^K -> the open unit L1 ball."""

    domain = constraints.real_vector
    codomain = constraints.l1_ball

    def __call__(self, x):
        # stick-breaking on the absolute values, signs carried by x
        eps = jnp.finfo(x.dtype)
        sticks = 2.0 * sigmoid(jnp.abs(x)) - 1.0  # in (0, 1)
        budget = jnp.cumprod(1.0 - sticks, axis=-1) / jnp.clip(
            1.0 - sticks, eps.tiny
        )
        return jnp.sign(x) * sticks * budget

    def _inverse(self, y):
        eps = jnp.finfo(y.dtype)
        mag = jnp.abs(y)
        budget = 1.0 - jnp.cumsum(mag, axis=-1) + mag
        sticks = mag / jnp.clip(budget, eps.tiny)
        half = jnp.clip(0.5 * (sticks + 1.0), eps.tiny, 1.0 - eps.eps)
        return jnp.sign(y) * logit(half)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        def one(v):
            return jnp.linalg.slogdet(jax.jacfwd(self)(v))[1]

        for _ in range(x.ndim - 1):
            one = jax.vmap(one)
        return one(x)


class PermuteTransform(Transform):
    pytree_data_fields = ("permutation",)
    domain = constraints.real_vector
    codomain = constraints.real_vector

    def __init__(self, permutation):
        self.permutation = permutation

    def __call__(self, x):
        return x[..., self.permutation]

    def _inverse(self, y):
        order = self.permutation
        undo = jnp.zeros_like(jnp.asarray(order)).at[order].set(
            jnp.arange(jnp.size(order))
        )
        return y[..., undo]

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.zeros(jnp.shape(x)[:-1], dtype=x.dtype)

    def __eq__(self, other):
        return _same_params(self, other, ("permutation",))


class UnpackTransform(Transform):
    """Flat trailing-axis vector -> pytree of subarrays via a user-supplied
    unpack callable (typically the unravel fn from ``ravel_pytree``); the
    workhorse behind packed-latent autoguides (reference:
    numpyro/distributions/transforms.py:1135).  Leading batch axes are
    handled by vmapping the unpack callable over a flattened batch.

    :param unpack_fn: ``(D,) -> pytree``.
    :param pack_fn: ``pytree -> (D,)``; required for ``.inv`` (single,
        unbatched pytrees only — batched pytrees cannot be distinguished
        from wider unbatched ones by shape alone).
    """

    domain = constraints.real_vector
    codomain = constraints.dependent
    pytree_aux_fields = ("unpack_fn", "pack_fn")

    def __init__(self, unpack_fn, pack_fn=None):
        self.unpack_fn = unpack_fn
        self.pack_fn = pack_fn

    def __call__(self, x):
        batch_shape = jnp.shape(x)[:-1]
        if not batch_shape:
            return self.unpack_fn(x)
        flat = jnp.reshape(x, (-1, jnp.shape(x)[-1]))
        out = jax.vmap(self.unpack_fn)(flat)
        return jax.tree_util.tree_map(
            lambda z: jnp.reshape(z, batch_shape + z.shape[1:]), out
        )

    def _inverse(self, y):
        if self.pack_fn is None:
            raise NotImplementedError(
                "UnpackTransform.inv requires a pack_fn."
            )
        return self.pack_fn(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.zeros(jnp.shape(x)[:-1])

    def forward_shape(self, shape):
        raise NotImplementedError

    def inverse_shape(self, shape):
        raise NotImplementedError

    def __eq__(self, other):
        return (
            isinstance(other, UnpackTransform)
            and self.unpack_fn is other.unpack_fn
            and self.pack_fn is other.pack_fn
        )

    __hash__ = Transform.__hash__


class ReshapeTransform(Transform):
    pytree_aux_fields = ("_forward_shape", "_inverse_shape")

    def __init__(self, forward_shape, inverse_shape):
        if math.prod(forward_shape) != math.prod(inverse_shape):
            raise ValueError("shape sizes must match")
        self._forward_shape = tuple(forward_shape)
        self._inverse_shape = tuple(inverse_shape)

    @property
    def domain(self):
        return constraints.independent(constraints.real, len(self._inverse_shape))

    @property
    def codomain(self):
        return constraints.independent(constraints.real, len(self._forward_shape))

    def _swap_event(self, shape, source, target):
        keep = len(shape) - len(source)
        if keep < 0 or shape[keep:] != source:
            raise ValueError(f"cannot reshape {shape}")
        return shape[:keep] + target

    def forward_shape(self, shape):
        return self._swap_event(shape, self._inverse_shape, self._forward_shape)

    def inverse_shape(self, shape):
        return self._swap_event(shape, self._forward_shape, self._inverse_shape)

    def __call__(self, x):
        return jnp.reshape(x, self.forward_shape(jnp.shape(x)))

    def _inverse(self, y):
        return jnp.reshape(y, self.inverse_shape(jnp.shape(y)))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        keep = jnp.ndim(x) - len(self._inverse_shape)
        return jnp.zeros(jnp.shape(x)[:keep], dtype=x.dtype)

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self._forward_shape == other._forward_shape
            and self._inverse_shape == other._inverse_shape
        )


class LowerCholeskyAffine(Transform):
    """y = loc + L @ x with L lower-triangular (MVN whitening transform)."""

    pytree_data_fields = ("loc", "scale_tril")
    domain = constraints.real_vector
    codomain = constraints.real_vector

    def __init__(self, loc, scale_tril):
        if jnp.ndim(scale_tril) != 2:
            raise ValueError("scale_tril must be a 2D matrix")
        self.loc = loc
        self.scale_tril = scale_tril

    def __call__(self, x):
        return self.loc + (self.scale_tril @ x[..., None])[..., 0]

    def _inverse(self, y):
        centered = y - self.loc
        flat_t = jnp.reshape(centered, (-1, jnp.shape(y)[-1])).T
        solved = jax.scipy.linalg.solve_triangular(
            self.scale_tril, flat_t, lower=True
        )
        return jnp.reshape(solved.T, jnp.shape(y))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        half_logdet = jnp.log(
            jnp.diagonal(self.scale_tril, axis1=-2, axis2=-1)
        ).sum(-1)
        return jnp.broadcast_to(half_logdet, jnp.shape(x)[:-1])

    def forward_shape(self, shape):
        if not shape:
            raise ValueError("Too few dimensions on input")
        return lax.broadcast_shapes(
            shape, jnp.shape(self.loc), jnp.shape(self.scale_tril)[:-1]
        )

    inverse_shape = forward_shape

    def __eq__(self, other):
        return _same_params(self, other, ("loc", "scale_tril"))


class ZeroSumTransform(Transform):
    """R^{n-1} per axis -> zero-sum vectors via the Householder-style map
    used for ZeroSumNormal."""

    pytree_aux_fields = ("transform_ndims",)

    def __init__(self, transform_ndims=1):
        self.transform_ndims = transform_ndims

    @property
    def domain(self):
        return constraints.independent(constraints.real, self.transform_ndims)

    @property
    def codomain(self):
        return constraints.zero_sum(self.transform_ndims)

    @staticmethod
    def _append_zero_sum_slot(x, axis):
        n = x.shape[axis] + 1
        total = x.sum(axis, keepdims=True)
        shift = total / (math.sqrt(n) + n)
        slot = shift - total / math.sqrt(n)
        return jnp.concatenate([x, slot], axis=axis) - shift

    @staticmethod
    def _drop_zero_sum_slot(y, axis):
        n = y.shape[axis]
        slot = jnp.take(y, jnp.array([n - 1]), axis=axis)
        total = -slot * math.sqrt(n)
        shift = total / (math.sqrt(n) + n)
        return jnp.take(y, jnp.arange(n - 1), axis=axis) + shift

    def __call__(self, x):
        for axis in range(-self.transform_ndims, 0):
            x = self._append_zero_sum_slot(x, axis)
        return x

    def _inverse(self, y):
        for axis in range(-self.transform_ndims, 0):
            y = self._drop_zero_sum_slot(y, axis)
        return y

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.zeros(x.shape[: x.ndim - self.transform_ndims], dtype=x.dtype)

    def forward_shape(self, shape):
        k = self.transform_ndims
        return shape[:-k] + tuple(s + 1 for s in shape[-k:])

    def inverse_shape(self, shape):
        k = self.transform_ndims
        return shape[:-k] + tuple(s - 1 for s in shape[-k:])

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.transform_ndims == other.transform_ndims
        )


class ComplexTransform(Transform):
    """Pair of reals <-> complex number
    (reference: numpyro/distributions/transforms.py:1594)."""

    domain = constraints.real_vector
    codomain = constraints.complex

    def __call__(self, x):
        assert x.shape[-1] == 2, "Input must have a trailing dimension of size 2."
        return lax.complex(x[..., 0], x[..., 1])

    def _inverse(self, y):
        return jnp.stack([y.real, y.imag], axis=-1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.zeros_like(y, dtype=jnp.result_type(float))

    def forward_shape(self, shape):
        assert shape[-1] == 2, "Input must have a trailing dimension of size 2."
        return shape[:-1]

    def inverse_shape(self, shape):
        return shape + (2,)


class RealFastFourierTransform(Transform):
    """N-dimensional real FFT over the trailing ``transform_ndims`` axes
    (reference: numpyro/distributions/transforms.py:1269)."""

    pytree_aux_fields = ("transform_shape", "transform_ndims")

    def __init__(self, transform_shape=None, transform_ndims=1):
        if isinstance(transform_shape, int):
            transform_shape = (transform_shape,)
        if transform_shape is not None and len(transform_shape) != transform_ndims:
            raise ValueError(
                f"Length of transform shape ({transform_shape}) does not match "
                f"number of dimensions to transform ({transform_ndims})."
            )
        self.transform_shape = transform_shape
        self.transform_ndims = transform_ndims

    def _axes(self):
        return tuple(range(-self.transform_ndims, 0))

    def _with_event(self, shape):
        if self.transform_shape is None:
            return shape
        keep = len(shape) - len(self.transform_shape)
        return shape[:keep] + tuple(self.transform_shape)

    def __call__(self, x):
        return jnp.fft.rfftn(x, self.transform_shape, self._axes())

    def _inverse(self, y):
        return jnp.fft.irfftn(y, self.transform_shape, self._axes())

    def forward_shape(self, shape):
        shape = self._with_event(shape)
        return shape[:-1] + (shape[-1] // 2 + 1,)

    def inverse_shape(self, shape):
        if self.transform_shape:
            return self._with_event(shape)
        return shape[:-1] + (2 * (shape[-1] - 1),)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        k = self.transform_ndims
        batch = jnp.broadcast_shapes(x.shape[: x.ndim - k], y.shape[: y.ndim - k])
        event = x.shape[x.ndim - k:]
        size = math.prod(event)
        n_self_conjugate = math.prod(2 - s % 2 for s in event)
        const = 0.5 * (
            size * math.log(size) - math.log(2.0) * (size - n_self_conjugate)
        )
        return jnp.full(batch, const)

    @property
    def domain(self):
        return constraints.independent(constraints.real, self.transform_ndims)

    @property
    def codomain(self):
        return constraints.independent(constraints.complex, self.transform_ndims)

    def __eq__(self, other):
        return (
            isinstance(other, RealFastFourierTransform)
            and self.transform_ndims == other.transform_ndims
            and self.transform_shape == other.transform_shape
        )


class PackRealFastFourierCoefficientsTransform(Transform):
    """Real vector <-> packed complex rFFT coefficient vector
    (reference: numpyro/distributions/transforms.py:1348)."""

    pytree_aux_fields = ("shape",)
    domain = constraints.real_vector
    codomain = constraints.independent(constraints.complex, 1)

    def __init__(self, transform_shape=None):
        if transform_shape is not None and len(transform_shape) != 1:
            raise AssertionError(
                "Packing Fourier coefficients is only implemented for vectors."
            )
        self.shape = transform_shape

    @staticmethod
    def _split_counts(n):
        n_real = n // 2 + 1
        return n_real, n - n_real

    def forward_shape(self, shape):
        return shape[:-1] + (shape[-1] // 2 + 1,)

    def inverse_shape(self, shape):
        if self.shape is None:
            raise AssertionError(
                "Shape must be specified in `__init__` for inverse transform."
            )
        (n,) = self.shape
        if shape[-1] != n // 2 + 1:
            raise AssertionError("packed length mismatch")
        return shape[:-1] + (n,)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        batch = jnp.broadcast_shapes(x.shape[:-1], y.shape[:-1])
        return jnp.zeros(batch, dtype=jnp.result_type(float))

    def __call__(self, x):
        assert self.shape is None or self.shape == x.shape[-1:]
        n_real, n_imag = self._split_counts(x.shape[-1])
        cplx = jnp.result_type(x.dtype, jnp.complex64)
        packed = x[..., :n_real].astype(cplx)
        return packed.at[..., 1 : 1 + n_imag].add(1j * x[..., n_real:])

    def _inverse(self, y):
        (n,) = self.shape
        _, n_imag = self._split_counts(n)
        return jnp.concatenate([y.real, y.imag[..., 1 : n_imag + 1]], axis=-1)

    def __eq__(self, other):
        return (
            isinstance(other, PackRealFastFourierCoefficientsTransform)
            and self.shape == other.shape
        )


class RecursiveLinearTransform(Transform):
    """y_t = A y_{t-1} + x_t over the second-to-last axis (volume preserving;
    the scan is the only sequential axis — reference:
    numpyro/distributions/transforms.py:1416)."""

    pytree_data_fields = ("transition_matrix",)
    domain = constraints.real_matrix
    codomain = constraints.real_matrix

    def __init__(self, transition_matrix):
        self.transition_matrix = transition_matrix

    def _push(self, state):
        return jnp.einsum("...ij,...j->...i", self.transition_matrix, state)

    def __call__(self, x):
        shocks = jnp.moveaxis(x, -2, 0)

        def accumulate(state, shock):
            state = self._push(state) + shock
            return state, state

        _, path = lax.scan(
            accumulate, jnp.zeros_like(shocks, shape=shocks.shape[1:]), shocks
        )
        return jnp.moveaxis(path, 0, -2)

    def _inverse(self, y):
        path = jnp.moveaxis(y, -2, 0)
        lagged = jnp.roll(path, 1, axis=0).at[0].set(0)

        def recover(carry, pair):
            y_t, y_prev = pair
            return carry, y_t - self._push(y_prev)

        _, shocks = lax.scan(recover, path[-1], (path, lagged), reverse=True)
        return jnp.moveaxis(shocks, 0, -2)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return jnp.zeros(x.shape[:-2], dtype=jnp.result_type(float))

    def __eq__(self, other):
        return isinstance(other, RecursiveLinearTransform) and jnp.array_equal(
            self.transition_matrix, other.transition_matrix
        )


# ---------------------------------------------------------------------------
# biject_to registry: constraint -> transform onto that constraint
# ---------------------------------------------------------------------------


class ConstraintRegistry:
    def __init__(self):
        self._registry = {}

    def register(self, constraint, factory=None):
        if factory is None:
            return lambda factory: self.register(constraint, factory)
        key = type(constraint) if isinstance(
            constraint, constraints.Constraint
        ) else constraint
        self._registry[key] = factory
        return factory

    def __call__(self, constraint):
        try:
            factory = self._registry[type(constraint)]
        except KeyError as e:
            raise NotImplementedError(
                f"Cannot transform {type(constraint).__name__} constraint"
            ) from e
        return factory(constraint)


biject_to = ConstraintRegistry()


def _onto_interval(lo, width, domain):
    return ComposeTransform(
        [SigmoidTransform(), AffineTransform(lo, width, domain=domain)]
    )


def _onto_halfline(bound, direction):
    return ComposeTransform(
        [
            ExpTransform(),
            AffineTransform(bound, direction, domain=constraints.positive),
        ]
    )


# the built-in table: each row is (constraint singleton(s), factory)
_BUILTIN_BIJECTIONS = (
    (constraints.real, lambda c: IdentityTransform()),
    (
        constraints.independent,
        lambda c: IndependentTransform(
            biject_to(c.base_constraint), c.reinterpreted_batch_ndims
        ),
    ),
    ((constraints.positive, constraints.nonnegative), lambda c: ExpTransform()),
    (constraints.softplus_positive, lambda c: SoftplusTransform()),
    (
        (constraints.greater_than, constraints.greater_than_eq),
        lambda c: _onto_halfline(c.lower_bound, 1.0),
    ),
    (
        (constraints.less_than, constraints.less_than_eq),
        lambda c: _onto_halfline(c.upper_bound, -1.0),
    ),
    (constraints.unit_interval, lambda c: SigmoidTransform()),
    (
        (constraints.interval, constraints.open_interval),
        lambda c: _onto_interval(
            c.lower_bound,
            c.upper_bound - c.lower_bound,
            constraints.unit_interval,
        ),
    ),
    (
        constraints.circular,
        lambda c: _onto_interval(-math.pi, 2 * math.pi, constraints.unit_interval),
    ),
    (constraints.simplex, lambda c: StickBreakingTransform()),
    (constraints.ordered_vector, lambda c: OrderedTransform()),
    (
        constraints.positive_ordered_vector,
        lambda c: ComposeTransform([OrderedTransform(), ExpTransform()]),
    ),
    (constraints.corr_cholesky, lambda c: CorrCholeskyTransform()),
    (
        constraints.corr_matrix,
        lambda c: ComposeTransform(
            [CorrCholeskyTransform(), CorrMatrixCholeskyTransform().inv]
        ),
    ),
    (constraints.lower_cholesky, lambda c: LowerCholeskyTransform()),
    (
        constraints.scaled_unit_lower_cholesky,
        lambda c: ScaledUnitLowerCholeskyTransform(),
    ),
    (
        constraints.softplus_lower_cholesky,
        lambda c: SoftplusLowerCholeskyTransform(),
    ),
    (
        (constraints.positive_definite, constraints.positive_semidefinite),
        lambda c: ComposeTransform(
            [LowerCholeskyTransform(), CholeskyTransform().inv]
        ),
    ),
    (constraints.l1_ball, lambda c: L1BallTransform()),
    (constraints.zero_sum, lambda c: ZeroSumTransform(c.event_dim)),
)

for _targets, _factory in _BUILTIN_BIJECTIONS:
    if not isinstance(_targets, tuple):
        _targets = (_targets,)
    for _t in _targets:
        biject_to.register(_t, _factory)
del _targets, _factory, _t
