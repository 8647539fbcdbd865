"""Constraint objects describing the support of distribution parameters/values.

Accelerator-native re-design of the constraint system of NumPyro
(reference: numpyro/distributions/constraints.py:75-760).  A ``Constraint``
is a lightweight callable returning a boolean feasibility mask; it carries an
``event_dim`` (how many rightmost dims make up one constrained event) and can
produce a feasible prototype value.  Constraints are the keys of the
``biject_to`` registry (see transforms.py), which is the engine that moves
HMC/SVI to unconstrained space.

All checks are written in terms of ``jax.numpy`` so they are jit/vmap-safe
and compile to vectorized device code.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def _fill_like(prototype, value):
    """Broadcast a feasible scalar onto the prototype's shape/dtype."""
    return jnp.broadcast_to(value, jnp.shape(prototype)).astype(
        jnp.result_type(prototype)
    )


def _eye_like(prototype):
    return _fill_like(prototype, jnp.eye(prototype.shape[-1]))


def _is_tril_with_positive_diag(x):
    strictly_lower = jnp.all(
        jnp.reshape(jnp.tril(x) == x, x.shape[:-2] + (-1,)), axis=-1
    )
    diag_ok = jnp.all(jnp.diagonal(x, axis1=-2, axis2=-1) > 0, axis=-1)
    return strictly_lower & diag_ok


def _is_symmetric(x):
    return jnp.all(jnp.isclose(x, jnp.swapaxes(x, -2, -1)), axis=(-2, -1))

__all__ = [
    "Constraint", "boolean", "circular", "corr_cholesky", "corr_matrix",
    "dependent", "is_dependent", "greater_than", "greater_than_eq", "less_than",
    "less_than_eq", "independent", "integer_interval", "integer_greater_than",
    "interval", "l1_ball", "lower_cholesky", "scaled_unit_lower_cholesky",
    "multinomial", "nonnegative", "nonnegative_integer", "open_interval",
    "ordered_vector", "positive", "positive_definite",
    "positive_semidefinite", "positive_integer", "positive_ordered_vector",
    "real", "real_vector", "real_matrix", "simplex",
    "softplus_lower_cholesky", "softplus_positive", "sphere", "unit_interval",
    "zero_sum",
]


class Constraint:
    """Abstract base: a region of feasible values.

    ``event_dim`` — number of rightmost dimensions that together constitute
    one constrained value (0 = scalar constraint, 1 = vector, 2 = matrix).
    ``is_discrete`` — whether the region is a countable set.
    """

    event_dim = 0
    is_discrete = False

    def __call__(self, x):
        raise NotImplementedError

    def check(self, value):
        return self(value)

    def feasible_like(self, prototype):
        """Return a feasible value with the same shape/dtype as ``prototype``."""
        raise NotImplementedError

    # Constraints are singletons or small parametric records; equality by
    # type (parametric subclasses override).
    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return self.__class__.__name__[1:].replace("Constraint", "")

    # Constraints are pytrees: parametric bounds are traced leaves so a
    # distribution holding an interval/greater_than support flows through
    # jit/vmap with the rest of its parameters.
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        from jax import tree_util

        tree_util.register_pytree_node(
            cls, cls._pytree_flatten, cls._pytree_unflatten
        )

    def _pytree_flatten(self):
        params = getattr(self, "_params", ())
        data = tuple(getattr(self, k) for k in params)
        aux = tuple(
            sorted(
                ((k, v) for k, v in self.__dict__.items() if k not in params),
                key=lambda kv: kv[0],
            )
        )
        return data, (params, aux)

    @classmethod
    def _pytree_unflatten(cls, meta, data):
        params, aux = meta
        obj = cls.__new__(cls)
        for k, v in zip(params, data):
            setattr(obj, k, v)
        for k, v in aux:
            setattr(obj, k, v)
        return obj

    def tree_flatten(self):  # pragma: no cover - compatibility hook
        return self._pytree_flatten()


class ParametricConstraint(Constraint):
    """Base for constraints with array-valued parameters (e.g. interval)."""

    def __eq__(self, other):
        if type(self) is not type(other):
            return False
        return all(
            np.array_equal(getattr(self, k), getattr(other, k))
            for k in self._params
        )

    def __hash__(self):
        return hash((type(self),))


class _Dependent(Constraint):
    """Placeholder for constraints that depend on other parameters."""

    def __init__(self, *, is_discrete=False, event_dim=0):
        self._is_discrete = is_discrete
        self._event_dim = event_dim

    @property
    def is_discrete(self):
        return self._is_discrete

    @property
    def event_dim(self):
        return self._event_dim

    def __call__(self, x=None, *, is_discrete=None, event_dim=None):
        if x is None:
            return _Dependent(
                is_discrete=self._is_discrete if is_discrete is None else is_discrete,
                event_dim=self._event_dim if event_dim is None else event_dim,
            )
        raise ValueError("Cannot determine validity of dependent constraint")

    def feasible_like(self, prototype):
        raise ValueError("Cannot get feasible value for dependent constraint")


class _IndependentConstraint(Constraint):
    """Wraps a base constraint, aggregating over extra rightmost dims.

    Mirrors the semantics of ``Independent`` distributions: validity requires
    all entries over the reinterpreted dims to satisfy the base constraint.
    """

    def __init__(self, base_constraint, reinterpreted_batch_ndims):
        assert isinstance(base_constraint, Constraint)
        assert reinterpreted_batch_ndims >= 0
        self.base_constraint = base_constraint
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def event_dim(self):
        return self.base_constraint.event_dim + self.reinterpreted_batch_ndims

    @property
    def is_discrete(self):
        return self.base_constraint.is_discrete

    def __call__(self, x):
        result = self.base_constraint(x)
        if self.reinterpreted_batch_ndims == 0:
            return result
        axes = tuple(range(-self.reinterpreted_batch_ndims, 0))
        return result.all(axes)

    def feasible_like(self, prototype):
        return self.base_constraint.feasible_like(prototype)

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.base_constraint == other.base_constraint
            and self.reinterpreted_batch_ndims == other.reinterpreted_batch_ndims
        )

    def __hash__(self):
        return hash((type(self), self.base_constraint, self.reinterpreted_batch_ndims))

    def __repr__(self):
        return f"independent({self.base_constraint!r}, {self.reinterpreted_batch_ndims})"


class _Real(Constraint):
    def __call__(self, x):
        # entire real line: no nan, no infinities
        return jnp.isfinite(x)

    def feasible_like(self, prototype):
        return jnp.zeros_like(prototype)


class _Boolean(Constraint):
    is_discrete = True

    def __call__(self, x):
        return (x == 0) | (x == 1)

    def feasible_like(self, prototype):
        return jnp.zeros_like(prototype)


class _Circular(Constraint):
    def __call__(self, x):
        return (x >= -math.pi) & (x <= math.pi)

    def feasible_like(self, prototype):
        return jnp.zeros_like(prototype)


class _GreaterThan(ParametricConstraint):
    _params = ("lower_bound",)

    def __init__(self, lower_bound):
        self.lower_bound = lower_bound

    def __call__(self, x):
        return x > self.lower_bound

    def feasible_like(self, prototype):
        return _fill_like(prototype, self.lower_bound + 1.0)

    def __repr__(self):
        return f"greater_than({self.lower_bound})"


class _GreaterThanEq(_GreaterThan):
    def __call__(self, x):
        return x >= self.lower_bound

    def __repr__(self):
        return f"greater_than_eq({self.lower_bound})"


class _LessThan(ParametricConstraint):
    _params = ("upper_bound",)

    def __init__(self, upper_bound):
        self.upper_bound = upper_bound

    def __call__(self, x):
        return x < self.upper_bound

    def feasible_like(self, prototype):
        return _fill_like(prototype, self.upper_bound - 1.0)

    def __repr__(self):
        return f"less_than({self.upper_bound})"


class _LessThanEq(_LessThan):
    def __call__(self, x):
        return x <= self.upper_bound


class _Interval(ParametricConstraint):
    _params = ("lower_bound", "upper_bound")

    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def __call__(self, x):
        return (x >= self.lower_bound) & (x <= self.upper_bound)

    def feasible_like(self, prototype):
        return _fill_like(prototype, (self.lower_bound + self.upper_bound) / 2)

    def __repr__(self):
        return f"interval({self.lower_bound}, {self.upper_bound})"


class _OpenInterval(_Interval):
    def __call__(self, x):
        return (x > self.lower_bound) & (x < self.upper_bound)

    def __repr__(self):
        return f"open_interval({self.lower_bound}, {self.upper_bound})"


class _UnitInterval(_Interval):
    def __init__(self):
        super().__init__(0.0, 1.0)

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class _IntegerInterval(ParametricConstraint):
    is_discrete = True
    _params = ("lower_bound", "upper_bound")

    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def __call__(self, x):
        in_range = (x >= self.lower_bound) & (x <= self.upper_bound)
        return in_range & (x == jnp.floor(x))

    def feasible_like(self, prototype):
        return _fill_like(prototype, self.lower_bound)

    def __repr__(self):
        return f"integer_interval({self.lower_bound}, {self.upper_bound})"


class _IntegerGreaterThan(ParametricConstraint):
    is_discrete = True
    _params = ("lower_bound",)

    def __init__(self, lower_bound):
        self.lower_bound = lower_bound

    def __call__(self, x):
        return (x >= self.lower_bound) & (x == jnp.floor(x))

    def feasible_like(self, prototype):
        return _fill_like(prototype, self.lower_bound)

    def __repr__(self):
        return f"integer_greater_than({self.lower_bound})"


class _Multinomial(ParametricConstraint):
    is_discrete = True
    event_dim = 1
    _params = ("upper_bound",)

    def __init__(self, upper_bound):
        self.upper_bound = upper_bound

    def __call__(self, x):
        return (x >= 0).all(-1) & (x.sum(-1) == self.upper_bound)

    def feasible_like(self, prototype):
        head = jnp.zeros_like(prototype[..., :-1])
        tail = _fill_like(prototype[..., :1], self.upper_bound)
        return jnp.concatenate([head, tail], axis=-1)


class _Simplex(Constraint):
    event_dim = 1

    def __call__(self, x):
        return (x >= 0).all(-1) & (jnp.abs(x.sum(-1) - 1.0) < 1e-6)

    def feasible_like(self, prototype):
        return jnp.full_like(prototype, 1.0 / prototype.shape[-1])


class _OrderedVector(Constraint):
    event_dim = 1

    def __call__(self, x):
        return (x[..., 1:] > x[..., :-1]).all(-1)

    def feasible_like(self, prototype):
        return _fill_like(prototype, jnp.arange(prototype.shape[-1]))


class _PositiveOrderedVector(Constraint):
    event_dim = 1

    def __call__(self, x):
        return _OrderedVector.__call__(self, x) & (x > 0).all(-1)

    def feasible_like(self, prototype):
        return _fill_like(prototype, jnp.arange(1, prototype.shape[-1] + 1))


class _CorrCholesky(Constraint):
    event_dim = 2

    def __call__(self, x):
        unit_rows = jnp.all(
            jnp.abs(jnp.linalg.norm(x, axis=-1) - 1.0) <= 1e-6, axis=-1
        )
        return _is_tril_with_positive_diag(x) & unit_rows

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _CorrMatrix(Constraint):
    event_dim = 2

    def __call__(self, x):
        unit_diag = jnp.all(
            jnp.abs(jnp.diagonal(x, axis1=-2, axis2=-1) - 1) < 1e-6, axis=-1
        )
        spd = jnp.linalg.eigvalsh(x)[..., 0] > 0
        return _is_symmetric(x) & spd & unit_diag

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _LowerCholesky(Constraint):
    event_dim = 2

    def __call__(self, x):
        return _is_tril_with_positive_diag(x)

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _ScaledUnitLowerCholesky(_LowerCholesky):
    pass


class _SoftplusPositive(_GreaterThan):
    def __init__(self):
        super().__init__(0.0)

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class _SoftplusLowerCholesky(_LowerCholesky):
    pass


class _PositiveSemiDefinite(Constraint):
    event_dim = 2

    def __call__(self, x):
        return _is_symmetric(x) & (jnp.linalg.eigvalsh(x)[..., 0] >= 0)

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _PositiveDefinite(_PositiveSemiDefinite):
    def __call__(self, x):
        return _is_symmetric(x) & (jnp.linalg.eigvalsh(x)[..., 0] > 0)


class _L1Ball(Constraint):
    event_dim = 1

    def __call__(self, x):
        return jnp.abs(x).sum(-1) <= 1 + 1e-6

    def feasible_like(self, prototype):
        return jnp.zeros_like(prototype)


class _Sphere(Constraint):
    event_dim = 1

    def __call__(self, x):
        norm = jnp.linalg.norm(x, axis=-1)
        return jnp.abs(norm - 1.0) < 1e-6

    def feasible_like(self, prototype):
        out = jnp.zeros_like(prototype)
        return out.at[..., 0].set(1.0)


class _ZeroSum(Constraint):
    def __init__(self, event_dim=1):
        self._event_dim = event_dim

    @property
    def event_dim(self):
        return self._event_dim

    def __call__(self, x):
        tol = 1e-6
        ok = jnp.array(True)
        for axis in range(-self._event_dim, 0):
            s = x.sum(axis)
            reduce_axes = tuple(range(-(self._event_dim - 1), 0)) if self._event_dim > 1 else ()
            if reduce_axes:
                ok = ok & (jnp.abs(s) < tol).all(reduce_axes)
            else:
                ok = ok & (jnp.abs(s) < tol)
        return ok

    def feasible_like(self, prototype):
        return jnp.zeros_like(prototype)

    def __eq__(self, other):
        return type(self) is type(other) and self._event_dim == other._event_dim

    def __hash__(self):
        return hash((type(self), self._event_dim))

    def __repr__(self):
        return f"zero_sum({self._event_dim})"


class dependent_property(property):
    """Decorator marking an instance-level ``support`` whose constraint
    depends on distribution parameters (reference:
    numpyro/distributions/constraints.py dependent_property).  Usable bare
    (``@dependent_property``) or parameterized
    (``@dependent_property(is_discrete=..., event_dim=...)``)."""

    def __init__(self, fn=None, *, is_discrete=False, event_dim=0):
        super().__init__(fn)
        self._is_discrete = is_discrete
        self._event_dim = event_dim

    def __call__(self, fn):
        if not callable(fn):
            raise ValueError("@dependent_property expects a callable")
        return dependent_property(
            fn, is_discrete=self._is_discrete, event_dim=self._event_dim
        )


class _Complex(Constraint):
    """Unconstrained complex values (codomain of FFT transforms)."""

    def __call__(self, x):
        return (x == x) | jnp.iscomplexobj(x)

    def feasible_like(self, prototype):
        return jnp.zeros_like(prototype)

    def __repr__(self):
        return "complex"


class _PositiveDefiniteCirculantVector(Constraint):
    """First row of a positive-definite circulant matrix: its real FFT
    (the matrix eigenvalues) must be strictly positive."""

    event_dim = 1

    def __call__(self, x):
        rfft = jnp.fft.rfft(x).real
        return (rfft > 0).all(-1)

    def feasible_like(self, prototype):
        return jnp.zeros_like(prototype).at[..., 0].set(1.0)

    def __repr__(self):
        return "positive_definite_circulant_vector"


# ---------------------------------------------------------------------------
# Public singletons / factories
# ---------------------------------------------------------------------------

def is_dependent(constraint):
    """True iff ``constraint`` is a :data:`dependent` placeholder (reference:
    numpyro/distributions/constraints.py:270)."""
    return isinstance(constraint, _Dependent)


boolean = _Boolean()
circular = _Circular()
complex = _Complex()
corr_cholesky = _CorrCholesky()
corr_matrix = _CorrMatrix()
dependent = _Dependent()
greater_than = _GreaterThan
greater_than_eq = _GreaterThanEq
less_than = _LessThan
less_than_eq = _LessThanEq
independent = _IndependentConstraint
integer_interval = _IntegerInterval
integer_greater_than = _IntegerGreaterThan
interval = _Interval
l1_ball = _L1Ball()
lower_cholesky = _LowerCholesky()
scaled_unit_lower_cholesky = _ScaledUnitLowerCholesky()
multinomial = _Multinomial
nonnegative = _GreaterThanEq(0.0)
nonnegative_integer = _IntegerGreaterThan(0)
open_interval = _OpenInterval
ordered_vector = _OrderedVector()
positive = _GreaterThan(0.0)
positive_definite = _PositiveDefinite()
positive_definite_circulant_vector = _PositiveDefiniteCirculantVector()
positive_semidefinite = _PositiveSemiDefinite()
positive_integer = _IntegerGreaterThan(1)
positive_ordered_vector = _PositiveOrderedVector()
real = _Real()
real_vector = _IndependentConstraint(real, 1)
real_matrix = _IndependentConstraint(real, 2)
simplex = _Simplex()
softplus_lower_cholesky = _SoftplusLowerCholesky()
softplus_positive = _SoftplusPositive()
sphere = _Sphere()
unit_interval = _UnitInterval()
zero_sum = _ZeroSum


# ---------------------------------------------------------------------------
# Singleton identity across pickling.  Code throughout the library (and user
# code) compares against module-level singletons with `is` (e.g.
# `domain is real`); pickle would otherwise rebuild fresh instances and
# silently break those checks, so singletons round-trip by name.
# ---------------------------------------------------------------------------


def _get_singleton(name):
    return globals()[name]


_SINGLETON_NAMES = {
    id(_val): _name
    for _name, _val in list(globals().items())
    if isinstance(_val, Constraint)
}


def _constraint_reduce(self):
    name = _SINGLETON_NAMES.get(id(self))
    if name is not None:
        return (_get_singleton, (name,))
    return object.__reduce_ex__(self, 2)


Constraint.__reduce__ = _constraint_reduce
