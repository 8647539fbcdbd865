"""Optimizers for SVI.

Accelerator-first design decision (vs numpyro/optim.py which wraps
jax.example_libraries.optimizers): **optax is the native backend** — every
optimizer here is an optax GradientTransformation wrapped in the thin
``_NumPyroOptim`` API (init/update/eval_and_update/get_params) that SVI
drives.  This keeps the optimizer state a flat pytree that shards with the
params under pjit.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import TypeVar

import jax
import jax.numpy as jnp
import optax
from jax import value_and_grad
from jax.flatten_util import ravel_pytree

__all__ = [
    "Adam",
    "Adagrad",
    "ClippedAdam",
    "Minimize",
    "Momentum",
    "RMSProp",
    "RMSPropMomentum",
    "SGD",
    "SM3",
    "optax_to_numpyro",
]

_Params = TypeVar("_Params")
_OptState = tuple  # (step, (params, optax_state))


class _NumPyroOptim:
    """Thin stateless-API optimizer: state = (step_count, (params, opt_state))."""

    def __init__(self, transformation: optax.GradientTransformation):
        self.transformation = transformation

    def init(self, params):
        opt_state = self.transformation.init(params)
        return jnp.array(0), (params, opt_state)

    def update(self, g, state):
        step, (params, opt_state) = state
        updates, opt_state = self.transformation.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return step + 1, (params, opt_state)

    def eval_and_update(self, fn: Callable, state, forward_mode_differentiation=False):
        """One optimization step on ``fn(params) -> (loss, aux)``."""
        params = self.get_params(state)
        if forward_mode_differentiation:
            loss_and_aux = fn(params)
            grads = jax.jacfwd(lambda p: fn(p)[0])(params)
            out, aux = loss_and_aux
        else:
            (out, aux), grads = value_and_grad(fn, has_aux=True)(params)
        return (out, aux), self.update(grads, state)

    def eval_and_stable_update(
        self, fn: Callable, state, forward_mode_differentiation=False
    ):
        """Like eval_and_update but keeps the previous state on
        non-finite loss (reference: SVI.stable_update semantics)."""
        params = self.get_params(state)
        (out, aux), grads = value_and_grad(fn, has_aux=True)(params)
        new_state = self.update(grads, state)
        out_is_finite = jnp.isfinite(out) & jnp.all(
            jnp.stack(
                [jnp.all(jnp.isfinite(x)) for x in jax.tree.leaves(new_state[1][0])]
            )
        )
        state = jax.tree.map(
            lambda new, old: jnp.where(out_is_finite, new, old), new_state, state
        )
        return (jnp.where(out_is_finite, out, jnp.nan), aux), state

    def get_params(self, state):
        _, (params, _) = state
        return params


def Adam(step_size=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> _NumPyroOptim:
    return _NumPyroOptim(optax.adam(step_size, b1=b1, b2=b2, eps=eps))


def ClippedAdam(step_size=1e-3, b1=0.9, b2=0.999, eps=1e-8, clip_norm=10.0):
    return _NumPyroOptim(
        optax.chain(
            optax.clip(clip_norm), optax.adam(step_size, b1=b1, b2=b2, eps=eps)
        )
    )


def Adagrad(step_size=1e-3, eps=1e-7) -> _NumPyroOptim:
    return _NumPyroOptim(optax.adagrad(step_size, eps=eps))


def Momentum(step_size=1e-3, mass=0.9) -> _NumPyroOptim:
    return _NumPyroOptim(optax.sgd(step_size, momentum=mass))


def RMSProp(step_size=1e-3, gamma=0.9, eps=1e-8) -> _NumPyroOptim:
    return _NumPyroOptim(optax.rmsprop(step_size, decay=gamma, eps=eps))


def RMSPropMomentum(
    step_size=1e-3, gamma=0.9, eps=1e-8, momentum=0.9
) -> _NumPyroOptim:
    return _NumPyroOptim(
        optax.rmsprop(step_size, decay=gamma, eps=eps, momentum=momentum)
    )


def SGD(step_size=1e-3) -> _NumPyroOptim:
    return _NumPyroOptim(optax.sgd(step_size))


def SM3(step_size=1e-3, momentum=0.9) -> _NumPyroOptim:
    # optax.sm3 indexes per-axis accumulators and breaks on 0-d leaves;
    # lift scalars to shape (1,) around the inner transformation
    inner = optax.sm3(step_size, momentum=momentum)

    def _lift(tree):
        return jax.tree.map(lambda x: jnp.atleast_1d(x), tree)

    def init_fn(params):
        return inner.init(_lift(params))

    def update_fn(updates, state, params=None):
        lifted_updates, treedef = jax.tree.flatten(_lift(updates))
        out, state = inner.update(
            jax.tree.unflatten(treedef, lifted_updates),
            state,
            None if params is None else _lift(params),
        )
        shaped = jax.tree.map(
            lambda u, orig: jnp.reshape(u, jnp.shape(orig)), out, updates
        )
        return shaped, state

    return _NumPyroOptim(optax.GradientTransformation(init_fn, update_fn))


def optax_to_numpyro(transformation: optax.GradientTransformation) -> _NumPyroOptim:
    """Wrap any optax transformation in the SVI optimizer API."""
    return _NumPyroOptim(transformation)


class Minimize:
    """scipy-style whole-fit optimizer (BFGS) via jax.scipy.optimize —
    state-compatible with the _NumPyroOptim API; each `update` runs a full
    minimization from the current params (reference: numpyro/optim.py:291)."""

    def __init__(self, method="BFGS", **minimize_kwargs):
        self._method = method
        self._kwargs = minimize_kwargs

    def init(self, params):
        return jnp.array(0), (params, None)

    def get_params(self, state):
        _, (params, _) = state
        return params

    def update(self, g, state):
        raise ValueError(
            "Minimize optimizer only works with eval_and_update; use SVI.run"
        )

    def eval_and_update(self, fn, state, forward_mode_differentiation=False):
        i, (flat_params, _) = state[0], state[1]
        params = flat_params
        flat, unravel = ravel_pytree(params)

        def loss_fn(x):
            return fn(unravel(x))[0]

        from jax.scipy.optimize import minimize

        results = minimize(
            loss_fn, flat, (), method=self._method, **self._kwargs
        )
        params = unravel(results.x)
        _, aux = fn(params)
        return (results.fun, aux), (state[0] + 1, (params, None))

    eval_and_stable_update = eval_and_update
