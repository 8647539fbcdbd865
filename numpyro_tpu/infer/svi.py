"""Stochastic Variational Inference driver.

Fresh implementation of numpyro/infer/svi.py.  Accelerator-first default: ``run``
compiles the whole optimization into one ``lax.scan`` program (the
reference's progress-bar python loop is the opt-in interactive path).
"""

from __future__ import annotations

from collections import namedtuple
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, random

from numpyro_tpu import handlers
from numpyro_tpu.distributions import constraints
from numpyro_tpu.distributions.transforms import biject_to
from numpyro_tpu.infer.util import transform_fn
from numpyro_tpu.util import maybe_jit

__all__ = ["SVI", "SVIState", "SVIRunResult"]

SVIState = namedtuple("SVIState", ["optim_state", "mutable_state", "rng_key"])
"""Current optimization state: optimizer state, mutable-site values, rng."""

SVIRunResult = namedtuple("SVIRunResult", ["params", "state", "losses"])


def _classify_site(site, loss, params, inv_transforms, mutable, overrides):
    """Record one traced site into the SVI parameter/mutable registries."""
    if site["type"] == "param":
        constraint = site["kwargs"].pop("constraint", constraints.real)
        with handlers.block():
            transform = biject_to(constraint)
        name = site["name"]
        inv_transforms[name] = transform
        value = overrides.get(name, site["value"])
        params[name] = transform.inv(value)
    elif site["type"] == "mutable":
        mutable[site["name"]] = site["value"]
    elif (
        site["type"] == "sample"
        and not site["is_observed"]
        and site["fn"].support.is_discrete
        and not loss.can_infer_discrete
    ):
        import warnings

        warnings.warn(
            f"Currently, SVI with {type(loss).__name__} loss does not"
            f" support models with discrete latent variables ({site['name']})",
            stacklevel=2,
        )


class SVI:
    """SVI driver (reference surface: numpyro/infer/svi.py:84-457)."""

    def __init__(self, model, guide, optim, loss, **static_kwargs):
        self.model = model
        self.guide = guide
        self.loss = loss
        self.optim = optim
        self.static_kwargs = static_kwargs
        self.constrain_fn = None
        self._init_params = None

    def init(self, rng_key, *args, init_params=None, **kwargs):
        """Trace guide + model, register params with their constraints,
        initialize the optimizer in unconstrained space."""
        rng_key, model_seed, guide_seed = random.split(rng_key, 3)
        model_init = handlers.seed(self.model, model_seed)
        guide_init = handlers.seed(self.guide, guide_seed)
        guide_trace = handlers.trace(guide_init).get_trace(
            *args, **kwargs, **self.static_kwargs
        )
        init_guide_params = {
            name: site["value"]
            for name, site in guide_trace.items()
            if site["type"] == "param"
        }
        if init_params is not None:
            init_guide_params.update(init_params)
        model_trace = handlers.trace(
            handlers.substitute(
                handlers.replay(model_init, guide_trace), init_guide_params
            )
        ).get_trace(*args, **kwargs, **self.static_kwargs)

        params, inv_transforms, mutable_state = {}, {}, {}
        for site in list(model_trace.values()) + list(guide_trace.values()):
            _classify_site(
                site, self.loss, params, inv_transforms, mutable_state,
                init_guide_params,
            )

        self.constrain_fn = partial(transform_fn, inv_transforms)
        # make sure we get valid (unconstrained) params after init
        params = jax.tree.map(jnp.asarray, params)
        return SVIState(
            self.optim.init(params), mutable_state or None, rng_key
        )

    def get_params(self, svi_state):
        """Constrained-space params from an SVIState."""
        params = self.constrain_fn(self.optim.get_params(svi_state.optim_state))
        return params

    def _advance(self, svi_state, args, kwargs, fwd_mode, stable):
        rng_key, step_key = random.split(svi_state.rng_key)
        held_mutable = svi_state.mutable_state

        def loss_fn(unconstrained):
            site_values = self.constrain_fn(unconstrained)
            if held_mutable is not None:
                site_values.update(held_mutable)
            out = self.loss.loss_with_mutable_state(
                step_key, site_values, self.model, self.guide,
                *args, **kwargs, **self.static_kwargs,
            )
            return out["loss"], out["mutable_state"]

        step = (
            self.optim.eval_and_stable_update
            if stable
            else self.optim.eval_and_update
        )
        (loss_val, mutable_state), optim_state = step(
            loss_fn,
            svi_state.optim_state,
            forward_mode_differentiation=fwd_mode,
        )
        return SVIState(optim_state, mutable_state, rng_key), loss_val

    def update(self, svi_state, *args, forward_mode_differentiation=False, **kwargs):
        """One optimization step; returns (new_state, loss)."""
        return self._advance(
            svi_state, args, kwargs, forward_mode_differentiation, stable=False
        )

    def stable_update(
        self, svi_state, *args, forward_mode_differentiation=False, **kwargs
    ):
        """Like update, but keeps the previous state on non-finite loss."""
        return self._advance(
            svi_state, args, kwargs, forward_mode_differentiation, stable=True
        )

    def run(
        self,
        rng_key,
        num_steps,
        *args,
        progress_bar=False,
        stable_update=False,
        init_state=None,
        init_params=None,
        forward_mode_differentiation=False,
        **kwargs,
    ):
        """Optimize for ``num_steps``.  Default: one compiled lax.scan program
        (progress_bar=True switches to per-step dispatch with tqdm)."""
        if init_state is None:
            svi_state = self.init(rng_key, *args, init_params=init_params, **kwargs)
        else:
            svi_state = init_state

        update_fn = self.stable_update if stable_update else self.update

        if progress_bar:
            try:
                from tqdm.auto import tqdm
            except ImportError:  # pragma: no cover
                tqdm = None
            losses = []
            jitted = maybe_jit(
                lambda state: update_fn(
                    state,
                    *args,
                    forward_mode_differentiation=forward_mode_differentiation,
                    **kwargs,
                )
            )
            iterator = tqdm(range(num_steps)) if tqdm else range(num_steps)
            for i in iterator:
                svi_state, loss = jitted(svi_state)
                losses.append(loss)
                if tqdm and i % 20 == 0:
                    iterator.set_description(
                        f"loss: {jax.device_get(loss):.4f}", refresh=False
                    )
            losses = jnp.stack(losses)
        else:

            def body_fn(svi_state, _):
                svi_state, loss = update_fn(
                    svi_state,
                    *args,
                    forward_mode_differentiation=forward_mode_differentiation,
                    **kwargs,
                )
                return svi_state, loss

            with jax.default_matmul_precision("highest"):
                svi_state, losses = lax.scan(
                    body_fn, svi_state, None, length=num_steps
                )

        return SVIRunResult(self.get_params(svi_state), svi_state, losses)

    def evaluate(self, svi_state, *args, **kwargs):
        """ELBO loss at the current state (no update)."""
        _, rng_key_eval = random.split(svi_state.rng_key)
        params = self.get_params(svi_state)
        if svi_state.mutable_state is not None:
            params.update(svi_state.mutable_state)
        return self.loss.loss(
            rng_key_eval,
            params,
            self.model,
            self.guide,
            *args,
            **kwargs,
            **self.static_kwargs,
        )
