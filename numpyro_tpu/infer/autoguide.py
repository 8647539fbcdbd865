"""Automatic guide generation for SVI/ADVI.

Implementation of the autoguide family of numpyro/infer/autoguide.py:
AutoNormal, AutoDelta, AutoContinuous (packed-latent base), AutoDiagonalNormal,
AutoMultivariateNormal, AutoLowRankMultivariateNormal, AutoLaplaceApproximation,
AutoGuideList, flows, DAIS variants, batched guides.

Chain/particle-massive note: every guide's ``sample_posterior`` vmaps over a
sample axis inside one program; the packed latent of AutoContinuous is a flat
(D,) vector so ELBO particles batch as (P, D) matmuls on the tensor cores.

Organisation: site iteration, constrained/unconstrained mapping, sample-axis
flattening and the DAIS annealing loop are single shared helpers — each
concrete guide only supplies its variational family.
"""

from __future__ import annotations

import math
import warnings
from abc import ABC, abstractmethod
from contextlib import ExitStack
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import grad, hessian, random, vmap
from jax.flatten_util import ravel_pytree

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu import handlers
from numpyro_tpu.distributions import constraints
from numpyro_tpu.distributions.transforms import (
    AffineTransform,
    ComposeTransform,
    IndependentTransform,
    LowerCholeskyAffine,
    UnpackTransform,
    biject_to,
)
from numpyro_tpu.distributions.util import sum_rightmost
from numpyro_tpu.infer.initialization import init_to_median, init_to_uniform
from numpyro_tpu.infer import util as infer_util
from numpyro_tpu.util import find_stack_level, not_jax_tracer

__all__ = [
    "AutoBatchedLowRankMultivariateNormal",
    "AutoBatchedMultivariateNormal",
    "AutoBNAFNormal",
    "AutoDAIS",
    "AutoContinuous",
    "AutoDelta",
    "AutoDiagonalNormal",
    "AutoGuide",
    "AutoGuideList",
    "AutoIAFNormal",
    "AutoLaplaceApproximation",
    "AutoLowRankMultivariateNormal",
    "AutoMultivariateNormal",
    "AutoNormal",
    "AutoSemiDAIS",
    "AutoSurrogateLikelihoodDAIS",
]


def _is_latent(site):
    """Continuous non-observed sample site?"""
    return (
        site["type"] == "sample"
        and not site["is_observed"]
        and not site["fn"].support.is_discrete
    )


def _support_bijector(site):
    """biject_to(site.support), built outside the handler stack."""
    with handlers.block():
        return biject_to(site["fn"].support)


def _map_leading_axes(fn, tree, n_leading):
    """Apply ``fn`` (defined on unbatched inputs) under ``n_leading`` extra
    leading axes by collapsing them to one vmapped axis."""
    if n_leading == 0:
        return fn(tree)
    leaves = jax.tree.leaves(tree)
    lead = jnp.shape(leaves[0])[:n_leading]
    flat = jax.tree.map(lambda a: jnp.reshape(a, (-1,) + a.shape[n_leading:]), tree)
    out = vmap(fn)(flat)
    return jax.tree.map(lambda a: jnp.reshape(a, lead + a.shape[1:]), out)


class AutoGuide(ABC):
    """Base: traces the model once (prototype), recreates its plates, and
    generates guide sample statements (reference: autoguide.py:73-223)."""

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=init_to_uniform,
        create_plates=None,
    ):
        self.model = model
        self.prefix = prefix
        self.create_plates = create_plates
        self.init_loc_fn = init_loc_fn
        self.prototype_trace = None
        self._plate_frames = {}
        self._plate_full_sizes = {}

    # -- shared small helpers -------------------------------------------

    def _pname(self, *suffix):
        return "_".join((self.prefix,) + suffix)

    def _latent_sites(self):
        for name, site in self.prototype_trace.items():
            if _is_latent(site):
                yield name, site

    def _constrain_dict(self, latent):
        """Map unconstrained site values onto their supports."""
        return {
            name: _support_bijector(self.prototype_trace[name])(value)
            for name, value in latent.items()
        }

    def _create_plates(self, *args, **kwargs):
        # NB: returned fresh each call and NOT stored on self — plate
        # objects hold their subsample indices, and retaining them would
        # leak tracers out of a surrounding jit/scan trace (e.g. SVI.run's
        # fused update loop under JAX_CHECK_TRACER_LEAKS)
        if self.create_plates is None:
            plates = {}
        else:
            created = self.create_plates(*args, **kwargs)
            if isinstance(created, numpyro_tpu.plate):
                created = [created]
            assert all(
                isinstance(p, numpyro_tpu.plate) for p in created
            ), "create_plates() returned a non-plate"
            plates = {p.name: p for p in created}
        for name, frame in sorted(self._plate_frames.items()):
            if name not in plates:
                full_size = self._plate_full_sizes[name]
                sub = frame.subsample_size
                plates[name] = numpyro_tpu.plate(
                    name,
                    full_size,
                    dim=frame.dim,
                    subsample_size=None if sub == full_size else sub,
                )
        return plates

    @abstractmethod
    def __call__(self, *args, **kwargs):
        raise NotImplementedError

    @abstractmethod
    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        raise NotImplementedError

    def _setup_prototype(self, *args, **kwargs):
        rng_key = numpyro_tpu.prng_key()
        if rng_key is None:
            rng_key = random.PRNGKey(0)
        with handlers.block():
            (
                init_params,
                self._potential_fn,
                postprocess_fn,
                self.prototype_trace,
            ) = infer_util.initialize_model(
                rng_key,
                self.model,
                init_strategy=self.init_loc_fn,
                dynamic_args=False,
                model_args=args,
                model_kwargs=kwargs,
                validate_grad=False,
            )
        self._init_locs = init_params[0]

        self._plate_frames = {}
        self._plate_full_sizes = {}
        for name, site in self.prototype_trace.items():
            if site["type"] == "sample":
                if not site["is_observed"] and site["fn"].support.is_discrete:
                    warnings.warn(
                        f"Model has discrete latent site {name}; autoguides "
                        "marginalize nothing — consider DiscreteHMCGibbs or "
                        "TraceEnum-style inference.",
                        stacklevel=2,
                    )
                for frame in site["cond_indep_stack"]:
                    self._plate_frames[frame.name] = frame
                    self._plate_full_sizes[frame.name] = frame.size
            elif site["type"] == "plate":
                self._plate_full_sizes[name] = site["args"][0]

    def median(self, params):
        raise NotImplementedError

    def quantiles(self, params, quantiles):
        raise NotImplementedError


class AutoGuideList(AutoGuide):
    """Container composing several part-guides over disjoint site sets
    (reference: autoguide.py:226)."""

    def __init__(self, model, *, prefix="auto", create_plates=None):
        self._guides = []
        super().__init__(model, prefix=prefix, create_plates=create_plates)

    def append(self, part):
        self._guides.append(part)

    def _merged(self, method, *args, **kwargs):
        merged = {}
        for part in self._guides:
            merged.update(getattr(part, method)(*args, **kwargs))
        return merged

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)
        return self._merged("__call__", *args, **kwargs)

    def __getitem__(self, key):
        return self._guides[key]

    def __len__(self):
        return len(self._guides)

    def __iter__(self):
        yield from self._guides

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        merged = {}
        for part in self._guides:
            rng_key, part_key = random.split(rng_key)
            merged.update(
                part.sample_posterior(
                    part_key, params, *args, sample_shape=sample_shape, **kwargs
                )
            )
        return merged

    def median(self, params):
        return self._merged("median", params)

    def quantiles(self, params, quantiles):
        return self._merged("quantiles", params, quantiles)


class AutoNormal(AutoGuide):
    """Per-site mean-field Normal in unconstrained space (reference:
    autoguide.py:342)."""

    scale_constraint = constraints.softplus_positive

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=init_to_uniform,
        init_scale=0.1,
        create_plates=None,
    ):
        self._init_scale = init_scale
        self._event_dims = {}
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, create_plates=create_plates
        )

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        for name, site in self._latent_sites():
            # a site seen through a subsample plate has fewer dims in the
            # trace than in the full-size init location
            self._event_dims[name] = (
                site["fn"].event_dim
                + jnp.ndim(self._init_locs[name])
                - jnp.ndim(site["value"])
            )

    def _site_family(self, name, init_loc, event_dim):
        """The per-site variational factor: Normal(loc, scale) params."""
        loc = numpyro_tpu.param(
            self._pname(name, "loc"), init_loc, event_dim=event_dim
        )
        scale = numpyro_tpu.param(
            self._pname(name, "scale"),
            jnp.full(jnp.shape(init_loc), self._init_scale),
            constraint=self.scale_constraint,
            event_dim=event_dim,
        )
        return dist.Normal(loc, scale).to_event(event_dim)

    @staticmethod
    def _is_real_support(support):
        if support is constraints.real:
            return True
        return isinstance(support, constraints.independent) and isinstance(
            support.base_constraint, type(constraints.real)
        )

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)

        plates = self._create_plates(*args, **kwargs)
        out = {}
        for name, site in self._latent_sites():
            with ExitStack() as stack:
                for frame in site["cond_indep_stack"]:
                    stack.enter_context(plates[frame.name])
                factor = self._site_family(
                    name, self._init_locs[name], self._event_dims[name]
                )
                if self._is_real_support(site["fn"].support):
                    out[name] = numpyro_tpu.sample(name, factor)
                else:
                    pushed = dist.TransformedDistribution(
                        factor, _support_bijector(site)
                    )
                    out[name] = numpyro_tpu.sample(name, pushed)
        return out

    def _constrain(self, latent_samples):
        probe = next(iter(latent_samples))
        n_sample_dims = jnp.ndim(latent_samples[probe]) - jnp.ndim(
            self._init_locs[probe]
        )
        return _map_leading_axes(
            self._constrain_dict, latent_samples, n_sample_dims
        )

    def _site_params(self, params, suffix):
        return {
            name: params[self._pname(name, suffix)] for name in self._init_locs
        }

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        locs = self._site_params(params, "loc")
        scales = self._site_params(params, "scale")
        with handlers.seed(rng_seed=rng_key):
            latent = {
                name: numpyro_tpu.sample(
                    name + "_latent",
                    dist.Normal(locs[name], scales[name]).to_event(
                        self._event_dims[name]
                    ),
                    sample_shape=sample_shape,
                )
                for name in locs
            }
        return self._constrain(latent)

    def median(self, params):
        return self._constrain_dict(self._site_params(params, "loc"))

    def quantiles(self, params, quantiles):
        q = jnp.array(quantiles)
        out = {}
        for name in self._init_locs:
            loc = params[self._pname(name, "loc")]
            scale = params[self._pname(name, "scale")]
            latent = dist.Normal(loc, scale).icdf(
                q.reshape((-1,) + (1,) * jnp.ndim(loc))
            )
            out[name] = _support_bijector(self.prototype_trace[name])(latent)
        return out


class AutoDelta(AutoGuide):
    """MAP guide: Delta distributions at learned locations (reference:
    autoguide.py:498)."""

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=init_to_median,
        create_plates=None,
    ):
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, create_plates=create_plates
        )

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        # AutoDelta parameterizes in *constrained* space
        with handlers.block():
            constrained = self._constrain_dict(self._init_locs)
        self._init_locs = {k: constrained[k] for k in self._init_locs}
        self._event_dims = {
            name: site["fn"].event_dim for name, site in self._latent_sites()
        }

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)

        plates = self._create_plates(*args, **kwargs)
        out = {}
        for name, site in self._latent_sites():
            event_dim = self._event_dims[name]
            with ExitStack() as stack:
                for frame in site["cond_indep_stack"]:
                    stack.enter_context(plates[frame.name])
                point = numpyro_tpu.param(
                    self._pname(name, "loc"),
                    self._init_locs[name],
                    constraint=site["fn"].support,
                    event_dim=event_dim,
                )
                out[name] = numpyro_tpu.sample(
                    name, dist.Delta(point, event_dim=event_dim)
                )
        return out

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        return {
            name: jnp.broadcast_to(
                params[self._pname(name, "loc")],
                sample_shape + jnp.shape(params[self._pname(name, "loc")]),
            )
            for name in self._init_locs
        }

    def median(self, params):
        return {
            name: params[self._pname(name, "loc")] for name in self._init_locs
        }
class AutoContinuous(AutoGuide):
    """Base for guides over a single packed unconstrained latent vector
    (reference: autoguide.py:642).  The packed layout is what makes ELBO
    particles matmul-friendly: (P, D) batched matmuls against guide params."""

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        self._init_latent, unpack_latent = ravel_pytree(self._init_locs)
        # wrapped so a batch of packed samples unpacks too (pyro parity)
        self._unpack_latent = UnpackTransform(unpack_latent)
        self.latent_dim = jnp.size(self._init_latent)
        if self.latent_dim == 0:
            raise RuntimeError(
                f"{type(self).__name__} found no latent variables; "
                "Use an empty guide instead."
            )

    @abstractmethod
    def _get_posterior(self):
        raise NotImplementedError

    def _sample_latent(self, *args, **kwargs):
        sample_shape = kwargs.pop("sample_shape", ())
        posterior = self._get_posterior()
        return numpyro_tpu.sample(
            "_auto_latent", posterior.mask(False), sample_shape=sample_shape
        )

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)

        packed = self._sample_latent(*args, **kwargs)

        # unpack into constrained sites, with explicit density correction
        out = {}
        for name, unconstrained in self._unpack_latent(packed).items():
            site = self.prototype_trace[name]
            push = _support_bijector(site)
            value = push(unconstrained)
            event_ndim = site["fn"].event_dim
            if numpyro_tpu.get_mask() is False:
                correction = 0.0
            else:
                correction = -push.log_abs_det_jacobian(unconstrained, value)
                correction = sum_rightmost(
                    correction,
                    jnp.ndim(correction) - jnp.ndim(value) + event_ndim,
                )
            out[name] = numpyro_tpu.sample(
                name,
                dist.Delta(value, log_density=correction, event_dim=event_ndim),
            )
        return out

    def _unpack_and_constrain(self, latent_sample, params):
        def one(flat):
            return self._constrain_dict(self._unpack_latent(flat))

        n_sample_dims = jnp.ndim(latent_sample) - 1
        return _map_leading_axes(one, latent_sample, n_sample_dims)

    def get_base_dist(self):
        """The (fixed) base distribution of the learned transport."""
        raise NotImplementedError

    def get_transform(self, params):
        """Bijection from base to posterior (for NeuTra) — generic: rebuild
        the posterior under ``params`` and compose its transforms
        (reference: autoguide.py:776-794)."""
        posterior = handlers.substitute(self._get_posterior, params)()
        if not isinstance(posterior, dist.TransformedDistribution):
            raise NotImplementedError(
                "posterior is not a transformed distribution"
            )
        chain = posterior.transforms
        return ComposeTransform(chain) if len(chain) > 1 else chain[0]

    def get_posterior(self, params):
        """Unconstrained posterior over the packed latent."""
        return dist.TransformedDistribution(
            self.get_base_dist(), self.get_transform(params)
        )

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        packed = handlers.substitute(
            handlers.seed(self._sample_latent, rng_key), params
        )(sample_shape=sample_shape)
        return self._unpack_and_constrain(packed, params)

    def median(self, params):
        raise NotImplementedError

    def quantiles(self, params, quantiles):
        raise NotImplementedError


class _PackedNormalGuide(AutoContinuous):
    """Shared init_scale plumbing for the packed gaussian-family guides."""

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=init_to_uniform,
        init_scale=0.1,
        create_plates=None,
    ):
        if init_scale <= 0:
            raise ValueError("Expected init_scale > 0.")
        self._init_scale = init_scale
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, create_plates=create_plates
        )

    def get_base_dist(self):
        return dist.Normal(jnp.zeros(self.latent_dim), 1.0).to_event(1)

    def median(self, params):
        return self._unpack_and_constrain(params[self._pname("loc")], params)

    def _marginal_normal(self, params):
        """Per-coordinate Normal matching the posterior marginals."""
        raise NotImplementedError

    def quantiles(self, params, quantiles):
        q = jnp.array(quantiles)[..., None]
        latent = self._marginal_normal(params).icdf(q)
        return self._unpack_and_constrain(latent, params)


class AutoDiagonalNormal(_PackedNormalGuide):
    """Diagonal Normal over the packed latent — classic ADVI (reference:
    autoguide.py:1725)."""

    scale_constraint = constraints.softplus_positive

    def _get_posterior(self):
        loc = numpyro_tpu.param(self._pname("loc"), self._init_latent)
        scale = numpyro_tpu.param(
            self._pname("scale"),
            jnp.full(self.latent_dim, self._init_scale),
            constraint=self.scale_constraint,
        )
        return dist.Normal(loc, scale).to_event(1)

    def get_transform(self, params):
        return IndependentTransform(
            AffineTransform(params[self._pname("loc")], params[self._pname("scale")]),
            1,
        )

    def get_posterior(self, params):
        return dist.Normal(
            params[self._pname("loc")], params[self._pname("scale")]
        ).to_event(1)

    def _marginal_normal(self, params):
        return dist.Normal(
            params[self._pname("loc")], params[self._pname("scale")]
        )


class AutoMultivariateNormal(_PackedNormalGuide):
    """Full-covariance MVN (reference: autoguide.py:1786)."""

    scale_tril_constraint = constraints.scaled_unit_lower_cholesky

    def _get_posterior(self):
        loc = numpyro_tpu.param(self._pname("loc"), self._init_latent)
        scale_tril = numpyro_tpu.param(
            self._pname("scale_tril"),
            jnp.identity(self.latent_dim) * self._init_scale,
            constraint=self.scale_tril_constraint,
        )
        return dist.MultivariateNormal(loc, scale_tril=scale_tril)

    def get_transform(self, params):
        return LowerCholeskyAffine(
            params[self._pname("loc")], params[self._pname("scale_tril")]
        )

    def get_posterior(self, params):
        return dist.MultivariateNormal(
            params[self._pname("loc")],
            scale_tril=params[self._pname("scale_tril")],
        )

    def _marginal_normal(self, params):
        root = params[self._pname("scale_tril")]
        return dist.Normal(
            params[self._pname("loc")], jnp.linalg.norm(root, axis=-1)
        )


class AutoLowRankMultivariateNormal(_PackedNormalGuide):
    """Low-rank-plus-diagonal MVN (reference: autoguide.py:1962)."""

    scale_constraint = constraints.softplus_positive

    def __init__(self, model, *, rank=None, **kwargs):
        self.rank = rank
        super().__init__(model, **kwargs)

    def _factor_params(self):
        rank = (
            int(round(self.latent_dim**0.5)) if self.rank is None else self.rank
        )
        loc = numpyro_tpu.param(self._pname("loc"), self._init_latent)
        raw_factor = numpyro_tpu.param(
            self._pname("cov_factor"), jnp.zeros((self.latent_dim, rank))
        )
        scale = numpyro_tpu.param(
            self._pname("scale"),
            jnp.full(self.latent_dim, self._init_scale),
            constraint=self.scale_constraint,
        )
        return loc, raw_factor, scale

    def _get_posterior(self, *args, **kwargs):
        loc, raw_factor, scale = self._factor_params()
        return dist.LowRankMultivariateNormal(
            loc, raw_factor * scale[..., None], jnp.square(scale)
        )

    def get_posterior(self, params):
        loc = params[self._pname("loc")]
        raw_factor = params[self._pname("cov_factor")]
        scale = params[self._pname("scale")]
        return dist.LowRankMultivariateNormal(
            loc, raw_factor * scale[..., None], jnp.square(scale)
        )

    def _marginal_normal(self, params):
        posterior = self.get_posterior(params)
        return dist.Normal(posterior.loc, jnp.sqrt(posterior.variance))


class AutoLaplaceApproximation(AutoContinuous):
    """Delta-fit then Gaussian at the MAP with covariance from the Hessian
    of the negative log joint (reference: autoguide.py:2099)."""

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=init_to_uniform,
        create_plates=None,
        hessian_fn=None,
    ):
        self._hessian_fn = (
            hessian_fn if hessian_fn is not None else (lambda f, x: hessian(f)(x))
        )
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, create_plates=create_plates
        )

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        self._args = args
        self._kwargs = kwargs

    def _get_posterior(self, *args, **kwargs):
        # the fitted object is a Delta at the MAP point
        point = numpyro_tpu.param(self._pname("loc"), self._init_latent)
        return dist.Delta(point, event_dim=1)

    def get_base_dist(self):
        return dist.Normal(jnp.zeros(self.latent_dim), 1.0).to_event(1)

    def _neg_log_joint(self, packed):
        return self._potential_fn(self._unpack_latent(packed))

    def get_posterior(self, params):
        """Gaussian posterior using the Hessian at the fitted loc."""
        point = params[self._pname("loc")]
        curvature = self._hessian_fn(self._neg_log_joint, point)
        scale_tril = jnp.linalg.cholesky(jnp.linalg.inv(curvature))
        if not_jax_tracer(scale_tril):
            if np.any(np.isnan(np.asarray(scale_tril))):
                warnings.warn(
                    "Hessian of log posterior at the MAP point is singular. "
                    "Posterior samples from AutoLaplaceApproximation will be "
                    "constant (equal to the MAP point).",
                    stacklevel=find_stack_level(),
                )
        scale_tril = jnp.where(jnp.isnan(scale_tril), 0.0, scale_tril)
        return dist.MultivariateNormal(point, scale_tril=scale_tril)

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        packed = self.get_posterior(params).sample(rng_key, sample_shape)
        return self._unpack_and_constrain(packed, params)

    def median(self, params):
        return self._unpack_and_constrain(params[self._pname("loc")], params)

    def quantiles(self, params, quantiles):
        q = jnp.array(quantiles)[..., None]
        posterior = self.get_posterior(params)
        latent = dist.Normal(posterior.loc, jnp.sqrt(posterior.variance)).icdf(q)
        return self._unpack_and_constrain(latent, params)


class _FlowGuide(AutoContinuous):
    """Shared flow-stack builder: interleaves reversing permutations between
    learned flow layers registered as numpyro modules."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=None, num_flows=1):
        self.num_flows = num_flows
        super().__init__(
            model,
            prefix=prefix,
            init_loc_fn=init_loc_fn if init_loc_fn is not None else init_to_uniform,
        )

    def _flow_layer(self, i):
        raise NotImplementedError

    def _get_posterior(self):
        from numpyro_tpu.distributions.transforms import PermuteTransform

        if self.latent_dim == 1:
            raise ValueError(
                "latent dim = 1. Consider using AutoDiagonalNormal instead"
            )
        layers = []
        for i in range(self.num_flows):
            if i:
                layers.append(
                    PermuteTransform(jnp.arange(self.latent_dim)[::-1])
                )
            layers.append(self._flow_layer(i))
        return dist.TransformedDistribution(self.get_base_dist(), layers)

    def get_base_dist(self):
        return dist.Normal(jnp.zeros(self.latent_dim), 1).to_event(1)


class AutoIAFNormal(_FlowGuide):
    """Diagonal-Normal base pushed through a stack of Inverse Autoregressive
    Flows over the packed latent (reference: autoguide.py:2202; Kingma et
    al. 2016).  The flow matmuls batch over ELBO particles on the tensor cores."""

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=None,
        num_flows=3,
        hidden_dims=None,
        skip_connections=False,
        nonlinearity=None,
    ):
        from jax.example_libraries import stax

        self._hidden_dims = hidden_dims
        self._skip_connections = skip_connections
        self._nonlinearity = nonlinearity if nonlinearity is not None else stax.Elu
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, num_flows=num_flows
        )

    def _flow_layer(self, i):
        from numpyro_tpu.distributions.flows import InverseAutoregressiveTransform
        from numpyro_tpu.nn import AutoregressiveNN

        widths = (
            [self.latent_dim, self.latent_dim]
            if self._hidden_dims is None
            else self._hidden_dims
        )
        conditioner = AutoregressiveNN(
            self.latent_dim,
            widths,
            permutation=jnp.arange(self.latent_dim),
            skip_connections=self._skip_connections,
            nonlinearity=self._nonlinearity,
        )
        net = numpyro_tpu.module(
            self._pname(f"arn__{i}"), conditioner, (self.latent_dim,)
        )
        return InverseAutoregressiveTransform(net)


class AutoBNAFNormal(_FlowGuide):
    """Diagonal-Normal base through a Block Neural Autoregressive Flow
    (reference: autoguide.py:2280; De Cao et al.)."""

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=None,
        num_flows=1,
        hidden_factors=[8, 8],
    ):
        self._hidden_factors = hidden_factors
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, num_flows=num_flows
        )

    def _flow_layer(self, i):
        from numpyro_tpu.distributions.flows import (
            BlockNeuralAutoregressiveTransform,
        )
        from numpyro_tpu.nn import BlockNeuralAutoregressiveNN

        residual = "gated" if i < (self.num_flows - 1) else None
        block_net = BlockNeuralAutoregressiveNN(
            self.latent_dim, self._hidden_factors, residual
        )
        net = numpyro_tpu.module(
            self._pname(f"arn__{i}"), block_net, (self.latent_dim,)
        )
        return BlockNeuralAutoregressiveTransform(net)
def _check_dais_hyperparams(K, eta_init, eta_max, gamma_init, init_scale):
    if K < 1:
        raise ValueError(f"K must satisfy K >= 1 (got K = {K})")
    if eta_init <= 0.0 or eta_init >= eta_max:
        raise ValueError("eta_init must be positive with eta_init < eta_max.")
    if eta_max <= 0.0:
        raise ValueError("eta_max must be positive.")
    if gamma_init <= 0.0 or gamma_init >= 1.0:
        raise ValueError("gamma_init must be in the open interval (0, 1).")
    if init_scale <= 0.0:
        raise ValueError("init_scale must be positive.")


def _dais_anneal(
    z_0,
    eps_seq,
    beta_seq,
    *,
    eta0,
    eta_coeff,
    eta_max,
    gamma,
    inv_mass,
    momentum_lp,
    base_grad,
    target_grad,
    widen,
    log_factor_0,
):
    """The K uncorrected-leapfrog annealing steps shared by every DAIS guide.

    One ``lax.scan`` whose carry is (position, velocity, accumulated
    importance-weight correction).  ``widen`` right-expands per-instance
    scalars (eta, beta, gamma) onto the latent axis — identity for the
    global AutoDAIS, ``x[:, None]`` for the per-datum AutoSemiDAIS.
    """

    def anneal_step(carry, inputs):
        eps_k, beta = inputs
        z_prev, v_prev, log_factor = carry
        eta = jnp.clip(eta0 + eta_coeff * beta, 0.0, eta_max)
        eta_w, beta_w = widen(eta), widen(beta)
        # leapfrog under the annealed density (1-beta)*base + beta*target
        z_half = z_prev + v_prev * eta_w * inv_mass
        pull = (1.0 - beta_w) * base_grad(z_half) + beta_w * target_grad(z_half)
        v_hat = v_prev + eta_w * pull
        z_next = z_half + v_hat * eta_w * inv_mass
        # partial momentum refresh, with the kinetic-energy correction
        v_next = widen(gamma) * v_hat + jnp.sqrt(1.0 - widen(gamma) ** 2) * eps_k
        log_factor = log_factor + momentum_lp(v_prev) - momentum_lp(v_hat)
        return (z_next, v_next, log_factor), None

    # the last refresh draw is never consumed; reuse it as the initial v
    v_0 = eps_seq[-1]
    (z, _, log_factor), _ = jax.lax.scan(
        anneal_step, (z_0, v_0, log_factor_0), (eps_seq, beta_seq)
    )
    return z, log_factor


def _normalized_schedule(raw_increments):
    steps = jnp.cumsum(raw_increments, axis=-1)
    return steps / steps[..., -1:]


class AutoDAIS(AutoContinuous):
    """Differentiable Annealed Importance Sampling guide (Geffner & Domke;
    Zhang et al.) — uncorrected-HMC annealing from a learnable Normal base to
    the posterior, all inside one ``lax.scan``
    (reference: autoguide.py:815)."""

    def __init__(
        self,
        model,
        *,
        K=4,
        base_dist="diagonal",
        eta_init=0.01,
        eta_max=0.1,
        gamma_init=0.9,
        prefix="auto",
        init_loc_fn=init_to_uniform,
        init_scale=0.1,
    ):
        _check_dais_hyperparams(K, eta_init, eta_max, gamma_init, init_scale)
        if base_dist not in ["diagonal", "cholesky"]:
            raise ValueError('base_dist must be one of "diagonal" or "cholesky".')
        self.eta_init = eta_init
        self.eta_max = eta_max
        self.gamma_init = gamma_init
        self.K = K
        self.base_dist = base_dist
        self._init_scale = init_scale
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn)

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        for name, site in self.prototype_trace.items():
            if (
                site["type"] == "plate"
                and isinstance(site["args"][1], int)
                and site["args"][0] > site["args"][1]
            ):
                raise NotImplementedError(
                    "AutoDAIS cannot be used with data subsampling."
                )

    def _get_posterior(self):
        raise NotImplementedError

    def _dais_log_density(self, x):
        with handlers.block():
            return -self._potential_fn(self._unpack_latent(x))

    def _dais_schedule_params(self):
        eta0 = numpyro_tpu.param(
            self._pname("eta0"),
            self.eta_init,
            constraint=constraints.interval(0, self.eta_max),
        )
        eta_coeff = numpyro_tpu.param(self._pname("eta_coeff"), 0.0)
        gamma = numpyro_tpu.param(
            self._pname("gamma"),
            self.gamma_init,
            constraint=constraints.interval(0, 1),
        )
        betas = _normalized_schedule(
            numpyro_tpu.param(
                self._pname("beta_increments"),
                jnp.ones(self.K),
                constraint=constraints.positive,
            )
        )
        return eta0, eta_coeff, gamma, betas

    def _base_family(self):
        anchor = numpyro_tpu.param(self._pname("z_0_loc"), self._init_latent)
        if self.base_dist == "diagonal":
            spread = numpyro_tpu.param(
                self._pname("z_0_scale"),
                jnp.full(self.latent_dim, self._init_scale),
                constraint=constraints.positive,
            )
            return dist.Normal(anchor, spread).to_event()
        root = numpyro_tpu.param(
            self._pname("z_0_scale_tril"),
            jnp.identity(self.latent_dim) * self._init_scale,
            constraint=constraints.scaled_unit_lower_cholesky,
        )
        return dist.MultivariateNormal(anchor, scale_tril=root)

    def _sample_latent(self, *args, **kwargs):
        eta0, eta_coeff, gamma, betas = self._dais_schedule_params()
        mass = numpyro_tpu.param(
            self._pname("mass_matrix"),
            jnp.ones(self.latent_dim),
            constraint=constraints.positive,
        )

        base = self._base_family()
        z_0 = numpyro_tpu.sample(
            self._pname("z_0"), base, infer={"is_auxiliary": True}
        )
        momentum = dist.Normal(0, mass).to_event()
        eps = numpyro_tpu.sample(
            self._pname("momentum"),
            momentum.expand((self.K,)).to_event().mask(False),
            infer={"is_auxiliary": True},
        )

        z, log_factor = _dais_anneal(
            z_0,
            eps,
            betas,
            eta0=eta0,
            eta_coeff=eta_coeff,
            eta_max=self.eta_max,
            gamma=gamma,
            inv_mass=0.5 / mass,
            momentum_lp=momentum.log_prob,
            base_grad=grad(base.log_prob),
            target_grad=grad(self._dais_log_density),
            widen=lambda s: s,
            log_factor_0=0.0,
        )
        numpyro_tpu.factor(self._pname("factor"), log_factor)
        return z

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        def one_draw(key):
            packed = handlers.substitute(
                handlers.seed(self._sample_latent, key), params
            )(sample_shape=())
            return self._unpack_and_constrain(packed, params)

        if not sample_shape:
            return one_draw(rng_key)
        keys = random.split(rng_key, int(np.prod(sample_shape)))
        draws = jax.lax.map(one_draw, keys)
        return jax.tree.map(
            lambda x: jnp.reshape(x, sample_shape + jnp.shape(x)[1:]), draws
        )


class AutoSurrogateLikelihoodDAIS(AutoDAIS):
    """DAIS guided by a cheap surrogate likelihood (Jankowiak & Phan) —
    unlike AutoDAIS this composes with data subsampling
    (reference: autoguide.py:1015)."""

    def __init__(
        self,
        model,
        surrogate_model,
        *,
        K=4,
        eta_init=0.01,
        eta_max=0.1,
        gamma_init=0.9,
        prefix="auto",
        base_dist="diagonal",
        init_loc_fn=init_to_uniform,
        init_scale=0.1,
    ):
        super().__init__(
            model,
            K=K,
            eta_init=eta_init,
            eta_max=eta_max,
            gamma_init=gamma_init,
            prefix=prefix,
            init_loc_fn=init_loc_fn,
            init_scale=init_scale,
            base_dist=base_dist,
        )
        self.surrogate_model = surrogate_model

    def _setup_prototype(self, *args, **kwargs):
        AutoContinuous._setup_prototype(self, *args, **kwargs)
        rng_key = numpyro_tpu.prng_key()
        if rng_key is None:
            rng_key = random.PRNGKey(0)
        with handlers.block():
            (
                _,
                self._surrogate_potential_fn,
                _,
                self._surrogate_prototype_trace,
            ) = infer_util.initialize_model(
                rng_key,
                self.surrogate_model,
                init_strategy=self.init_loc_fn,
                dynamic_args=False,
                model_args=(),
                model_kwargs={},
            )

    def _dais_log_density(self, x):
        with handlers.block():
            return -self._surrogate_potential_fn(self._unpack_latent(x))

    def _sample_latent(self, *args, **kwargs):
        # register surrogate params so they are optimized jointly
        for name, site in self._surrogate_prototype_trace.items():
            if site["type"] == "param":
                numpyro_tpu.param(name, site["value"], **site["kwargs"])
        return super()._sample_latent(*args, **kwargs)


class AutoBatchedMixin:
    """Infer batch/event split for guides batched over a leading plate
    (reference: autoguide.py:1850)."""

    def __init__(self, *args, **kwargs):
        self._batch_shape = None
        self._event_shape = None
        self.batch_ndim = kwargs.pop("batch_ndim")
        super().__init__(*args, **kwargs)

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        batch_shape = None
        for site in self.prototype_trace.values():
            if site["type"] == "sample" and not site["is_observed"]:
                shape = site["value"].shape
                if site["value"].ndim < self.batch_ndim + site["fn"].event_dim:
                    raise ValueError(
                        f"Expected {self.batch_ndim} batch dimensions, but "
                        f"site `{site['name']}` only has shape {shape}."
                    )
                shape = shape[: self.batch_ndim]
                if batch_shape is None:
                    batch_shape = shape
                elif shape != batch_shape:
                    raise ValueError("Encountered inconsistent batch shapes.")
        self._batch_shape = batch_shape
        batch_size = math.prod(self._batch_shape)
        if self.latent_dim % batch_size:
            raise RuntimeError(
                f"Incompatible batch shape {batch_shape} (size {batch_size}) "
                f"and latent dims {self.latent_dim}."
            )
        self._event_shape = (self.latent_dim // batch_size,)

    def _get_batched_posterior(self):
        raise NotImplementedError

    def _get_posterior(self):
        from numpyro_tpu.distributions.transforms import ReshapeTransform

        return dist.TransformedDistribution(
            self._get_batched_posterior(),
            ReshapeTransform(
                (self.latent_dim,), self._batch_shape + self._event_shape
            ),
        )

    def median(self, params):
        flat = params[self._pname("loc")].reshape((self.latent_dim,))
        return self._unpack_and_constrain(flat, params)


class AutoBatchedMultivariateNormal(AutoBatchedMixin, AutoContinuous):
    """Batched full-covariance Normal guide: one MVN per element of a
    leading batch axis (reference: autoguide.py:1909)."""

    scale_tril_constraint = constraints.scaled_unit_lower_cholesky

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=init_to_uniform,
        init_scale=0.1,
        batch_ndim=1,
    ):
        if init_scale <= 0:
            raise ValueError(f"Expected init_scale > 0. but got {init_scale}")
        self._init_scale = init_scale
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, batch_ndim=batch_ndim
        )

    def _get_batched_posterior(self):
        grouped = self._init_latent.reshape(self._batch_shape + self._event_shape)
        loc = numpyro_tpu.param(self._pname("loc"), grouped)
        eye = jnp.identity(grouped.shape[-1]) * self._init_scale
        scale_tril = numpyro_tpu.param(
            self._pname("scale_tril"),
            jnp.broadcast_to(eye, self._batch_shape + eye.shape),
            constraint=self.scale_tril_constraint,
        )
        return dist.MultivariateNormal(loc, scale_tril=scale_tril)


class AutoBatchedLowRankMultivariateNormal(AutoBatchedMixin, AutoContinuous):
    """Batched low-rank + diagonal Normal guide
    (reference: autoguide.py:2040)."""

    scale_constraint = constraints.softplus_positive

    def __init__(
        self,
        model,
        *,
        prefix="auto",
        init_loc_fn=init_to_uniform,
        init_scale=0.1,
        rank=None,
        batch_ndim=1,
    ):
        if init_scale <= 0:
            raise ValueError(f"Expected init_scale > 0. but got {init_scale}")
        self._init_scale = init_scale
        self.rank = rank
        super().__init__(
            model, prefix=prefix, init_loc_fn=init_loc_fn, batch_ndim=batch_ndim
        )

    def _get_batched_posterior(self):
        rank = (
            int(round(self._event_shape[0] ** 0.5))
            if self.rank is None
            else self.rank
        )
        grouped = self._init_latent.reshape(self._batch_shape + self._event_shape)
        loc = numpyro_tpu.param(self._pname("loc"), grouped)
        raw_factor = numpyro_tpu.param(
            self._pname("cov_factor"),
            jnp.zeros(self._batch_shape + self._event_shape + (rank,)),
        )
        scale = numpyro_tpu.param(
            self._pname("scale"),
            jnp.full(self._batch_shape + self._event_shape, self._init_scale),
            constraint=self.scale_constraint,
        )
        return dist.LowRankMultivariateNormal(
            loc, raw_factor * scale[..., None], jnp.square(scale)
        )


def _flatten_local_dict(values):
    """Concatenate a dict of arrays (sorted by name) into one flat vector,
    returning (flat, shape_dict)."""
    names = sorted(values)
    flat = jnp.concatenate([jnp.reshape(values[n], (-1,)) for n in names])
    shapes = {n: jnp.shape(values[n]) for n in names}
    return flat, shapes


def _unflatten_local_dict(flat, shapes):
    out, pos = {}, 0
    for n in sorted(shapes):
        size = int(np.prod(shapes[n])) if shapes[n] else 1
        out[n] = jnp.reshape(flat[pos : pos + size], shapes[n])
        pos += size
    return out


def _subsample_model(model, *args, **kwargs):
    """Pin plate subsample indices via the ``_subsample_idx`` kwarg
    (reference: autoguide.py:1229)."""
    data = kwargs.pop("_subsample_idx", {})
    with handlers.substitute(data=data):
        return model(*args, **kwargs)


class AutoSemiDAIS(AutoGuide):
    """Semi-parametric DAIS (Jankowiak & Phan): a parametric guide over the
    global latents combined with Differentiable Annealed Importance Sampling
    over the *local* latents inside a subsample plate — the subsample-capable
    sibling of :class:`AutoDAIS` (reference: autoguide.py:1235).

    Shape note: the K annealed uncorrected-HMC steps run in one
    ``lax.scan`` over a ``(subsample, D)`` local-latent matrix, so all
    per-datum dynamics are batched elementwise programs with no host loop.

    :param callable model: full model (globals + locals).
    :param callable local_model: the local portion; called with the return
        value of the global model.
    :param global_guide: autoguide for the global latents (or None).
    :param local_guide: optional guide whose samples serve as the DAIS base
        distribution for the locals.
    """

    def __init__(
        self,
        model,
        local_model,
        global_guide=None,
        local_guide=None,
        *,
        prefix="auto",
        K=4,
        eta_init=0.01,
        eta_max=0.1,
        gamma_init=0.9,
        init_scale=0.1,
        subsample_plate=None,
        use_global_dais_params=False,
    ):
        super().__init__(model, prefix=prefix, init_loc_fn=init_to_uniform)
        _check_dais_hyperparams(K, eta_init, eta_max, gamma_init, init_scale)
        self.local_model = local_model
        self.global_guide = global_guide
        self.local_guide = local_guide
        self.K = K
        self.eta_init = eta_init
        self.eta_max = eta_max
        self.gamma_init = gamma_init
        self._init_scale = init_scale
        self.subsample_plate = subsample_plate
        self.use_global_dais_params = use_global_dais_params

    # -- prototype ------------------------------------------------------

    def _find_subsample_plate(self):
        def is_subsampled(site):
            return (
                site["type"] == "plate"
                and isinstance(site["args"][1], int)
                and site["args"][0] > site["args"][1]
            )

        candidates = {
            n: s for n, s in self.prototype_trace.items() if is_subsampled(s)
        }
        if self.subsample_plate is not None:
            candidates[self.subsample_plate] = self.prototype_trace[
                self.subsample_plate
            ]
        elif not candidates:
            candidates = {
                n: s
                for n, s in self.prototype_trace.items()
                if s["type"] == "plate"
            }
        if len(candidates) != 1:
            raise ValueError(
                "AutoSemiDAIS expects exactly one data (subsample) plate, "
                f"found {len(candidates)}"
            )
        name = next(iter(candidates))
        full, sub = candidates[name]["args"]
        return name, full, full if sub is None else sub

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        plate_name, N, subsample_size = self._find_subsample_plate()

        # locate local latents (inside the plate) and which axis of each the
        # plate occupies
        self._local_axes = {}
        plate_dim = None
        for name, site in self.prototype_trace.items():
            if site["type"] != "sample" or site["is_observed"]:
                continue
            for frame in site["cond_indep_stack"]:
                if frame.name == plate_name:
                    if plate_dim is None:
                        plate_dim = frame.dim
                    self._local_axes[name] = plate_dim - site["fn"].event_dim
                    break
        if not self._local_axes:
            raise RuntimeError(
                f"No local latent variables found in plate `{plate_name}`; "
                "AutoSemiDAIS requires local variables."
            )

        local_init = {
            n: v for n, v in self._init_locs.items() if n in self._local_axes
        }
        per_datum = {
            n: jnp.take(v, 0, axis=self._local_axes[n])
            for n, v in local_init.items()
        }
        _, self._local_shapes = _flatten_local_dict(per_datum)
        self._pack_local = vmap(
            lambda x: _flatten_local_dict(x)[0], in_axes=(self._local_axes,)
        )
        self._unpack_local = vmap(
            partial(_unflatten_local_dict, shapes=self._local_shapes),
            out_axes=self._local_axes,
        )
        self._local_latent_dim = jnp.size(self._pack_local(local_init)) // subsample_size
        self._local_plate = (plate_name, N, subsample_size)

        # prototype traces of the local model (and guide) to find their params
        if self.global_guide is not None:
            with handlers.block():
                local_args = (self.global_guide.model(*args, **kwargs),)
                local_kwargs = {}
        else:
            local_args = args
            local_kwargs = kwargs.copy()
        if self.local_guide is not None:
            with handlers.block(), handlers.trace() as tr:
                self.local_guide(*local_args, **local_kwargs)
            self._proto_local_guide_trace = tr
        with handlers.block(), handlers.trace() as tr:
            self.local_model(*local_args, **local_kwargs)
        self._proto_local_model_trace = tr

    def _get_posterior(self):
        raise NotImplementedError

    # -- guide body -----------------------------------------------------

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)
        global_latents, local_flat = self._sample_latent(*args, **kwargs)

        out = dict(global_latents)
        _, N, subsample_size = self._local_plate
        for name, unconstrained in self._unpack_local(local_flat).items():
            site = self.prototype_trace[name]
            push = biject_to(site["fn"].support)
            value = push(unconstrained)
            event_ndim = site["fn"].event_dim
            if numpyro_tpu.get_mask() is False:
                correction = 0.0
            else:
                correction = -push.log_abs_det_jacobian(unconstrained, value)
                correction = (N / subsample_size) * sum_rightmost(
                    correction,
                    jnp.ndim(correction) - jnp.ndim(value) + event_ndim,
                )
            out[name] = numpyro_tpu.sample(
                name,
                dist.Delta(value, log_density=correction, event_dim=event_ndim),
            )
        return out

    def _register_trace_params(self, proto_trace):
        registered = {}
        for name, site in proto_trace.items():
            if site["type"] == "param":
                registered[name] = numpyro_tpu.param(
                    name, site["value"], **site["kwargs"]
                )
        return registered

    def _dais_fleet_params(self, idx, N, D, K):
        """Per-datum (or shared-and-broadcast) DAIS schedule parameters."""
        if self.use_global_dais_params:
            eta0 = jnp.broadcast_to(
                numpyro_tpu.param(
                    self._pname("eta0"),
                    self.eta_init,
                    constraint=constraints.interval(0, self.eta_max),
                ),
                idx.shape,
            )
            eta_coeff = jnp.broadcast_to(
                numpyro_tpu.param(self._pname("eta_coeff"), 0.0), idx.shape
            )
            gamma = jnp.broadcast_to(
                numpyro_tpu.param(
                    self._pname("gamma"),
                    self.gamma_init,
                    constraint=constraints.interval(0, 1),
                ),
                idx.shape,
            )
            betas = jnp.broadcast_to(
                numpyro_tpu.param(
                    self._pname("beta_increments"),
                    jnp.ones(K),
                    constraint=constraints.positive,
                ),
                idx.shape + (K,),
            )
            mass = jnp.broadcast_to(
                numpyro_tpu.param(
                    self._pname("mass_matrix"),
                    jnp.ones(D),
                    constraint=constraints.positive,
                ),
                idx.shape + (D,),
            )
        else:
            eta0 = numpyro_tpu.param(
                self._pname("eta0"),
                jnp.full(N, self.eta_init),
                constraint=constraints.interval(0, self.eta_max),
                event_dim=0,
            )
            eta_coeff = numpyro_tpu.param(
                self._pname("eta_coeff"), jnp.zeros(N), event_dim=0
            )
            gamma = numpyro_tpu.param(
                self._pname("gamma"),
                jnp.full(N, self.gamma_init),
                constraint=constraints.interval(0, 1),
                event_dim=0,
            )
            betas = numpyro_tpu.param(
                self._pname("beta_increments"),
                jnp.ones((N, K)),
                constraint=constraints.positive,
                event_dim=1,
            )
            mass = numpyro_tpu.param(
                self._pname("mass_matrix"),
                jnp.ones((N, D)),
                constraint=constraints.positive,
                event_dim=1,
            )
        return eta0, eta_coeff, gamma, _normalized_schedule(betas), mass

    def _sample_latent(self, *args, **kwargs):
        kwargs.pop("sample_shape", ())
        if self.global_guide is not None:
            global_latents = self.global_guide(*args, **kwargs)
            with handlers.block(), handlers.substitute(data=global_latents):
                global_outputs = self.global_guide.model(*args, **kwargs)
            local_args = (global_outputs,)
            local_kwargs = {}
        else:
            global_latents = {}
            local_args = args
            local_kwargs = kwargs.copy()

        local_guide_params = (
            self._register_trace_params(self._proto_local_guide_trace)
            if self.local_guide is not None
            else {}
        )
        local_model_params = self._register_trace_params(
            self._proto_local_model_trace
        )

        def local_log_density(x):
            latent = self._unpack_local(x)
            with handlers.block():
                return -infer_util.potential_energy(
                    partial(_subsample_model, self.local_model),
                    local_args,
                    local_kwargs,
                    {**latent, **local_model_params},
                )

        plate_name, N, subsample_size = self._local_plate
        D, K = self._local_latent_dim, self.K

        with numpyro_tpu.plate(plate_name, N, subsample_size=subsample_size) as idx:
            eta0, eta_coeff, gamma, betas, mass = self._dais_fleet_params(
                idx, N, D, K
            )
            local_kwargs["_subsample_idx"] = {plate_name: idx}

            if self.local_guide is not None:
                subsample_guide = partial(_subsample_model, self.local_guide)
                with handlers.block(), handlers.trace() as tr, handlers.substitute(
                    data=local_guide_params
                ):
                    subsample_guide(*local_args, **local_kwargs)
                drawn = {
                    name: biject_to(site["fn"].support).inv(site["value"])
                    for name, site in tr.items()
                    if site["type"] == "sample"
                    and not site.get("is_observed", False)
                }
                z_0 = self._pack_local(drawn)

                def base_log_prob(z):
                    latent = self._unpack_local(z)
                    with handlers.block():
                        scale = N / subsample_size
                        return (
                            -infer_util.potential_energy(
                                subsample_guide,
                                local_args,
                                local_kwargs,
                                {**local_guide_params, **latent},
                            )
                            / scale
                        )

                # emitted under the plate: broadcast over subsample_size, so
                # pre-divide to keep the total contribution exact
                numpyro_tpu.factor(
                    self._pname("z_0_factor"),
                    base_log_prob(z_0) / subsample_size,
                )
            else:
                z_0_loc = numpyro_tpu.param(
                    self._pname("z_0_loc"), jnp.zeros((N, D)), event_dim=1
                )
                z_0_scale = numpyro_tpu.param(
                    self._pname("z_0_scale"),
                    jnp.full((N, D), self._init_scale),
                    constraint=constraints.positive,
                    event_dim=1,
                )
                base_z_dist = dist.Normal(z_0_loc, z_0_scale).to_event(1)
                z_0 = numpyro_tpu.sample(
                    self._pname("z_0"), base_z_dist, infer={"is_auxiliary": True}
                )

                def base_log_prob(x):
                    return base_z_dist.log_prob(x).sum()

            momentum = dist.Normal(0, mass).to_event(1)
            eps = numpyro_tpu.sample(
                self._pname("momentum"),
                dist.Normal(0, mass[..., None])
                .expand([subsample_size, D, K])
                .to_event(2)
                .mask(False),
                infer={"is_auxiliary": True},
            )

            z, log_factor = _dais_anneal(
                z_0,
                jnp.moveaxis(eps, -1, 0),
                jnp.moveaxis(betas, -1, 0),
                eta0=eta0,
                eta_coeff=eta_coeff,
                eta_max=self.eta_max,
                gamma=gamma,
                inv_mass=0.5 / mass,
                momentum_lp=momentum.log_prob,
                base_grad=grad(base_log_prob),
                target_grad=lambda zh: (subsample_size / N)
                * grad(local_log_density)(zh),
                widen=lambda s: s[:, None],
                log_factor_0=jnp.zeros(subsample_size),
            )
            numpyro_tpu.factor(self._pname("local_dais_factor"), log_factor)
            return global_latents, z

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        def one_draw(key):
            global_latents, local_flat = handlers.substitute(
                handlers.seed(self._sample_latent, key), params
            )(*args, **kwargs)
            out = dict(global_latents)
            for name, unconstrained in self._unpack_local(local_flat).items():
                site = self.prototype_trace[name]
                out[name] = biject_to(site["fn"].support)(unconstrained)
            return out

        if not sample_shape:
            return one_draw(rng_key)
        keys = random.split(rng_key, int(np.prod(sample_shape)))
        draws = jax.lax.map(one_draw, keys)
        return jax.tree.map(
            lambda x: jnp.reshape(x, sample_shape + jnp.shape(x)[1:]), draws
        )
