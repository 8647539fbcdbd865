"""Model → density bridge (L3).

Fresh implementation of the surface of numpyro/infer/util.py:
``log_density`` / ``potential_energy`` / ``initialize_model`` /
``Predictive`` / ``log_likelihood`` / constrain-unconstrain machinery.

Chain-massive design: ``find_valid_initial_params`` and ``Predictive`` are
vectorized over the chain/sample axis from day one (vmap inside one program,
never a host loop), so 4096-chain initialization is one XLA launch.
"""

from __future__ import annotations

import warnings
from collections import namedtuple
from functools import partial
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import device_get, jacfwd, lax, random, value_and_grad, vmap
from jax.flatten_util import ravel_pytree

from numpyro_tpu import handlers
from numpyro_tpu.distributions import constraints
from numpyro_tpu.distributions.transforms import biject_to
from numpyro_tpu.distributions.util import is_prng_key, sum_rightmost
from numpyro_tpu.infer.initialization import init_to_uniform
from numpyro_tpu.primitives import _PYRO_STACK, Messenger
from numpyro_tpu.util import identity, not_jax_tracer, soft_vmap

__all__ = [
    "constrain_fn",
    "find_valid_initial_params",
    "get_transforms",
    "initialize_model",
    "log_density",
    "log_likelihood",
    "potential_energy",
    "Predictive",
    "transform_fn",
    "unconstrain_fn",
]

ModelInfo = namedtuple(
    "ModelInfo", ["param_info", "potential_fn", "postprocess_fn", "model_trace"]
)
ParamInfo = namedtuple("ParamInfo", ["z", "potential_energy", "z_grad"])


def is_identically_one(x):
    if isinstance(x, (int, float)):
        return x == 1
    if not_jax_tracer(x) and np.ndim(x) == 0:
        return bool(np.asarray(x) == 1)
    return False


def _site_log_prob(site, *, check_shapes=False):
    """Scaled elementwise log-prob of one traced sample site.

    The single implementation behind log_density / compute_log_probs /
    get_importance_trace — transformed-sample intermediates and plate
    subsample scales are handled here once.
    """
    value = site["value"]
    if site["intermediates"]:
        lp = site["fn"].log_prob(value, site["intermediates"])
    else:
        if check_shapes:
            fn_shape = tuple(site["fn"].shape())
            try:
                jnp.broadcast_shapes(jnp.shape(value), fn_shape)
            except ValueError:
                raise ValueError(
                    f"Model and guide shapes disagree at site: "
                    f"'{site['name']}': {fn_shape} vs {jnp.shape(value)}"
                )
        lp = site["fn"].log_prob(value)
    scale = site["scale"]
    if scale is not None and not is_identically_one(scale):
        lp = scale * lp
    return lp


def _traced_log_probs(model, model_args, model_kwargs, params, **lp_kwargs):
    """(site name -> elementwise scaled log-prob, trace) for all sample
    sites of the substituted model."""
    model = handlers.substitute(model, data=params)
    trace = handlers.trace(model).get_trace(*model_args, **model_kwargs)
    lps = {
        name: _site_log_prob(site, **lp_kwargs)
        for name, site in trace.items()
        if site["type"] == "sample"
    }
    return lps, trace


def log_density(model, model_args, model_kwargs, params):
    """Sum of scaled log-probs of all sample sites given substituted params.

    Returns (log_joint, model_trace).
    """
    lps, trace = _traced_log_probs(
        model, model_args, model_kwargs, params, check_shapes=True
    )
    log_joint = jnp.zeros(())
    for lp in lps.values():
        log_joint = log_joint + jnp.sum(lp)
    return log_joint, trace


def compute_log_probs(model, model_args, model_kwargs, params, batch_ndims=0):
    """Per-site (optionally per-batch) log probs; returns (dict, trace)."""
    lps, trace = _traced_log_probs(model, model_args, model_kwargs, params)
    reduced = {
        name: jnp.sum(lp)
        if batch_ndims == 0
        else sum_rightmost(lp, jnp.ndim(lp) - batch_ndims)
        for name, lp in lps.items()
    }
    return reduced, trace


class _without_rsample_stop_gradient(Messenger):
    """Stop gradient for sites with non-reparameterizable samplers."""

    def postprocess_message(self, msg):
        if (
            msg["type"] == "sample"
            and (not msg["is_observed"])
            and (not msg["fn"].has_rsample)
        ):
            msg["value"] = lax.stop_gradient(msg["value"])


def get_importance_trace(model, guide, args, kwargs, params):
    """Run guide, replay model against it; return both traces."""
    guide = handlers.substitute(guide, data=params)
    with _without_rsample_stop_gradient():
        guide_trace = handlers.trace(guide).get_trace(*args, **kwargs)
    model = handlers.substitute(handlers.replay(model, guide_trace), data=params)
    model_trace = handlers.trace(model).get_trace(*args, **kwargs)
    for site in [*guide_trace.values(), *model_trace.values()]:
        if site["type"] == "sample" and "log_prob" not in site:
            site["log_prob"] = _site_log_prob(site)
    return model_trace, guide_trace


def transform_fn(transforms, params, invert=False):
    """Apply (or invert) a dict of per-site transforms to params."""
    def pick(name):
        t = transforms.get(name)
        if t is None:
            return identity
        return t.inv if invert else t

    return {name: pick(name)(value) for name, value in params.items()}


def constrain_fn(model, model_args, model_kwargs, params, return_deterministic=False):
    """Transform unconstrained params to constrained space and recover
    deterministic sites by re-running the model."""
    def substitute_fn(site):
        given = params.get(site["name"])
        if given is None:
            return None
        if site["type"] != "sample":
            return given
        with handlers.block():
            return biject_to(site["fn"].support)(given)

    substituted_model = handlers.substitute(model, substitute_fn=substitute_fn)
    model_trace = handlers.trace(substituted_model).get_trace(
        *model_args, **model_kwargs
    )
    def wanted(name, site):
        if name in params:
            return True
        return return_deterministic and site["type"] == "deterministic"

    return {
        name: site["value"]
        for name, site in model_trace.items()
        if wanted(name, site)
    }


def unconstrain_fn(model, model_args, model_kwargs, params):
    """Constrained params -> unconstrained space."""
    model = handlers.substitute(model, data=params)
    model_trace = handlers.trace(model).get_trace(*model_args, **model_kwargs)

    def is_free_latent(site):
        return (
            site["type"] == "sample"
            and not site["is_observed"]
            and site["fn"].support is not None
        )

    transforms = {
        name: biject_to(site["fn"].support)
        for name, site in model_trace.items()
        if is_free_latent(site)
    }
    return transform_fn(transforms, params, invert=True)


def _unconstrain_reparam(params, site):
    """Substitute-fn that maps unconstrained values into site supports and
    adds the log|det J| as a factor — the inner transformation of
    potential_energy (reference: infer/util.py:269-299)."""
    name = site["name"]
    if name in params:
        if site["type"] != "sample":
            return params[name]
        p = params[name]
        support = site["fn"].support
        with handlers.block():
            t = biject_to(support)
        if t is None:
            return p
        # inside scan we substitute one step's slice of the whole series
        i = site["infer"].get("_scan_current_index", None) if "infer" in site else None
        if i is not None:
            event_dim_shift = t.codomain.event_dim - t.domain.event_dim
            expected_unconstrained_dim = len(site["fn"].shape()) - event_dim_shift
            if jnp.ndim(p) > expected_unconstrained_dim:
                p = p[i]
        if isinstance(support, constraints._IndependentConstraint):
            base = support.base_constraint
        else:
            base = support
        if isinstance(base, constraints._Real):
            # identity transform: no jacobian term
            return p
        value = t(p)

        log_det = t.log_abs_det_jacobian(p, value)
        log_det = sum_rightmost(
            log_det, jnp.ndim(log_det) - jnp.ndim(value) + len(site["fn"].event_shape)
        )
        from numpyro_tpu import factor as numpyro_factor

        numpyro_factor(f"_{name}_log_det", log_det)
        return value


def potential_energy(model, model_args, model_kwargs, params, enum=False):
    """-log p(constrained(params)) - log|det J| — the NUTS target."""
    if enum:
        from numpyro_tpu.contrib.enum import log_density as density_fn
    else:
        density_fn = log_density
    reparamed = handlers.substitute(
        model, substitute_fn=partial(_unconstrain_reparam, params)
    )
    log_joint, _ = density_fn(reparamed, model_args, model_kwargs, {})
    return -log_joint


def find_valid_initial_params(
    rng_key,
    model,
    *,
    init_strategy=init_to_uniform,
    enum=False,
    model_args=(),
    model_kwargs=None,
    prototype_params=None,
    forward_mode_differentiation=False,
    validate_grad=True,
):
    """Rejection-sample initial latents until potential & grad are finite
    (≤100 tries), batched over an arbitrary rng_key batch — the whole search
    for all chains is ONE while_loop program (reference: infer/util.py:335).

    Returns ((init_params, pe, grad), is_valid).
    """
    model_kwargs = {} if model_kwargs is None else model_kwargs
    init_strategy = (
        init_strategy if isinstance(init_strategy, partial) else init_strategy()
    )
    # init_to_uniform can draw directly in unconstrained space — no model
    # trace per rejection iteration, and per-chain keys apply even when the
    # model closure carries its own inner seed
    from numpyro_tpu.infer.initialization import init_to_uniform as _itu

    uniform_radius = (
        init_strategy.keywords.get("radius", 2.0)
        if getattr(init_strategy, "func", None) is _itu
        and prototype_params is not None
        else None
    )

    def draw_candidate(key, margs, mkwargs, proto):
        """One candidate latent dict in unconstrained space."""
        if uniform_radius is not None:
            leaves, treedef = jax.tree.flatten(proto)
            draws = [
                random.uniform(
                    k, jnp.shape(leaf), minval=-uniform_radius, maxval=uniform_radius
                )
                for k, leaf in zip(random.split(key, len(leaves)), leaves)
            ]
            return jax.tree.unflatten(treedef, draws)
        # otherwise: trace under the strategy, then pull each constrained
        # draw back through its support bijector
        strategized = handlers.substitute(
            handlers.seed(model, key), substitute_fn=init_strategy
        )
        trace = handlers.trace(strategized).get_trace(*margs, **mkwargs)
        out = {}
        for name, site in trace.items():
            if (
                site["type"] == "sample"
                and not site["is_observed"]
                and not site["fn"].support.is_discrete
            ):
                with handlers.block():
                    out[name] = biject_to(site["fn"].support).inv(site["value"])
        return out

    def score_candidate(params, margs, mkwargs):
        """(pe, grad-or-None, finite?) for one candidate."""
        pe_fn = partial(potential_energy, model, margs, mkwargs, enum=enum)
        if not validate_grad:
            pe = pe_fn(params)
            return pe, None, jnp.isfinite(pe)
        if forward_mode_differentiation:
            pe, grad = pe_fn(params), jacfwd(pe_fn)(params)
        else:
            pe, grad = value_and_grad(pe_fn)(params)
        finite = jnp.isfinite(pe) & jnp.all(
            jnp.isfinite(ravel_pytree(grad)[0])
        )
        return pe, grad, finite

    def attempt(state, margs, mkwargs, proto):
        tries, key, _, _ = state
        key, sub = random.split(key)
        params = draw_candidate(sub, margs, mkwargs, proto)
        pe, grad, ok = score_candidate(params, margs, mkwargs)
        return tries + 1, key, (params, pe, grad), ok

    def search(key, margs, mkwargs, exit_early=False, proto=None):
        proto = prototype_params if proto is None else proto
        seed_state = (
            0,
            key,
            (
                proto,
                jnp.zeros(()),
                proto if validate_grad else None,
            ),
            jnp.asarray(False),
        )
        if exit_early and not_jax_tracer(key):
            # first try outside the loop: the common case needs no retries
            # and can return without compiling the while_loop at all
            seed_state = attempt(seed_state, margs, mkwargs, proto)
            ok = seed_state[3]
            if not_jax_tracer(ok) and device_get(ok):
                return seed_state[2], ok
        _, _, found, ok = lax.while_loop(
            lambda s: (s[0] < 100) & ~s[3],
            lambda s: attempt(s, margs, mkwargs, proto),
            seed_state,
        )
        return found, ok

    # batched over the leading dim of rng_key: ALL chains share one batched
    # while_loop program (reference vmaps this too, infer/util.py:471-477).
    # Jitted as ONE program: eager dispatch would execute the search graph
    # op-by-op (hundreds of tiny device programs, each a launch and a
    # host round trip), and lax.map would run it sequentially per chain
    # (num_chains full-data passes at covtype scale).  The model data ride
    # in as traced ARGUMENTS — a closure capture would bake them into the
    # program as constants, embedding the whole dataset in the compiled
    # program and recompiling for every new dataset.
    if is_prng_key(rng_key):
        return search(rng_key, model_args, model_kwargs, exit_early=True)
    from numpyro_tpu.util import merge_dynamic, split_dynamic

    # prototype_params also rides as an argument: a jax.Array baked as a
    # constant is copied from the device to the host at lowering time
    dyn, meta = split_dynamic((model_args, model_kwargs, prototype_params))

    @jax.jit
    def _batched_search(keys, dyn):
        margs, mkwargs, proto = merge_dynamic(dyn, meta)
        return vmap(lambda k: search(k, margs, mkwargs, proto=proto))(keys)

    return _batched_search(rng_key, dyn)


def _get_model_transforms(model, model_args=(), model_kwargs=None):
    model_kwargs = {} if model_kwargs is None else model_kwargs
    model_trace = handlers.trace(model).get_trace(*model_args, **model_kwargs)
    inv_transforms = {}
    has_enumerate_support = False
    replay_model = False
    for k, v in model_trace.items():
        if v["type"] == "sample" and not v["is_observed"]:
            if v["fn"].support.is_discrete:
                enum_type = v["infer"].get("enumerate")
                if enum_type is not None and enum_type != "parallel":
                    raise RuntimeError(f"This algorithm might only work for discrete sites with enumerate marked 'parallel'.")
                if enum_type is None and not v["fn"].has_enumerate_support:
                    raise RuntimeError(
                        f"MCMC marginalization requires discrete site '{k}' "
                        "to have enumerate support."
                    )
                has_enumerate_support = True
            else:
                support = v["fn"].support
                with handlers.block():
                    inv_transforms[k] = biject_to(support)
                # heuristics: if the support depends on traced values, the
                # model must be replayed for postprocessing
                if callable(support) and hasattr(support, "__dict__"):
                    for attr in support.__dict__.values():
                        if isinstance(attr, jax.core.Tracer):
                            replay_model = True
        elif v["type"] == "deterministic":
            replay_model = True
    return inv_transforms, replay_model, has_enumerate_support, model_trace


def get_transforms(model, model_args, model_kwargs, params=None):
    """Dict of per-site biject_to transforms of the model."""
    substituted = (
        handlers.substitute(model, data=params) if params is not None else model
    )
    inv_transforms, _, _, _ = _get_model_transforms(
        substituted, model_args, model_kwargs
    )
    return inv_transforms


def get_potential_fn(
    model,
    inv_transforms,
    *,
    enum=False,
    replay_model=False,
    dynamic_args=False,
    model_args=(),
    model_kwargs=None,
):
    """Build (potential_fn, postprocess_fn) closures (reference:
    infer/util.py:546-611)."""
    if dynamic_args:

        def potential_fn(*args, **kwargs):
            result = partial(potential_energy, model, args, kwargs, enum=enum)
            return result

        def postprocess_fn(*args, **kwargs):
            if replay_model:
                return partial(
                    constrain_fn, model, args, kwargs, return_deterministic=True
                )
            else:
                return partial(transform_fn, inv_transforms)

    else:
        model_kwargs = {} if model_kwargs is None else model_kwargs
        potential_fn = partial(
            potential_energy, model, model_args, model_kwargs, enum=enum
        )
        if replay_model:
            postprocess_fn = partial(
                constrain_fn,
                model,
                model_args,
                model_kwargs,
                return_deterministic=True,
            )
        else:
            postprocess_fn = partial(transform_fn, inv_transforms)

    return potential_fn, postprocess_fn


def initialize_model(
    rng_key,
    model,
    *,
    init_strategy=init_to_uniform,
    dynamic_args=False,
    model_args=(),
    model_kwargs=None,
    forward_mode_differentiation=False,
    validate_grad=True,
):
    """Trace the model, build potential/postprocess closures, and find valid
    initial params (reference: infer/util.py:632-800).

    ``rng_key`` may be a batch of keys — initialization is then vectorized
    over chains inside a single program.
    """
    model_kwargs = {} if model_kwargs is None else model_kwargs
    substituted_model = handlers.substitute(
        handlers.seed(model, rng_key if is_prng_key(rng_key) else rng_key[0]),
        substitute_fn=init_strategy
        if isinstance(init_strategy, partial)
        else init_strategy(),
    )
    (
        inv_transforms,
        replay_model,
        has_enumerate_support,
        model_trace,
    ) = _get_model_transforms(substituted_model, model_args, model_kwargs)

    if has_enumerate_support:
        from numpyro_tpu.contrib.enum import enum as enum_handler, config_enumerate

        max_plate_nesting = _guess_max_plate_nesting(model_trace)
        model = enum_handler(
            config_enumerate(model), first_available_dim=-1 - max_plate_nesting
        )

    enum = has_enumerate_support
    potential_fn, postprocess_fn = get_potential_fn(
        model,
        inv_transforms,
        enum=enum,
        replay_model=replay_model,
        dynamic_args=dynamic_args,
        model_args=model_args,
        model_kwargs=model_kwargs,
    )

    init_strategy_ = (
        init_strategy if isinstance(init_strategy, partial) else init_strategy()
    )

    prototype_params = transform_fn(
        inv_transforms,
        {
            k: v["value"]
            for k, v in model_trace.items()
            if v["type"] == "sample"
            and not v["is_observed"]
            and not v["fn"].support.is_discrete
        },
        invert=True,
    )

    # NB: pass the *unseeded* model — draw_candidate applies its own
    # per-candidate seed, and baking a (possibly traced) rng_key into a
    # seed handler here leaks that tracer through jax's while_loop caches
    (init_params, pe, grad), is_valid = find_valid_initial_params(
        rng_key,
        model,
        init_strategy=init_strategy_,
        enum=enum,
        model_args=model_args,
        model_kwargs=model_kwargs,
        prototype_params=prototype_params,
        forward_mode_differentiation=forward_mode_differentiation,
        validate_grad=validate_grad,
    )

    if not_jax_tracer(is_valid):
        if device_get(~jnp.all(is_valid)):
            raise RuntimeError(
                "Cannot find valid initial parameters. Please check your model "
                "again."
            )

    return ModelInfo(
        ParamInfo(init_params, pe, grad), potential_fn, postprocess_fn, model_trace
    )


def _guess_max_plate_nesting(model_trace):
    """Largest -dim over all plates in a trace."""
    sites = [site for site in model_trace.values() if site["type"] == "sample"]
    dims = [
        frame.dim
        for site in sites
        for frame in site["cond_indep_stack"]
        if frame.dim is not None
    ]
    return -min(dims) if dims else 0


def _predictive(
    rng_key,
    model,
    posterior_samples,
    batch_shape,
    return_sites=None,
    infer_discrete=False,
    parallel=True,
    model_args=(),
    model_kwargs={},
    exclude_deterministic=True,
):
    masked_model = handlers.mask(model, mask=False)

    def single_prediction(val):
        rng_key, samples = val
        if infer_discrete:
            # sample enumerated discrete sites from their conditional
            # posterior given the continuous draw (contrib.enum VE engine)
            from numpyro_tpu.contrib.enum import infer_discrete as _infer_discrete

            rng_key, discrete_key = random.split(rng_key)
            conditioned = handlers.substitute(model, samples)
            first_available_dim = -1 - _guess_max_plate_nesting_from_model(
                conditioned, model_args, model_kwargs, rng_key
            )
            sampled_model = _infer_discrete(
                conditioned,
                first_available_dim=first_available_dim,
                temperature=1,
                rng_key=discrete_key,
            )
            model_trace = handlers.trace(
                handlers.seed(handlers.mask(sampled_model, mask=False), rng_key)
            ).get_trace(*model_args, **model_kwargs)
        else:
            substituted_model = handlers.substitute(masked_model, samples)
            model_trace = handlers.trace(
                handlers.seed(substituted_model, rng_key)
            ).get_trace(*model_args, **model_kwargs)
        if return_sites is not None:
            if return_sites == "":
                sites = {
                    k for k, site in model_trace.items() if site["type"] != "plate"
                }
            else:
                sites = return_sites
        else:
            sites = {
                k
                for k, site in model_trace.items()
                if (site["type"] == "sample" and k not in samples)
                or (site["type"] == "deterministic")
            }
        return {
            name: site["value"]
            for name, site in model_trace.items()
            if name in sites
        }

    num_samples = int(np.prod(batch_shape))
    key_shape = rng_key.shape
    if num_samples > 1:
        rng_key = random.split(rng_key, num_samples)
    rng_key = rng_key.reshape(batch_shape + key_shape)
    chunk_size = num_samples if parallel else 1
    return soft_vmap(
        single_prediction,
        (rng_key, posterior_samples),
        len(batch_shape),
        chunk_size,
    )


class Predictive:
    """Prior/posterior predictive sampler (reference: infer/util.py:803-1091).

    Vectorized via soft_vmap (chunked vmap) — memory-bounded fan-out on chip.
    """

    def __init__(
        self,
        model: Callable,
        posterior_samples=None,
        *,
        guide=None,
        params=None,
        num_samples=None,
        return_sites=None,
        infer_discrete=False,
        parallel=False,
        batch_ndims=None,
        exclude_deterministic=True,
    ):
        if posterior_samples is None and num_samples is None:
            raise ValueError(
                "Either posterior_samples or num_samples must be specified."
            )
        if batch_ndims is None:
            # a guide draws fresh latents per call from unbatched params;
            # posterior samples carry a leading sample axis
            batch_ndims = 0 if guide is not None else 1
        posterior_samples = posterior_samples or {}

        batch_shape = _common_batch_shape(posterior_samples, batch_ndims)
        if batch_shape is not None:
            batch_size = int(np.prod(batch_shape))
            if num_samples is not None and num_samples != batch_size:
                warnings.warn(
                    f"Sample's batch dimension size {batch_size} is different "
                    f"from the provided {num_samples} num_samples argument. "
                    f"Defaulting to {batch_size}.",
                    UserWarning,
                    stacklevel=2,
                )
            num_samples = batch_size
        elif num_samples is None:
            raise ValueError(
                "No sample sites in posterior samples to infer `num_samples`."
            )
        else:
            batch_shape = (1,) * (batch_ndims - 1) + (num_samples,)

        if return_sites is not None:
            assert isinstance(return_sites, (list, tuple, set))

        self.model = model
        self.posterior_samples = {} if posterior_samples is None else posterior_samples
        self.num_samples = num_samples
        self.guide = guide
        self.params = {} if params is None else params
        self.infer_discrete = infer_discrete
        self.return_sites = return_sites
        self.parallel = parallel
        self.batch_ndims = batch_ndims
        self._batch_shape = batch_shape
        self.exclude_deterministic = exclude_deterministic

    def _call_with_params(self, rng_key, params, args, kwargs):
        posterior_samples = self.posterior_samples
        if self.guide is not None:
            rng_key, guide_rng_key = random.split(rng_key)
            # use return_sites='' as a special signal to return all sites
            guide = handlers.substitute(self.guide, params)
            posterior_samples = _predictive(
                guide_rng_key,
                guide,
                posterior_samples,
                self._batch_shape,
                return_sites="",
                parallel=self.parallel,
                model_args=args,
                model_kwargs=kwargs,
            )
        model = handlers.substitute(self.model, self.params)
        return _predictive(
            rng_key,
            model,
            posterior_samples,
            self._batch_shape,
            return_sites=self.return_sites,
            infer_discrete=self.infer_discrete,
            parallel=self.parallel,
            model_args=args,
            model_kwargs=kwargs,
            exclude_deterministic=self.exclude_deterministic,
        )

    def __call__(self, rng_key, *args, **kwargs):
        if self.batch_ndims == 0 or self.params == {} or self.guide is None:
            return self._call_with_params(rng_key, self.params, args, kwargs)
        elif self.batch_ndims == 1:  # batch over parameters
            batch_size = jnp.shape(jax.tree.flatten(self.params)[0][0])[0]
            rng_keys = random.split(rng_key, batch_size)
            return jax.vmap(
                partial(self._call_with_params, args=args, kwargs=kwargs),
                in_axes=0,
                out_axes=1,
            )(rng_keys, self.params)
        else:
            raise NotImplementedError


def _common_batch_shape(samples, batch_ndims):
    """The shared leading batch shape of a sample dict (None if empty);
    raises if sites disagree."""
    shape, witness = None, None
    for name, value in samples.items():
        here = jnp.shape(value)[:batch_ndims]
        if shape is not None and here != shape:
            raise ValueError(
                f"Batch shapes at site {name} and {witness} should be the "
                f"same, but got {here} and {shape}"
            )
        shape, witness = here, name
    return shape


def log_likelihood(
    model, posterior_samples, *args, parallel=False, batch_ndims=1, **kwargs
):
    """Per-observation log-probs of observed sites over posterior samples
    (reference: infer/util.py:1094-1147)."""

    def single_loglik(samples):
        substituted = (
            handlers.substitute(model, samples) if isinstance(samples, dict) else model
        )
        trace = handlers.trace(substituted).get_trace(*args, **kwargs)
        return {
            name: site["fn"].log_prob(site["value"])
            for name, site in trace.items()
            if site["type"] == "sample" and site["is_observed"]
        }

    batch_shape = _common_batch_shape(posterior_samples, batch_ndims)
    if batch_shape is None:  # no posterior draws: a single prior evaluation
        batch_shape = (1,) * batch_ndims
        posterior_samples = np.zeros(batch_shape)
    chunk_size = int(np.prod(batch_shape)) if parallel else 1
    return soft_vmap(single_loglik, posterior_samples, len(batch_shape), chunk_size)


def _guess_max_plate_nesting_from_model(model, model_args, model_kwargs, rng_key):
    """Trace once (seeded) to find the deepest plate dim."""
    with handlers.block():
        tr = handlers.trace(handlers.seed(model, rng_key)).get_trace(
            *model_args, **model_kwargs
        )
    return _guess_max_plate_nesting(tr)
