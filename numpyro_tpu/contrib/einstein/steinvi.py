"""SteinVI / SVGD / ASVGD — particle variational inference.

Fresh accelerator-first implementation of the reference engine
(numpyro/contrib/einstein/steinvi.py:37-760).  The ensemble of guide-param
particles lives as one ``(num_particles, flat_dim)`` array; the attractive
(kernelized grad) and repulsive (kernel grad) Stein forces are (P, P)
batched contractions fused into one update program — no per-particle Python
at runtime.

- ``SteinVI``: Stein mixture inference — particles parameterize a mixture
  of guides (Rønning et al. 2023).
- ``SVGD``: Stein variational gradient descent over an AutoDelta guide
  (Liu & Wang 2016).
- ``ASVGD``: annealed SVGD with a cyclical tempering schedule (D'Angelo &
  Fortuin 2021).
"""

from __future__ import annotations

from collections import namedtuple
from itertools import chain

import jax
import jax.numpy as jnp
from jax import grad, random, vmap

from numpyro_tpu import handlers
from numpyro_tpu.contrib.einstein.stein_kernels import RBFKernel
from numpyro_tpu.contrib.einstein.stein_loss import SteinLoss
from numpyro_tpu.contrib.einstein.stein_util import (
    batch_ravel_pytree,
    get_parameter_transform,
)
from numpyro_tpu.infer.autoguide import AutoDelta

SteinVIState = namedtuple("SteinVIState", ["optim_state", "rng_key"])
SteinVIRunResult = namedtuple("SteinRunResult", ["params", "state", "losses"])


class SteinVI:
    """Stein mixture inference engine.

    :param model: numpyro_tpu model.
    :param guide: an autoguide whose params become the transported particles.
    :param optim: a numpyro_tpu optimizer.
    :param kernel_fn: a :class:`SteinKernel` (default RBF/median heuristic).
    :param num_stein_particles: ensemble size.
    :param num_elbo_particles: MC draws per particle ELBO gradient.
    :param loss_temperature: scale on the attractive force.
    :param repulsion_temperature: scale on the repulsive force.
    """

    def __init__(
        self,
        model,
        guide,
        optim,
        kernel_fn=None,
        num_stein_particles=10,
        num_elbo_particles=10,
        loss_temperature=1.0,
        repulsion_temperature=1.0,
        **static_kwargs,
    ):
        self.model = model
        self.guide = guide
        self.optim = optim
        self.kernel_fn = kernel_fn if kernel_fn is not None else RBFKernel()
        self.num_stein_particles = num_stein_particles
        self.num_elbo_particles = num_elbo_particles
        self.loss_temperature = loss_temperature
        self.repulsion_temperature = repulsion_temperature
        self.static_kwargs = static_kwargs
        self.stein_loss = SteinLoss(
            elbo_num_particles=num_elbo_particles,
            stein_num_particles=num_stein_particles,
        )
        self.particle_transforms = {}
        self._particle_param_names = set()

    # -- setup ---------------------------------------------------------

    def _init_params(self, rng_key, *args, **kwargs):
        model_seed, guide_seed, particle_seed = random.split(rng_key, 3)
        guide_init = handlers.seed(self.guide, guide_seed)
        guide_trace = handlers.trace(guide_init).get_trace(
            *args, **kwargs, **self.static_kwargs
        )
        model_init = handlers.seed(self.model, model_seed)
        model_trace = handlers.trace(
            handlers.substitute(
                model_init,
                data={
                    k: site["value"]
                    for k, site in guide_trace.items()
                    if site["type"] == "sample"
                },
            )
        ).get_trace(*args, **kwargs, **self.static_kwargs)

        params = {}
        transforms = {}
        sites = [
            s
            for s in chain(model_trace.values(), guide_trace.values())
            if s["type"] == "param"
        ]
        pkeys = random.split(particle_seed, max(len(sites), 1))
        for site, pkey in zip(sites, pkeys):
            name, value = site["name"], site["value"]
            if name in params:
                continue
            transform = get_parameter_transform(site)
            transforms[name] = transform
            unconstrained = transform.inv(value)
            # every guide param is replicated to the particle axis with
            # jittered inits so the ensemble starts dispersed; params may be
            # pytrees (e.g. flax module dicts), so jitter leaf-wise
            leaves, treedef = jax.tree.flatten(unconstrained)
            leaf_keys = random.split(pkey, max(len(leaves), 1))
            jittered = [
                leaf[None]
                + 0.1
                * random.normal(
                    k, (self.num_stein_particles,) + jnp.shape(leaf)
                )
                for leaf, k in zip(leaves, leaf_keys)
            ]
            params[name] = jax.tree.unflatten(treedef, jittered)
            self._particle_param_names.add(name)
        self.particle_transforms = transforms
        return params

    @staticmethod
    def _calc_particle_info(particle_params):
        info, start = {}, 0
        for name in sorted(particle_params):
            size = sum(
                int(leaf.size // leaf.shape[0])
                for leaf in jax.tree.leaves(particle_params[name])
            )
            info[name] = (start, start + size)
            start += size
        return info

    # -- the Stein update ------------------------------------------------

    def _loss_and_grads(self, rng_key, unconstr_params, *args, **kwargs):
        particles = {
            k: v
            for k, v in unconstr_params.items()
            if k in self._particle_param_names
        }
        flat, unravel_one, unravel_batch = batch_ravel_pytree(
            particles, nbatch_dims=1
        )
        particle_info = self._calc_particle_info(particles)

        def constrain(p):
            return {k: self.particle_transforms[k](v) for k, v in p.items()}

        def particle_ld(p_flat, idx, key):
            # attractive objective for one particle: its mixture ELBO
            return self.stein_loss.particle_loss(
                key,
                self.model,
                self.guide,
                constrain(unravel_one(p_flat)),
                lambda pj: constrain(unravel_one(pj)),
                flat,
                idx,
                args,
                {**kwargs, **self.static_kwargs},
                {},
            )

        idxs = jnp.arange(self.num_stein_particles)
        score_keys = random.split(rng_key, self.num_stein_particles)
        grads = vmap(lambda p, i, k: grad(particle_ld)(p, i, k))(
            flat, idxs, score_keys
        )
        loss = -jnp.mean(vmap(particle_ld)(flat, idxs, score_keys))

        kernel = self.kernel_fn.compute(
            rng_key,
            flat,
            particle_info,
            lambda p: particle_ld(p, 0, score_keys[0]),
        )
        mode = self.kernel_fn.mode

        def phi(xi):
            if mode == "matrix":
                kvals = vmap(lambda xj: kernel(xj, xi))(flat)  # (P, D, D)
                attract = jnp.sum(jnp.einsum("pij,pj->pi", kvals, grads), axis=0)
            else:
                kvals = vmap(lambda xj: kernel(xj, xi))(flat)  # (P,) or (P, D)
                if mode == "norm":
                    kvals = kvals[:, None]
                attract = jnp.sum(kvals * grads, axis=0)
            repulse = jnp.sum(
                vmap(lambda xj: grad(lambda a: jnp.sum(kernel(a, xi)))(xj))(flat),
                axis=0,
            )
            return (
                self.loss_temperature * attract
                + self.repulsion_temperature * repulse
            ) / self.num_stein_particles

        forces = vmap(phi)(flat)
        particle_grads = unravel_batch(-forces)  # optimizers minimize
        return loss, {**particle_grads}

    # -- public API ----------------------------------------------------

    def init(self, rng_key, *args, **kwargs):
        rng_key, init_key = random.split(rng_key)
        params = self._init_params(init_key, *args, **kwargs)
        return SteinVIState(self.optim.init(params), rng_key)

    def get_params(self, state):
        unconstr = self.optim.get_params(state.optim_state)
        return {
            k: self.particle_transforms[k](v)
            if k in self.particle_transforms
            else v
            for k, v in unconstr.items()
        }

    def update(self, state, *args, **kwargs):
        rng_key, step_key = random.split(state.rng_key)
        params = self.optim.get_params(state.optim_state)
        loss, grads = self._loss_and_grads(step_key, params, *args, **kwargs)
        optim_state = self.optim.update(grads, state.optim_state)
        return SteinVIState(optim_state, rng_key), loss

    def run(self, rng_key, num_steps, *args, progress_bar=False, **kwargs):
        state = self.init(rng_key, *args, **kwargs)

        def body(state, _):
            state, loss = self.update(state, *args, **kwargs)
            return state, loss

        state, losses = jax.lax.scan(body, state, None, length=num_steps)
        return SteinVIRunResult(self.get_params(state), state, losses)


class SVGD(SteinVI):
    """Stein variational gradient descent: AutoDelta particles transported
    by the Stein force of the model's log-joint (Liu & Wang 2016)."""

    def __init__(
        self,
        model,
        optim,
        kernel_fn=None,
        num_stein_particles=10,
        guide_kwargs={},
        **static_kwargs,
    ):
        super().__init__(
            model,
            AutoDelta(model, **guide_kwargs),
            optim,
            kernel_fn=kernel_fn,
            num_stein_particles=num_stein_particles,
            num_elbo_particles=1,
            **static_kwargs,
        )

    def _loss_and_grads(self, rng_key, unconstr_params, *args, **kwargs):
        # SVGD: attractive grad is the model log-joint at each Delta particle
        from numpyro_tpu.infer.util import log_density

        particles = {
            k: v
            for k, v in unconstr_params.items()
            if k in self._particle_param_names
        }
        flat, unravel_one, unravel_batch = batch_ravel_pytree(
            particles, nbatch_dims=1
        )
        particle_info = self._calc_particle_info(particles)

        def log_joint(p_flat, key):
            constrained = {
                k: self.particle_transforms[k](v)
                for k, v in unravel_one(p_flat).items()
            }
            guided = handlers.substitute(
                handlers.seed(self.guide, key), data=constrained
            )
            # run the guide to map auto_loc params -> latent values
            with handlers.block(), handlers.trace() as gtr:
                guided(*args, **kwargs, **self.static_kwargs)
            latents = {
                k: site["value"]
                for k, site in gtr.items()
                if site["type"] == "sample"
            }
            ld, _ = log_density(
                handlers.seed(self.model, key),
                args,
                {**kwargs, **self.static_kwargs},
                latents,
            )
            return ld

        keys = random.split(rng_key, self.num_stein_particles)
        grads = vmap(lambda p, k: grad(log_joint)(p, k))(flat, keys)
        loss = -jnp.mean(vmap(log_joint)(flat, keys))

        kernel = self.kernel_fn.compute(
            rng_key, flat, particle_info, lambda p: log_joint(p, keys[0])
        )
        mode = self.kernel_fn.mode

        def phi(xi):
            if mode == "matrix":
                kvals = vmap(lambda xj: kernel(xj, xi))(flat)
                attract = jnp.sum(jnp.einsum("pij,pj->pi", kvals, grads), axis=0)
            else:
                kvals = vmap(lambda xj: kernel(xj, xi))(flat)
                if mode == "norm":
                    kvals = kvals[:, None]
                attract = jnp.sum(kvals * grads, axis=0)
            repulse = jnp.sum(
                vmap(lambda xj: grad(lambda a: jnp.sum(kernel(a, xi)))(xj))(flat),
                axis=0,
            )
            return (
                self.loss_temperature * attract
                + self.repulsion_temperature * repulse
            ) / self.num_stein_particles

        forces = vmap(phi)(flat)
        return loss, unravel_batch(-forces)


class ASVGD(SVGD):
    """Annealed SVGD: the attractive force is tempered by a cyclical
    schedule so particles explore before they exploit."""

    def __init__(
        self,
        model,
        optim,
        kernel_fn=None,
        num_stein_particles=10,
        num_cycles=10,
        transition_speed=10,
        guide_kwargs={},
        **static_kwargs,
    ):
        assert num_cycles > 0 and transition_speed > 0
        self.num_cycles = num_cycles
        self.transition_speed = transition_speed
        self._num_steps = 100
        super().__init__(
            model,
            optim,
            kernel_fn,
            num_stein_particles,
            guide_kwargs,
            **static_kwargs,
        )

    @staticmethod
    def _cyclical_annealing(num_steps, num_cycles, trans_speed, t):
        norm = float(num_steps + 1) / float(num_cycles)
        cs_t = jnp.power(jnp.mod(t, norm) * num_cycles / num_steps, trans_speed)
        last_cycle = t // norm >= (num_cycles - 1)
        return jnp.where(last_cycle, 1.0, jnp.clip(cs_t, 0.0, 1.0))

    def run(self, rng_key, num_steps, *args, progress_bar=False, **kwargs):
        self._num_steps = num_steps
        state = self.init(rng_key, *args, **kwargs)

        def body(carry, t):
            state = carry
            anneal = self._cyclical_annealing(
                num_steps, self.num_cycles, self.transition_speed, t
            )
            rng_key, step_key = random.split(state.rng_key)
            params = self.optim.get_params(state.optim_state)
            loss, grads = self._annealed_loss_and_grads(
                anneal, step_key, params, *args, **kwargs
            )
            optim_state = self.optim.update(grads, state.optim_state)
            return SteinVIState(optim_state, rng_key), loss

        state, losses = jax.lax.scan(
            body, state, jnp.arange(num_steps, dtype=jnp.float32)
        )
        return SteinVIRunResult(self.get_params(state), state, losses)

    def _annealed_loss_and_grads(self, anneal, rng_key, params, *args, **kwargs):
        saved = self.loss_temperature
        self.loss_temperature = anneal  # traced scalar; used multiplicatively
        try:
            return super()._loss_and_grads(rng_key, params, *args, **kwargs)
        finally:
            self.loss_temperature = saved
