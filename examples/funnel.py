"""Neal's funnel: non-centered reparameterization via LocScaleReparam
(reference: examples/funnel.py).

The centered funnel defeats NUTS (step size cannot satisfy both the neck
and the mouth); ``LocScaleReparam(0)`` rewrites the geometry to a standard
Gaussian — a pure retracing change, zero runtime cost.
"""

import argparse

import numpy as np

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu import handlers
from numpyro_tpu.infer import MCMC, NUTS
from numpyro_tpu.infer.reparam import LocScaleReparam


def model(dim=10):
    y = numpyro_tpu.sample("y", dist.Normal(0.0, 3.0))
    with numpyro_tpu.plate("D", dim):
        numpyro_tpu.sample("x", dist.Normal(0.0, jnp.exp(y / 2)))


def reparam_model(dim=10):
    y = numpyro_tpu.sample("y", dist.Normal(0.0, 3.0))
    with numpyro_tpu.plate("D", dim):
        with handlers.reparam(config={"x": LocScaleReparam(0)}):
            numpyro_tpu.sample("x", dist.Normal(0.0, jnp.exp(y / 2)))


def run(m, name, args):
    mcmc = MCMC(
        NUTS(m),
        num_warmup=args.num_warmup,
        num_samples=args.num_samples,
        progress_bar=False,
    )
    mcmc.run(random.PRNGKey(0), args.dim)
    y = np.asarray(mcmc.get_samples()["y"])
    print(f"{name}: E[y]={y.mean():.2f} sd={y.std():.2f}  (truth: 0.00, 3.00)")
    return y


def main(args):
    run(model, "centered   ", args)
    y = run(reparam_model, "non-centered", args)
    assert abs(y.std() - 3.0) < 0.8, "non-centered run failed to reach the neck"


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=10)
    p.add_argument("--num-warmup", type=int, default=500)
    p.add_argument("--num-samples", type=int, default=1000)
    main(p.parse_args())
