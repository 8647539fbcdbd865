"""Sparse regression with the (regularized) horseshoe prior
(reference: examples/horseshoe_regression.py).

Notes: the global-local scale hierarchy makes the posterior strongly
funnel-shaped, so this is the canonical dense-mass workload — we run NUTS
with ``dense_mass=True`` so warmup learns the full covariance of the
unconstrained latents in one (D+k)x(D+k) matmul-friendly matrix.
"""

import argparse

import numpy as np

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.infer import MCMC, NUTS


def make_data(N, D, active, key=0):
    rng = np.random.RandomState(key)
    X = rng.randn(N, D)
    beta = np.zeros(D)
    beta[:active] = rng.randn(active) * 2.0
    y = X @ beta + 0.5 * rng.randn(N)
    return jnp.asarray(X), jnp.asarray(y), beta


def model(X, y):
    D = X.shape[1]
    # regularized horseshoe (Piironen & Vehtari)
    tau = numpyro_tpu.sample("tau", dist.HalfCauchy(0.1))
    with numpyro_tpu.plate("D", D):
        lam = numpyro_tpu.sample("lambda", dist.HalfCauchy(1.0))
    sigma = numpyro_tpu.sample("sigma", dist.HalfNormal(1.0))
    scaled = tau * lam
    with numpyro_tpu.plate("D2", D):
        beta = numpyro_tpu.sample("beta", dist.Normal(0.0, scaled))
    with numpyro_tpu.plate("N", X.shape[0]):
        numpyro_tpu.sample("y", dist.Normal(X @ beta, sigma), obs=y)


def main(args):
    X, y, beta_true = make_data(args.num_data, args.num_dims, args.active_dims)
    kernel = NUTS(model, dense_mass=args.dense_mass)
    mcmc = MCMC(
        kernel,
        num_warmup=args.num_warmup,
        num_samples=args.num_samples,
        num_chains=args.num_chains,
        progress_bar=False,
    )
    mcmc.run(random.PRNGKey(0), X, y)
    beta_hat = np.asarray(mcmc.get_samples()["beta"]).mean(0)
    err = np.abs(beta_hat - beta_true).max()
    print(f"max |beta_hat - beta_true| = {err:.3f}")
    mcmc.print_summary(exclude_deterministic=False)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-data", type=int, default=100)
    p.add_argument("--num-dims", type=int, default=20)
    p.add_argument("--active-dims", type=int, default=3)
    p.add_argument("--num-warmup", type=int, default=500)
    p.add_argument("--num-samples", type=int, default=500)
    p.add_argument("--num-chains", type=int, default=1)
    p.add_argument("--dense-mass", action="store_true", default=True)
    main(p.parse_args())
