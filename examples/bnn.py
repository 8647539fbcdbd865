"""Bayesian neural network regression via NUTS over all weights
(reference: examples/bnn.py).

Performance note: the whole network forward is two matmuls batched over
(chains x data) — a pure matmul workload; vectorized chains make the weight
tensors (C, H, D) so even a small net fills the matrix units.
"""

import argparse

import numpy as np

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.infer import MCMC, NUTS, Predictive


def make_data(N, key=0):
    rng = np.random.RandomState(key)
    x = np.linspace(-1, 1, N)[:, None]
    y = 0.5 * np.sin(4 * x[:, 0]) + 0.1 * rng.randn(N)
    return jnp.asarray(x), jnp.asarray(y)


def model(x, y=None, hidden=8):
    D = x.shape[1]
    w1 = numpyro_tpu.sample(
        "w1", dist.Normal(jnp.zeros((D, hidden)), 1.0).to_event(2)
    )
    b1 = numpyro_tpu.sample("b1", dist.Normal(jnp.zeros(hidden), 1.0).to_event(1))
    w2 = numpyro_tpu.sample("w2", dist.Normal(jnp.zeros(hidden), 1.0).to_event(1))
    b2 = numpyro_tpu.sample("b2", dist.Normal(0.0, 1.0))
    sigma = numpyro_tpu.sample("sigma", dist.HalfNormal(0.5))
    h = jnp.tanh(x @ w1 + b1)
    mean = h @ w2 + b2
    with numpyro_tpu.plate("N", x.shape[0]):
        numpyro_tpu.sample("y", dist.Normal(mean, sigma), obs=y)


def main(args):
    x, y = make_data(args.num_data)
    mcmc = MCMC(
        NUTS(model),
        num_warmup=args.num_warmup,
        num_samples=args.num_samples,
        num_chains=args.num_chains,
        progress_bar=False,
    )
    mcmc.run(random.PRNGKey(0), x, y)
    pred = Predictive(model, mcmc.get_samples())(random.PRNGKey(1), x)
    rmse = float(jnp.sqrt(jnp.mean((pred["y"].mean(0) - y) ** 2)))
    print(f"posterior-predictive RMSE: {rmse:.3f}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-data", type=int, default=100)
    p.add_argument("--num-warmup", type=int, default=500)
    p.add_argument("--num-samples", type=int, default=500)
    p.add_argument("--num-chains", type=int, default=1)
    main(p.parse_args())
