"""HMM with enumerated discrete states via markov dim recycling
(reference: examples/hmm_enum.py, funsor-free here)."""

import argparse

import numpy as np

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.contrib.control_flow import scan
from numpyro_tpu.contrib.enum import markov
from numpyro_tpu.infer import MCMC, NUTS


def make_data(T, key=0):
    rng = np.random.RandomState(key)
    p0 = np.array([0.6, 0.4])
    Tr = np.array([[0.85, 0.15], [0.25, 0.75]])
    locs = np.array([-1.0, 1.0])
    zs = [rng.choice(2, p=p0)]
    for _ in range(1, T):
        zs.append(rng.choice(2, p=Tr[zs[-1]]))
    return jnp.asarray(locs[zs] + 0.3 * rng.randn(T))


def model(ys):
    T = ys.shape[0]
    probs = numpyro_tpu.sample(
        "trans", dist.Dirichlet(jnp.ones((2, 2))).to_event(1)
    )
    locs = jnp.array([-1.0, 1.0])
    sigma = numpyro_tpu.sample("sigma", dist.HalfNormal(1.0))
    z = numpyro_tpu.sample(
        "z_0",
        dist.Categorical(jnp.array([0.5, 0.5])),
        infer={"enumerate": "parallel"},
    )
    numpyro_tpu.sample("y_0", dist.Normal(locs[z], sigma), obs=ys[0])
    for t in markov(range(1, T), history=1):
        z = numpyro_tpu.sample(
            f"z_{t}", dist.Categorical(probs[z]), infer={"enumerate": "parallel"}
        )
        numpyro_tpu.sample(f"y_{t}", dist.Normal(locs[z], sigma), obs=ys[t])


def scan_model(ys):
    """Same HMM through the effectful ``scan``: the python loop becomes one
    compiled lax.scan and the enumerated time axis collapses via an
    associative logmatmulexp chain (O(log T) depth on the tensor cores) — the form
    that scales to long sequences."""
    probs = numpyro_tpu.sample(
        "trans", dist.Dirichlet(jnp.ones((2, 2))).to_event(1)
    )
    locs = jnp.array([-1.0, 1.0])
    sigma = numpyro_tpu.sample("sigma", dist.HalfNormal(1.0))

    def transition(z_prev, y):
        z = numpyro_tpu.sample(
            "z", dist.Categorical(probs[z_prev]), infer={"enumerate": "parallel"}
        )
        numpyro_tpu.sample("y", dist.Normal(locs[z], sigma), obs=y)
        return z, None

    scan(transition, 0, ys)


def main(args):
    ys = make_data(args.num_steps)
    mcmc = MCMC(
        NUTS(scan_model if args.use_scan else model),
        num_warmup=args.num_warmup,
        num_samples=args.num_samples,
        progress_bar=False,
    )
    mcmc.run(random.PRNGKey(0), ys)
    mcmc.print_summary()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-warmup", type=int, default=300)
    p.add_argument("--num-samples", type=int, default=300)
    p.add_argument("--num-steps", type=int, default=50)
    p.add_argument("--use-scan", action="store_true",
                   help="use the scan/parallel-chain form of the model")
    main(p.parse_args())
