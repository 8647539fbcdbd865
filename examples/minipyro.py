"""The pyro-api generic interface backed by numpyro_tpu.compat — write
Pyro-style code, run it on the numpyro_tpu engine (reference: examples/minipyro.py)."""

import argparse

import numpy as np

import jax.numpy as jnp
from jax import random

from numpyro_tpu.compat import distributions as dist
from numpyro_tpu.compat import infer, optim, pyro


def main(args):
    data = 2.0 + 0.5 * np.random.RandomState(0).randn(100)
    data = jnp.asarray(data)

    def model(data):
        loc = pyro.sample("loc", dist.Normal(0.0, 1.0))
        with pyro.plate("N", data.shape[0]):
            pyro.sample("obs", dist.Normal(loc, 1.0), obs=data)

    def guide(data):
        loc_q = pyro.param("loc_q", jnp.asarray(0.0))
        pyro.sample("loc", dist.Delta(loc_q))

    svi = infer.SVI(model, guide, optim.Adam({"lr": 0.05}), infer.Trace_ELBO())
    for i in range(args.num_iters):
        loss = svi.step(data, rng_key=random.PRNGKey(0) if i == 0 else None)
    loc_hat = float(svi.get_params()["loc_q"])
    print(f"posterior mode of loc: {loc_hat:.2f} (expect ~1.98)")
    assert abs(loc_hat - float(data.mean())) < 0.1


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-iters", type=int, default=400)
    main(p.parse_args())
