"""Checkpoint/resume tests (in-memory resume parity: reference
infer/mcmc.py:549-578; file round-trip is new accelerator-native surface)."""

import os
import tempfile

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.checkpoint import restore_checkpoint, save_checkpoint
from numpyro_tpu.infer import MCMC, NUTS


def test_checkpoint_roundtrip_and_resume():
    def model(y):
        mu = numpyro_tpu.sample("mu", dist.Normal(0.0, 5.0))
        numpyro_tpu.sample("y", dist.Normal(mu, 1.0), obs=y)

    y = jnp.array(2.0)
    m = MCMC(NUTS(model), num_warmup=80, num_samples=60, progress_bar=False)
    m.warmup(random.PRNGKey(0), y)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "warm")
        save_checkpoint(p, m.post_warmup_state)
        restored = restore_checkpoint(p, m.post_warmup_state)
        for a, b in zip(
            jax.tree.leaves(m.post_warmup_state), jax.tree.leaves(restored)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        m.post_warmup_state = restored
        m.run(restored.rng_key, y)
        post = float(m.get_samples()["mu"].mean())
        # posterior of mu: N(2*25/26, 25/26)
        assert abs(post - 2 * 25 / 26) < 0.35
