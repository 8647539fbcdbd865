"""Semi-supervised Hidden Markov Model with a PARALLEL-SCAN forward pass.

Role parity with the reference's `examples/hmm.py` (semi-supervised
word-category HMM with a hand-marginalized forward algorithm), rebuilt
Accelerator-first: the forward recursion over the unsupervised sequence is an
``lax.associative_scan`` over log-transition matrices (logmatmulexp
semiring), so the time dimension reduces in O(log T) depth of tensor-core
contractions instead of a T-step sequential scan — the same machinery
`contrib.control_flow.scan` uses for enumerated chains.

Run (CPU):
    JAX_PLATFORMS=cpu python examples/hmm_semisupervised.py --num-samples 300
"""

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, random
from jax.scipy.special import logsumexp

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.infer import MCMC, NUTS


def simulate(key, K, V, n_sup, n_unsup):
    kt, ke, ks = random.split(key, 3)
    trans = dist.Dirichlet(jnp.ones(K)).sample(kt, (K,))
    emit = dist.Dirichlet(jnp.full((V,), 0.1)).sample(ke, (K,))

    def step(z, k):
        kz, kw = random.split(k)
        z = dist.Categorical(trans[z]).sample(kz)
        w = dist.Categorical(emit[z]).sample(kw)
        return z, (z, w)

    keys = random.split(ks, n_sup + n_unsup)
    _, (zs, ws) = lax.scan(step, jnp.asarray(0), keys)
    return (
        (zs[:n_sup], ws[:n_sup]),
        ws[n_sup:],
        (trans, emit),
    )


def _log_forward(log_trans, log_like, log_init):
    """log p(w_1..T) by associative scan over the log-semiring.

    ``M_t[i, j] = log_trans[i, j] + log_like[t, j]`` propagates mass from
    state i at t-1 to state j at t; the product of all M_t (logmatmulexp)
    reduces in O(log T) depth.
    """
    M = log_trans[None, :, :] + log_like[:, None, :]  # (T, K, K)

    def combine(a, b):  # logmatmulexp: later ∘ earlier
        return logsumexp(a[..., :, :, None] + b[..., None, :, :], axis=-2)

    total = lax.associative_scan(combine, M, axis=0)[-1]  # (K, K)
    return logsumexp(log_init[:, None] + total, axis=(0, 1))


def model(sup_z, sup_w, unsup_w, K, V):
    with numpyro_tpu.plate("K", K):
        trans = numpyro_tpu.sample("transition", dist.Dirichlet(jnp.ones(K)))
        emit = numpyro_tpu.sample(
            "emission", dist.Dirichlet(jnp.full((V,), 0.1))
        )
    # supervised pairs: plain categorical likelihoods
    numpyro_tpu.sample(
        "sup_z", dist.Categorical(trans[sup_z[:-1]]), obs=sup_z[1:]
    )
    numpyro_tpu.sample("sup_w", dist.Categorical(emit[sup_z]), obs=sup_w)
    # unsupervised words: marginalize the chain with the parallel forward
    log_trans = jnp.log(trans)
    log_like = jnp.log(emit)[:, unsup_w].T  # (T, K)
    log_init = jnp.log(jnp.full((K,), 1.0 / K)) + log_like[0]
    numpyro_tpu.factor(
        "unsup_marginal", _log_forward(log_trans, log_like[1:], log_init)
    )


def main(args):
    (sup_z, sup_w), unsup_w, (true_trans, true_emit) = simulate(
        random.PRNGKey(0),
        args.num_categories,
        args.num_words,
        args.num_supervised,
        args.num_unsupervised,
    )
    mcmc = MCMC(
        NUTS(model),
        num_warmup=args.num_warmup,
        num_samples=args.num_samples,
        num_chains=args.num_chains,
        progress_bar=False,
    )
    t0 = time.time()
    mcmc.run(
        random.PRNGKey(1),
        sup_z,
        sup_w,
        unsup_w,
        args.num_categories,
        args.num_words,
    )
    print(f"MCMC elapsed time: {time.time() - t0:.1f}s")
    post_trans = np.asarray(mcmc.get_samples()["transition"]).mean(0)
    err = np.abs(post_trans - np.asarray(true_trans)).max()
    print(f"max |posterior mean - true transition| = {err:.3f}")
    mcmc.print_summary()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="semi-supervised HMM")
    p.add_argument("--num-categories", type=int, default=3)
    p.add_argument("--num-words", type=int, default=10)
    p.add_argument("--num-supervised", type=int, default=100)
    p.add_argument("--num-unsupervised", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=500)
    p.add_argument("--num-warmup", type=int, default=500)
    p.add_argument("--num-chains", type=int, default=1)
    main(p.parse_args())
