"""Exact-density and moment checks for the structured/matrix/time-series
families (the checks used to validate the accelerator-first rewrites, promoted into
the suite): MVN/MVT/low-rank against scipy, matrix normal against its vec-MVN
identity, Wishart-Cholesky against scipy.wishart with the exact Jacobian,
circulant/state-space/Euler-Maruyama against manual densities, CAR against
its dense precision, copulas, power laws, and zero-inflated normalization."""

import numpy as np
import pytest
import scipy.stats as st

import jax.numpy as jnp
from jax import random

import numpyro_tpu.distributions as dist


@pytest.fixture(scope="module")
def spd():
    rng = np.random.RandomState(0)
    A = rng.randn(4, 4)
    return A @ A.T + 4 * np.eye(4), rng.randn(4), rng.randn(6, 4)


def test_mvn_logpdf_entropy_cov(spd):
    cov, mu, xs = spd
    d = dist.MultivariateNormal(jnp.asarray(mu), covariance_matrix=jnp.asarray(cov))
    ref = st.multivariate_normal(mu, cov)
    assert np.allclose(d.log_prob(jnp.asarray(xs)), ref.logpdf(xs), atol=1e-4)
    assert abs(float(d.entropy()) - ref.entropy()) < 1e-4
    s = d.sample(random.PRNGKey(1), (50000,))
    assert np.allclose(np.cov(np.asarray(s).T), cov, atol=0.15)


def test_mvt_logpdf(spd):
    cov, mu, xs = spd
    L = np.linalg.cholesky(cov)
    d = dist.MultivariateStudentT(4.0, jnp.asarray(mu), jnp.asarray(L))
    ref = st.multivariate_t(mu, cov, df=4)
    assert np.allclose(d.log_prob(jnp.asarray(xs)), ref.logpdf(xs), atol=1e-4)


def test_lowrank_mvn_equals_dense(spd):
    cov, mu, xs = spd
    rng = np.random.RandomState(1)
    W = rng.randn(4, 2)
    dg = np.abs(rng.randn(4)) + 0.5
    low = dist.LowRankMultivariateNormal(
        jnp.asarray(mu), jnp.asarray(W), jnp.asarray(dg)
    )
    dense = dist.MultivariateNormal(
        jnp.asarray(mu), covariance_matrix=jnp.asarray(W @ W.T + np.diag(dg))
    )
    assert np.allclose(
        low.log_prob(jnp.asarray(xs)), dense.log_prob(jnp.asarray(xs)), atol=1e-4
    )
    assert np.allclose(low.precision_matrix, dense.precision_matrix, atol=1e-4)
    assert np.allclose(low.entropy(), dense.entropy(), atol=1e-4)


def test_matrix_normal_equals_vec_mvn():
    rng = np.random.RandomState(2)
    R = np.tril(rng.randn(3, 3))
    np.fill_diagonal(R, np.abs(R.diagonal()) + 1)
    C = np.tril(rng.randn(2, 2))
    np.fill_diagonal(C, np.abs(C.diagonal()) + 1)
    loc = rng.randn(3, 2)
    d = dist.MatrixNormal(jnp.asarray(loc), jnp.asarray(R), jnp.asarray(C))
    X = rng.randn(3, 2)
    ref = st.multivariate_normal(
        loc.T.ravel(), np.kron(C @ C.T, R @ R.T)
    ).logpdf(X.T.ravel())
    assert abs(float(d.log_prob(jnp.asarray(X))) - ref) < 1e-4


def test_wishart_cholesky_exact_density(spd):
    cov, _, _ = spd
    W = 6 * cov
    L = np.linalg.cholesky(W)
    d = dist.WishartCholesky(7.0, scale_matrix=jnp.asarray(cov))
    got = float(d.log_prob(jnp.asarray(L)))
    k = 4
    jacobian = k * np.log(2) + sum(
        (k - i) * np.log(L[i, i]) for i in range(k)
    )
    want = st.wishart(7, cov).logpdf(W) + jacobian
    assert abs(got - want) < 1e-3


def test_wishart_mean(spd):
    cov, _, _ = spd
    d = dist.Wishart(7.0, scale_matrix=jnp.asarray(cov))
    s = d.sample(random.PRNGKey(3), (20000,))
    assert np.allclose(np.asarray(s).mean(0), 7 * cov, rtol=0.1)


def test_circulant_normal_equals_dense():
    row = np.array([3.0, 1.0, 0.5, 1.0])
    d = dist.CirculantNormal(jnp.zeros(4), covariance_row=jnp.asarray(row))
    Cmat = np.array([[row[(i - j) % 4] for j in range(4)] for i in range(4)])
    xs = np.random.RandomState(3).randn(5, 4)
    ref = st.multivariate_normal(np.zeros(4), Cmat)
    assert np.allclose(d.log_prob(jnp.asarray(xs)), ref.logpdf(xs), atol=1e-4)
    assert abs(float(d.entropy()) - ref.entropy()) < 1e-4


def test_gaussian_state_space_density_and_cov():
    A = jnp.asarray([[0.9, 0.1], [0.0, 0.8]])
    d = dist.GaussianStateSpace(5, A, covariance_matrix=jnp.eye(2) * 0.5)
    s = d.sample(random.PRNGKey(4), (3000,))
    v = np.asarray(s[0])
    innov = np.concatenate([v[:1], v[1:] - v[:-1] @ np.asarray(A).T], 0)
    want = st.multivariate_normal(np.zeros(2), 0.5 * np.eye(2)).logpdf(innov).sum()
    assert abs(float(d.log_prob(jnp.asarray(v))) - want) < 1e-3
    z1 = np.asarray(s)[:, 1]
    pred = np.asarray(A) @ (0.5 * np.eye(2)) @ np.asarray(A).T + 0.5 * np.eye(2)
    assert np.allclose(np.cov(z1.T), pred, atol=0.07)


def test_euler_maruyama_density():
    def sde(x, t):
        return -0.5 * x, jnp.ones(())

    d = dist.EulerMaruyama(jnp.linspace(0.0, 1.0, 11), sde, dist.Normal(0.0, 1.0))
    s = d.sample(random.PRNGKey(5), (50,))
    assert s.shape == (50, 11)
    v = np.asarray(s[0])
    t = np.linspace(0, 1, 11)
    dt = np.diff(t)
    want = (
        st.norm(0, 1).logpdf(v[0])
        + st.norm(v[:-1] - 0.5 * v[:-1] * dt, np.sqrt(dt)).logpdf(v[1:]).sum()
    )
    assert abs(float(d.log_prob(jnp.asarray(v))) - want) < 1e-3
    # batched log_prob agrees with per-path evaluation
    batch = np.asarray(d.log_prob(s[:4]))
    per = [float(d.log_prob(s[i])) for i in range(4)]
    assert np.allclose(batch, per, atol=1e-4)


def test_car_equals_dense_precision():
    adj = np.array(
        [[0, 1, 0, 1], [1, 0, 1, 0], [0, 1, 0, 1], [1, 0, 1, 0]], dtype=float
    )
    d = dist.CAR(jnp.zeros(4), 0.5, 2.0, jnp.asarray(adj))
    P = np.asarray(d.precision_matrix)
    xs = np.random.RandomState(1).randn(5, 4)
    ref = st.multivariate_normal(np.zeros(4), np.linalg.inv(P)).logpdf(xs)
    assert np.allclose(d.log_prob(jnp.asarray(xs)), ref, atol=1e-3)


def test_zero_sum_normal_constraint_and_variance():
    d = dist.ZeroSumNormal(1.3, (5,))
    s = d.sample(random.PRNGKey(6), (20000,))
    assert np.abs(np.asarray(s).sum(-1)).max() < 1e-4
    assert np.allclose(
        np.asarray(s).var(0), 1.3**2 * (1 - 1 / 5), rtol=0.1
    )


def test_gaussian_copula_beta_marginals():
    corr = jnp.asarray([[1.0, 0.7], [0.7, 1.0]])
    d = dist.GaussianCopulaBeta(jnp.array([2.0, 3.0]), jnp.array([3.0, 2.0]),
                                correlation_matrix=corr)
    s = np.asarray(d.sample(random.PRNGKey(7), (40000,)))
    # marginals stay Beta despite the coupling
    for i, (a, b) in enumerate([(2.0, 3.0), (3.0, 2.0)]):
        D, pv = st.kstest(s[:, i], st.beta(a, b).cdf)
        assert pv > 1e-4, (i, pv)
    # correlation induced by the copula is positive and substantial
    assert np.corrcoef(s.T)[0, 1] > 0.4


def test_power_laws_vs_pareto():
    d = dist.LowerTruncatedPowerLaw(-2.5, 1.0)
    ref = st.pareto(1.5)
    xs = np.linspace(1.1, 5, 5)
    assert np.allclose(d.log_prob(jnp.asarray(xs)), ref.logpdf(xs), atol=1e-5)
    assert np.allclose(d.cdf(jnp.asarray(xs)), ref.cdf(xs), atol=1e-6)
    d2 = dist.DoublyTruncatedPowerLaw(-1.0, 1.0, 10.0)
    assert np.allclose(
        d2.log_prob(jnp.asarray(xs)),
        -np.log(xs) - np.log(np.log(10)),
        atol=1e-6,
    )
    q = jnp.linspace(0.01, 0.99, 11)
    for alpha in (-1.0, 0.7, -2.3):
        d3 = dist.DoublyTruncatedPowerLaw(alpha, 0.5, 4.0)
        assert np.allclose(d3.cdf(d3.icdf(q)), q, atol=1e-5)


def test_truncated_polya_gamma_finite():
    d = dist.TruncatedPolyaGamma()
    s = d.sample(random.PRNGKey(8), (500,))
    assert float(s.min()) > 0 and float(s.max()) <= d.truncation_point
    assert np.isfinite(np.asarray(d.log_prob(s))).all()


def test_zero_inflated_normalizations():
    d = dist.ZeroInflatedPoisson(0.3, 2.0)
    total = np.exp(np.asarray(d.log_prob(jnp.arange(60)))).sum()
    assert abs(total - 1) < 1e-6
    d2 = dist.ZeroInflatedNegativeBinomial2(2.0, 3.0, gate_logits=0.5)
    total2 = np.exp(np.asarray(d2.log_prob(jnp.arange(200)))).sum()
    assert abs(total2 - 1) < 1e-5
