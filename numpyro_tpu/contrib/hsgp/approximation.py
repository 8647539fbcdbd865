"""HSGP low-rank GP approximations — model fragments usable inside any
numpyro_tpu model (reference: contrib/hsgp/approximation.py:64-162).  The
basis matmul phi @ (spd * beta) is a single tensor-core contraction."""

from __future__ import annotations

import jax.numpy as jnp

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.contrib.hsgp.laplacian import (
    eigenfunctions,
    eigenfunctions_periodic,
)
from numpyro_tpu.contrib.hsgp.spectral_densities import (
    diag_spectral_density_matern,
    diag_spectral_density_periodic,
    diag_spectral_density_squared_exponential,
)

__all__ = [
    "hsgp_matern",
    "hsgp_periodic_non_centered",
    "hsgp_squared_exponential",
    "linear_approximation",
]


def _non_centered_approximation(phi, spd, m):
    with numpyro_tpu.plate("basis", m):
        beta = numpyro_tpu.sample("beta", dist.Normal(0.0, 1.0))
    return phi @ (spd * beta)


def _centered_approximation(phi, spd, m):
    with numpyro_tpu.plate("basis", m):
        beta = numpyro_tpu.sample("beta", dist.Normal(0.0, spd))
    return phi @ beta


def linear_approximation(phi, spd, m, non_centered=True):
    """phi @ diag(spd) @ beta (Riutort-Mayol et al. Eq. 8)."""
    if non_centered:
        return _non_centered_approximation(phi, spd, m)
    return _centered_approximation(phi, spd, m)


def hsgp_squared_exponential(x, alpha, length, ell, m, non_centered=True):
    """HSGP fragment with the squared exponential kernel."""
    dim = jnp.shape(x)[-1] if jnp.ndim(x) > 1 else 1
    phi = eigenfunctions(x=x, ell=ell, m=m)
    spd = jnp.sqrt(
        diag_spectral_density_squared_exponential(
            alpha=alpha, length=length, ell=ell, m=m, dim=dim
        )
    )
    return linear_approximation(phi, spd, phi.shape[-1], non_centered)


def hsgp_matern(x, nu, alpha, length, ell, m, non_centered=True):
    """HSGP fragment with the Matérn kernel."""
    dim = jnp.shape(x)[-1] if jnp.ndim(x) > 1 else 1
    phi = eigenfunctions(x=x, ell=ell, m=m)
    spd = jnp.sqrt(
        diag_spectral_density_matern(
            nu=nu, alpha=alpha, length=length, ell=ell, m=m, dim=dim
        )
    )
    return linear_approximation(phi, spd, phi.shape[-1], non_centered)


def hsgp_periodic_non_centered(x, alpha, length, w0, m):
    """Periodic-kernel low-rank fragment (non-centered)."""
    q2 = diag_spectral_density_periodic(alpha=alpha, length=length, m=m)
    cosines, sines = eigenfunctions_periodic(x=x, w0=w0, m=m)
    with numpyro_tpu.plate("cos_basis", m):
        beta_cos = numpyro_tpu.sample("beta_cos", dist.Normal(0, 1))
    with numpyro_tpu.plate("sin_basis", m - 1):
        beta_sin = numpyro_tpu.sample("beta_sin", dist.Normal(0, 1))
    beta_sin = jnp.concatenate((jnp.array([0.0]), beta_sin))
    return cosines @ (q2 * beta_cos) + sines @ (q2 * beta_sin)
