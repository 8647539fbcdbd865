"""MCMC diagnostics: split-R̂, FFT-based effective sample size, HPDI,
summary tables.

Accelerator-first twist vs the reference (numpyro/diagnostics.py): every statistic
has a pure-jnp implementation that runs device-side (so cross-host R̂/ESS
can be computed with collectives on sharded sample buffers, without a
device->host gather); the printing layer works on whatever is handed to it.
"""

from __future__ import annotations

from itertools import product

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "autocorrelation",
    "autocovariance",
    "effective_sample_size",
    "gelman_rubin",
    "hpdi",
    "print_summary",
    "split_gelman_rubin",
    "summary",
]


def _device_get_if_needed(x):
    return np.asarray(jax.device_get(x))


def gelman_rubin(x):
    """R̂ over axis 0=chain, axis 1=draw (device-side jnp)."""
    assert jnp.ndim(x) >= 2
    assert x.shape[0] >= 2
    x = jnp.asarray(x, dtype=jnp.result_type(float))

    # find and within variance
    var_within = jnp.var(x, ddof=1, axis=1)
    var_estimator = jnp.mean(var_within, axis=0)
    if x.shape[0] > 1:
        var_between = x.shape[1] * jnp.var(jnp.mean(x, axis=1), ddof=1, axis=0)
        var_estimator = (
            (x.shape[1] - 1) / x.shape[1]
        ) * var_estimator + var_between / x.shape[1]

    return jnp.sqrt(var_estimator / jnp.mean(var_within, axis=0))


def split_gelman_rubin(x):
    """Split-R̂: halve each chain then compute R̂ over 2C half-chains."""
    assert jnp.ndim(x) >= 2
    assert x.shape[1] >= 4
    N_half = x.shape[1] // 2
    x_split = jnp.concatenate(
        [x[:, :N_half, ...], x[:, -N_half:, ...]], axis=0
    )
    return gelman_rubin(x_split)


def _fft_next_fast_len(target):
    # find the next composite of 2, 3, 5 (FFT-fast length)
    if target <= 2:
        return target
    while True:
        m = target
        while m % 2 == 0:
            m //= 2
        while m % 3 == 0:
            m //= 3
        while m % 5 == 0:
            m //= 5
        if m == 1:
            return target
        target += 1


def autocorrelation(x, axis=0, bias=True):
    """Autocorrelation along ``axis`` via FFT (O(N log N), device-side)."""
    N = x.shape[axis]
    dtype = jnp.result_type(float)
    x = jnp.asarray(x, dtype=dtype)

    M = _fft_next_fast_len(N)
    M2 = 2 * M

    # transpose axis with -1 for the fft
    x = jnp.swapaxes(x, axis, -1)

    # centering x
    centered_signal = x - x.mean(-1, keepdims=True)

    # Fourier transform
    freqvec = jnp.fft.rfft(centered_signal, n=M2, axis=-1)
    # take square of magnitude of freqvec (or freqvec x freqvec*)
    freq_powers = jnp.real(freqvec * jnp.conjugate(freqvec))
    # inverse Fourier transform
    autocorr = jnp.fft.irfft(freq_powers, n=M2, axis=-1)
    # truncate and normalize the result
    autocorr = autocorr[..., :N]
    if not bias:
        autocorr = autocorr / jnp.arange(N, 0.0, -1)
    with np.errstate(invalid="ignore", divide="ignore"):
        autocorr = autocorr / autocorr[..., :1]
    return jnp.swapaxes(autocorr, axis, -1)


def autocovariance(x, axis=0, bias=True):
    N = x.shape[axis]
    x = jnp.asarray(x, dtype=jnp.result_type(float))
    var = jnp.var(jnp.swapaxes(x, axis, -1), axis=-1, keepdims=True)
    autocorr = jnp.swapaxes(autocorrelation(x, axis=axis, bias=bias), axis, -1)
    return jnp.swapaxes(autocorr * var, axis, -1)


def effective_sample_size(x, bias=True):
    """ESS over axis 0=chain, axis 1=draw, with Geyer initial-monotone
    truncation (reference: numpyro/diagnostics.py:158-203)."""
    assert jnp.ndim(x) >= 2
    assert x.shape[1] >= 2

    # find autocovariance for each chain at lag k
    gamma_k_c = autocovariance(x, axis=1, bias=bias)  # C x N x sample_shape

    # find autocorrelation at lag k (from Stan reference)
    var_within, var_estimator = _var_estimates(x)
    rho_k = jnp.concatenate(
        [
            jnp.ones_like(var_estimator)[None, ...],
            1.0 - (var_within - gamma_k_c.mean(0)[1:]) / var_estimator,
        ],
        axis=0,
    )

    # Geyer initial positive sequence: sum autocorrelations in (even, odd)
    # pairs, keep only while positive
    n_pairs = rho_k.shape[0] // 2
    rho_even = rho_k[: 2 * n_pairs : 2, ...]
    rho_odd = rho_k[1 : 2 * n_pairs : 2, ...]
    Rho_k = rho_even + rho_odd

    # initial positive: zero out everything after the first non-positive pair
    positive = Rho_k > 0
    all_positive_so_far = jax.lax.associative_scan(
        jnp.logical_and, positive, axis=0
    )
    Rho_k = jnp.where(all_positive_so_far, Rho_k, 0.0)

    # initial monotone (decreasing) sequence
    Rho_k = jax.lax.associative_scan(jnp.minimum, Rho_k, axis=0)
    Rho_k = jnp.clip(Rho_k, 0.0)

    tau = -1.0 + 2.0 * jnp.sum(Rho_k, axis=0)
    # antithetic safeguard (Stan/ArviZ convention): in strongly negatively
    # correlated chains the truncated pair sum can push tau <= 0; floor it
    # at 1/log10(N), capping ESS at N*log10(N) instead of going negative
    total = x.shape[0] * x.shape[1]
    tau = jnp.maximum(tau, 1.0 / np.log10(max(total, 10)))
    n_eff = jnp.asarray(total, dtype=tau.dtype) / tau
    return n_eff


def _var_estimates(x):
    x = jnp.asarray(x, dtype=jnp.result_type(float))
    var_within = jnp.var(x, ddof=1, axis=1).mean(0)
    var_estimator = ((x.shape[1] - 1) / x.shape[1]) * var_within
    if x.shape[0] > 1:
        var_between = x.shape[1] * jnp.var(jnp.mean(x, axis=1), ddof=1, axis=0)
        var_estimator = var_estimator + var_between / x.shape[1]
    return var_within, var_estimator


def hpdi(x, prob=0.90, axis=0):
    """Highest-posterior-density interval."""
    x = np.swapaxes(_device_get_if_needed(x), axis, 0)
    sorted_x = np.sort(x, axis=0)
    mass = x.shape[0]
    index_length = int(prob * mass)
    intervals_left = sorted_x[: (mass - index_length)]
    intervals_right = sorted_x[index_length:]
    intervals_length = intervals_right - intervals_left
    index_start = intervals_length.argmin(axis=0)
    index_end = index_start + index_length
    hpd_left = np.take_along_axis(sorted_x, index_start[None, ...], axis=0)
    hpd_left = np.swapaxes(hpd_left, axis, 0)
    hpd_right = np.take_along_axis(sorted_x, index_end[None, ...], axis=0)
    hpd_right = np.swapaxes(hpd_right, axis, 0)
    return np.concatenate([hpd_left, hpd_right], axis=axis)


def summary(samples, prob=0.90, group_by_chain=True):
    """Per-site summary dict: mean/std/median/HPDI/n_eff/R̂."""
    if not group_by_chain:
        samples = {k: v[None, ...] for k, v in samples.items()}
    if not isinstance(samples, dict):
        samples = {
            f"Param:{i}": v for i, v in enumerate(jax.tree.flatten(samples)[0])
        }

    summary_dict = {}
    for name, value in samples.items():
        value = _device_get_if_needed(value)
        value_flat = np.reshape(value, (-1,) + value.shape[2:])
        mean = value_flat.mean(axis=0)
        std = value_flat.std(axis=0, ddof=1)
        median = np.median(value_flat, axis=0)
        low, high = np.split(hpdi(value_flat, prob=prob), 2, axis=0)
        n_eff = _device_get_if_needed(effective_sample_size(value))
        r_hat = _device_get_if_needed(split_gelman_rubin(value)) if value.shape[
            1
        ] >= 4 else np.full(value.shape[2:], np.nan)
        hpd_key = f"{prob * 100:.1f}%"
        summary_dict[name] = {
            "mean": mean,
            "std": std,
            "median": median,
            f"{50 - prob * 50:.1f}%": np.squeeze(low, axis=0),
            f"{50 + prob * 50:.1f}%": np.squeeze(high, axis=0),
            "n_eff": n_eff,
            "r_hat": r_hat,
        }
    return summary_dict


def print_summary(samples, prob=0.90, group_by_chain=True):
    """Stan-style summary table (host-side printing)."""
    if not group_by_chain:
        samples = {k: v[None, ...] for k, v in samples.items()}
    if not isinstance(samples, dict):
        samples = {
            f"Param:{i}": v for i, v in enumerate(jax.tree.flatten(samples)[0])
        }

    summary_dict = summary(samples, prob, group_by_chain=True)

    row_names = {
        k: k + "[" + ",".join(map(lambda x: str(x - 1), v.shape[2:])) + "]"
        for k, v in samples.items()
    }
    max_len = max(max(map(lambda x: len(x), row_names.values()), default=0), 10)
    name_format = "{:>" + str(max_len) + "}"
    header_format = name_format + " {:>9}" * 7
    columns = [""] + list(list(summary_dict.values())[0].keys())

    print()
    print(header_format.format(*columns))

    row_format = name_format + " {:>9.2f}" * 7
    for name, stats_dict in summary_dict.items():
        shape = stats_dict["mean"].shape
        if len(shape) == 0:
            print(row_format.format(name, *stats_dict.values()))
        else:
            for idx in product(*map(range, shape)):
                idx_str = "[{}]".format(",".join(map(str, idx)))
                print(
                    row_format.format(
                        name + idx_str, *[v[idx] for v in stats_dict.values()]
                    )
                )
    print()
