"""Natively chain-batched HMC/NUTS engine.

This module is the accelerator-first replacement for the reference's per-chain
recursive/iterative tree code (numpyro/infer/hmc.py + hmc_util.py, which
vmaps a *scalar* NUTS over chains).  Here the chain axis is a first-class
dimension of every array: position/momentum live in packed ``(C, D)``
"panels", and a NUTS transition for all C chains is ONE ``lax.while_loop``
whose body performs exactly one batched gradient evaluation — there is no
nested per-chain tree recursion to vmap, and no per-level bookkeeping loops.

Design highlights (see SURVEY.md §7 "hard part (a)"):

- **Flat panels.** Positions are packed into ``(C, D)`` via a static
  :class:`FlatLayout`; the model's potential is evaluated through
  ``vmap(value_and_grad(pe ∘ unravel))`` so the hot path is a single fused
  XLA program with matmul-friendly batched matmuls.
- **One loop, per-chain state machines.** Each chain carries registers
  (depth, leaf index, direction, proposal, trajectory ends) and the loop
  body advances *every* chain by one leapfrog.  Chains whose trajectory
  terminated are masked.  The doubling structure of NUTS is tracked with
  integer arithmetic instead of nested loops.
- **Vectorized U-turn checkpoints.** The iterative U-turn scheme (after
  arXiv:1912.11554) is re-derived here in a fully data-parallel form: leaf
  ``n`` (0-indexed inside the current subtree) *stores* a checkpoint at
  slot ``popcount(n)`` when ``n`` is even, and *checks* slots
  ``popcount(n)-t .. popcount(n)-1`` (``t`` = number of trailing one-bits
  of ``n``) when ``n`` is odd.  All ``K = max_tree_depth`` slots are
  evaluated at once as a ``(C, K)`` masked reduction — no inner loop.
- **Asynchronous harvest sampling.** :func:`build_fused_run` overlaps
  transitions across chains: a chain that finishes its trajectory
  immediately refreshes momentum and starts the next transition while slow
  chains keep integrating.  Per-sample cost therefore tracks the *mean*
  tree size instead of the per-step max over chains ("Efficiently
  Vectorized MCMC", PAPERS.md), which removes the incentive to cap
  ``max_tree_depth``.

The algorithms (velocity Verlet, Stan warmup windows, dual averaging,
Welford estimators, multinomial NUTS with biased progressive doubling)
follow the published literature; behavioral parity targets are cited per
function against the reference implementation.
"""

from __future__ import annotations

import math
from collections import namedtuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, random, vmap

__all__ = [
    "FlatLayout",
    "MassBlocks",
    "AdaptPanel",
    "batched_step_size_search",
    "build_mass_blocks",
    "build_warmup",
    "init_mass",
    "hmc_transition",
    "nuts_transition",
    "build_fused_run",
]


# ---------------------------------------------------------------------------
# Flat (C, D) layout


class FlatLayout:
    """Static description of how a latent pytree packs into a flat vector.

    Built once from a *single-chain* prototype; afterwards
    :meth:`ravel_batch` / :meth:`unravel_batch` move ``(C, *site_shape)``
    pytrees to/from ``(C, D)`` panels with pure reshapes (free at trace
    time).
    """

    def __init__(self, z_proto):
        leaves, treedef = jax.tree.flatten(z_proto)
        self.treedef = treedef
        self.shapes = tuple(jnp.shape(x) for x in leaves)
        self.dtypes = tuple(jnp.result_type(x) for x in leaves)
        self.sizes = tuple(int(np.prod(s)) for s in self.shapes)
        self.dim = int(sum(self.sizes))
        self.flat_dtype = (
            jnp.result_type(*self.dtypes) if leaves else jnp.float32
        )
        # site name -> (offset, size) for dict-structured latents, in the
        # flatten order jax uses (sorted keys)
        self.site_ranges = {}
        if isinstance(z_proto, dict):
            offset = 0
            for name in sorted(z_proto):
                size = int(np.prod(jnp.shape(z_proto[name])))
                self.site_ranges[name] = (offset, size)
                offset += size

    def ravel_one(self, tree):
        leaves = jax.tree.leaves(tree)
        if not leaves:
            return jnp.zeros((0,), self.flat_dtype)
        return jnp.concatenate(
            [jnp.reshape(x, (-1,)).astype(self.flat_dtype) for x in leaves]
        )

    def unravel_one(self, flat):
        leaves, offset = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaves.append(
                jnp.reshape(flat[offset : offset + size], shape).astype(dtype)
            )
            offset += size
        return jax.tree.unflatten(self.treedef, leaves)

    def ravel_batch(self, tree):
        """Pytree of ``(C, *s)`` leaves -> ``(C, D)`` panel."""
        leaves = jax.tree.leaves(tree)
        if not leaves:
            return jnp.zeros((1, 0), self.flat_dtype)
        c = jnp.shape(leaves[0])[0]
        return jnp.concatenate(
            [jnp.reshape(x, (c, -1)).astype(self.flat_dtype) for x in leaves],
            axis=1,
        )

    def unravel_batch(self, panel):
        """(C, D) panel -> pytree with ``(C, *s)`` leaves."""
        c = panel.shape[0]
        leaves, offset = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            leaves.append(
                jnp.reshape(
                    panel[:, offset : offset + size], (c,) + shape
                ).astype(dtype)
            )
            offset += size
        return jax.tree.unflatten(self.treedef, leaves)


def batched_potential(potential_fn, layout, forward_mode=False):
    """(C, D) panel -> potential (C,) and gradient panel (C, D)."""

    def pe_flat(flat):
        return potential_fn(layout.unravel_one(flat))

    if forward_mode:

        def one(flat):
            return pe_flat(flat), jax.jacfwd(pe_flat)(flat)

    else:
        one = jax.value_and_grad(pe_flat)

    def pe_grad(panel):
        if layout.dim == 0:
            c = panel.shape[0]
            return jnp.zeros((c,), panel.dtype), panel
        pe, g = vmap(one)(panel)
        return pe, g

    return pe_grad


# ---------------------------------------------------------------------------
# Mass-matrix blocks
#
# The mass matrix is a direct sum of blocks over index sets of the flat
# dimension: each block is either diagonal ``(C, b)`` or dense ``(C, b, b)``.
# The common single-full-block case avoids all gathers.  Reference
# semantics for ``dense_mass`` (bool or list of site-name tuples):
# numpyro/infer/hmc_util.py:439-515.

MassBlocks = namedtuple("MassBlocks", ["names", "indices", "dense", "full"])
"""Static block structure.  ``names``: tuple of site-name tuples (or None),
``indices``: tuple of np index arrays into the flat dim, ``dense``: tuple of
bools, ``full``: True when there is a single block covering every dim in
order (fast path, no gathers)."""


def build_mass_blocks(layout, dense_mass):
    d = layout.dim
    if isinstance(dense_mass, bool):
        names = (tuple(sorted(layout.site_ranges)) or None,)
        return MassBlocks(names, (np.arange(d),), (dense_mass,), True)
    # list of site-name tuples -> dense blocks; leftovers form a diag block
    if not layout.site_ranges:
        raise ValueError(
            "structured `dense_mass` requires a dict-structured latent "
            "(use a model, not a raw potential_fn)"
        )
    names, indices, dense = [], [], []
    covered = set()
    for group in dense_mass:
        idx = np.concatenate(
            [
                np.arange(*(lambda o, s: (o, o + s))(*layout.site_ranges[k]))
                for k in group
            ]
        )
        names.append(tuple(group))
        indices.append(idx)
        dense.append(True)
        covered.update(group)
    rest = tuple(sorted(set(layout.site_ranges) - covered))
    if rest:
        idx = np.concatenate(
            [np.arange(o, o + s) for o, s in (layout.site_ranges[k] for k in rest)]
        )
        names.append(rest)
        indices.append(idx)
        dense.append(False)
    full = (
        len(indices) == 1
        and len(indices[0]) == d
        and bool(np.all(indices[0] == np.arange(d)))
    )
    return MassBlocks(tuple(names), tuple(indices), tuple(dense), full)


def _as_parts(blocks, exposed):
    """Exposed mass structure (bare array or name-keyed dict) -> block list."""
    if isinstance(exposed, dict):
        return [exposed[k] for k in blocks.names]
    return [exposed]


def _expose(blocks, parts):
    if len(parts) == 1:
        return parts[0]
    return dict(zip(blocks.names, parts))


def apply_inv_mass(blocks, inv_mass, r):
    """v = M^{-1} r over panels ``(C, ..., D)`` (extra axes broadcast)."""
    parts = _as_parts(blocks, inv_mass)
    if blocks.full:
        m = parts[0]
        if m.ndim == 2:  # (C, D) diagonal
            return m.reshape(m.shape[:1] + (1,) * (r.ndim - 2) + m.shape[1:]) * r
        return jnp.einsum("cij,c...j->c...i", m, r)
    v = jnp.zeros_like(r)
    for idx, m in zip(blocks.indices, parts):
        rb = jnp.take(r, idx, axis=-1)
        if m.ndim == 2:
            vb = m.reshape(m.shape[:1] + (1,) * (r.ndim - 2) + m.shape[1:]) * rb
        else:
            vb = jnp.einsum("cij,c...j->c...i", m, rb)
        v = v.at[..., idx].set(vb)
    return v


def kinetic(blocks, inv_mass, r):
    """K(r) = r^T M^{-1} r / 2, batched over (C, ..., D) -> (C, ...)."""
    return 0.5 * jnp.sum(apply_inv_mass(blocks, inv_mass, r) * r, axis=-1)


def draw_momentum(blocks, sqrt_mass, eps):
    """r = chol(M) eps for standard normals eps (C, D)."""
    parts = _as_parts(blocks, sqrt_mass)
    if blocks.full:
        m = parts[0]
        if m.ndim == 2:
            return m * eps
        return jnp.einsum("cij,cj->ci", m, eps)
    r = jnp.zeros_like(eps)
    for idx, m in zip(blocks.indices, parts):
        eb = jnp.take(eps, idx, axis=-1)
        rb = m * eb if m.ndim == 2 else jnp.einsum("cij,cj->ci", m, eb)
        r = r.at[..., idx].set(rb)
    return r


def _precision_factors(cov):
    """(S, S^{-1}) with S lower-triangular and S S^T = cov^{-1}, batched.

    Uses the flip-reorder trick so no explicit inverse of cov is formed;
    S^{-1} comes out exactly (it is the flipped-Cholesky transpose), which
    matters for kernels that whiten momenta with it.
    """
    rev = jnp.linalg.cholesky(cov[..., ::-1, ::-1])[..., ::-1, ::-1]
    sqrt_inv = jnp.swapaxes(rev, -2, -1)
    eye = jnp.broadcast_to(jnp.eye(cov.shape[-1], dtype=cov.dtype), cov.shape)
    sqrt = jax.scipy.linalg.solve_triangular(sqrt_inv, eye, lower=True)
    return sqrt, sqrt_inv


def init_mass(blocks, num_chains, dtype, init_inverse=None):
    """Identity (or user-provided) mass; returns (inv, sqrt, sqrt_inv).

    ``init_inverse`` may be a bare array (applied to the sole block) or a
    dict keyed by block site-name tuples, matching the reference contract
    (numpyro/infer/hmc_util.py:439-515).  Arrays may be unbatched — they
    broadcast over chains.
    """
    inv_p, sqrt_p, sqrt_inv_p = [], [], []
    for name, idx, dense in zip(blocks.names, blocks.indices, blocks.dense):
        b = len(idx)
        given = None
        if init_inverse is not None:
            given = (
                init_inverse.get(name)
                if isinstance(init_inverse, dict)
                else init_inverse
            )
        if given is None:
            if dense:
                inv = jnp.broadcast_to(
                    jnp.eye(b, dtype=dtype), (num_chains, b, b)
                )
            else:
                inv = jnp.ones((num_chains, b), dtype)
            sqrt = inv
            sqrt_inv = inv
        else:
            given = jnp.asarray(given, dtype)
            if dense and given.ndim == 1:
                given = jnp.diag(given)
            if given.ndim == (2 if dense else 1):
                given = jnp.broadcast_to(
                    given, (num_chains,) + given.shape
                )
            inv = given
            if dense:
                sqrt, sqrt_inv = _precision_factors(inv)
            else:
                sqrt_inv = jnp.sqrt(inv)
                sqrt = 1.0 / sqrt_inv
        inv_p.append(inv)
        sqrt_p.append(sqrt)
        sqrt_inv_p.append(sqrt_inv)
    return (
        _expose(blocks, inv_p),
        _expose(blocks, sqrt_p),
        _expose(blocks, sqrt_inv_p),
    )


# ---------------------------------------------------------------------------
# Batched per-chain RNG helpers (works for typed keys and legacy uint32)


def split_keys(keys, n):
    """(C,)-batched key array -> tuple of n (C,)-batched key arrays."""
    pieces = vmap(lambda k: random.split(k, n))(keys)
    return tuple(pieces[:, i] for i in range(n))


def batch_uniform(keys):
    return vmap(lambda k: random.uniform(k))(keys)


def batch_normal(keys, d):
    return vmap(lambda k: random.normal(k, (d,)))(keys)


def batch_rademacher(keys):
    return vmap(lambda k: jnp.where(random.bernoulli(k), 1.0, -1.0))(keys)


# ---------------------------------------------------------------------------
# Leapfrog


def leapfrog(pe_grad, blocks, inv_mass, eps, z, r, grad):
    """One velocity-Verlet step with per-chain signed step size eps (C,)."""
    e = eps[:, None]
    r_half = r - 0.5 * e * grad
    z_new = z + e * apply_inv_mass(blocks, inv_mass, r_half)
    pe_new, grad_new = pe_grad(z_new)
    r_new = r_half - 0.5 * e * grad_new
    return z_new, r_new, pe_new, grad_new


# ---------------------------------------------------------------------------
# NUTS transition: all chains, one while loop, one gradient per iteration

NutsCarry = namedtuple(
    "NutsCarry",
    [
        "key",  # (C,) batched rng keys
        # building edge (the point the next leapfrog starts from)
        "z", "r", "grad", "pe",
        # trajectory ends in time order (bwd = earliest, fwd = latest)
        "zb", "rb", "gradb", "peb",
        "zf", "rf", "gradf", "pef",
        "rho",  # (C, D) total momentum sum over the trajectory
        # current multinomial proposal over the whole trajectory
        "prop_z", "prop_grad", "prop_pe", "prop_energy",
        "logw",  # (C,) log total weight of the trajectory
        # subtree under construction
        "s_logw", "s_prop_z", "s_prop_grad", "s_prop_pe", "s_prop_energy",
        "s_prefix",  # (C, D) running momentum sum inside the subtree
        "ck_r", "ck_s",  # (C, K, D) checkpoint momenta / prefix sums
        "leaf", "depth",  # (C,) int32
        "direction",  # (C,) +-1.0
        "e0", "accept_sum", "n_leaf",  # (C,)
        "diverging", "done",  # (C,) bool
    ],
)


def _turning(blocks, inv_mass, r_first, r_last, rho):
    """Generalized U-turn criterion; supports extra broadcast axes."""
    vf = apply_inv_mass(blocks, inv_mass, r_first)
    vl = apply_inv_mass(blocks, inv_mass, r_last)
    return (jnp.sum(rho * vf, -1) <= 0) | (jnp.sum(rho * vl, -1) <= 0)


def _init_nuts_carry(keys, z, pe, grad, blocks, inv_mass, sqrt_mass, k_slots):
    c, d = z.shape
    key, k_mom, k_dir = split_keys(keys, 3)
    r0 = draw_momentum(blocks, sqrt_mass, batch_normal(k_mom, d))
    e0 = pe + kinetic(blocks, inv_mass, r0)
    fz = jnp.zeros((c,), z.dtype)
    return NutsCarry(
        key=key,
        z=z, r=r0, grad=grad, pe=pe,
        zb=z, rb=r0, gradb=grad, peb=pe,
        zf=z, rf=r0, gradf=grad, pef=pe,
        rho=r0,
        prop_z=z, prop_grad=grad, prop_pe=pe, prop_energy=e0,
        logw=-e0,
        s_logw=jnp.full((c,), -jnp.inf, z.dtype),
        s_prop_z=z, s_prop_grad=grad, s_prop_pe=pe, s_prop_energy=e0,
        s_prefix=jnp.zeros_like(z),
        ck_r=jnp.zeros((c, k_slots, d), z.dtype),
        ck_s=jnp.zeros((c, k_slots, d), z.dtype),
        leaf=jnp.zeros((c,), jnp.int32),
        depth=jnp.zeros((c,), jnp.int32),
        direction=batch_rademacher(k_dir).astype(z.dtype),
        e0=e0,
        accept_sum=fz,
        n_leaf=jnp.zeros((c,), jnp.int32),
        diverging=jnp.zeros((c,), bool),
        done=jnp.zeros((c,), bool),
    )


def _sel(mask, new, old):
    """Per-chain select with broadcasting over trailing axes."""
    return jnp.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _nuts_tick(
    t, blocks, pe_grad, inv_mass, step_size, max_depth, max_delta_energy
):
    """One batched leapfrog + tree bookkeeping for every chain."""
    active = ~t.done
    key, k_swap, k_merge, k_dir = split_keys(t.key, 4)

    eps = t.direction * step_size
    z_n, r_n, pe_n, grad_n = leapfrog(
        pe_grad, blocks, inv_mass, eps, t.z, t.r, t.grad
    )
    energy = pe_n + kinetic(blocks, inv_mass, r_n)
    energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
    delta = energy - t.e0
    div_leaf = delta > max_delta_energy
    logw_leaf = -energy
    accept_leaf = jnp.exp(jnp.minimum(0.0, -delta))
    accept_sum = t.accept_sum + jnp.where(active, accept_leaf, 0.0)
    n_leaf = t.n_leaf + active.astype(jnp.int32)

    # --- iterative U-turn machinery, vectorized over checkpoint slots
    n = t.leaf
    pc = lax.population_count(n)
    is_even = (n & 1) == 0
    k_slots = t.ck_r.shape[1]
    slot_ids = jnp.arange(k_slots, dtype=jnp.int32)
    # even leaf: store (momentum, prefix-before) at slot popcount(n)
    store = (active & is_even)[:, None] & (slot_ids[None, :] == pc[:, None])
    ck_r = jnp.where(store[..., None], r_n[:, None, :], t.ck_r)
    ck_s = jnp.where(store[..., None], t.s_prefix[:, None, :], t.ck_s)
    s_after = t.s_prefix + r_n
    # odd leaf: check slots [pc - trailing_ones, pc)
    t_ones = lax.population_count(n ^ (n + 1)) - 1
    check = (
        (active & ~is_even)[:, None]
        & (slot_ids[None, :] >= (pc - t_ones)[:, None])
        & (slot_ids[None, :] < pc[:, None])
    )
    rho_k = s_after[:, None, :] - ck_s  # momentum sum over each subspan
    turn_k = _turning(blocks, inv_mass, ck_r, r_n[:, None, :], rho_k)
    turn_within = jnp.any(check & turn_k, axis=1)

    # --- progressive multinomial inside the subtree
    s_logw = jnp.logaddexp(t.s_logw, logw_leaf)
    take = jnp.log(batch_uniform(k_swap)) < (logw_leaf - s_logw)
    s_prop_z = _sel(active & take, z_n, t.s_prop_z)
    s_prop_grad = _sel(active & take, grad_n, t.s_prop_grad)
    s_prop_pe = jnp.where(active & take, pe_n, t.s_prop_pe)
    s_prop_energy = jnp.where(active & take, energy, t.s_prop_energy)

    invalid = div_leaf | turn_within
    leaf_next = n + 1
    complete = leaf_next == (1 << t.depth)
    a_bad = active & invalid  # transition over, discard subtree
    b_merge = active & ~invalid & complete  # subtree done, merge into tree
    c_cont = active & ~invalid & ~complete  # keep building the subtree

    # --- merge: biased progressive sampling between tree and subtree
    merge_take = b_merge & (
        jnp.log(batch_uniform(k_merge)) < (s_logw - t.logw)
    )
    prop_z = _sel(merge_take, s_prop_z, t.prop_z)
    prop_grad = _sel(merge_take, s_prop_grad, t.prop_grad)
    prop_pe = jnp.where(merge_take, s_prop_pe, t.prop_pe)
    prop_energy = jnp.where(merge_take, s_prop_energy, t.prop_energy)
    logw = jnp.where(b_merge, jnp.logaddexp(t.logw, s_logw), t.logw)
    rho = _sel(b_merge, t.rho + s_after, t.rho)

    fwd = b_merge & (t.direction > 0)
    bwd = b_merge & (t.direction < 0)
    zf = _sel(fwd, z_n, t.zf)
    rf = _sel(fwd, r_n, t.rf)
    gradf = _sel(fwd, grad_n, t.gradf)
    pef = jnp.where(fwd, pe_n, t.pef)
    zb = _sel(bwd, z_n, t.zb)
    rb = _sel(bwd, r_n, t.rb)
    gradb = _sel(bwd, grad_n, t.gradb)
    peb = jnp.where(bwd, pe_n, t.peb)

    turn_tree = b_merge & _turning(blocks, inv_mass, rb, rf, rho)
    depth = t.depth + b_merge.astype(jnp.int32)
    done = t.done | a_bad | turn_tree | (b_merge & (depth >= max_depth))
    diverging = t.diverging | (active & div_leaf)

    # --- next building edge: new subtree starts at a trajectory end
    start_new = b_merge & ~done
    direction = jnp.where(start_new, batch_rademacher(k_dir), t.direction)
    go_fwd = direction > 0
    z = _sel(c_cont, z_n, _sel(go_fwd, zf, zb))
    r = _sel(c_cont, r_n, _sel(go_fwd, rf, rb))
    grad = _sel(c_cont, grad_n, _sel(go_fwd, gradf, gradb))
    pe = jnp.where(c_cont, pe_n, jnp.where(go_fwd, pef, peb))

    reset = b_merge | a_bad
    neg_inf = jnp.full_like(s_logw, -jnp.inf)
    return t._replace(
        key=key,
        z=z, r=r, grad=grad, pe=pe,
        zb=zb, rb=rb, gradb=gradb, peb=peb,
        zf=zf, rf=rf, gradf=gradf, pef=pef,
        rho=rho,
        prop_z=prop_z, prop_grad=prop_grad,
        prop_pe=prop_pe, prop_energy=prop_energy,
        logw=logw,
        s_logw=jnp.where(reset, neg_inf, s_logw),
        s_prop_z=s_prop_z, s_prop_grad=s_prop_grad,
        s_prop_pe=s_prop_pe, s_prop_energy=s_prop_energy,
        s_prefix=_sel(reset, jnp.zeros_like(s_after), s_after),
        ck_r=ck_r, ck_s=ck_s,
        leaf=jnp.where(reset, 0, jnp.where(active, leaf_next, n)),
        depth=depth,
        direction=direction,
        accept_sum=accept_sum,
        n_leaf=n_leaf,
        diverging=diverging,
        done=done,
    )


TransitionOut = namedtuple(
    "TransitionOut",
    ["key", "z", "pe", "grad", "energy", "num_steps", "accept_prob", "diverging"],
)

WarmState = namedtuple(
    "WarmState", ["keys", "z", "pe", "grad", "adapt", "mean_accept"]
)
"""Resumable warmup-phase state for the chunked fused run."""

SampleState = namedtuple(
    "SampleState",
    ["carry", "buf_z", "buf", "trans_idx", "mean_accept", "adapt"],
)
"""Resumable sampling-phase state (collection buffers ride along)."""


def nuts_transition(
    pe_grad,
    blocks,
    keys,
    z,
    pe,
    grad,
    inv_mass,
    sqrt_mass,
    step_size,
    max_depth,
    max_delta_energy=1000.0,
    k_slots=None,
):
    """Run one multinomial-NUTS transition for all chains simultaneously.

    Behavioral parity target: numpyro/infer/hmc_util.py:972-1180 (iterative
    build_tree), re-designed as a single masked loop (module docstring).
    """
    k_slots = k_slots if k_slots is not None else max(int(max_depth), 1)
    carry = _init_nuts_carry(
        keys, z, pe, grad, blocks, inv_mass, sqrt_mass, k_slots
    )
    if z.shape[1] == 0:
        c = z.shape[0]
        return TransitionOut(
            carry.key, z, pe, grad, carry.e0,
            jnp.ones((c,), jnp.int32), jnp.ones((c,), z.dtype),
            jnp.zeros((c,), bool),
        )

    def cond_fn(t):
        return jnp.any(~t.done)

    def body_fn(t):
        return _nuts_tick(
            t, blocks, pe_grad, inv_mass, step_size, max_depth, max_delta_energy
        )

    out = lax.while_loop(cond_fn, body_fn, carry)
    accept_prob = out.accept_sum / jnp.maximum(out.n_leaf, 1)
    return TransitionOut(
        out.key, out.prop_z, out.prop_pe, out.prop_grad, out.prop_energy,
        out.n_leaf, accept_prob, out.diverging,
    )


# ---------------------------------------------------------------------------
# Fixed-trajectory HMC transition (per-chain trajectory lengths)

HmcCarry = namedtuple(
    "HmcCarry", ["z", "r", "grad", "pe", "step", "num_steps"]
)


def hmc_transition(
    pe_grad,
    blocks,
    keys,
    z,
    pe,
    grad,
    inv_mass,
    sqrt_mass,
    step_size,
    trajectory_length=None,
    num_steps=None,
    max_delta_energy=1000.0,
):
    """One batched HMC transition; trajectory lengths may differ per chain
    (each chain runs ceil(len/eps) leapfrogs, lagging chains are masked).

    Parity target: numpyro/infer/hmc.py:364-414.
    """
    c, d = z.shape
    key, k_mom, k_acc = split_keys(keys, 3)
    if d == 0:
        e0 = pe
        return TransitionOut(
            key, z, pe, grad, e0, jnp.ones((c,), jnp.int32),
            jnp.ones((c,), z.dtype), jnp.zeros((c,), bool),
        )
    r0 = draw_momentum(blocks, sqrt_mass, batch_normal(k_mom, d))
    e0 = pe + kinetic(blocks, inv_mass, r0)
    if num_steps is None:
        lengths = jnp.ceil(trajectory_length / step_size).astype(jnp.int32)
        lengths = jnp.maximum(lengths, 1)
    else:
        lengths = jnp.full((c,), num_steps, jnp.int32)

    def cond_fn(t):
        return jnp.any(t.step < t.num_steps)

    def body_fn(t):
        live = t.step < t.num_steps
        z_n, r_n, pe_n, grad_n = leapfrog(
            pe_grad, blocks, inv_mass, step_size, t.z, t.r, t.grad
        )
        return HmcCarry(
            _sel(live, z_n, t.z),
            _sel(live, r_n, t.r),
            _sel(live, grad_n, t.grad),
            jnp.where(live, pe_n, t.pe),
            t.step + live.astype(jnp.int32),
            t.num_steps,
        )

    end = lax.while_loop(
        cond_fn, body_fn, HmcCarry(z, r0, grad, pe, jnp.zeros((c,), jnp.int32), lengths)
    )
    e1 = end.pe + kinetic(blocks, inv_mass, end.r)
    delta = jnp.where(jnp.isnan(e1), jnp.inf, e1) - e0
    accept_prob = jnp.exp(jnp.minimum(0.0, -delta))
    diverging = delta > max_delta_energy
    take = jnp.log(batch_uniform(k_acc)) < -delta
    return TransitionOut(
        key,
        _sel(take, end.z, z),
        jnp.where(take, end.pe, pe),
        _sel(take, end.grad, grad),
        jnp.where(take, e1, e0),
        lengths,
        accept_prob,
        diverging,
    )


def integrate_segment(
    pe_grad, blocks, inv_mass, step_size, num_steps, z, r, pe, grad
):
    """Leapfrog every chain for its own ``num_steps`` (masked; momentum is
    carried, not refreshed) — the building block for composite-trajectory
    kernels like MixedHMC."""
    c = z.shape[0]

    def cond_fn(t):
        return jnp.any(t[0] < num_steps)

    def body_fn(t):
        step, z, r, pe, grad = t
        live = step < num_steps
        z_n, r_n, pe_n, grad_n = leapfrog(
            pe_grad, blocks, inv_mass, step_size, z, r, grad
        )
        return (
            step + live.astype(jnp.int32),
            _sel(live, z_n, z),
            _sel(live, r_n, r),
            jnp.where(live, pe_n, pe),
            _sel(live, grad_n, grad),
        )

    _, z, r, pe, grad = lax.while_loop(
        cond_fn, body_fn, (jnp.zeros((c,), jnp.int32), z, r, pe, grad)
    )
    return z, r, pe, grad


# ---------------------------------------------------------------------------
# Batched reasonable-step-size search (all chains search simultaneously)


def batched_step_size_search(
    pe_grad, blocks, keys, z, pe, grad, inv_mass, sqrt_mass, init_step_size,
    target=0.8,
):
    """Per-chain doubling/halving search for a step size whose single-step
    acceptance crosses ``target`` (parity: numpyro/infer/hmc_util.py:314-384,
    here as one masked loop over all chains)."""
    c, d = z.shape
    if d == 0:
        return keys, init_step_size
    log_target = math.log(target)
    finfo = jnp.finfo(z.dtype)

    def cond_fn(state):
        _, ss, prev_dir, cur_dir, settled = state
        return jnp.any(~settled)

    def body_fn(state):
        keys, ss, prev_dir, cur_dir, settled = state
        keys, k_mom = split_keys(keys, 2)
        ss_new = jnp.where(settled, ss, ss * (2.0 ** cur_dir))
        r = draw_momentum(blocks, sqrt_mass, batch_normal(k_mom, d))
        _, r1, pe1, _ = leapfrog(
            pe_grad, blocks, inv_mass, ss_new, z, r, grad
        )
        e0 = pe + kinetic(blocks, inv_mass, r)
        e1 = pe1 + kinetic(blocks, inv_mass, r1)
        delta = jnp.where(jnp.isnan(e1), jnp.inf, e1 - e0)
        new_dir = jnp.where(log_target < -delta, 1.0, -1.0)
        crossed = (prev_dir != 0.0) & (new_dir != prev_dir)
        extreme = (ss_new <= finfo.tiny) | (ss_new >= finfo.max)
        return (
            keys,
            jnp.where(settled, ss, ss_new),
            jnp.where(settled, prev_dir, new_dir),
            jnp.where(settled, cur_dir, new_dir),
            settled | crossed | extreme,
        )

    zeros = jnp.zeros((c,), z.dtype)
    ss0 = jnp.broadcast_to(jnp.asarray(init_step_size, z.dtype), (c,))
    keys, ss, _, _, _ = lax.while_loop(
        cond_fn, body_fn, (keys, ss0, zeros, zeros, jnp.zeros((c,), bool))
    )
    return keys, ss


# ---------------------------------------------------------------------------
# Warmup adaptation, batched over chains.
#
# Stan-style windows (75 / 25·2^k / 50: numpyro/infer/hmc_util.py:387-436)
# precomputed as boolean per-step masks; dual averaging and Welford run with
# a leading chain axis.  Window-end work happens under a scalar lax.cond so
# Cholesky factorizations only execute on boundary steps.

AdaptPanel = namedtuple(
    "AdaptPanel",
    [
        "step_size",  # (C,)
        "inverse_mass_matrix", "mass_matrix_sqrt", "mass_matrix_sqrt_inv",
        "da_log", "da_log_avg", "da_grad_avg", "da_count", "da_anchor",  # (C,)
        "wf_mean", "wf_m2", "wf_count",  # welford (structures like mass)
        "rng_key",  # (C,) batched keys
    ],
)


def stan_windows(num_steps):
    """(start, end) inclusive windows; list shrinks for short warmups."""
    if num_steps < 20:
        return [(0, num_steps - 1)]
    head, tail, first = 75, 50, 25
    if head + tail + first > num_steps:
        head = int(0.15 * num_steps)
        tail = int(0.1 * num_steps)
        first = num_steps - head - tail
    windows = [(0, head - 1)]
    pos, width = head, first
    last_start = num_steps - tail
    while pos < last_start:
        if 3 * width <= last_start - pos:
            end = pos + width
        else:
            end = last_start
        windows.append((pos, end - 1))
        pos, width = end, 2 * width
    windows.append((last_start, num_steps - 1))
    return windows


def _window_masks(num_warmup):
    """Per-step masks: inside a middle window / at a middle-window end.

    Kept as host numpy — converting eagerly would bake device-array
    constants into every jitted sampler program (each a device-to-host
    copy at lowering time, and a larger program to compile).
    """
    in_middle = np.zeros(max(num_warmup, 1), bool)
    at_end = np.zeros(max(num_warmup, 1), bool)
    windows = stan_windows(num_warmup)
    for w_idx, (start, end) in enumerate(windows):
        if 0 < w_idx < len(windows) - 1:
            in_middle[start : end + 1] = True
            at_end[end] = True
    return in_middle, at_end


def _welford_init(blocks, num_chains, dtype):
    means, m2s = [], []
    for idx, dense in zip(blocks.indices, blocks.dense):
        b = len(idx)
        means.append(jnp.zeros((num_chains, b), dtype))
        m2s.append(
            jnp.zeros((num_chains, b, b), dtype)
            if dense
            else jnp.zeros((num_chains, b), dtype)
        )
    return (
        _expose(blocks, means),
        _expose(blocks, m2s),
        jnp.zeros((num_chains,), dtype),
    )


def _welford_update(blocks, wf, z_flat):
    means, m2s, count = wf
    count = count + 1
    new_means, new_m2s = [], []
    for idx, dense, mean, m2 in zip(
        blocks.indices, blocks.dense, _as_parts(blocks, means), _as_parts(blocks, m2s)
    ):
        x = z_flat if blocks.full else jnp.take(z_flat, idx, axis=-1)
        pre = x - mean
        mean = mean + pre / count[:, None]
        post = x - mean
        if dense:
            m2 = m2 + jnp.einsum("ci,cj->cij", post, pre)
        else:
            m2 = m2 + post * pre
        new_means.append(mean)
        new_m2s.append(m2)
    return _expose(blocks, new_means), _expose(blocks, new_m2s), count


def _welford_finalize(blocks, wf, regularize=True):
    """Per-chain covariance estimate -> (inv_mass, sqrt, sqrt_inv)."""
    means, m2s, count = wf
    inv_p, sqrt_p, sqrt_inv_p = [], [], []
    for dense, m2 in zip(blocks.dense, _as_parts(blocks, m2s)):
        n = count.reshape(count.shape + (1,) * (m2.ndim - 1))
        cov = m2 / jnp.maximum(n - 1, 1)
        if regularize:
            shrink = (n / (n + 5.0)) * cov
            ridge = 1e-3 * (5.0 / (n + 5.0))
            if dense:
                b = cov.shape[-1]
                cov = shrink + ridge * jnp.eye(b, dtype=cov.dtype)
            else:
                cov = shrink + ridge
        if dense:
            inv_p.append(cov)
            sqrt, sqrt_inv = _precision_factors(cov)
            sqrt_p.append(sqrt)
            sqrt_inv_p.append(sqrt_inv)
        else:
            inv_p.append(cov)
            root = jnp.sqrt(cov)
            sqrt_p.append(1.0 / root)
            sqrt_inv_p.append(root)
    return (
        _expose(blocks, inv_p),
        _expose(blocks, sqrt_p),
        _expose(blocks, sqrt_inv_p),
    )


def _welford_pool(blocks, wf):
    """Combine per-chain Welford states into one pooled estimate, broadcast
    back over the chain axis (parallel-Welford merge: pooled m2 adds the
    between-chain mean-spread term).  Under a GSPMD-sharded chain axis the
    chain-mean reductions lower to psums across devices — this is the multi-host
    pooled-adaptation collective."""
    means, m2s, count = wf
    c = count.shape[0]
    total = jnp.full_like(count, jnp.sum(count))
    pooled_means, pooled_m2s = [], []
    for dense, mean, m2 in zip(
        blocks.dense, _as_parts(blocks, means), _as_parts(blocks, m2s)
    ):
        grand = jnp.mean(mean, axis=0, keepdims=True)  # equal per-chain counts
        spread = mean - grand
        n = count.reshape((c,) + (1,) * (m2.ndim - 1))
        if dense:
            between = jnp.einsum("ci,cj->cij", spread, spread)
        else:
            between = spread**2
        m2_pooled = jnp.sum(m2 + n * between, axis=0, keepdims=True)
        pooled_means.append(jnp.broadcast_to(grand, mean.shape))
        pooled_m2s.append(jnp.broadcast_to(m2_pooled, m2.shape))
    return (
        _expose(blocks, pooled_means),
        _expose(blocks, pooled_m2s),
        total,
    )


def _pool_step_size(ss):
    """Harmonic-mean pooled step size, broadcast over chains."""
    return jnp.broadcast_to(1.0 / jnp.mean(1.0 / ss), ss.shape)


def build_warmup(
    pe_grad,
    blocks,
    num_warmup,
    *,
    adapt_step_size=True,
    adapt_mass_matrix=True,
    target_accept_prob=0.8,
    regularize_mass_matrix=True,
    da_t0=10.0,
    da_kappa=0.75,
    da_gamma=0.05,
    find_step_size=True,
    pool_chains=False,
):
    """Returns (init_fn, update_fn) for chain-batched warmup adaptation.

    Parity target: numpyro/infer/hmc_util.py:518-707 (warmup_adapter), with
    per-chain dual averaging / Welford states and boolean window masks
    instead of a window-index register.

    ``pool_chains=True`` opts into cross-chain pooled adaptation: one shared
    step size driven by the mean accept statistic and one mass matrix from
    the pooled Welford moments of every chain.  All pooling reductions are
    plain chain-axis means/sums, so on a sharded chain mesh they compile to
    cross-device collectives and the scheme extends to multi-host unchanged.
    """
    in_middle, at_end = _window_masks(num_warmup)

    def da_reset(step_size):
        z = jnp.zeros_like(step_size)
        return (z, z, z, z, jnp.log(10.0 * step_size))

    def init_fn(keys, z, pe, grad, step_size, inverse_mass_matrix=None):
        c, d = z.shape
        dtype = z.dtype
        inv, sqrt, sqrt_inv = init_mass(
            blocks, c, dtype, init_inverse=inverse_mass_matrix
        )
        ss = jnp.broadcast_to(jnp.asarray(step_size, dtype), (c,))
        if adapt_step_size and find_step_size and d > 0:
            keys, ss = batched_step_size_search(
                pe_grad, blocks, keys, z, pe, grad, inv, sqrt, ss,
                target=target_accept_prob,
            )
            if pool_chains:
                ss = _pool_step_size(ss)
        da = da_reset(ss)
        wf = _welford_init(blocks, c, dtype)
        return AdaptPanel(ss, inv, sqrt, sqrt_inv, *da, *wf, keys)

    def _da_update(adapt, accept_prob, is_last):
        if pool_chains:
            # every chain's dual-averaging state receives the same fleet
            # statistic, so shared-init states stay bitwise identical.
            # GEOMETRIC mean, not arithmetic: with an arithmetic mean, 7
            # chains at 0.91 + 1 stuck chain at 0.0 average to exactly the
            # 0.8 target — a stable equilibrium that never rescues the stuck
            # chain.  The log-mean lets any near-zero accept veto equilibrium
            # until that chain moves.
            pooled = jnp.exp(
                jnp.mean(jnp.log(jnp.maximum(accept_prob, 1e-6)))
            )
            accept_prob = jnp.broadcast_to(pooled, accept_prob.shape)
        g = target_accept_prob - accept_prob
        count = adapt.da_count + 1
        grad_avg = (1 - 1 / (count + da_t0)) * adapt.da_grad_avg + g / (
            count + da_t0
        )
        log_ss = adapt.da_anchor - jnp.sqrt(count) / da_gamma * grad_avg
        w = count ** (-da_kappa)
        log_avg = (1 - w) * adapt.da_log_avg + w * log_ss
        step_size = jnp.exp(jnp.where(is_last, log_avg, log_ss))
        finfo = jnp.finfo(step_size.dtype)
        step_size = jnp.clip(step_size, finfo.tiny, finfo.max)
        return adapt._replace(
            step_size=step_size,
            da_log=log_ss,
            da_log_avg=log_avg,
            da_grad_avg=grad_avg,
            da_count=count,
        )

    def _window_end(adapt, z, pe, grad, pe_grad_now):
        keys = adapt.rng_key
        inv, sqrt, sqrt_inv = (
            adapt.inverse_mass_matrix,
            adapt.mass_matrix_sqrt,
            adapt.mass_matrix_sqrt_inv,
        )
        if adapt_mass_matrix:
            wf = (adapt.wf_mean, adapt.wf_m2, adapt.wf_count)
            if pool_chains:
                wf = _welford_pool(blocks, wf)
            inv, sqrt, sqrt_inv = _welford_finalize(
                blocks, wf, regularize=regularize_mass_matrix
            )
        ss = adapt.step_size
        if adapt_step_size:
            if find_step_size:
                keys, ss = batched_step_size_search(
                    pe_grad_now, blocks, keys, z, pe, grad, inv, sqrt, ss,
                    target=target_accept_prob,
                )
                if pool_chains:
                    ss = _pool_step_size(ss)
            da = da_reset(ss)
        else:
            da = (
                adapt.da_log, adapt.da_log_avg, adapt.da_grad_avg,
                adapt.da_count, adapt.da_anchor,
            )
        wf = _welford_init(blocks, z.shape[0], z.dtype)
        return AdaptPanel(ss, inv, sqrt, sqrt_inv, *da, *wf, keys)

    def update_fn(i, adapt, accept_prob, z, pe, grad, pe_grad_now=None):
        """i: scalar step index (same for every chain in the sync phase).

        ``pe_grad_now`` overrides the construction-time potential for the
        window-end step-size search — callers whose potential depends on
        per-step state (e.g. Gibbs conditioning) must pass the current one
        or the search would probe a stale density.
        """
        pe_grad_now = pe_grad if pe_grad_now is None else pe_grad_now
        idx = jnp.minimum(i, max(num_warmup - 1, 0))
        if adapt_step_size:
            adapt = _da_update(adapt, accept_prob, i == num_warmup - 1)
        if adapt_mass_matrix and num_warmup > 0:
            adapt = lax.cond(
                jnp.asarray(in_middle)[idx],
                lambda a: a._replace(
                    **dict(
                        zip(
                            ("wf_mean", "wf_m2", "wf_count"),
                            _welford_update(
                                blocks, (a.wf_mean, a.wf_m2, a.wf_count), z
                            ),
                        )
                    )
                ),
                lambda a: a,
                adapt,
            )
        if num_warmup > 0:
            adapt = lax.cond(
                jnp.asarray(at_end)[idx],
                lambda a: _window_end(a, z, pe, grad, pe_grad_now),
                lambda a: a,
                adapt,
            )
        return adapt

    return init_fn, update_fn


# ---------------------------------------------------------------------------
# Fused sampler: sync warmup + asynchronous harvest sampling in ONE program


def build_fused_run(
    pe_grad,
    blocks,
    *,
    algo,
    num_warmup,
    num_samples,
    thinning=1,
    max_depth=10,
    warmup_max_depth=None,
    trajectory_length=None,
    fixed_num_steps=None,
    max_delta_energy=1000.0,
    adapt_step_size=True,
    adapt_mass_matrix=True,
    target_accept_prob=0.8,
    regularize_mass_matrix=True,
    find_step_size=True,
    pool_chains=False,
    progress_callback=None,
    progress_every=0,
):
    """Build a function running warmup + sampling for all chains in one
    compiled program.

    Warmup is synchronous at transition granularity (adaptation wants all
    chains at the same step), sampling is *asynchronous*: the single global
    while loop advances every chain by one leapfrog per iteration, and a
    chain that completes a transition immediately banks the sample and
    starts its next trajectory — no chain ever idles waiting for the
    slowest tree.  See module docstring; this is the replacement for the
    driver-level sample loop (numpyro/infer/mcmc.py:461-506 + fori_collect).
    """
    warmup_max_depth = warmup_max_depth or max_depth
    num_collect = (num_samples + thinning - 1) // thinning
    wa_init, wa_update = build_warmup(
        pe_grad,
        blocks,
        num_warmup,
        adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix,
        target_accept_prob=target_accept_prob,
        regularize_mass_matrix=regularize_mass_matrix,
        find_step_size=find_step_size,
        pool_chains=pool_chains,
    )

    def transition(keys, z, pe, grad, adapt, depth_cap):
        if algo == "NUTS":
            return nuts_transition(
                pe_grad, blocks, keys, z, pe, grad,
                adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt,
                adapt.step_size, depth_cap, max_delta_energy,
                k_slots=max(max_depth, warmup_max_depth, 1),
            )
        return hmc_transition(
            pe_grad, blocks, keys, z, pe, grad,
            adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt,
            adapt.step_size, trajectory_length, fixed_num_steps,
            max_delta_energy,
        )

    # The run is exposed in resumable pieces so the driver can advance it
    # in chunks where a progress bar needs update points.  All state stays
    # on device between calls, so the fusion wins are unchanged.

    def _empty_buffers(c, d, dtype):
        buf_z = jnp.zeros((c, num_collect, d), dtype)
        buf = {
            "energy": jnp.zeros((c, num_collect), dtype),
            "diverging": jnp.zeros((c, num_collect), bool),
            "num_steps": jnp.zeros((c, num_collect), jnp.int32),
            "accept_prob": jnp.zeros((c, num_collect), dtype),
            "mean_accept_prob": jnp.zeros((c, num_collect), dtype),
        }
        return buf_z, buf

    def _bank(buf_z, buf, rows, slot, t, acc, mean_acc):
        buf_z = buf_z.at[rows, slot].set(t.prop_z, mode="drop")
        vals = {
            "energy": t.prop_energy,
            "diverging": t.diverging,
            "num_steps": t.n_leaf,
            "accept_prob": acc,
            "mean_accept_prob": mean_acc,
        }
        buf = {
            k: v.at[rows, slot].set(vals[k], mode="drop")
            for k, v in buf.items()
        }
        return buf_z, buf

    def warm_init(keys, z, pe, grad, step_size, inverse_mass_matrix=None):
        adapt = wa_init(
            keys, z, pe, grad, step_size, inverse_mass_matrix=inverse_mass_matrix
        )
        keys = adapt.rng_key
        return WarmState(
            keys, z, pe, grad, adapt._replace(rng_key=None),
            jnp.zeros((z.shape[0],), z.dtype),
        )

    def warm_steps(ws, start, n):
        """Advance ``n`` warmup transitions from absolute step ``start``."""

        def body(j, ws):
            i = start + j
            out = transition(
                ws.keys, ws.z, ws.pe, ws.grad, ws.adapt, warmup_max_depth
            )
            keys, adapt_keys = split_keys(out.key, 2)
            adapt = ws.adapt._replace(rng_key=adapt_keys)
            adapt = wa_update(i, adapt, out.accept_prob, out.z, out.pe, out.grad)
            mean_acc = ws.mean_accept + (out.accept_prob - ws.mean_accept) / (
                i + 1
            )
            return WarmState(
                keys, out.z, out.pe, out.grad,
                adapt._replace(rng_key=None), mean_acc,
            )

        return lax.fori_loop(0, n, body, ws)

    def sample_start(ws):
        """Initialize the sampling phase state (buffers + NUTS machines)."""
        c, d = ws.z.shape
        dtype = ws.z.dtype
        buf_z, buf = _empty_buffers(c, d, dtype)
        zero_i = jnp.zeros((c,), jnp.int32)
        zero_f = jnp.zeros((c,), dtype)
        if algo == "NUTS":
            carry = _init_nuts_carry(
                ws.keys, ws.z, ws.pe, ws.grad, blocks,
                ws.adapt.inverse_mass_matrix, ws.adapt.mass_matrix_sqrt,
                max(max_depth, 1),
            )
        else:
            carry = (ws.keys, ws.z, ws.pe, ws.grad)
        return SampleState(carry, buf_z, buf, zero_i, zero_f, ws.adapt)

    def _sample_until_async(ss, target):
        """Harvest loop: advance every chain one leapfrog per iteration;
        chains that finish a trajectory bank the sample and immediately
        start the next one.  Runs until every chain has completed
        ``target`` transitions (chains past the target keep producing
        rather than idling, so chunked calls waste nothing).
        """
        adapt = ss.adapt
        goal = jnp.minimum(target, num_samples)

        def cond_fn(ss):
            return ~jnp.all(ss.trans_idx >= goal)

        def body_fn(ss):
            t = ss.carry
            c = t.z.shape[0]
            d = t.z.shape[1]
            dtype = t.z.dtype
            finished = ss.trans_idx >= num_samples
            t = t._replace(done=t.done | finished)
            t = _nuts_tick(
                t, blocks, pe_grad, adapt.inverse_mass_matrix,
                adapt.step_size, max_depth, max_delta_energy,
            )
            boundary = t.done & ~finished
            acc = t.accept_sum / jnp.maximum(t.n_leaf, 1)
            n1 = ss.trans_idx + 1
            mean_acc = jnp.where(
                boundary,
                ss.mean_accept + (acc - ss.mean_accept) / n1,
                ss.mean_accept,
            )
            keep = boundary & (ss.trans_idx % thinning == 0)
            slot = jnp.where(keep, ss.trans_idx // thinning, num_collect)
            rows = jnp.arange(c)
            buf_z, buf = _bank(ss.buf_z, ss.buf, rows, slot, t, acc, mean_acc)
            trans_idx = jnp.where(boundary, n1, ss.trans_idx)
            # refresh momentum and restart the machines at boundaries
            restart = boundary & (trans_idx < num_samples)
            key, k_mom, k_dir = split_keys(t.key, 3)
            r0 = draw_momentum(
                blocks, adapt.mass_matrix_sqrt, batch_normal(k_mom, d)
            )
            e0 = t.prop_pe + kinetic(blocks, adapt.inverse_mass_matrix, r0)
            fresh = NutsCarry(
                key=key,
                z=t.prop_z, r=r0, grad=t.prop_grad, pe=t.prop_pe,
                zb=t.prop_z, rb=r0, gradb=t.prop_grad, peb=t.prop_pe,
                zf=t.prop_z, rf=r0, gradf=t.prop_grad, pef=t.prop_pe,
                rho=r0,
                prop_z=t.prop_z, prop_grad=t.prop_grad,
                prop_pe=t.prop_pe, prop_energy=e0,
                logw=-e0,
                s_logw=jnp.full((c,), -jnp.inf, dtype),
                s_prop_z=t.prop_z, s_prop_grad=t.prop_grad,
                s_prop_pe=t.prop_pe, s_prop_energy=e0,
                s_prefix=jnp.zeros_like(t.prop_z),
                ck_r=t.ck_r, ck_s=t.ck_s,
                leaf=jnp.zeros((c,), jnp.int32),
                depth=jnp.zeros((c,), jnp.int32),
                direction=batch_rademacher(k_dir).astype(dtype),
                e0=e0,
                accept_sum=jnp.zeros((c,), dtype),
                n_leaf=jnp.zeros((c,), jnp.int32),
                diverging=jnp.zeros((c,), bool),
                done=jnp.zeros((c,), bool),
            )
            t = jax.tree.map(
                lambda new, old: _sel(restart, new, old),
                fresh,
                t._replace(key=key),
            )
            return SampleState(t, buf_z, buf, trans_idx, mean_acc, ss.adapt)

        return lax.while_loop(cond_fn, body_fn, ss)

    def _sample_until_sync(ss, target):
        """HMC path: transitions in lockstep until ``target`` draws."""
        adapt = ss.adapt
        goal = jnp.minimum(target, num_samples)

        def cond_fn(ss):
            return ~jnp.all(ss.trans_idx >= goal)

        def body_fn(ss):
            keys, z, pe, grad = ss.carry
            c = z.shape[0]
            out = transition(keys, z, pe, grad, adapt, max_depth)
            i = ss.trans_idx[0]
            mean_acc = ss.mean_accept + (out.accept_prob - ss.mean_accept) / (
                i + 1
            )
            keep = i % thinning == 0
            slot = jnp.where(keep, i // thinning, num_collect)
            buf_z = ss.buf_z.at[:, slot].set(out.z, mode="drop")
            vals = {
                "energy": out.energy,
                "diverging": out.diverging,
                "num_steps": out.num_steps,
                "accept_prob": out.accept_prob,
                "mean_accept_prob": mean_acc,
            }
            buf = {
                k: v.at[:, slot].set(vals[k], mode="drop")
                for k, v in ss.buf.items()
            }
            return SampleState(
                (out.key, out.z, out.pe, out.grad),
                buf_z, buf, ss.trans_idx + 1, mean_acc, ss.adapt,
            )

        return lax.while_loop(cond_fn, body_fn, ss)

    def sample_until(ss, target):
        if algo == "NUTS":
            return _sample_until_async(ss, target)
        return _sample_until_sync(ss, target)

    def sample_finish(ss):
        if algo == "NUTS":
            t = ss.carry
            keys, z, pe, grad = t.key, t.prop_z, t.prop_pe, t.prop_grad
        else:
            keys, z, pe, grad = ss.carry
        return {
            "keys": keys,
            "z": z,
            "pe": pe,
            "grad": grad,
            "samples_z": ss.buf_z,
            "extras": ss.buf,
            "adapt": ss.adapt,
            "mean_accept_prob": ss.mean_accept,
        }

    def warmup(keys, z, pe, grad, step_size, inverse_mass_matrix=None):
        ws = warm_init(keys, z, pe, grad, step_size, inverse_mass_matrix)
        ws = warm_steps(ws, 0, num_warmup)
        return {
            "keys": ws.keys, "z": ws.z, "pe": ws.pe, "grad": ws.grad,
            "adapt": ws.adapt, "mean_accept_prob": ws.mean_accept,
        }

    def sample(keys, z, pe, grad, adapt):
        ws = WarmState(keys, z, pe, grad, adapt, jnp.zeros_like(pe))
        ss = sample_start(ws)
        ss = sample_until(ss, num_samples)
        return sample_finish(ss)

    def run(keys, z, pe, grad, step_size, inverse_mass_matrix=None):
        w = warmup(keys, z, pe, grad, step_size, inverse_mass_matrix)
        return sample(w["keys"], w["z"], w["pe"], w["grad"], w["adapt"])

    run.warmup = warmup
    run.sample = sample
    run.warm_init = warm_init
    run.warm_steps = warm_steps
    run.sample_start = sample_start
    run.sample_until = sample_until
    run.sample_finish = sample_finish
    return run
