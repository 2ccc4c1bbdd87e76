"""Dense (all-pairs) nonbonded evaluator — the "Reference platform" path.

Chunked, masked O(N^2) evaluation of an arbitrary pair energy function with
exclusions. This plays the role OpenMM's Reference platform plays for the
reference's test suite (SURVEY.md §4): deterministic, f64-capable, the source
of golden energies. The production path is the fixed-capacity cell-list sweep
in ops/neighbors.py — which is checked against this one.

Design notes:
  * mask-don't-branch: every pair is computed, invalid ones multiplied by 0;
  * row-chunked lax.scan keeps peak memory at O(chunk * N);
  * forces come from jax.grad of the energy — no hand-written force kernels
    on this path.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from .pbc import minimum_image


def _pad_rows(a, n_pad):
    if n_pad == 0:
        return a
    pad_width = [(0, n_pad)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad_width)


def dense_pair_energy(
    pair_fn: Callable,
    x: jnp.ndarray,
    box: jnp.ndarray,
    per_particle: Dict[str, jnp.ndarray],
    exclusions: jnp.ndarray,
    r_cut,
    chunk: int = 256,
) -> jnp.ndarray:
    """Sum of pair_fn over all unique pairs with r < r_cut, minus exclusions.

    Args:
      pair_fn: (r, pi: dict, pj: dict) -> energy; pi/pj hold per-particle
        parameters gathered for each side of the pair.
      x: (N, 3) positions.
      box: (3,) periodic box.
      per_particle: dict name -> (N,) parameter arrays (charge, sigma, ...).
      exclusions: (N, M) int32, j-indices excluded for each i, padded with -1.
        Must be symmetric (if j in exc[i] then i in exc[j]); only the j > i
        half is consulted.
      r_cut: scalar cutoff distance.
      chunk: row-chunk size (static).

    Returns total energy (scalar, dtype of x).
    """
    n = x.shape[0]
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk - n

    xp = _pad_rows(x, n_pad)
    excp = _pad_rows(exclusions, n_pad) if n_pad else exclusions
    if n_pad:
        # padded exclusion rows: -1 everywhere
        excp = excp.at[n:].set(-1)
    ppp = {k: _pad_rows(v, n_pad) for k, v in per_particle.items()}

    i_all = jnp.arange(n_chunks * chunk, dtype=jnp.int32)
    j_ids = jnp.arange(n_chunks * chunk, dtype=jnp.int32)[None, :]  # (1, Np)
    j_valid = (j_ids < n)

    x_rows = xp.reshape(n_chunks, chunk, 3)
    i_rows = i_all.reshape(n_chunks, chunk)
    exc_rows = excp.reshape(n_chunks, chunk, -1)
    pp_rows = {k: v.reshape(n_chunks, chunk) for k, v in ppp.items()}

    rc2 = jnp.asarray(r_cut, x.dtype) ** 2

    def chunk_energy(carry, inp):
        xi, ii, exc_i, pp_i = inp
        dx = minimum_image(xi[:, None, :] - xp[None, :, :], box)  # (C, Np, 3)
        r2 = jnp.sum(dx * dx, axis=-1)  # (C, Np)
        mask = (j_ids > ii[:, None]) & j_valid & (r2 < rc2)
        # exclusion mask: j in exc_i (C, M)
        excluded = jnp.any(j_ids[:, None, :] == exc_i[:, :, None], axis=1)
        mask &= ~excluded
        r = jnp.sqrt(jnp.where(mask, r2, 1.0))
        pi = {k: v[:, None] for k, v in pp_i.items()}
        pj = {k: ppp[k][None, :] for k in per_particle}
        e = pair_fn(r, pi, pj)
        return carry + jnp.sum(jnp.where(mask, e, 0.0)), None

    total, _ = jax.lax.scan(
        chunk_energy,
        jnp.zeros((), x.dtype),
        (x_rows, i_rows, exc_rows, pp_rows),
    )
    return total


def pairlist_energy(
    pair_fn: Callable,
    x: jnp.ndarray,
    box: jnp.ndarray,
    pairs: jnp.ndarray,
    pair_params: Dict[str, jnp.ndarray],
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Sum pair_fn over an explicit (P, 2) pair list with per-pair parameters.

    Used for exceptions (atomsmm/forces.py::NonbondedExceptionsForce) and for
    subtracting exclusion contributions where add-then-subtract is appropriate.
    Padded entries are masked (mask=False) — pad indices with 0 and params with
    benign values.
    """
    xi = x[pairs[:, 0]]
    xj = x[pairs[:, 1]]
    dx = minimum_image(xi - xj, box)
    r2 = jnp.sum(dx * dx, axis=-1)
    if mask is None:
        mask = jnp.ones(pairs.shape[0], dtype=bool)
    r = jnp.sqrt(jnp.where(mask, r2, 1.0))
    e = pair_fn(r, pair_params)
    return jnp.sum(jnp.where(mask, e, 0.0))
