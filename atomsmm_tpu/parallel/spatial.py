"""Spatial decomposition across a device mesh (SURVEY.md §2c optional row).

The reference runs on a single device; for atom counts where one chip's
FLOPs bind (~100k+, BASELINE.md config 5) the honest analog of "domain
decomposition" splits the dominant costs over the mesh:

  * pair forces — FORCE decomposition over home cells: every device holds
    the replicated positions/buckets (a few MB — trivially affordable next
    to pair-tile compute) and evaluates the cell-pair tiles for its slice of
    home cells, on the full (symmetric) stencil so each atom's force is
    complete within its home device; one `psum` combines the
    disjoint per-device force arrays. Communication per evaluation: one
    (N, 3) psum + a scalar — no halo bookkeeping, no load-imbalance cliffs,
    exact same numerics as the single-device full-stencil path.

  * PME reciprocal — ATOM-sharded charge spreading (the scatter-heavy,
    dominant part): each device spreads its atom shard onto a local grid,
    one grid `psum` combines them, and the small FFT + convolution runs
    replicated. Gradient flows through the shard_map, so forces come from
    the same `jax.grad` as the single-device path.

Both are pure functions of a `jax.sharding.Mesh`; the driver-facing demo
lives in `__graft_entry__.dryrun_multichip` (replica axis) and
tests/test_parallel.py (virtual 8-device CPU mesh — SURVEY.md §2c says
validate sharding without real chips).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.neighbors import _cell_pair_sums


def sharded_cell_pair_energy_forces(
    pair_fn, x, box, per_particle, spec, bucket, r_cut, mesh: Mesh,
    axis: str = "dp",
):
    """(energy, forces (N, 3)) — force decomposition of the cell-pair sweep
    over `mesh[axis]`. Matches ops/neighbors.cell_pair_energy_forces on the
    full-stencil path exactly (same tiles, same summation order per cell)."""
    n = x.shape[0]
    ncells, cap = bucket.shape
    ndev = mesh.shape[axis]
    nper = -(-ncells // ndev)
    ids = jnp.concatenate(
        [jnp.arange(ncells, dtype=jnp.int32),
         jnp.full((ndev * nper - ncells,), ncells, jnp.int32)]
    )
    # force decomposition needs complete per-home-cell forces -> symmetric
    # full stencil (the Newton half-stencil's reaction write-back would cross
    # shard boundaries)
    spec_full = dataclasses.replace(spec, half_stencil=False)

    def local(cell_ids):
        e, f_bucket = _cell_pair_sums(
            spec_full, pair_fn, x, box, per_particle, bucket, r_cut,
            with_forces=True, cell_ids=cell_ids,
        )
        rows = jnp.where(
            cell_ids < ncells, cell_ids, ncells
        )
        bucket_pad = jnp.concatenate(
            [bucket, jnp.full((1, cap), n, jnp.int32)]
        )
        slots = bucket_pad[rows]
        forces = jnp.zeros((n + 1, 3), x.dtype)
        forces = forces.at[slots.reshape(-1)].add(
            f_bucket.reshape(-1, 3), mode="drop"
        )
        return (
            jax.lax.psum(e, axis),
            jax.lax.psum(forces[:n], axis),
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(P(), P()),
        check_vma=False,
    )(ids)


def sharded_cell_pair_energy(
    pair_fn, x, box, per_particle, spec, bucket, r_cut, mesh: Mesh,
    axis: str = "dp",
):
    """Energy-only variant of sharded_cell_pair_energy_forces (observe/report
    path)."""
    ncells = bucket.shape[0]
    ndev = mesh.shape[axis]
    nper = -(-ncells // ndev)
    ids = jnp.concatenate(
        [jnp.arange(ncells, dtype=jnp.int32),
         jnp.full((ndev * nper - ncells,), ncells, jnp.int32)]
    )
    spec_full = dataclasses.replace(spec, half_stencil=False)

    def local(cell_ids):
        e, _ = _cell_pair_sums(
            spec_full, pair_fn, x, box, per_particle, bucket, r_cut,
            with_forces=False, cell_ids=cell_ids,
        )
        return jax.lax.psum(e, axis)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis),), out_specs=P(),
        check_vma=False,
    )(ids)


def sharded_pme_reciprocal_energy(
    x, box, q, alpha, grid_shape, mesh: Mesh, axis: str = "dp",
    order: int = 4, chunk: int = 2048,
):
    """Reciprocal-space PME energy with atom-sharded spreading + one grid
    psum; FFT/convolution replicated. Matches ops/pme.pme_reciprocal_energy.

    Fallback path: use sharded_pme_reciprocal_energy_fft when K1 and K2
    divide the device count — it additionally distributes the FFT +
    convolution (slab decomposition) and halves the spreading traffic
    (reduce-scatter instead of all-reduce)."""
    from ..ops.pme import pme_reciprocal_from_grid, spread_charges

    n = x.shape[0]
    ndev = mesh.shape[axis]
    nper = -(-n // ndev)
    pad = ndev * nper - n
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    qp = jnp.pad(q, (0, pad))  # zero charge -> no contribution

    def local(xs, qs):
        grid = spread_charges(xs, box, qs, grid_shape, order,
                              min(chunk, nper))
        grid = jax.lax.psum(grid, axis)
        return pme_reciprocal_from_grid(grid, box, alpha, grid_shape, order)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )(xp, qp)


def sharded_pme_reciprocal_energy_fft(
    x, box, q, alpha, grid_shape, mesh: Mesh, axis: str = "dp",
    order: int = 4, chunk: int = 2048,
):
    """Fully distributed reciprocal path — slab-decomposed FFT
    (SURVEY.md §2c TP row; VERDICT r3 #5: "the FFT is precisely the part
    worth sharding").

    Pipeline, per device (D devices along `axis`):
      1. spread the local ATOM shard onto a full grid (dense one-hot matmul
         spreading, unchanged), then `psum_scatter` along K1 — each device
         keeps only its (K1/D, K2, K3) slab. Communication: one
         reduce-scatter = HALF the bytes of the fallback's all-reduce, and
         no device ever holds the summed K^3 grid.
      2. local rfft over K3 and fft over K2 (both axes device-local).
      3. one `all_to_all` transpose: (K1/D, K2, K3r) -> (K1, K2/D, K3r) —
         the only full-spectrum shuffle, riding the interconnect.
      4. local fft over K1; multiply by THIS DEVICE'S block of the
         influence function (pme_influence(k2_indices=...)); psum the
         scalar.
    Forces come from jax.grad through the whole pipeline — the transposes
    of psum_scatter/all_to_all are all_gather/all_to_all, which XLA lowers
    back onto the interconnect (NVLink between GPUs).

    Requires K1 % D == 0 and K2 % D == 0 (choose_pme_parameters
    multiple_of=D). Matches pme_reciprocal_energy to roundoff.
    """
    from ..ops.pme import pme_influence, spread_charges

    k1, k2, k3 = grid_shape
    ndev = mesh.shape[axis]
    if k1 % ndev or k2 % ndev:
        raise ValueError(
            f"slab FFT needs K1 ({k1}) and K2 ({k2}) divisible by the "
            f"device count ({ndev}); build the grid with "
            "choose_pme_parameters(..., multiple_of=n_devices)"
        )
    n = x.shape[0]
    nper = -(-n // ndev)
    pad = ndev * nper - n
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    qp = jnp.pad(q, (0, pad))  # zero charge -> no contribution

    def local(xs, qs):
        grid = spread_charges(xs, box, qs, grid_shape, order,
                              min(chunk, nper))
        slab = jax.lax.psum_scatter(
            grid, axis, scatter_dimension=0, tiled=True
        )  # (K1/D, K2, K3)
        s = jnp.fft.rfft(slab, axis=2)
        s = jnp.fft.fft(s, axis=1)
        s = jax.lax.all_to_all(
            s, axis, split_axis=1, concat_axis=0, tiled=True
        )  # (K1, K2/D, K3r)
        s = jnp.fft.fft(s, axis=0)
        d = jax.lax.axis_index(axis)
        k2_idx = d * (k2 // ndev) + jnp.arange(k2 // ndev)
        w = pme_influence(box, alpha, grid_shape, order, x.dtype,
                          k2_indices=k2_idx)
        return jax.lax.psum(jnp.sum(w * jnp.abs(s) ** 2), axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )(xp, qp)
