"""Atom-block (tile) pair evaluation — slot-count-optimal nonbonded path.

The cell-bucket formulation (ops/neighbors.py) pays twice for fixed-capacity
padding: home rows are ~55% occupied and candidate columns inherit the same
factor, so only ~2.5% of tile slots are real in-range pairs at water density.
This module replaces cells with the NAMD/GPU-style *tile list*, reshaped for
elementwise evaluation:

  * atoms are sorted by the serpentine (boustrophedon) order of their
    fine-grid cell — consecutive 64-atom BLOCKS are then spatially compact,
    and home blocks are 100% dense by construction;
  * per home block, a fixed-capacity list of candidate blocks is built from
    periodic AABB distances (block pair kept iff gap(AABB_i, AABB_j) <=
    r_build); Newton applies at block level: only j >= i is listed, each
    block pair is evaluated once;
  * evaluation is the same mask-don't-branch (B, K*B) tile sweep as the cell
    path — one coarse gather to stage candidate features, pure elementwise
    math, no fine-grained gathers;
  * cross-block reaction forces scatter back by construction: candidate
    columns of block j live at sorted positions j*B..j*B+B, so the
    write-back is a single indexed add in sorted space, then one unsort.

Measured at 30k-atom water (v5e): ~2.4x fewer slots than cell buckets for
the near force and ~3.7x for the far force at equal physics.

Rebuild policy mirrors cells: valid while no atom moved more than skin/2
(xref displacement check); candidate-list overflow is flagged, never
silently dropped (SURVEY.md §2b N2).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import pytree_dataclass, static_field
from .pbc import minimum_image
from .rv import pair_eval

def _keys(name: str):
    prefix = "nbr" if name == "default" else f"nbr_{name}"
    return (
        f"{prefix}_order",     # (NB*B,) sorted atom ids, sentinel n padded
        f"{prefix}_cand",      # (NB, K) candidate block ids, -1 padded
        f"{prefix}_xref",
        f"{prefix}_boxref",
        f"{prefix}_overflow",
    )


@pytree_dataclass
class BlockNeighborSpec:
    """Static-shape tile-list configuration (counterpart of NeighborSpec)."""

    exclusions: jnp.ndarray = None   # (N, M) int32, -1 padded
    r_build: jnp.ndarray = None      # scalar: cutoff + skin
    skin: jnp.ndarray = None         # scalar
    block_size: int = static_field(default=64)
    n_blocks: int = static_field(default=1)
    max_cand: int = static_field(default=16)   # K
    block_chunk: int = static_field(default=8)  # home blocks per scan step
    sort_grid: Tuple[int, int, int] = static_field(default=(8, 8, 8))

    @property
    def n_padded(self) -> int:
        return self.n_blocks * self.block_size


def _serpentine_key(xw, box, grid):
    """Boustrophedon cell ordering: walk z, flip direction each z-row, flip y
    each x-plane — CONSECUTIVE cells are always spatially adjacent, so blocks
    cut from the sorted order have bounded AABBs. (Morton order has octant
    jumps: a block straddling one produces a box-spanning AABB whose
    candidate list blows up — measured K_max 168 vs mean 18 at 30k water.)"""
    gx, gy, gz = grid
    g = jnp.asarray(grid, xw.dtype)
    c = jnp.clip((xw * (g / box)).astype(jnp.int32),
                 0, jnp.asarray(grid, jnp.int32) - 1)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    ey = jnp.where(cx % 2 == 1, gy - 1 - cy, cy)
    row = cx * gy + ey
    ez = jnp.where(row % 2 == 1, gz - 1 - cz, cz)
    return (row * gz + ez).astype(jnp.int32)


def sorted_block_aabbs(x, box, sort_grid, block_size, n_blocks, n_padded):
    """Shared prologue of the block/tile-pair builders: serpentine-sort
    atoms, cut consecutive blocks, compute per-block AABBs from wrapped
    coordinates. Returns (order, ctr, ext, empty)."""
    n = x.shape[0]
    dtype = x.dtype
    xw = x - box * jnp.floor(x * (1.0 / box))
    order = jnp.argsort(_serpentine_key(xw, box, sort_grid)).astype(jnp.int32)
    order = jnp.concatenate([order, jnp.full((n_padded - n,), n, jnp.int32)])

    xw_pad = jnp.concatenate([xw, jnp.zeros((1, 3), dtype)])
    xs = xw_pad[order].reshape(n_blocks, block_size, 3)
    real = (order < n).reshape(n_blocks, block_size, 1)
    big = jnp.asarray(1e30, dtype)
    lo = jnp.min(jnp.where(real, xs, big), axis=1)       # (NB, 3)
    hi = jnp.max(jnp.where(real, xs, -big), axis=1)
    empty = ~jnp.any(real, axis=1)[:, 0]
    ctr = 0.5 * (lo + hi)
    ext = 0.5 * (hi - lo)
    return order, ctr, ext, empty


def build_block_lists(spec: BlockNeighborSpec, x, box):
    """(order, cand, overflow): serpentine-sort atoms, list candidate blocks
    by periodic AABB distance (Newton: j >= i only). All device-side."""
    n = x.shape[0]
    b = spec.block_size
    nb = spec.n_blocks
    k_max = spec.max_cand
    dtype = x.dtype

    order, ctr, ext, empty = sorted_block_aabbs(
        x, box, spec.sort_grid, b, nb, spec.n_padded
    )

    # periodic center distance minus extents, clamped at 0 per dim
    dc = jnp.abs(minimum_image(ctr[:, None, :] - ctr[None, :, :], box))
    gap = jnp.maximum(dc - ext[:, None, :] - ext[None, :, :], 0.0)
    d2 = jnp.sum(gap * gap, axis=-1)                      # (NB, NB)

    i_ids = jnp.arange(nb, dtype=jnp.int32)
    rb2 = (spec.r_build.astype(dtype)) ** 2
    keep = (
        (d2 <= rb2)
        & (i_ids[None, :] >= i_ids[:, None])              # Newton: j >= i
        & ~empty[None, :]
        & ~empty[:, None]
    )
    # compact each row to its first K hits (ascending j keeps self first)
    key = jnp.where(keep, i_ids[None, :], nb)
    skey = jnp.sort(key, axis=1)[:, :k_max]
    cand = jnp.where(skey < nb, skey, -1).astype(jnp.int32)
    overflow = jnp.any(jnp.sum(keep, axis=1) > k_max)
    return order, cand, overflow


def block_list_extras(spec, x, box, name: str = "default") -> Dict[str, jnp.ndarray]:
    ko, kc, kx, kbox, kov = _keys(name)
    order, cand, overflow = build_block_lists(spec, x, box)
    return {ko: order, kc: cand, kx: x, kbox: box, kov: overflow}


def needs_rebuild(spec, extra, x, box, name: str = "default"):
    from .neighbors import moved_beyond_half_skin

    _, _, kx, kbox, _ = _keys(name)
    return moved_beyond_half_skin(spec.skin, extra[kx], extra[kbox], x, box)


def update_blocks(spec, extra, x, box, name: str = "default",
                  force: bool = False):
    """force=True rebuilds unconditionally — see
    neighbors.update_neighbors: grouped update loops must force at group
    boundaries or the skin/2 rebuild trigger races the d1+d2 staleness
    bound."""
    ko, kc, kx, kbox, kov = _keys(name)

    def rebuild(_):
        order, cand, overflow = build_block_lists(spec, x, box)
        return order, cand, x, box, extra[kov] | overflow

    def keep(_):
        return extra[ko], extra[kc], extra[kx], extra[kbox], extra[kov]

    if force:
        order, cand, xref, boxref, overflow = rebuild(None)
    else:
        order, cand, xref, boxref, overflow = jax.lax.cond(
            needs_rebuild(spec, extra, x, box, name), rebuild, keep, None
        )
    return {ko: order, kc: cand, kx: xref, kbox: boxref, kov: overflow}


def block_pair_sums(spec, pair_fn, x, box, per_particle, order, cand, r_cut,
                    with_forces: bool):
    """Core tile sweep: scan over home-block chunks.

    Returns (energy, f_home (NB, B, 3) or None, f_cand (NB, K, B, 3) or None)
    in SORTED space.
    """
    n = x.shape[0]
    b = spec.block_size
    nb = spec.n_blocks
    k_max = spec.max_cand
    dtype = x.dtype

    cols = [x] + [p[:, None].astype(dtype) for p in per_particle.values()]
    feats = jnp.concatenate(cols, axis=1)
    feats = jnp.concatenate([feats, jnp.zeros((1, feats.shape[1]), dtype)])
    fs = feats[order]                                  # (NB*B, 3+P) sorted
    fs = fs.reshape(nb, b, -1)
    ids = order.reshape(nb, b)                         # sentinel n

    exc = spec.exclusions
    exc_pad = jnp.concatenate([exc, jnp.full((1, exc.shape[1]), -1, exc.dtype)])
    exc_s = exc_pad[jnp.clip(order, 0, n)].reshape(nb, b, -1)

    chunk = min(spec.block_chunk, nb)
    n_chunks = -(-nb // chunk)
    rows = jnp.arange(n_chunks * chunk, dtype=jnp.int32).reshape(
        n_chunks, chunk
    )
    rc2 = jnp.asarray(r_cut, dtype) ** 2
    names = list(per_particle.keys())

    def chunk_body(carry, blk_ids):
        ok = blk_ids < nb
        bi = jnp.where(ok, blk_ids, 0)
        home_f = fs[bi]                                # (C, B, 3+P)
        home_id = jnp.where(ok[:, None], ids[bi], n)
        home_exc = exc_s[bi]                           # (C, B, M)

        cj = cand[bi]                                  # (C, K)
        valid = ok[:, None] & (cj >= 0)
        cjc = jnp.where(valid, cj, 0)
        cand_f = fs[cjc].reshape(bi.shape[0], k_max * b, -1)
        cand_id = jnp.where(
            valid[:, :, None], ids[cjc], n
        ).reshape(bi.shape[0], k_max * b)

        dx = minimum_image(
            home_f[:, :, None, :3] - cand_f[:, None, :, :3], box
        )
        r2 = jnp.sum(dx * dx, axis=-1)                 # (C, B, K*B)
        mask = (
            (home_id[:, :, None] < n)
            & (cand_id[:, None, :] < n)
            & (home_id[:, :, None] != cand_id[:, None, :])
            & (r2 < rc2)
        )
        excluded = jnp.any(
            cand_id[:, None, None, :] == home_exc[:, :, :, None], axis=2
        )
        mask &= ~excluded

        # Newton weights: the self block (cand id == home id) holds both
        # orderings -> energy weight 1/2, no reaction; cross blocks (j > i)
        # appear once -> weight 1 + reaction write-back.
        is_self = (cjc == bi[:, None]) & valid         # (C, K)
        w_col = jnp.where(is_self, 0.5, 1.0)[:, None, :, None]  # (C,1,K,1)
        w_col = jnp.broadcast_to(
            w_col, (bi.shape[0], 1, k_max, b)
        ).reshape(bi.shape[0], 1, k_max * b)
        j_col = jnp.where(is_self | ~valid, 0.0, 1.0)[:, :, None]  # (C,K,1)

        r2m = jnp.where(mask, r2, 1.0)
        pi = {k: home_f[:, :, None, 3 + i] for i, k in enumerate(names)}
        pj = {k: cand_f[:, None, :, 3 + i] for i, k in enumerate(names)}
        u, dudr2 = pair_eval(pair_fn, r2m, pi, pj, with_forces)
        if with_forces:
            fmag = jnp.where(mask, 2.0 * dudr2, 0.0)
            fvec = fmag[..., None] * dx                # (C, B, K*B, 3)
            f_home = -jnp.sum(fvec, axis=2)            # (C, B, 3)
            f_cand = jnp.sum(fvec, axis=1).reshape(
                bi.shape[0], k_max, b, 3
            ) * j_col[..., None]
        else:
            f_home = f_cand = None
        e = jnp.sum(jnp.where(mask, u, 0.0) * w_col)
        return carry + e, (f_home, f_cand)

    energy, (f_home_c, f_cand_c) = jax.lax.scan(
        chunk_body, jnp.zeros((), dtype), rows
    )
    if not with_forces:
        return energy, None, None
    f_home = f_home_c.reshape(n_chunks * chunk, b, 3)[:nb]
    f_cand = f_cand_c.reshape(n_chunks * chunk, k_max, b, 3)[:nb]
    return energy, f_home, f_cand


def block_pair_energy(pair_fn, x, box, per_particle, spec, order, cand, r_cut):
    e, _, _ = block_pair_sums(
        spec, pair_fn, x, box, per_particle, order, cand, r_cut, False
    )
    return e


def block_pair_energy_forces(pair_fn, x, box, per_particle, spec, order, cand,
                             r_cut):
    """(energy, forces (N, 3)): tile sweep + Newton reaction write-back in
    sorted space + one unsort scatter."""
    n = x.shape[0]
    b = spec.block_size
    nb = spec.n_blocks
    e, f_home, f_cand = block_pair_sums(
        spec, pair_fn, x, box, per_particle, order, cand, r_cut, True
    )
    f_sorted = f_home.reshape(nb * b, 3)
    # candidate columns of block j live at sorted rows j*B..j*B+B
    tgt = jnp.where(cand >= 0, cand, nb)[:, :, None] * b + jnp.arange(
        b, dtype=jnp.int32
    )[None, None, :]                                   # (NB, K, B)
    f_sorted = jnp.concatenate([f_sorted, jnp.zeros((b, 3), f_sorted.dtype)])
    f_sorted = f_sorted.at[tgt.reshape(-1)].add(
        f_cand.reshape(-1, 3), mode="drop"
    )[: nb * b]
    forces = jnp.zeros((n + 1, 3), x.dtype)
    forces = forces.at[order].add(f_sorted, mode="drop")
    return e, forces[:n]


def make_block_spec(
    box,
    n: int,
    r_cut_max: float,
    skin: float = 0.1,
    exclusions=None,
    block_size: int = 64,
    max_cand: int | None = None,
    occupancy_from=None,
    cand_safety: float = 1.25,
    block_chunk: int | None = None,
) -> BlockNeighborSpec:
    """Host-side setup. K (max candidate blocks per home block) comes from
    geometry — ((s + 2 r_build)^3 rho / B) / 2 with a fragmentation margin —
    or, preferably, from a measured configuration (`occupancy_from`)."""
    box = np.asarray(box, np.float64)
    r_build = float(r_cut_max) + float(skin)
    nb = -(-n // block_size)
    rho = n / float(np.prod(box))
    side = (block_size / rho) ** (1.0 / 3.0)
    # serpentine sort grid: cells of roughly one block volume keep blocks
    # compact without Morton's octant jumps
    sort_grid = tuple(max(1, int(round(b / side))) for b in box)
    if max_cand is None:
        # Minkowski sum of the AABB-overlap cube (side 2*s) with a ball of
        # radius r_build — the exact acceptance region for equal cubic
        # blocks — times a fragmentation margin for non-cubic snake blocks.
        # (The naive (s + 2r)^3 underestimates ~2x: measured mean 52 vs est
        # 18 at 30k water, r_build = 1.0.)
        a = 2.0 * side
        vol = (
            a ** 3
            + 6.0 * a * a * r_build
            + 3.0 * math.pi * a * r_build ** 2
            + (4.0 / 3.0) * math.pi * r_build ** 3
        )
        est = vol * rho / block_size / 2.0
        frag = 2.0  # snake-wrap blocks: measured max/mean ~1.9 on lattices
        max_cand = int(math.ceil(est * max(cand_safety, 1.0) * frag)) + 4
    max_cand = min(max_cand, nb)
    if exclusions is None:
        exclusions = jnp.full((n, 1), -1, jnp.int32)
    if block_chunk is None:
        per_blk = block_size * max_cand * block_size * 4
        block_chunk = max(1, min(nb, (48 << 20) // max(per_blk, 1)))
    spec = BlockNeighborSpec(
        exclusions=jnp.asarray(exclusions),
        r_build=jnp.asarray(r_build),
        skin=jnp.asarray(float(skin)),
        block_size=block_size,
        n_blocks=nb,
        max_cand=max_cand,
        block_chunk=block_chunk,
        sort_grid=sort_grid,
    )
    if occupancy_from is not None:
        spec = retune_block_spec(spec, occupancy_from, box, cand_safety)
    return spec


def retune_block_spec(spec: BlockNeighborSpec, x, box, safety: float = 1.25):
    """Measure the real max candidate-block count for configuration x and
    resize K (tile work scales linearly with K)."""
    import dataclasses

    wide = dataclasses.replace(spec, max_cand=spec.n_blocks)
    _, cand, _ = build_block_lists(wide, jnp.asarray(x), jnp.asarray(box))
    count = int(jnp.max(jnp.sum(cand >= 0, axis=1)))
    k = min(int(math.ceil(count * safety)) + 2, spec.n_blocks)
    per_blk = spec.block_size * k * spec.block_size * 4
    chunk = max(1, min(spec.n_blocks, (48 << 20) // max(per_blk, 1)))
    return dataclasses.replace(spec, max_cand=k, block_chunk=chunk)
