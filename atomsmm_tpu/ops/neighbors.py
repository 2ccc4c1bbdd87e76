"""Cell-list pair evaluation — the production nonbonded path.

Replacement for OpenMM's neighbor/cell list machinery (SURVEY.md §2b N2).
The per-atom compacted neighbor list (gather (N, K, 3) every step) is not
used; evaluation runs on the *cell-block* formulation, whose tiles are
regular and fully static in shape:

  * rebuild (cheap, every ~50-200 steps, on-demand): bin atoms into a static
    cell grid by one argsort + scatter into fixed-capacity buckets
    (ncells, cap) of atom ids, sentinel-padded;
  * evaluation (every step, fully regular): stage positions+parameters into
    bucket layout with ONE coarse row gather, then for each home cell compute
    masked pair interactions against the S neighboring cells' blocks —
    (cap, S*cap) tiles of elementwise math, no fine-grained gathers;
  * forces are explicit and symmetric: F_i = -sum_cand u'(r) r_hat, no
    autodiff scatter in the hot loop; u and u' come from one jvp sweep;
  * mask-don't-branch: sentinel slots, self pairs, out-of-range and excluded
    pairs are masked, never branched on.

Static shapes: grid dims, capacity, neighborhood size S, and the scan chunk
are fixed at setup (NeighborSpec); bucket overflow is detected and flagged,
never silently dropped. The bucketing is valid while no atom moved more than
skin/2 since the rebuild (checked against stored reference positions).
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

# State.extra keys used by the neighbor subsystem (default spec; named
# specs use nbr_<name>_bucket etc.)
NBR_BUCKET = "nbr_bucket"
NBR_XREF = "nbr_xref"
NBR_BOXREF = "nbr_boxref"
NBR_OVERFLOW = "nbr_overflow"


def _keys(name: str):
    if name == "default":
        return NBR_BUCKET, NBR_XREF, NBR_BOXREF, NBR_OVERFLOW
    return (
        f"nbr_{name}_bucket",
        f"nbr_{name}_xref",
        f"nbr_{name}_boxref",
        f"nbr_{name}_overflow",
    )


def _cover_key(name: str) -> str:
    return "nbr_undercover" if name == "default" else f"nbr_{name}_undercover"


def _constrained_dims(spec: "NeighborSpec"):
    """Dims where the stencil does NOT wrap the whole (periodic) grid.
    Along a wrapping dim (2*reach+1 >= grid cells) every cell pair is a
    candidate regardless of the cell width, so coverage can never be lost
    there — without this mask a small-grid NPT compression would raise a
    FALSE fatal coverage error (grid 2-3 systems are common in tests)."""
    return np.asarray([2 * r + 1 < g
                       for r, g in zip(spec.reach, spec.grid)])


def coverage_deficient(spec: "NeighborSpec", box):
    """True when the stencil reach (fixed at setup) no longer covers the
    cutoff at the *current* box — e.g. after an NPT shrink. Silently dropping
    pairs is the failure mode this guards (ADVICE r01 medium): overflow is
    flagged elsewhere, under-coverage was not."""
    cd = _constrained_dims(spec)
    if not cd.any():
        return jnp.zeros((), bool)
    from .pbc import perp_widths

    dtype = jnp.asarray(box).dtype
    idx = jnp.asarray(np.nonzero(cd)[0])  # static size (jit-safe indexing)
    grid = jnp.asarray(spec.grid, dtype)
    reach = jnp.asarray(spec.reach, dtype)
    r_cut = spec.r_build - spec.skin
    covered = perp_widths(box) / grid * reach
    return jnp.any(covered[idx] < r_cut.astype(dtype))


def effective_skin(spec: "NeighborSpec", box):
    """Displacement margin actually available at the CURRENT box.

    spec.skin is the geometric margin at the SETUP box (reach*w - r_cut,
    capped). After an NPT shrink the margin is smaller; gating rebuilds or
    the staleness guard on the setup skin would then under-trigger and
    silently miss pairs in the shrunken-margin band between spec.skin and
    coverage loss. Along wrapping dims coverage is unconditional, so only
    constrained dims bound the margin."""
    cd = _constrained_dims(spec)
    dtype = jnp.asarray(box).dtype
    skin = spec.skin.astype(dtype)
    if not cd.any():
        return skin
    from .pbc import perp_widths

    idx = jnp.asarray(np.nonzero(cd)[0])  # static size (jit-safe indexing)
    grid = jnp.asarray(spec.grid, dtype)
    reach = jnp.asarray(spec.reach, dtype)
    r_cut = (spec.r_build - spec.skin).astype(dtype)
    margin = jnp.min((perp_widths(box) / grid * reach)[idx]) - r_cut
    return jnp.minimum(skin, jnp.maximum(margin, 0.0))


def iter_specs(system):
    """(name, spec) pairs for every neighbor spec attached to a system."""
    if getattr(system, "neighbors", None) is not None:
        yield "default", system.neighbors
    for name, spec in (getattr(system, "extra_neighbor_specs", None) or {}).items():
        yield name, spec


@pytree_dataclass
class NeighborSpec:
    """Static-shape cell-list configuration, attached to a System.

    nbr_cells is the precomputed (ncells, S) map of neighboring cell ids,
    -1-padded after deduplication (small periodic grids repeat cells; without
    dedup pairs would be double-counted).
    """

    nbr_cells: jnp.ndarray = None          # (ncells, S) int32, -1 padded
    exclusions: jnp.ndarray = None         # (N, M) int32, -1 padded
    r_build: jnp.ndarray = None            # scalar: max cutoff + skin
    skin: jnp.ndarray = None               # scalar
    # half-stencil (Newton) maps: column 0 is the self cell, the rest are the
    # lexicographically-positive directions; inv[c, k] = c - d_k. None when
    # the grid is too small (direction collisions) — full stencil then.
    nbr_cells_half: jnp.ndarray = None     # (ncells, S_half) int32
    inv_cells_half: jnp.ndarray = None     # (ncells, S_half) int32
    grid: Tuple[int, int, int] = static_field(default=(1, 1, 1))
    reach: Tuple[int, int, int] = static_field(default=(1, 1, 1))
    cell_capacity: int = static_field(default=64)
    cell_chunk: int = static_field(default=4)  # home cells per scan step
    half_stencil: bool = static_field(default=False)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.grid))


def _neighbor_cell_map(grid, reach=(1, 1, 1)) -> np.ndarray:
    """Host-side: for each cell, the unique neighboring cell ids within
    +-reach cells per dimension (periodic), -1 padded."""
    nx, ny, nz = grid
    rx, ry, rz = reach
    ncells = nx * ny * nz
    s_max = (2 * rx + 1) * (2 * ry + 1) * (2 * rz + 1)
    out = np.full((ncells, s_max), -1, dtype=np.int32)
    for cx in range(nx):
        for cy in range(ny):
            for cz in range(nz):
                cid = (cx * ny + cy) * nz + cz
                seen = set()
                for dx in range(-rx, rx + 1):
                    for dy in range(-ry, ry + 1):
                        for dz in range(-rz, rz + 1):
                            nid = (
                                ((cx + dx) % nx) * ny + ((cy + dy) % ny)
                            ) * nz + ((cz + dz) % nz)
                            seen.add(nid)
                cells = sorted(seen)
                out[cid, : len(cells)] = cells
    # trim fully-padded columns (small grids dedup heavily)
    used = int((out >= 0).sum(axis=1).max())
    return out[:, :used]


def _half_stencil_maps(grid, reach):
    """(nbr_half, inv_half) or (None, None) when the periodic grid is too
    small for collision-free direction maps (any dim < 2*reach + 1)."""
    nx, ny, nz = grid
    rx, ry, rz = reach
    if nx < 2 * rx + 1 or ny < 2 * ry + 1 or nz < 2 * rz + 1:
        return None, None
    dirs = [(0, 0, 0)]
    for dx in range(-rx, rx + 1):
        for dy in range(-ry, ry + 1):
            for dz in range(-rz, rz + 1):
                if (dx, dy, dz) > (0, 0, 0):
                    dirs.append((dx, dy, dz))
    ncells = nx * ny * nz
    nbr = np.zeros((ncells, len(dirs)), np.int32)
    inv = np.zeros((ncells, len(dirs)), np.int32)
    for cx in range(nx):
        for cy in range(ny):
            for cz in range(nz):
                cid = (cx * ny + cy) * nz + cz
                for k, (dx, dy, dz) in enumerate(dirs):
                    nbr[cid, k] = (
                        ((cx + dx) % nx) * ny + ((cy + dy) % ny)
                    ) * nz + ((cz + dz) % nz)
                    inv[cid, k] = (
                        ((cx - dx) % nx) * ny + ((cy - dy) % ny)
                    ) * nz + ((cz - dz) % nz)
    return nbr, inv


def _max_cell_occupancy(x, box, grid) -> int:
    """Host-side: max atoms in any cell of `grid` for configuration x
    (either box form; matrix boxes bin fractionally, matching
    build_cell_buckets)."""
    x = np.asarray(x)
    box = np.asarray(box, np.float64)
    grid_a = np.asarray(grid)
    if not np.isfinite(x).all():
        # Non-finite positions clip every NaN atom into cell 0, so the
        # "measured" occupancy becomes ~N and the retuned capacity sizes a
        # pair matrix quadratic in N (observed: a diverged 16 fs melt fed a
        # 34504-capacity spec whose compile requested a 66 GB intermediate).
        # Diverged dynamics must fail loudly, not as a compiler OOM.
        bad = int((~np.isfinite(x).all(axis=-1)).sum())
        raise FloatingPointError(
            f"{bad}/{x.shape[0]} positions are non-finite — the trajectory "
            "has diverged (timestep too large for this state?); refusing to "
            "retune neighbor capacities from it"
        )
    if box.ndim == 2:
        s = x @ np.linalg.inv(box)
        s -= np.floor(s)
        c3 = np.clip((s * grid_a).astype(np.int64), 0, grid_a - 1)
    else:
        w = box / grid_a
        xw = x - box * np.floor(x / box)
        c3 = np.clip((xw / w).astype(np.int64), 0, grid_a - 1)
    cid = (c3[:, 0] * grid[1] + c3[:, 1]) * grid[2] + c3[:, 2]
    return int(np.bincount(cid, minlength=int(np.prod(grid_a))).max())


def retune_spec(spec: "NeighborSpec", x, box, safety: float = 1.15,
                floor: int = 0) -> "NeighborSpec":
    """Resize a spec's cell capacity to the MEASURED max occupancy of `x`
    (same grid/stencil). Pair-slot work scales with capacity^2, and liquid
    density fluctuations are far below the cold-start sizing margin, so
    retuning on an equilibrated configuration is a ~2x throughput lever.
    Returns a new spec (static shape change -> step recompiles once).

    `floor` sets a minimum capacity. Overflow auto-recovery passes the
    spec's current capacity + 4 here: the recovery loop restores the
    PRE-chunk state and replays the chunk with the same RNG, so a retune
    measured on the pre-chunk configuration that SHRANK capacity (or merely
    reproduced it) would deterministically overflow again — capacities must
    grow monotonically for the retry loop to make progress."""
    import dataclasses

    occ = _max_cell_occupancy(x, box, spec.grid)
    # round to 4, +1 absolute margin: pair work scales with cap^2, so coarse
    # rounding is expensive — a 12^3 near grid quantized 32 -> 40 costs 56%
    # more slots. Tight safety is safe because Context.step auto-recovers
    # from capacity overflow (restore + retune + re-run).
    cap = ((max(int(math.ceil(occ * safety)) + 1, floor) + 3) // 4) * 4
    s = spec.nbr_cells.shape[1]
    per_cell = cap * s * cap * 4
    chunk = max(1, min(spec.ncells, (48 << 20) // max(per_cell, 1)))
    return dataclasses.replace(spec, cell_capacity=cap, cell_chunk=chunk)


def retune_neighbor_specs(system, x, box, safety: float = 1.15,
                          grow_only: bool = False, floors=None):
    """Retune every neighbor spec attached to a system (see retune_spec /
    blocks.retune_block_spec). grow_only floors each capacity at its
    current value + 4 — required by overflow auto-recovery, whose
    restore-and-replay loop only makes progress if capacities grow
    monotonically (retune_spec docstring).

    `floors` optionally maps spec key ("default" or an extra-spec name) to a
    minimum cell capacity — used by bench.py to replay the high-water
    capacities a prior full run settled on (bench_data/caps.json), so a
    capture run does zero overflow->retune recompiles (VERDICT r4 #1d)."""
    from ..utils import replace as dreplace
    from .blocks import BlockNeighborSpec, retune_block_spec

    if getattr(system, "neighbors", None) is None:
        return system
    floors = floors or {}

    def one(spec, key):
        if isinstance(spec, BlockNeighborSpec):
            return retune_block_spec(spec, x, box, max(safety, 1.15))
        floor = spec.cell_capacity + 4 if grow_only else 0
        floor = max(floor, int(floors.get(key, 0)))
        return retune_spec(spec, x, box, safety, floor=floor)

    default = one(system.neighbors, "default")
    extra = {
        name: one(spec, name)
        for name, spec in (system.extra_neighbor_specs or {}).items()
    }
    return dreplace(
        system, neighbors=default, extra_neighbor_specs=extra or None
    )


def make_neighbor_spec(
    box,
    n: int,
    r_cut_max: float,
    skin: float = 0.1,
    min_skin: float = 0.04,
    exclusions=None,
    density_safety: float = 1.7,
    cells_per_cutoff: int = 1,
    cell_chunk: int | None = None,
    occupancy_from=None,
    occupancy_safety: float = 1.15,
    occupancy_floor_from=None,
) -> NeighborSpec:
    """Host-side setup: pick the cell grid and capacity for a system of n
    atoms in `box` with the largest relevant cutoff r_cut_max.

    Grid choice: candidate pair work scales with the cell width cubed, so the
    grid is the finest one whose cell width still covers r_cut_max + min_skin;
    the *effective* skin is then whatever margin the width leaves
    (w - r_cut), capped at `skin` — a tight grid with a small skin (more
    frequent cheap rebuilds) beats a loose grid with a large skin by ~2x in
    slot count. For NPT pass a larger min_skin so the grid stays valid as the
    box fluctuates.

    Capacity: by default `density_safety` x mean occupancy — safe from cold
    (lattice) starts. Pass `occupancy_from` (an (N, 3) position array, e.g. an
    equilibrated configuration) to size capacity from the MEASURED max cell
    occupancy x `occupancy_safety` instead: liquids suppress density
    fluctuations far below Poisson (water S(0) ~ 0.06), so measured caps run
    ~40% tighter and pair-slot work scales with cap^2 — retuning after
    equilibration is a ~2x throughput lever (see retune_neighbor_specs).

    `occupancy_floor_from` raises (never lowers) the density-based capacity
    to cover the measured max occupancy of a setup configuration. Cold
    lattice starts can alias whole crystal planes into one coarse cell —
    measured: 750 TIP4P molecules on a 3^3 grid put ~213 sites in a cell
    vs the 200 the 1.7x mean-density margin provisions — and while
    Context.step auto-recovers from overflow, direct aux consumers
    (group_energies / force_fn with a hand-built aux) would silently drop
    pairs. Builders pass their initial coordinates here.

    The sweep runs the Newton half stencil when the grid admits
    collision-free direction maps, the full stencil otherwise.
    """
    box = np.asarray(box, np.float64)
    triclinic = box.ndim == 2
    if triclinic:
        # grid/reach sizing runs on PERPENDICULAR widths (a sheared cell's
        # faces are closer than its edge lengths suggest); binning is
        # fractional (build_cell_buckets) and pair displacements go through
        # the triclinic minimum image the sweep already calls, so the same
        # periodic stencil topology applies unchanged.
        vol = abs(float(np.linalg.det(box)))
        b_eff = np.asarray([
            vol / np.linalg.norm(np.cross(box[(i + 1) % 3],
                                          box[(i + 2) % 3]))
            for i in range(3)
        ])
    else:
        b_eff = box
    target_w = (float(r_cut_max) + float(min_skin)) / cells_per_cutoff
    grid = tuple(max(1, int(np.floor(b / target_w))) for b in b_eff)
    w = b_eff / np.array(grid)
    # effective build radius = what the grid actually covers (per stencil reach)
    skin_eff = min(float(np.min(w)) * cells_per_cutoff - float(r_cut_max),
                   float(skin))
    skin_eff = max(skin_eff, float(min_skin))
    r_build = float(r_cut_max) + skin_eff
    reach = tuple(int(np.ceil(r_build / wi)) for wi in w)
    vol = abs(float(np.linalg.det(box))) if triclinic else float(
        np.prod(box))
    rho = n / vol
    cell_vol = vol / float(np.prod(grid))
    if occupancy_from is not None:
        occ_max = int(_max_cell_occupancy(occupancy_from, box, grid))
        cap = int(math.ceil(occ_max * occupancy_safety) + 2)
    else:
        cap = int(math.ceil(rho * cell_vol * density_safety) + 4)
    if occupancy_floor_from is not None:
        occ_max = int(_max_cell_occupancy(occupancy_floor_from, box, grid))
        cap = max(cap, int(math.ceil(occ_max * occupancy_safety) + 2))
    cap = ((cap + 7) // 8) * 8
    if exclusions is None:
        exclusions = jnp.full((n, 1), -1, jnp.int32)
    if cell_chunk is None:
        # aim for ~48 MB per (chunk, cap, S*cap) f32 intermediate: big
        # tiles amortize the per-scan-step overhead
        ncells = int(np.prod(grid))
        s = min((2 * reach[0] + 1) * (2 * reach[1] + 1) * (2 * reach[2] + 1),
                ncells)
        per_cell = cap * s * cap * 4
        cell_chunk = max(1, min(ncells, (48 << 20) // max(per_cell, 1)))
    nbr_half, inv_half = _half_stencil_maps(grid, reach)
    return NeighborSpec(
        nbr_cells=jnp.asarray(_neighbor_cell_map(grid, reach)),
        exclusions=jnp.asarray(exclusions),
        r_build=jnp.asarray(r_build),
        skin=jnp.asarray(skin_eff),
        nbr_cells_half=None if nbr_half is None else jnp.asarray(nbr_half),
        inv_cells_half=None if inv_half is None else jnp.asarray(inv_half),
        grid=grid,
        reach=reach,
        cell_capacity=cap,
        cell_chunk=cell_chunk,
        half_stencil=nbr_half is not None,
    )


def build_cell_buckets(spec: NeighborSpec, x, box):
    """Bin atoms into (ncells, cap) id buckets (sentinel N). One sort.

    When cell id and atom index pack into 31 bits, a VALUE sort of
    ``cid << idx_bits | i`` replaces the argsort (the key-carries-payload
    trick): XLA's variadic sort-with-index is measurably slower than a plain
    int32 sort.
    """
    n = x.shape[0]
    grid = jnp.asarray(spec.grid, jnp.int32)
    ncells = spec.ncells
    cap = spec.cell_capacity

    if jnp.asarray(box).ndim == 2:
        # triclinic: bin in fractional coordinates (cells are parallelepiped
        # slabs of the lattice); Precision.HIGHEST — the GPU default runs
        # f32 matmuls in TF32 (10-bit mantissa), which mis-bins atoms near
        # cell planes
        inv_h = jnp.linalg.inv(box)
        s_frac = jnp.matmul(x, inv_h, precision=jax.lax.Precision.HIGHEST)
        s_frac = s_frac - jnp.floor(s_frac)
        c3 = jnp.clip((s_frac * grid.astype(s_frac.dtype)).astype(jnp.int32),
                      0, grid - 1)
    else:
        w = box / grid.astype(box.dtype)
        xw = x - box * jnp.floor(x / box)
        c3 = jnp.clip((xw / w).astype(jnp.int32), 0, grid - 1)
    cid = (c3[:, 0] * spec.grid[1] + c3[:, 1]) * spec.grid[2] + c3[:, 2]

    idx_bits = max(n - 1, 1).bit_length()
    if (ncells << idx_bits) < 2**31:
        packed = jnp.sort((cid << idx_bits)
                          | jnp.arange(n, dtype=jnp.int32))
        order = packed & ((1 << idx_bits) - 1)
        sorted_cid = packed >> idx_bits
    else:  # > ~2B combined keys: fall back to argsort
        order = jnp.argsort(cid).astype(jnp.int32)
        sorted_cid = cid[order]
    iarr = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(first, iarr, 0))
    rank = iarr - seg_start
    ok = rank < cap
    slot = jnp.where(ok, sorted_cid * cap + rank, ncells * cap)
    bucket = jnp.full((ncells * cap,), n, jnp.int32)
    bucket = bucket.at[slot].set(order, mode="drop")
    return bucket.reshape(ncells, cap), jnp.any(~ok)


def neighbor_list_extras(spec, x, box, name: str = "default") -> Dict[str, jnp.ndarray]:
    from .blocks import BlockNeighborSpec, block_list_extras

    if isinstance(spec, BlockNeighborSpec):
        return block_list_extras(spec, x, box, name)
    kb, kx, kbox, kov = _keys(name)
    bucket, overflow = build_cell_buckets(spec, x, box)
    return {kb: bucket, kx: x, kbox: box, kov: overflow,
            _cover_key(name): coverage_deficient(spec, box)}


def all_neighbor_extras(system, x, box) -> Dict[str, jnp.ndarray]:
    out = {}
    for name, spec in iter_specs(system):
        out.update(neighbor_list_extras(spec, x, box, name))
    return out


def unhealthy_flags(extras: Dict[str, jnp.ndarray],
                    kinds=("overflow", "undercover")):
    """OR of the named health-flag kinds in an extras dict, one traced
    boolean per kind (False where a kind has no flags). Owns the
    '*_overflow' / '*_undercover' key convention so consumers (the MC
    barostat's trial validation, assert_neighbor_health, diagnostics)
    don't each re-implement the string match."""
    out = []
    for kind in kinds:
        flag = jnp.zeros((), bool)
        for k, v in extras.items():
            if k.endswith(kind):
                flag = flag | v
        out.append(flag)
    return tuple(out)


def assert_neighbor_health(extras: Dict[str, jnp.ndarray]) -> None:
    """Raise if any neighbor list in `extras` overflowed its cell capacity
    or undercovers its build radius.

    Context.step auto-recovers from these flags (restore + retune + re-run),
    but DIRECT aux consumers — group_energies / force_fn over a hand-built
    all_neighbor_extras, as in chip_smoke.py and diagnostic scripts — would
    otherwise silently drop pair interactions. Call this eagerly after
    building extras; it is host-side (forces a device sync on the flags)."""
    bad = [k for k, v in extras.items()
           if (k.endswith("overflow") or k.endswith("undercover")) and bool(v)]
    if bad:
        raise RuntimeError(
            f"neighbor list unhealthy: {bad} — cell capacity overflow drops "
            "pairs and undercoverage misses cells; rebuild the spec with a "
            "larger capacity (retune_neighbor_specs / occupancy_floor_from) "
            "or a finer grid before trusting energies")


def make_aux(system, extra):
    """Assemble the aux dict passed to force evaluations: for each attached
    neighbor spec (the default plus any named ones, e.g. the finer 'near'
    grid), its spec + current bucket (cell path) or order+cand (block path).
    None when no neighbor path exists."""
    from . import blocks as blk

    aux = {}
    for name, spec in iter_specs(system):
        if isinstance(spec, blk.BlockNeighborSpec):
            ko, kc, *_ = blk._keys(name)
            if ko in extra:
                aux[name] = {
                    "spec": spec, "bucket": extra[ko], "cand": extra[kc]
                }
            continue
        kb, *_ = _keys(name)
        if kb in extra:
            aux[name] = {"spec": spec, "bucket": extra[kb]}
    for k, v in extra.items():
        # amortized PME spreading buckets (forces.pme_spread_extras) ride
        # the same extras->aux path; forces look them up by layout key
        if k.startswith("pmesp_") and k.endswith("_bucket"):
            aux[k] = v
    return aux or None


def moved_beyond_half_skin(skin, xref, boxref, x, box, fraction=0.5):
    """The single rebuild predicate shared by every neighbor backend: some
    atom moved more than `fraction`*skin since the reference build, or the
    box changed. fraction=1.0 is the staleness GUARD threshold (beyond a
    full skin even a stationary partner can be missed)."""
    disp = minimum_image(x - xref, box)
    moved = jnp.max(jnp.sum(disp * disp, axis=-1)) > (
        fraction * skin.astype(x.dtype)
    ) ** 2
    return moved | jnp.any(box != boxref)


def staleness_flags(system, extra, x, box):
    """Sticky per-spec flags: pairs may have been silently missed since the
    reference build. Checked by Context.step when neighbor updates run every
    K > 1 outer steps.

    Bound: a pair (i, j) absent from the list at build time can have closed
    by at most d_i + d_j, so no pair can have entered the cutoff while
    max1 + max2 <= skin, where max1 >= max2 are the two largest per-atom
    displacements (distinct atoms). This is rigorous and strictly tighter
    than the single-atom 2*max1 > skin criterion — one fast atom (a
    librating water hydrogen in the Maxwell tail) no longer trips the guard
    by itself unless it covers the whole skin alone."""
    out = {}
    for name, spec in iter_specs(system):
        _, kx, kbox, _ = _keys(name)
        if kx not in extra:
            continue
        key = ("nbr_stale" if name == "default" else f"nbr_{name}_stale")
        prev = extra.get(key, jnp.zeros((), bool))
        disp = minimum_image(x - extra[kx], box)
        d2 = jnp.sum(disp * disp, axis=-1)
        if d2.shape[0] >= 2:
            top2 = jax.lax.top_k(d2, 2)[0]
            pair_close = jnp.sqrt(top2[0]) + jnp.sqrt(top2[1])
        else:
            # N == 1: no pair bound exists (top_k(k=2) would fail, ADVICE
            # r3); fall back to the conservative single-atom 2*max bound
            pair_close = 2.0 * jnp.sqrt(jnp.max(d2))
        stale = (pair_close > effective_skin(spec, box).astype(x.dtype)
                 ) | jnp.any(box != extra[kbox])
        out[key] = prev | stale
    return out


def needs_rebuild(spec: NeighborSpec, extra, x, box, name: str = "default"):
    """True when any atom moved more than skin/2 since the reference build
    (or the box changed). The margin is the box-dependent effective skin so
    an NPT shrink tightens the rebuild cadence with it."""
    _, kx, kbox, _ = _keys(name)
    return moved_beyond_half_skin(effective_skin(spec, box), extra[kx],
                                  extra[kbox], x, box)


def update_neighbors(spec: NeighborSpec, extra, x, box, name: str = "default",
                     force: bool = False):
    """Conditionally re-bin (lax.cond — static shapes both ways).

    force=True rebuilds unconditionally (no cond). Grouped update loops
    (Context(neighbor_update_every=K), hrex.make_replica_run) MUST use it at
    group boundaries: the conditional trigger (max displacement > skin/2)
    races the two-displacement staleness bound (d1 + d2 > skin) — at steady
    state d2 tracks skin/2 right behind d1, so with boundary-only checks
    both cross mid-group and the guard trips on ordinary thermal motion.
    Forced boundary rebuilds reset the reference every K steps, so the
    guard only ever measures K-step windows (thermally far below any sane
    skin). Sticky flags still OR across the rebuild."""
    kb, kx, kbox, kov = _keys(name)
    kcv = _cover_key(name)
    cover_prev = extra.get(kcv, jnp.zeros((), bool))

    def rebuild(_):
        bucket, overflow = build_cell_buckets(spec, x, box)
        return (bucket, x, box, extra[kov] | overflow,
                cover_prev | coverage_deficient(spec, box))

    def keep(_):
        return extra[kb], extra[kx], extra[kbox], extra[kov], cover_prev

    if force:
        bucket, xref, boxref, overflow, undercover = rebuild(None)
    else:
        bucket, xref, boxref, overflow, undercover = jax.lax.cond(
            needs_rebuild(spec, extra, x, box, name), rebuild, keep, None
        )
    return {kb: bucket, kx: xref, kbox: boxref, kov: overflow,
            kcv: undercover}


def update_all_neighbors(system, extra, x, box, force: bool = False):
    from . import blocks as blk

    out = {}
    for name, spec in iter_specs(system):
        if isinstance(spec, blk.BlockNeighborSpec):
            ko, *_ = blk._keys(name)
            if ko in extra:
                out.update(blk.update_blocks(spec, extra, x, box, name,
                                             force=force))
            continue
        kb, *_ = _keys(name)
        if kb in extra:
            out.update(update_neighbors(spec, extra, x, box, name,
                                        force=force))
    return out


# --------------------------------------------------------------------------
# Pair evaluation over cell buckets
# --------------------------------------------------------------------------


def _stage_buckets(x, per_particle, bucket):
    """One coarse row-gather staging positions + params into bucket layout.

    Returns (bucket_x (ncells, cap, 3), bucket_pp dict of (ncells, cap)).
    Sentinel slots gather row N of a padded stack (zeros) and are masked by id.
    """
    cols = [x] + [p[:, None] for p in per_particle.values()]
    stacked = jnp.concatenate(cols, axis=1)  # (N, 3 + P)
    stacked = jnp.concatenate(
        [stacked, jnp.zeros((1, stacked.shape[1]), stacked.dtype)]
    )
    g = stacked[bucket]  # (ncells, cap, 3 + P)
    bucket_x = g[..., :3]
    bucket_pp = {
        k: g[..., 3 + i] for i, k in enumerate(per_particle.keys())
    }
    return bucket_x, bucket_pp


def _cell_pair_sums(spec, pair_fn, x, box, per_particle, bucket, r_cut,
                    with_forces: bool, cell_ids=None):
    """Core loop: scan over home-cell chunks; returns (energy, bucket_forces
    or None).

    cell_ids: optional flat (K,) int32 array of home cells to process (ids
    >= ncells are masked padding) — the spatial force-decomposition shard
    path (parallel/spatial.py) passes each device's slice. Default: all
    cells. When given, the returned bucket forces align with cell_ids rows
    (K, cap, 3) instead of (ncells, cap, 3)."""
    n = x.shape[0]
    ncells, cap = bucket.shape
    s = spec.nbr_cells.shape[1]
    chunk = min(spec.cell_chunk, ncells)

    bucket_x, bucket_pp = _stage_buckets(x, per_particle, bucket)

    exc = spec.exclusions
    exc_pad = jnp.concatenate(
        [exc, jnp.full((1, exc.shape[1]), -1, exc.dtype)]
    )

    explicit_ids = cell_ids is not None
    if explicit_ids:
        k = cell_ids.shape[0]
        # chunk by the CALLER'S id count, not ncells: the spatial shard path
        # passes ncells/D ids per device, and padding them back up to a
        # full-size chunk made every device do the whole sweep's FLOPs on
        # masked rows (caught by tools/dd_scaling.py — r4)
        chunk = min(chunk, k)
        n_chunks = -(-k // chunk)
        pad = n_chunks * chunk - k
        cells = jnp.concatenate(
            [cell_ids.astype(jnp.int32),
             jnp.full((pad,), ncells, jnp.int32)]
        ).reshape(n_chunks, chunk)
    else:
        n_chunks = -(-ncells // chunk)
        cells = jnp.arange(n_chunks * chunk, dtype=jnp.int32).reshape(
            n_chunks, chunk
        )
    rc2 = jnp.asarray(r_cut, x.dtype) ** 2

    nbr_map = spec.nbr_cells  # (ncells, S)

    def chunk_body(carry, cell_ids):
        cell_ok = cell_ids < ncells
        cid = jnp.where(cell_ok, cell_ids, 0)
        home_x = bucket_x[cid]                      # (B, cap, 3)
        home_id = jnp.where(
            cell_ok[:, None], bucket[cid], n
        )                                           # (B, cap)
        home_pp = {k: v[cid] for k, v in bucket_pp.items()}

        ncell_ids = nbr_map[cid]                    # (B, S)
        nvalid = ncell_ids >= 0
        ncid = jnp.where(nvalid, ncell_ids, 0)
        cand_x = bucket_x[ncid].reshape(cid.shape[0], s * cap, 3)
        cand_id = jnp.where(
            nvalid[:, :, None], bucket[ncid], n
        ).reshape(cid.shape[0], s * cap)
        cand_pp = {
            k: v[ncid].reshape(cid.shape[0], s * cap)
            for k, v in bucket_pp.items()
        }

        dx = minimum_image(home_x[:, :, None, :] - cand_x[:, None, :, :], box)
        r2 = jnp.sum(dx * dx, axis=-1)              # (B, cap, S*cap)
        mask = (
            (home_id[:, :, None] < n)
            & (cand_id[:, None, :] < n)
            & (home_id[:, :, None] != cand_id[:, None, :])
            & (r2 < rc2)
        )
        home_exc = exc_pad[jnp.clip(home_id, 0, n)]  # (B, cap, M)
        excluded = jnp.any(
            cand_id[:, None, None, :] == home_exc[:, :, :, None], axis=2
        )
        mask &= ~excluded

        r2m = jnp.where(mask, r2, 1.0)
        pi = {k: v[:, :, None] for k, v in home_pp.items()}
        pj = {k: v[:, None, :] for k, v in cand_pp.items()}
        u, dudr2 = pair_eval(pair_fn, r2m, pi, pj, with_forces)
        if with_forces:
            # f = -u'(r) r̂ = -2 (du/dr²) Δx — no 1/r (ops/rv.py)
            fmag = jnp.where(mask, 2.0 * dudr2, 0.0)
            f_home = -jnp.sum(fmag[..., None] * dx, axis=2)  # (B, cap, 3)
        else:
            f_home = None
        e = 0.5 * jnp.sum(jnp.where(mask, u, 0.0))
        return carry + e, f_home

    energy, f_chunks = jax.lax.scan(
        chunk_body, jnp.zeros((), x.dtype), cells
    )
    if not with_forces:
        return energy, None
    rows = cell_ids.shape[0] if explicit_ids else ncells
    f_bucket = f_chunks.reshape(n_chunks * chunk, cap, 3)[:rows]
    return energy, f_bucket


def _cell_pair_sums_half(spec, pair_fn, x, box, per_particle, bucket, r_cut,
                         with_forces: bool):
    """Newton (half-stencil) variant: each cell PAIR is visited once — the
    self cell (column 0, both orderings inside, energy weight 1/2) plus the
    lexicographically-positive directions (weight 1). Home forces accumulate
    as usual; candidate-side reactions are summed per (direction, slot) and
    routed back through the inverse direction map. Roughly half the pair
    FLOPs of the full stencil."""
    n = x.shape[0]
    ncells, cap = bucket.shape
    s_half = spec.nbr_cells_half.shape[1]
    chunk = min(spec.cell_chunk, ncells)
    n_chunks = -(-ncells // chunk)

    bucket_x, bucket_pp = _stage_buckets(x, per_particle, bucket)
    exc = spec.exclusions
    exc_pad = jnp.concatenate(
        [exc, jnp.full((1, exc.shape[1]), -1, exc.dtype)]
    )
    cells = jnp.arange(n_chunks * chunk, dtype=jnp.int32).reshape(
        n_chunks, chunk
    )
    rc2 = jnp.asarray(r_cut, x.dtype) ** 2
    nbr_map = spec.nbr_cells_half  # (ncells, S_half), column 0 = self

    # per-slot energy weight: 0.5 for the self column, 1 for the rest
    w_cols = jnp.concatenate(
        [jnp.full((cap,), 0.5, x.dtype), jnp.ones(((s_half - 1) * cap,), x.dtype)]
    )
    # J-side reaction mask: zero for the self column (already both-ordered)
    j_cols = jnp.concatenate(
        [jnp.zeros((cap,), x.dtype), jnp.ones(((s_half - 1) * cap,), x.dtype)]
    )

    def chunk_body(carry, cell_ids):
        cell_ok = cell_ids < ncells
        cid = jnp.where(cell_ok, cell_ids, 0)
        home_x = bucket_x[cid]
        home_id = jnp.where(cell_ok[:, None], bucket[cid], n)
        home_pp = {k: v[cid] for k, v in bucket_pp.items()}

        ncid = nbr_map[cid]  # (B, S_half) — always valid cells
        cand_x = bucket_x[ncid].reshape(cid.shape[0], s_half * cap, 3)
        cand_id = bucket[ncid].reshape(cid.shape[0], s_half * cap)
        cand_id = jnp.where(cell_ok[:, None], cand_id, n)
        cand_pp = {
            k: v[ncid].reshape(cid.shape[0], s_half * cap)
            for k, v in bucket_pp.items()
        }

        dx = minimum_image(home_x[:, :, None, :] - cand_x[:, None, :, :], box)
        r2 = jnp.sum(dx * dx, axis=-1)
        mask = (
            (home_id[:, :, None] < n)
            & (cand_id[:, None, :] < n)
            & (home_id[:, :, None] != cand_id[:, None, :])
            & (r2 < rc2)
        )
        home_exc = exc_pad[jnp.clip(home_id, 0, n)]
        excluded = jnp.any(
            cand_id[:, None, None, :] == home_exc[:, :, :, None], axis=2
        )
        mask &= ~excluded

        r2m = jnp.where(mask, r2, 1.0)
        pi = {k: v[:, :, None] for k, v in home_pp.items()}
        pj = {k: v[:, None, :] for k, v in cand_pp.items()}
        u, dudr2 = pair_eval(pair_fn, r2m, pi, pj, with_forces)
        if with_forces:
            fmag = jnp.where(mask, 2.0 * dudr2, 0.0)
            fvec = fmag[..., None] * dx                      # (B, cap, S*cap, 3)
            f_home = -jnp.sum(fvec, axis=2)                  # (B, cap, 3)
            f_cand = jnp.sum(fvec, axis=1) * j_cols[None, :, None]
        else:
            f_home = f_cand = None
        e = jnp.sum(jnp.where(mask, u, 0.0) * w_cols[None, None, :])
        return carry + e, (f_home, f_cand)

    energy, (f_home_c, f_cand_c) = jax.lax.scan(
        chunk_body, jnp.zeros((), x.dtype), cells
    )
    if not with_forces:
        return energy, None
    f_home = f_home_c.reshape(n_chunks * chunk, cap, 3)[:ncells]
    f_cand = f_cand_c.reshape(n_chunks * chunk, s_half, cap, 3)[:ncells]
    # reaction write-back: cell c receives, for each direction k, the J-side
    # sums computed by home cell (c - d_k)
    inv = spec.inv_cells_half  # (ncells, S_half)
    gathered = f_cand[inv, jnp.arange(s_half)[None, :]]  # (ncells, S_half, cap, 3)
    f_bucket = f_home + jnp.sum(gathered, axis=1)
    return energy, f_bucket


def cell_pair_energy(pair_fn, x, box, per_particle, spec, bucket, r_cut):
    """Half-counted pair energy over the cell buckets."""
    sums = _cell_pair_sums_half if spec.half_stencil else _cell_pair_sums
    e, _ = sums(
        spec, pair_fn, x, box, per_particle, bucket, r_cut, with_forces=False
    )
    return e


def cell_pair_energy_forces(pair_fn, x, box, per_particle, spec, bucket, r_cut):
    """(energy, forces (N, 3)) with explicit symmetric forces.

    Newton half stencil (each cell pair once + reaction write-back, ~half
    the FLOPs) when the maps exist, else the full stencil where candidate
    sets are symmetric and F_i = -sum u'(r) r_hat. The write-back is a
    scatter-add; on a GPU its atomics sum in an order that varies from run
    to run, so forces agree between runs to roundoff, not bitwise."""
    n = x.shape[0]
    if spec.half_stencil:
        e, f_bucket = _cell_pair_sums_half(
            spec, pair_fn, x, box, per_particle, bucket, r_cut, with_forces=True
        )
    else:
        e, f_bucket = _cell_pair_sums(
            spec, pair_fn, x, box, per_particle, bucket, r_cut, with_forces=True
        )
    forces = jnp.zeros((n + 1, 3), x.dtype)
    forces = forces.at[bucket.reshape(-1)].add(
        f_bucket.reshape(-1, 3), mode="drop"
    )
    return e, forces[:n]
