"""Spatial-DD scaling measurement (VERDICT r3 #5).

Speedup is measured on the GPUs themselves; this tool gives the model to
hold those times against. The two indirect timers are confounded: XLA
cost_analysis counts a lax.scan body once regardless of trip count (the
cell sweep is chunk-scanned), and wall time over virtual CPU devices mixes
in host thread contention. What IS exact and deterministic is the WORK
MODEL: the pair sweep's cost is its padded tile-slot count (n_chunks x
chunk x cap x S x cap pair slots per device), and the reciprocal cost is
grid points spread + FFT points transformed per device. This tool computes
those per-device counts exactly from the NeighborSpec/grid for D = 1..8 and
combines them with an NVLink comm model — every number is falsifiable
arithmetic, not a noisy proxy.

This modeling caught a real bug in r4: _cell_pair_sums padded each
device's cell_ids back up to a full-size chunk, so every device did the
whole sweep's FLOPs on masked rows.

Usage: python tools/dd_scaling.py [n_molecules] [pme|cutoff]
Writes a markdown table to stdout.
"""
from __future__ import annotations

import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pair_slots_per_device(spec, d):
    """Exact padded pair-slot count per device for the cell sweep.

    d == 1: the single-device Newton half-stencil path (production);
    d > 1: the sharded full-stencil force decomposition over home cells
    (parallel/spatial.py) — ceil(ncells/d) home cells per device, chunked
    by min(cell_chunk, k), each chunk row costing cap x S x cap slots.
    """
    ncells = int(np.prod(spec.grid))
    cap = int(spec.cell_capacity)
    if d == 1:
        s = spec.nbr_cells_half.shape[1] if spec.nbr_cells_half is not None \
            else spec.nbr_cells.shape[1]
        k = ncells
    else:
        s = spec.nbr_cells.shape[1]
        k = -(-ncells // d)
    chunk = min(int(spec.cell_chunk), k)
    n_chunks = -(-k // chunk)
    return n_chunks * chunk * cap * s * cap


def recip_points_per_device(n_atoms, grid_shape, d):
    """Spreading work (atoms/d x K^3 one-hot matmul columns) + FFT points
    per device on the slab path (K^3 log K split over d)."""
    k1, k2, k3 = grid_shape
    kcube = k1 * k2 * k3
    spread = -(-n_atoms // d) * kcube
    fft = kcube * np.log2(max(kcube, 2)) / d
    return spread, fft


def main():
    n_mol = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    method = sys.argv[2] if len(sys.argv) > 2 else "pme"

    from atomsmm_tpu import RESPASystem
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.pme import choose_pme_parameters

    system, x, box = water_system(n_molecules=n_mol, method=method,
                                  neighbors=True)
    if method == "pme":
        # grid divisible by 8 so every D in {1,2,4,8} takes the slab path
        nb = system.forces[0]
        _, grid, _ = choose_pme_parameters(
            float(nb.r_cut), np.asarray(box), order=nb.spline_order,
            multiple_of=8)
        from atomsmm_tpu.utils import replace

        system = system.replace_forces(
            [replace(nb, grid_shape=grid)] + list(system.forces[1:]))
    respa = RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    n = system.num_particles

    # the dominant cost: the far force's sweep on the default grid (the
    # near force has its own finer grid — same scaling shape)
    spec = respa.neighbors
    grid_shape = (system.forces[0].grid_shape if method == "pme"
                  else None)
    print(f"# spatial-DD per-device work, {n} atoms, {method} "
          f"(exact padded tile/grid counts)\n")
    print("| D | pair Mslots/dev | vs D=1 | spread Mpts/dev | FFT Mpts/dev |")
    print("|---|---|---|---|---|")
    base = pair_slots_per_device(spec, 1)
    for d in (1, 2, 4, 8):
        slots = pair_slots_per_device(spec, d)
        if grid_shape is not None:
            sp, ff = recip_points_per_device(n, grid_shape, d)
            rec = f"{sp/1e6:.1f} | {ff/1e6:.1f}"
        else:
            rec = "- | -"
        print(f"| {d} | {slots/1e6:.1f} | {base/slots:.2f}x | {rec} |")
    print("\n(D=1 is the Newton half-stencil path; D>1 the sharded sweep "
          "runs the full stencil — ~2x the slots — so the crossover where "
          "D devices beat 1 is D ~ 3; past it, scaling is linear until the "
          "link terms below matter.)")

    # communication model: NVLink, 450 GB/s each way per H100 (data sheet)
    psum_bytes = 12 * n  # (N, 3) f32 force allreduce
    if method == "pme":
        grid_elems = int(np.prod(system.forces[0].grid_shape))
        # slab path: reduce-scatter of the spread grid + one all_to_all of
        # the (complex64) half-spectrum
        k1, k2, k3 = system.forces[0].grid_shape
        spec_bytes = 8 * k1 * k2 * (k3 // 2 + 1)
        comm = psum_bytes * 2 + 4 * grid_elems + spec_bytes
        print(f"\ncomm/force-eval: force psum {psum_bytes/1e6:.2f} MB x2, "
              f"grid reduce-scatter {4*grid_elems/1e6:.2f} MB, "
              f"spectrum all_to_all {spec_bytes/1e6:.2f} MB")
    else:
        comm = psum_bytes
        print(f"\ncomm/force-eval: force psum {psum_bytes/1e6:.2f} MB")
    print("NVLink 450 GB/s each way; ring allreduce(M) ~ 2M(D-1)/D / BW:")
    for d in (2, 4, 8):
        t_us = 2 * comm * (d - 1) / d / 450e9 * 1e6
        print(f"  D={d}: ~{t_us:.0f} us/eval of link time")


if __name__ == "__main__":
    main()
