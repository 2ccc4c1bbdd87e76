"""Far-force sweep micro-benchmark (VERDICT r3 #2).

Measures ms/eval of the dominant far-force kernel (the fused
full+negated-near tile pass on the default r=0.9 grid) for the 30k-atom
water system across stencil/capacity variants, on the GPU, from the
frozen equilibrated state. Run: python tools/kernel_bench.py [cutoff|pme]
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import HEADLINE_RCUT_IN, load_eq  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(fn, x, reps=20, tries=3):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(x):
        def body(i, acc):
            return acc + fn(x + 1e-30 * acc)
        return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(x))

    out = loop(x)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        out = loop(x)
        float(out[0, 0])
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else "cutoff"
    import jax.numpy as jnp

    from atomsmm_tpu import (
        Context,
        MultipleTimeScaleIntegrator,
        RESPASystem,
        make_state,
    )
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.neighbors import (
        build_cell_buckets,
        cell_pair_energy_forces,
        retune_spec,
    )

    system, x, box = water_system(n_molecules=10000, method=method,
                                  neighbors=True)
    respa = RESPASystem(system, rcut_in=HEADLINE_RCUT_IN,
                        rswitch_in=HEADLINE_RCUT_IN - 0.1)
    eq = load_eq("eq_water30k")
    ex, ev, ebox = eq
    x = jnp.asarray(ex)
    box = jnp.asarray(ebox)

    # the fused far force is the FarNonbondedForce on the default grid
    far = next(f for f in respa.forces if f.name == "FarNonbondedForce")
    spec0 = retune_spec(respa.neighbors, x, box, safety=1.15)
    log(f"default grid {spec0.grid}, retuned cap {spec0.cell_capacity}, "
        f"chunk {spec0.cell_chunk}")

    pair_fn = far._pair_fn({})
    pp = far._per_particle({})
    r_cut = far.full.r_cut
    results = {}

    def run_variant(tag, spec):
        bucket, ov = build_cell_buckets(spec, x, box)
        assert not bool(ov), f"{tag}: overflow"

        def f(xx):
            _, ff = cell_pair_energy_forces(
                pair_fn, xx, box, pp, spec, bucket, r_cut
            )
            return ff

        ms = timeit(f, x)
        results[tag] = round(ms, 3)
        log(f"{tag}: {ms:.3f} ms")

    variants = [
        ("xla_half_auto", spec0),
        ("xla_full", dataclasses.replace(spec0, half_stencil=False)),
    ]
    # capacity alignment: pad cap up to the next multiples of 8 and 16
    for pad in (8, 16, 32):
        cap = -(-spec0.cell_capacity // pad) * pad
        if cap != spec0.cell_capacity:
            variants.append(
                (f"xla_half_cap{cap}",
                 dataclasses.replace(spec0, cell_capacity=cap)))
    # chunk sweep (home cells per scan step)
    for ch in (2, 4, 8, 16):
        if ch != spec0.cell_chunk:
            variants.append(
                (f"xla_half_chunk{ch}",
                 dataclasses.replace(spec0, cell_chunk=ch)))

    # finer grids with larger stencil reach: candidate volume shrinks toward
    # the Minkowski bound at the cost of more (smaller) tiles
    from atomsmm_tpu.ops.neighbors import make_neighbor_spec

    n = x.shape[0]
    for reach in (2, 3):
        try:
            sp = make_neighbor_spec(
                box, n, float(r_cut), skin=0.1,
                exclusions=respa.neighbors.exclusions,
                cells_per_cutoff=reach, occupancy_from=x,
            )
            variants.append((
                f"xla_half_reach{reach}_grid{sp.grid[0]}_cap{sp.cell_capacity}",
                sp))
        except Exception as e:
            log(f"reach{reach} spec failed: {e}")

    for tag, spec in variants:
        try:
            run_variant(tag, spec)
        except Exception as e:
            log(f"{tag} failed: {type(e).__name__}: {e}")

    # near-force sweep on its own grid (2 evals per outer step)
    near = next(f for f in respa.forces if f.name == "NearNonbondedForce")
    near_spec = (respa.extra_neighbor_specs or {}).get("near")
    if near_spec is not None:
        from atomsmm_tpu.ops.neighbors import retune_spec as _rt

        near_spec = _rt(near_spec, x, box)
        nb_bucket, nov = build_cell_buckets(near_spec, x, box)
        assert not bool(nov)
        npair = near._pair_fn({})
        npp = near._per_particle({})

        def fnear(xx):
            _, ff = cell_pair_energy_forces(
                npair, xx, box, npp, near_spec, nb_bucket, near.r_cut
            )
            return ff

        ms = timeit(fnear, x)
        results["near_sweep"] = round(ms, 3)
        log(f"near_sweep (grid {near_spec.grid} cap "
            f"{near_spec.cell_capacity}): {ms:.3f} ms")

    if method == "pme":
        # exact-vs-approx erfc on the fused far sweep (pairfuncs.erfc gate)
        os.environ["ATOMSMM_EXACT_ERFC"] = "1"
        try:
            run_variant("far_exact_erfc",
                        spec0)
            if near_spec is not None:
                ms = timeit(fnear, x)
                results["near_exact_erfc"] = round(ms, 3)
                log(f"near_exact_erfc: {ms:.3f} ms")
        finally:
            del os.environ["ATOMSMM_EXACT_ERFC"]
        # reciprocal part alone
        import jax

        full = far.full

        def frec(xx):
            e = full._recip_energy(xx, box, {}, True)
            return jax.grad(lambda y: full._recip_energy(y, box, {}, True))(xx)

        ms = timeit(frec, x)
        results["reciprocal_ms"] = round(ms, 3)
        log(f"reciprocal (energy+grad): {ms:.3f} ms")

    # neighbor maybe-update cost (runs once per outer step in Context.run)
    from atomsmm_tpu.ops.neighbors import all_neighbor_extras, update_all_neighbors

    import jax as _jax

    extras0 = _jax.jit(all_neighbor_extras)(respa, x, box)

    def fupd(xx):
        out = update_all_neighbors(respa, extras0, xx, box)
        key = next(k for k in out if k.endswith("xref"))
        return out[key]

    ms = timeit(fupd, x)
    results["nbr_update_ms"] = round(ms, 3)
    log(f"nbr maybe-update (keep path): {ms:.3f} ms")

    # forced-rebuild path: xref displaced beyond skin/2 -> predicate True.
    # CAVEAT (see KERNELS.md): these two probes close over `extras0` as a
    # baked constant, so each loop iteration re-materializes the constant
    # buckets and keep ≈ rebuild here measures that copy, NOT an eager
    # cond. tools/nbr_update_bench.py carries the extras as loop state
    # (the Context.run structure) and measures the true keep path at
    # ~0.05 ms.
    extras_moved = dict(extras0)
    for k in extras_moved:
        if k.endswith("xref"):
            extras_moved[k] = extras_moved[k] + 0.2

    def fupd2(xx):
        out = update_all_neighbors(respa, extras_moved, xx, box)
        key = next(k for k in out if k.endswith("xref"))
        return out[key]

    ms = timeit(fupd2, x)
    results["nbr_rebuild_ms"] = round(ms, 3)
    log(f"nbr forced rebuild: {ms:.3f} ms")

    print(json.dumps({"method": method, "far_ms": results}))


if __name__ == "__main__":
    main()
