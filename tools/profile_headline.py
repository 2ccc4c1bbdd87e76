"""Per-kernel dissection of the headline step (VERDICT r3 #2 groundwork).

Prints ms per force-group evaluation (in-loop, dispatch-free) and the
step-rate decomposition for the 30k water RESPA config, from the frozen
equilibrated state. Run on the GPU: python tools/profile_headline.py
[cutoff|pme]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import HEADLINE_DT, HEADLINE_LOOPS, HEADLINE_RCUT_IN, load_eq  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else "cutoff"
    import jax

    from atomsmm_tpu import (
        Context,
        MultipleTimeScaleIntegrator,
        RESPASystem,
        make_state,
    )
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.profiling import profile_forces, profile_step

    system, x, box = water_system(n_molecules=10000, method=method,
                                  neighbors=True)
    respa = RESPASystem(system, rcut_in=HEADLINE_RCUT_IN,
                        rswitch_in=HEADLINE_RCUT_IN - 0.1)
    integ = MultipleTimeScaleIntegrator(
        HEADLINE_DT, HEADLINE_LOOPS, temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * system.num_particles - 3,
    )
    eq = load_eq("eq_water30k")
    ex, ev, ebox = eq
    ctx = Context(respa, integ, make_state(ex, v=ev, box=ebox))
    t0 = time.perf_counter()
    jax.block_until_ready(ctx.step(1).state)
    log(f"compile {time.perf_counter()-t0:.0f}s")
    ctx.step(100)
    ctx.retune_neighbors()
    ctx.step(1)
    for name, spec in [("default", ctx.system.neighbors)] + list(
        (ctx.system.extra_neighbor_specs or {}).items()
    ):
        log(f"spec[{name}]: grid={spec.grid} cap={spec.cell_capacity} "
            f"chunk={spec.cell_chunk} "
            f"half={spec.half_stencil}")

    prof = profile_forces(ctx, reps=30)
    step_ms = profile_step(ctx, steps=200)
    # report-row cost (VERDICT r2 weak #6): one get_state() — the
    # ExtendedStateDataReporter's per-row evaluation — in step-times
    ctx.get_state()  # compile
    t0 = time.perf_counter()
    for _ in range(5):
        snap = ctx.get_state()
        float(snap.potential_energy)
    row_ms = (time.perf_counter() - t0) / 5 * 1e3
    n0, n1 = HEADLINE_LOOPS[0], HEADLINE_LOOPS[1]
    # per outer step: far x1, near x n1, bonded x n0*n1
    loops_cost = {}
    groups = sorted(ctx.system.force_groups)
    mults = {groups[0]: n0 * n1, groups[1]: n1}
    for g in groups[2:]:
        mults[g] = 1
    total_accounted = 0.0
    for g in groups:
        ms = prof[f"group {g}"] - prof["overhead"]
        loops_cost[f"group{g}_ms x{mults[g]}"] = round(ms, 3)
        total_accounted += ms * mults[g]
    out = {
        "method": method,
        "profile_ms": {k: round(v, 3) for k, v in prof.items()},
        "per_outer_step": loops_cost,
        "accounted_ms": round(total_accounted, 2),
        "measured_step_ms": round(step_ms, 2),
        "unaccounted_ms (thermostat+move+nbr-update)": round(
            step_ms - total_accounted, 2),
        "report_row_ms": round(row_ms, 2),
        "report_row_step_times": round(row_ms / step_ms, 2),
    }
    log(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
