"""SIN(R) outer-step study on FLEXIBLE q-SPC/Fw water (round-4 lever).

Margul & Tuckerman (JCTC 12, 2170 (2016)) sustain very large outer steps
on flexible water with the stochastic-isokinetic SIN(R) splitting — the
per-DOF constraint m v^2 + Q1 v1^2/2 = kT suppresses both the 4-5 fs
deterministic-NVT resonance wall AND the near-level resonance, so the
slow (far) force can step 1-2 orders beyond it. This study validates the
claim on our q-SPC/Fw configuration 2 (the headline system, reduced to
216 molecules so the study runs on the CPU f64 Reference platform):

  * reference row: r-RESPA [4,2,1] @ 4 fs with an NHC bath — the
    configurational ensemble to match (PE/atom, its fluctuation).
  * SIN(R) rows at 8/12/16/24/30 fs outer steps, bonded held at
    0.4-0.5 fs, near (0.5 nm) at 2-3 fs.

Pass criteria per SINR_TIMESTEP.md: PE/atom within the reference row's
fluctuation band, kinetic T at the ISOKINETIC expectation kT/2 per DOF
(150 K at a 300 K setpoint, L=1), constraint residual at rounding, no
blowup. Throughput is NOT meaningful here (CPU, 648 atoms) — the GPU
bench row (config 2b, bench.py::bench_water_sinr) carries the ns/day.

Usage: python tools/sinr_water_study.py [quick]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _setup(n_molecules=216):
    import jax

    # CPU f64 Reference platform
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


_EQ_CACHE = {}


def equilibrated_state(n_molecules=216, steps=2000):
    """One common 300 K state from an MTS/NHC melt of the lattice."""
    if n_molecules in _EQ_CACHE:
        return _EQ_CACHE[n_molecules]
    from atomsmm_tpu import (
        Context,
        MultipleTimeScaleIntegrator,
        RESPASystem,
        make_state,
    )
    from atomsmm_tpu.models import water_system

    system, x, box = water_system(n_molecules=n_molecules, method="cutoff")
    respa = RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    dof = 3 * system.num_particles - 3
    integ = MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=dof)
    ctx = Context(respa, integ, make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=7)
    for _ in range(8):
        ctx.step(steps // 8)
        t_now = float(ctx.temperature())
        ctx.set_velocities((300.0 / t_now) ** 0.5 * ctx.state.v)
    ctx.step(steps // 2)
    _EQ_CACHE[n_molecules] = (np.asarray(ctx.state.x),
                              np.asarray(ctx.state.v),
                              np.asarray(ctx.state.box))
    return _EQ_CACHE[n_molecules]


def run_reference(steps=3000, n_molecules=216, sample_every=250):
    """The 4 fs r-RESPA/NHC row: canonical PE/atom and its noise band."""
    from atomsmm_tpu import (
        Context,
        MultipleTimeScaleIntegrator,
        RESPASystem,
        make_state,
    )
    from atomsmm_tpu.models import water_system

    system, x0, box0 = water_system(n_molecules=n_molecules, method="cutoff")
    respa = RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    dof = 3 * system.num_particles - 3
    integ = MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=dof)
    ex, ev, ebox = equilibrated_state(n_molecules)
    ctx = Context(respa, integ, make_state(ex, v=ev, box=ebox))
    ctx.step(250)
    n = system.num_particles
    pe, t = [], []
    for _ in range(steps // sample_every):
        ctx.step(sample_every)
        pe.append(float(ctx.get_state().potential_energy) / n)
        t.append(float(ctx.temperature()))
    row = {
        "dt_fs": 4.0, "scheme": "RESPA[4,2,1]+NHC",
        "T_kin_K": round(float(np.mean(t)), 2),
        "PE_per_atom": round(float(np.mean(pe)), 4),
        "PE_sigma": round(float(np.std(pe)), 4),
        "finite": True,
    }
    log(json.dumps(row))
    return row


def run_candidate(dt, loops, steps, n_molecules=216, sample_every=100):
    from atomsmm_tpu import Context, RESPASystem, SIN_R_Integrator, make_state
    from atomsmm_tpu.models import water_system

    system, x0, box0 = water_system(n_molecules=n_molecules, method="cutoff")
    respa = RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    integ = SIN_R_Integrator(
        dt, list(loops), temperature=300.0, time_scale=0.05, friction=10.0)
    ex, ev, ebox = equilibrated_state(n_molecules)
    ctx = Context(respa, integ, make_state(ex, v=ev, box=ebox, seed=11))
    t0 = time.perf_counter()
    ctx.step(1)
    float(ctx.state.x[0, 0])
    compile_s = time.perf_counter() - t0
    ctx.step(max(50, int(0.0008 / dt * 1000)))  # ~0.8 ps re-equilibration

    n = system.num_particles
    t_hist, pe_hist = [], []
    t_wall = time.perf_counter()
    done = 0
    while done < steps:
        ctx.step(sample_every)
        done += sample_every
        t_hist.append(float(ctx.temperature()))
        pe_hist.append(float(ctx.get_state().potential_energy))
        if not np.isfinite(pe_hist[-1]):
            log(f"  BLEW UP at step {done}")
            break
    wall = time.perf_counter() - t_wall
    tail = slice(int(len(t_hist) * 0.4), None)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sinr_study import constraint_residual  # reuse the metric

    row = {
        "dt_fs": dt * 1e3,
        "loops": list(loops),
        "steps": done,
        "span_ps": round(done * dt, 1),
        "ms_step_cpu": round(wall / max(done, 1) * 1e3, 2),
        "T_kin_K": round(float(np.mean(t_hist[tail])), 2),
        "PE_per_atom": round(float(np.mean(pe_hist[tail])) / n, 4),
        "constraint_residual": round(constraint_residual(ctx), 9),
        "finite": bool(np.isfinite(pe_hist[-1])),
        "compile_s": round(compile_s, 1),
    }
    log(json.dumps(row))
    return row


# loops [n0, n1, 1]: bonded dt/(n0*n1), near (0.5 nm) dt/n1, far dt.
# bonded held at 0.4-0.5 fs (the OH stretch period is ~9 fs), near at 2-3 fs.
CANDIDATES = [
    (0.008, [4, 4, 1], 3000),    # bonded 0.5, near 2, far 8
    (0.012, [4, 6, 1], 2500),    # bonded 0.5, near 2, far 12
    (0.016, [4, 8, 1], 2000),    # bonded 0.5, near 2, far 16
    (0.024, [4, 12, 1], 1500),   # bonded 0.5, near 2, far 24
    (0.030, [5, 15, 1], 1200),   # bonded 0.4, near 2, far 30
    (0.030, [4, 10, 1], 1200),   # bonded 0.75, near 3 — the cheap variant
    # round-5 near-work scan (VERDICT r4 #7): the near sweep dominates the
    # SIN(R) water cost (12 sweeps/outer at [4,12,1]); push the NEAR step
    # with the same isokinetic suppression that freed the outer step
    (0.024, [6, 8, 1], 1500),    # bonded 0.5, near 3, far 24 — 8 sweeps
    (0.030, [6, 10, 1], 1200),   # bonded 0.5, near 3, far 30
    (0.024, [8, 6, 1], 1500),    # bonded 0.5, near 4, far 24 — 6 sweeps
    (0.036, [6, 12, 1], 1000),   # bonded 0.5, near 3, far 36
]


def main():
    _setup()
    quick = len(sys.argv) > 1 and sys.argv[1] == "quick"
    rows = [run_reference(steps=1500 if quick else 3000)]
    for dt, loops, steps in CANDIDATES:
        if quick:
            steps = min(steps, 800)
        try:
            rows.append(run_candidate(dt, loops, steps))
        except Exception as e:
            log(f"candidate {dt} {loops} failed: {e}")
    log("| dt | loops | T_kin [K] | PE/N | sigma-dist | constraint |")
    log("|" + "---|" * 6)
    ref = rows[0]
    for r in rows[1:]:
        dist = (r["PE_per_atom"] - ref["PE_per_atom"]) / max(
            ref["PE_sigma"], 1e-9)
        log(f"| {r['dt_fs']:.0f} fs | {r['loops']} | {r['T_kin_K']} | "
            f"{r['PE_per_atom']} | {dist:+.1f}σ | "
            f"{r['constraint_residual']:.1e} |")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
