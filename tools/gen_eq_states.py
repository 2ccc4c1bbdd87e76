"""Generate frozen equilibrated states for bench.py (VERDICT r2 #1).

Runs the TIMESTEP.md protocol once per bench config on the device and
freezes the result into bench_data/*.npz (x, v, box, plus provenance
metadata). bench.py then measures from these states after a short
re-equilibration instead of 600 lattice-melt steps — the measured number
matches the studied protocol and the reported temperature telemetry is
honest (~300 K, not a cooling transient).

Usage: python tools/gen_eq_states.py [water30k] [water100k] [emim] [all]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "bench_data")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _save(name, ctx, **meta):
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, name)
    np.savez_compressed(
        path,
        x=np.asarray(ctx.state.x, np.float32),
        v=np.asarray(ctx.state.v, np.float32),
        box=np.asarray(ctx.state.box, np.float32),
        **{k: np.asarray(v) for k, v in meta.items()},
    )
    log(f"saved {path}.npz  T={float(ctx.temperature()):.1f}K")


def _melt_then_nvt(ctx, temperature, melt_steps, nvt_steps, chunk=500):
    """Chunked velocity-rescale off the lattice, then free NHC NVT."""
    for _ in range(8):
        ctx.step(melt_steps // 8)
        t_now = float(ctx.temperature())
        ctx.set_velocities((temperature / t_now) ** 0.5 * ctx.state.v)
    ctx.retune_neighbors()
    done = 0
    while done < nvt_steps:
        n = min(chunk, nvt_steps - done)
        ctx.step(n)
        done += n
        log(f"  nvt {done}/{nvt_steps}  T={float(ctx.temperature()):.1f}K")


def gen_water30k():
    from atomsmm_tpu import (
        Context,
        MultipleTimeScaleIntegrator,
        RESPASystem,
        make_state,
    )
    from atomsmm_tpu.models import water_system

    n_mol = 10000
    system, x, box = water_system(n_molecules=n_mol, method="cutoff",
                                  neighbors=True)
    respa = RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    integ = MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * system.num_particles - 3,
    )
    ctx = Context(respa, integ, make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=7)
    t0 = time.perf_counter()
    ctx.step(1)
    log(f"water30k compile {time.perf_counter()-t0:.0f}s")
    # 600 melt + 5000 x 4 fs = 20 ps NVT (TIMESTEP.md protocol)
    _melt_then_nvt(ctx, 300.0, 600, 5000)
    _save("eq_water30k", ctx, n_molecules=n_mol, dt_fs=4.0,
          protocol="600 melt + 20ps NHC NVT @300K, RESPA[4,2,1] cutoff rin=0.5")


def gen_water100k():
    from atomsmm_tpu import (
        Context,
        MultipleTimeScaleIntegrator,
        RESPASystem,
        make_state,
    )
    from atomsmm_tpu.models import water_system

    n_mol = 33334
    system, x, box = water_system(n_molecules=n_mol, neighbors=True)
    respa = RESPASystem(system, rcut_in=0.6, rswitch_in=0.5)
    integ = MultipleTimeScaleIntegrator(
        0.004, [4, 2, 1], temperature=300.0, time_scale=0.1,
        degrees_of_freedom=3 * system.num_particles - 3,
    )
    ctx = Context(respa, integ, make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=3)
    t0 = time.perf_counter()
    ctx.step(1)
    log(f"water100k compile {time.perf_counter()-t0:.0f}s")
    # 600 melt + 8 ps NVT (box stays fixed; the NPT bench adds its barostat)
    _melt_then_nvt(ctx, 300.0, 600, 2000)
    _save("eq_water100k", ctx, n_molecules=n_mol, dt_fs=4.0,
          protocol="600 melt + 8ps NHC NVT @300K, RESPA[4,2,1] cutoff rin=0.6")


def gen_emim():
    from atomsmm_tpu import Context, RESPASystem, SIN_R_Integrator, make_state
    from atomsmm_tpu.minimize import minimize_energy
    from atomsmm_tpu.models import ionic_liquid_system

    system, x, box = ionic_liquid_system(n_pairs=400, method="pme",
                                         neighbors=True)
    respa = RESPASystem(system, rcut_in=0.7, rswitch_in=0.6)
    integ = SIN_R_Integrator(
        0.004, [8, 2, 1], temperature=353.0, time_scale=0.05, friction=10.0
    )
    ctx = Context(respa, integ, make_state(x, box=box, seed=11))
    minimize_energy(ctx, steps=200)
    t0 = time.perf_counter()
    ctx.step(1)
    log(f"emim compile {time.perf_counter()-t0:.0f}s")
    ctx.step(199)
    ctx.retune_neighbors()
    # 5000 x 4 fs = 20 ps at 353 K
    done = 0
    while done < 5000:
        ctx.step(500)
        done += 500
        log(f"  nvt {done}/5000  T={float(ctx.temperature()):.1f}K")
    _save("eq_emim", ctx, n_pairs=400, dt_fs=4.0,
          protocol="minimize + 20ps SIN(R)@4fs PME @353K, rin=0.7")


def gen_tip3p30k():
    from atomsmm_tpu import Context, GlobalThermostatIntegrator, make_state
    from atomsmm_tpu.integrate.propagators import NoseHooverChainPropagator
    from atomsmm_tpu.models import rigid_water_system

    n_mol = 10000
    system, x, box = rigid_water_system(n_molecules=n_mol, r_cut=0.9,
                                        r_switch=0.8, neighbors=True)
    dof = 3 * system.num_particles - system.num_constraints - 3
    integ = GlobalThermostatIntegrator(
        0.002, NoseHooverChainPropagator(300.0, dof, 0.1))
    ctx = Context(system, integ, make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=9)
    t0 = time.perf_counter()
    ctx.step(1)
    log(f"tip3p30k compile {time.perf_counter()-t0:.0f}s")
    # 600 melt + 10000 x 2 fs = 20 ps NVT
    _melt_then_nvt(ctx, 300.0, 600, 10000)
    _save("eq_tip3p30k", ctx, n_molecules=n_mol, dt_fs=2.0,
          protocol="600 melt + 20ps NHC NVT @300K, rigid TIP3P SETTLE VV@2fs")


if __name__ == "__main__":
    which = set(sys.argv[1:]) or {"water30k"}
    if "all" in which:
        which = {"water30k", "water100k", "emim", "tip3p30k"}
    if "water30k" in which:
        gen_water30k()
    if "water100k" in which:
        gen_water100k()
    if "emim" in which:
        gen_emim()
    if "tip3p30k" in which:
        gen_tip3p30k()
