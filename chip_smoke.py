"""Prove the production MD path on an NVIDIA GPU, through the public API.

Usage:
  python chip_smoke.py          # one GPU: device, correctness gate, and the
                                # 30k-water RESPA main path (cutoff and PME)
  python chip_smoke.py --multi  # four GPUs: replicated boxes, spatial
                                # decomposition (slab-FFT PME) and HREX,
                                # each compared with one-GPU runs

Phases, all in this one process (the only one that opens the card):

1. device — JAX's default device must be a GPU. Without one the script
   exits non-zero, names what is missing and never continues on the CPU.
   Prints the JAX version, the device kind and the card's name and power
   limit (nvidia-smi, from a child process that stays off JAX).
2. gate — per-group energies and forces of the f32 cell-list path on the
   GPU against the f64 dense path on the CPU (argon 4096, water 3000 RESPA,
   water 3000 PME at order 6, TIP4P/Ew 3000 with virtual sites, triclinic
   argon 1728), plus at real width the 30k-atom PME water state
   (bench_data/eq_water30k.npz): its reciprocal and total forces on the GPU
   (block-binned spreading, as production runs it) against the f64 CPU
   path. Then the argon NVE drift and the SETTLE geometry residual on the
   GPU. Tolerances: energy rel <= 5e-4, force max|dF| <= 2e-5 of the
   group's max component, NVE drift <= 2e-4 kJ/mol/atom/ps, SETTLE
   residual <= 2e-5.
3. headline — 30k q-SPC/Fw water, RESPASystem (near cutoff 0.5 nm),
   MultipleTimeScaleIntegrator [4, 2, 1] at 4 fs, NHC NVT at 300 K, built
   exactly as bench.py builds it: compile, 250 re-equilibration steps, 200
   timed steps (twice), 1000 telemetry steps graded against bench.EXPECT,
   the per-force-group in-loop times, and a checkpoint save/resume round
   trip.
4. pme — the same with the PME far force and block-binned spreading.

x64: the f64 references need it and the main path must run as users run
it, without it. So every reference is computed first, on the CPU device,
inside one `jax.enable_x64(True)` scope; everything on the GPU runs after
that scope has closed, with x64 off.

The last line of stdout is the JSON record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed; otherwise the script exits 1
without it.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

E_REL = 5e-4        # per-group energy, relative to max(|E|, 1)
F_REL = 2e-5        # per-group max|dF| over the group's max |F| component
NVE_DRIFT = 2e-4    # kJ/mol/atom/ps
SETTLE_RES = 2e-5   # max relative geometry residual
TRAJ_TOL = 1e-3     # nm, max |dx| between a sharded and a one-GPU run,
PERTURB = 1e-6      # or the max |dx| a one-GPU run reaches from a start
                    # PERTURB nm away (~2 f32 ulps at the box edge)
MULTI = 4           # cards the --multi phase needs


def result_line(devices) -> str:
    """The contract's last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


class Report:
    """Prints every check with its measured value and limit; remembers
    what failed. A phase's exception is printed and counted as a failure,
    never swallowed."""

    def __init__(self):
        self.failed = []

    def check(self, label, value, limit):
        ok = bool(np.isfinite(value) and value <= limit)
        print(f"{'PASS' if ok else 'FAIL'}  {label}: {value:.3e} "
              f"(limit {limit:.1e})", flush=True)
        if not ok:
            self.failed.append(label)
        return ok

    def phase(self, name, fn, *args):
        print(f"\n== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(self, *args)
        except Exception:
            traceback.print_exc()
            print(f"FAIL  {name}: exception (traceback on stderr)",
                  flush=True)
            self.failed.append(f"{name} (exception)")
        print(f"-- {name}: {time.perf_counter() - t0:.1f} s", flush=True)


# --- correctness gate --------------------------------------------------------


def _groups(system):
    return sorted({int(f.group) for f in system.forces
                   if not type(f).__name__.startswith("MonteCarlo")})


def _healthy_aux(system, x, box):
    """Cell-list aux at (x, box), retuned when the builder's cold-start
    capacity overflows: a direct aux consumer has no Context auto-recovery,
    and a silently dropped pair would read as a precision failure."""
    import jax

    from atomsmm_tpu.ops.neighbors import (
        all_neighbor_extras,
        assert_neighbor_health,
        make_aux,
        retune_neighbor_specs,
        unhealthy_flags,
    )

    extras = jax.jit(all_neighbor_extras)(system, x, box)
    if any(bool(f) for f in unhealthy_flags(extras)):
        system = retune_neighbor_specs(system, x, box)
        extras = jax.jit(all_neighbor_extras)(system, x, box)
    assert_neighbor_health(extras)
    return system, make_aux(system, extras)


def _evaluate(system, x, box, cells):
    """{group: (energy, forces)} on the current default device; the cell
    path when `cells`, else the dense path."""
    import jax

    from atomsmm_tpu.potential import force_fn

    aux = None
    if cells:
        system, aux = _healthy_aux(system, x, box)
    out = {}
    for g in _groups(system):
        e, f = jax.jit(force_fn(system, {g}))(x, box, {}, aux)
        out[g] = (float(e), np.asarray(f, np.float64))
    return out


def _reciprocal(system, x, box):
    """Reciprocal-space PME energy and forces of the system's PME force,
    with the spreading its parameters select (dense or block-binned)."""
    import jax

    from atomsmm_tpu.forces import _pme_carrier
    from atomsmm_tpu.ops.pme import pme_reciprocal_energy

    [nb] = [g for g in map(_pme_carrier, system.forces) if g is not None]

    def energy(xx):
        return pme_reciprocal_energy(
            xx, box, nb.charge, nb.ewald_alpha, nb.grid_shape,
            nb.spline_order, spread_block=nb.spread_block or None,
            spread_cap=nb.spread_cap)

    e, g = jax.jit(jax.value_and_grad(energy))(x)
    spreading = (f"block-binned {tuple(nb.spread_block)} cap "
                 f"{nb.spread_cap}" if nb.spread_block else "dense one-hot")
    return float(e), -np.asarray(g, np.float64), spreading


def _compare(rep, label, ref, got, skip=()):
    """Energy and force checks; `skip` atoms (see _cutoff_straddlers) are
    left out of max|dF| and reported."""
    e_ref, f_ref = ref
    e_got, f_got = got
    rel = abs(e_got - e_ref) / max(abs(e_ref), 1.0)
    rep.check(f"{label} energy rel (E_f64 {e_ref:.6f}, E_f32 {e_got:.6f} "
              "kJ/mol)", rel, E_REL)
    scale = max(float(np.abs(f_ref).max()), 1.0)
    err = np.abs(f_got - f_ref).max(axis=1)
    worst = int(np.argmax(err))
    note = ""
    if len(skip):
        print(f"{label}: all atoms max|dF| {err[worst]:.3e} at atom {worst}"
              f" ({'a' if worst in set(skip) else 'not a'} cutoff "
              f"straddler); {len(skip)} straddlers left out below")
        err = np.delete(err, skip)
        note = f", {len(skip)} straddlers out"
    df = float(err.max())
    rep.check(f"{label} force max|dF|/max|F| (max|dF| {df:.3e}, scale "
              f"{scale:.1e} kJ/mol/nm{note})", df / scale, F_REL)


def _cutoff_straddlers(system, x, box, band=1e-5):
    """Atoms with a partner whose r^2 lies within `band` (relative) of the
    PME direct-space cutoff^2. The truncated erfc Coulomb sum jumps there
    (by up to ~0.2 kJ/mol/nm for a water O-H charge pair at 0.9 nm), and
    f32 rounding of r^2 (~1e-6 relative) can count such a pair on the
    other side of the cutoff than f64 does — a property of the truncated
    potential, not an arithmetic error of the f32 path. Orthorhombic
    boxes; () when the system has no PME force."""
    from scipy.spatial import cKDTree

    from atomsmm_tpu.forces import _pme_carrier

    carriers = [g for g in map(_pme_carrier, system.forces) if g is not None]
    if not carriers:
        return ()
    r_cut = float(carriers[0].r_cut)
    box = np.asarray(box, np.float64)
    xw = np.mod(np.asarray(x, np.float64), box)
    xw = np.where(xw >= box, xw - box, xw)
    pairs = cKDTree(xw, boxsize=box).query_pairs(
        r_cut * np.sqrt(1.0 + band), output_type="ndarray")
    d = xw[pairs[:, 0]] - xw[pairs[:, 1]]
    d -= box * np.round(d / box)
    near = np.abs(np.sum(d * d, axis=1) / r_cut ** 2 - 1.0) < band
    return np.unique(pairs[near].ravel())


def gate_systems(water_n=1000, argon_n=4096, tip4p_n=750, tri_grid=12):
    """(label, build(dtype) -> (system, x, box), position jitter [nm]).
    Thermal jitter on the lattice builds: at the pristine lattice the
    bonded reference forces are ~0 and the f32 position roundoff of the
    stiff springs would swamp any relative measure."""
    from atomsmm_tpu import RESPASystem
    from atomsmm_tpu.models import (
        argon_system,
        tip4p_water_system,
        water_system,
    )

    def argon(dtype):
        return argon_system(n=argon_n, jitter=0.1, seed=1, neighbors=True,
                            dtype=dtype)

    def water_respa(dtype):
        s, x, b = water_system(n_molecules=water_n, method="cutoff",
                               neighbors=True, dtype=dtype)
        return RESPASystem(s, rcut_in=0.7, rswitch_in=0.6), x, b

    def water_pme(dtype):
        return water_system(n_molecules=water_n, method="pme",
                            neighbors=True, dtype=dtype,
                            dispersion_correction=True)

    def tip4p(dtype):
        return tip4p_water_system(n_molecules=tip4p_n, neighbors=True,
                                  dtype=dtype)

    def triclinic_argon(dtype):
        from atomsmm_tpu.ops.neighbors import make_neighbor_spec
        from atomsmm_tpu.ops.pbc import triclinic_from_lengths_angles
        from atomsmm_tpu.utils import replace

        h = 3.0 * np.asarray(triclinic_from_lengths_angles(
            2.2, 2.0, 2.4, 90.0, 105.0, 80.0))
        h = h * tri_grid / 12.0
        rs = np.random.RandomState(7)
        frac = np.stack(np.meshgrid(*[np.arange(tri_grid)] * 3,
                                    indexing="ij"), -1).reshape(-1, 3)
        frac = frac / tri_grid + rs.uniform(-0.015, 0.015, (len(frac), 3))
        x = frac @ h
        system, _, _ = argon_system(n=len(x), jitter=0.0, seed=2, r_cut=0.7,
                                    r_switch=0.6, dtype=dtype)
        system = replace(system, default_box=np.asarray(h, dtype))
        system = system.with_neighbors(
            make_neighbor_spec(h, len(x), 0.7, occupancy_floor_from=x))
        return system, np.asarray(x, dtype), np.asarray(h, dtype)

    return [
        (f"argon {argon_n}, LJ cutoff+switch", argon, 0.0),
        (f"water {3 * water_n}, RESPA near/far", water_respa, 0.004),
        (f"water {3 * water_n}, PME order 6", water_pme, 0.004),
        (f"TIP4P/Ew {4 * tip4p_n} sites, virtual sites", tip4p, 0.004),
        (f"triclinic argon {tri_grid ** 3}, sheared cells", triclinic_argon,
         0.0),
    ]


def pme_water(dtype, x, n_molecules):
    """The PME water system at positions x (cell lists retuned to them)."""
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.neighbors import retune_neighbor_specs

    system, _, box = water_system(n_molecules=n_molecules, method="pme",
                                  neighbors=True, dtype=dtype)
    x = np.asarray(x, dtype)
    return retune_neighbor_specs(system, x, box), x, box


def gate(rep, gpu, cpu, systems=None, pme_molecules=10000, nve_n=4096,
         settle_n=1000, nve_steps=1000, settle_steps=500):
    import jax
    import jax.numpy as jnp

    from bench import load_eq

    systems = gate_systems() if systems is None else systems
    print(f"GPU path: f32 cell lists on {gpu.device_kind}; reference: f64 "
          f"on the CPU (dense path; cell lists for the {3 * pme_molecules}-"
          f"atom PME state). PME spreading and CMAP matrix products "
          f"run at Precision.HIGHEST (FP32 inputs, no TF32); "
          f"jax_default_matmul_precision = "
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    # the real-width PME check runs on the equilibrated 30k state; other
    # sizes (rehearsals) on a jittered lattice
    if pme_molecules == 10000:
        x_pme = np.asarray(load_eq("eq_water30k")[0], np.float32)
    else:
        from atomsmm_tpu.models import water_system

        _, x_pme, _ = water_system(n_molecules=pme_molecules, method="pme",
                                   dtype=np.float32)
        x_pme = np.asarray(x_pme) + np.random.RandomState(1).normal(
            0.0, 0.004, x_pme.shape).astype(np.float32)

    # f64 references first, on the CPU, in the only x64 scope
    refs, positions = {}, {}
    t0 = time.perf_counter()
    with jax.enable_x64(True), jax.default_device(cpu):
        for label, build, jitter in systems:
            system, x, box = build(np.float64)
            x = np.asarray(x, np.float64)
            if jitter:
                x = x + np.random.RandomState(0).normal(0.0, jitter, x.shape)
            # both paths see the same f32-representable positions
            x = x.astype(np.float32).astype(np.float64)
            positions[label] = x
            refs[label] = _evaluate(system, jnp.asarray(x),
                                    jnp.asarray(box), cells=False)
        system, x, box = pme_water(np.float64, x_pme, pme_molecules)
        xb, bb = jnp.asarray(x), jnp.asarray(box)
        refs["pme"] = (_evaluate(system, xb, bb, cells=True),
                       _reciprocal(system, xb, bb))
    print(f"f64 CPU references: {time.perf_counter() - t0:.1f} s", flush=True)

    # the f32 production path on the GPU, x64 off
    with jax.default_device(gpu):
        for label, build, _ in systems:
            system, _, box = build(np.float32)
            x = jnp.asarray(positions[label], jnp.float32)
            got = _evaluate(system, x, jnp.asarray(box, jnp.float32),
                            cells=True)
            skip = _cutoff_straddlers(system, positions[label], box)
            for g, ref in refs[label].items():
                _compare(rep, f"{label}, group {g}", ref, got[g], skip)
        from atomsmm_tpu.forces import retune_pme_spread

        system, x, box = pme_water(np.float32, x_pme, pme_molecules)
        system = retune_pme_spread(system, x, box)
        x, box = jnp.asarray(x), jnp.asarray(box)
        groups_ref, (er, fr, spread_ref) = refs["pme"]
        e, f, spread = _reciprocal(system, x, box)
        label = f"water {x.shape[0]} PME reciprocal"
        print(f"{label}: GPU spreading {spread}, reference {spread_ref}")
        _compare(rep, label, (er, fr), (e, f))
        got = _evaluate(system, x, box, cells=True)
        skip = _cutoff_straddlers(system, x_pme, box)
        for g, ref in groups_ref.items():
            _compare(rep, f"water {x.shape[0]} PME total, group {g}", ref,
                     got[g], skip)

        nve_drift(rep, nve_n, nve_steps)
        settle_geometry(rep, settle_n, settle_steps)


def nve_drift(rep, n=4096, steps=1000):
    from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
    from atomsmm_tpu.models import argon_system

    system, x, box = argon_system(n=n, jitter=0.1, seed=1, neighbors=True,
                                  dtype=np.float32)
    ctx = Context(system, VelocityVerletIntegrator(dt=0.002),
                  make_state(x, box=box))
    ctx.set_velocities_to_temperature(120.0, seed=3)
    e0 = float(ctx.conserved_energy())
    ctx.step(steps)
    e1 = float(ctx.conserved_energy())
    span_ps = steps * 0.002
    rep.check(f"NVE drift, argon {n}, {span_ps:g} ps (kJ/mol/atom/ps)",
              abs(e1 - e0) / n / span_ps, NVE_DRIFT)


def settle_geometry(rep, n_molecules=1000, steps=500):
    from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
    from atomsmm_tpu.models import rigid_water_system
    from atomsmm_tpu.ops.settle import settle_residual

    system, x, box = rigid_water_system(n_molecules=n_molecules,
                                        neighbors=True, dtype=np.float32)
    ctx = Context(system, VelocityVerletIntegrator(dt=0.002),
                  make_state(x, box=box))
    ctx.set_velocities_to_temperature(300.0, seed=5)
    ctx.step(steps)
    rep.check(f"SETTLE residual, rigid TIP3P {3 * n_molecules}, "
              f"{steps * 0.002:g} ps", float(settle_residual(
                  system.settle, ctx.state.x)), SETTLE_RES)


# --- main path ---------------------------------------------------------------


def main_path(rep, method, card, n_molecules=10000, eq_steps=250, steps=200,
              telemetry_steps=1000, resume_steps=50):
    """The headline through Context, as bench.py builds it."""
    import jax

    import bench
    from atomsmm_tpu.checkpoint import load_checkpoint, save_checkpoint
    from atomsmm_tpu.profiling import profile_forces

    tag = f"water30k_respa_{method}"
    dt = bench.HEADLINE_DT
    ctx, from_eq = bench.water_respa_context(n_molecules, method=method,
                                             tag=tag)
    if n_molecules == 10000 and not from_eq:
        raise RuntimeError("bench_data/eq_water30k.npz is missing")
    n = ctx.system.num_particles
    t0 = time.perf_counter()
    jax.block_until_ready(ctx.step(1).state)
    print(f"compile + first step: {time.perf_counter() - t0:.1f} s")
    jax.block_until_ready(ctx.step(eq_steps).state)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(ctx.step(steps).state)
        times.append(time.perf_counter() - t0)
    best = min(times)
    ms = best / steps * 1e3
    ns_day = dt * 1e-3 * steps / best * 86400.0
    print(f"{n} atoms, RESPA {bench.HEADLINE_LOOPS} @ {dt * 1e3:g} fs, "
          f"{method}: {ms} ms/step, {ns_day} ns/day (best of "
          f"{[round(t / steps * 1e3, 4) for t in times]} ms/step over "
          f"{steps} steps) on {card}")

    # per-group times at the capacities the timed window ran with (the
    # telemetry below may grow them through overflow auto-recovery)
    names = {0: "bonded", 1: "near sweep", 2: "far sweep"}
    for key, t in profile_forces(ctx).items():
        g = int(key.split()[1]) if key.startswith("group") else None
        label = f"{key} ({names[g]})" if g in names else key
        print(f"in-loop {label}: {t} ms/eval")

    extras = {}
    bench.telemetry(ctx, telemetry_steps, 250, dt, tag, extras)
    print(f"telemetry over {telemetry_steps} steps: T "
          f"{extras[f'{tag}_T_K']} K, PE/N {extras[f'{tag}_PE_per_atom']} "
          f"kJ/mol, drift {extras[f'{tag}_drift_kJ_mol_atom_ps']} "
          f"kJ/mol/atom/ps; band {bench.EXPECT[tag]}")
    if not extras[f"{tag}_ok"]:
        print(f"FAIL  {tag} telemetry outside its EXPECT band")
        rep.failed.append(f"{tag} telemetry")
    else:
        print(f"PASS  {tag} telemetry inside its EXPECT band")

    # save/resume: the resumed run continues from the saved state; on a GPU
    # the force scatter-adds sum in a varying order, so the two continuations
    # agree to roundoff growth, not bitwise
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_checkpoint(path, ctx.state)
        like = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), ctx.state)
        x_a = np.asarray(ctx.step(resume_steps).state.x)
        ctx.state = load_checkpoint(path, like)
        x_b = np.asarray(ctx.step(resume_steps).state.x)
    dx = float(np.abs(x_a - x_b).max())
    print(f"checkpoint resume: bitwise {'yes' if dx == 0.0 else 'no'}")
    rep.check(f"checkpoint resume, max|dx| after {resume_steps} steps (nm)",
              dx, TRAJ_TOL)


# --- four cards --------------------------------------------------------------


def _trajectory_check(rep, label, dx, control):
    """MD is chaotic: roundoff-level force differences (another summation
    order, or a pair that f32 rounding puts on the other side of a cutoff)
    grow along a trajectory. So a sharded run may drift from the one-GPU
    run no farther than a one-GPU run drifts from a start PERTURB nm away
    (or TRAJ_TOL, whichever is larger)."""
    limit = max(TRAJ_TOL, control)
    print(f"{label}: control (one-GPU run from a start {PERTURB:g} nm away) "
          f"max|dx| {control:.3e} nm -> limit {limit:.3e} nm")
    rep.check(f"{label} max|dx| (nm)", dx, limit)


def _perturbed(x, seed=11):
    import jax.numpy as jnp

    noise = np.random.RandomState(seed).normal(0.0, PERTURB, np.shape(x))
    return jnp.asarray(x) + jnp.asarray(noise, jnp.asarray(x).dtype)


def _on_all(rep, label, arr, devices):
    got = {s.device for s in arr.addressable_shards}
    ok = got == set(devices)
    print(f"{'PASS' if ok else 'FAIL'}  {label} on devices "
          f"{sorted(d.id for d in got)}")
    if not ok:
        rep.failed.append(f"{label} placement")


def multi(rep, devices, n_molecules=10000, steps=100, hrex_water=1000,
          hrex_steps=50):
    """The three multi-device paths on a 1-D ("dp",) mesh: the cards are
    joined all to all, so no torus shape applies."""
    from jax.sharding import Mesh

    mesh = Mesh(np.array(devices), ("dp",))
    rep.phase("replicas", multi_replicas, mesh, n_molecules, steps)
    rep.phase("spatial", multi_spatial, mesh, n_molecules, steps)
    rep.phase("hrex", multi_hrex, mesh, hrex_water, hrex_steps)


def multi_replicas(rep, mesh, n_molecules, steps):
    """Replicated boxes (parallel/replicas.py): one headline box per card,
    against one-card runs of the same starting velocities."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from atomsmm_tpu.context import refresh_force_caches
    from atomsmm_tpu.ops.neighbors import update_all_neighbors
    from atomsmm_tpu.parallel import make_replicated_step, replicate_state
    from atomsmm_tpu.state import maxwell_boltzmann_velocities
    from atomsmm_tpu.utils import replace

    devices = list(mesh.devices.flat)
    k = len(devices)
    with jax.default_device(devices[0]):
        ctx, _ = bench.water_respa_context(n_molecules)
        system, base = ctx.system, ctx.state
        step = ctx.integrator.make_step()

        def run(system, s, globals):
            def body(i, s):
                s = step(system, s, globals)
                return s.with_extra(**update_all_neighbors(
                    system, s.extra, s.x, s.box))

            s = refresh_force_caches(system, s, globals)
            return jax.lax.fori_loop(0, steps, body, s)

        v = jnp.stack([maxwell_boltzmann_velocities(
            jax.random.PRNGKey(seed), system.masses, 300.0, base.x.dtype)
            for seed in range(k)])
        states = replace(replicate_state(base, k), v=v)
        single = jax.jit(run)
        ref = [np.asarray(single(system, jax.tree.map(
            lambda a, i=i: a[i], states), {}).x) for i in range(k)]
        s0 = jax.tree.map(lambda a: a[0], states)
        control = float(np.abs(np.asarray(single(
            system, replace(s0, x=_perturbed(s0.x)), {}).x) - ref[0]).max())
    sharded = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("dp"))), states)
    out = jax.jit(make_replicated_step(run, mesh))(system, sharded, {})
    jax.block_until_ready(out)
    _on_all(rep, f"{k} replica states", out.x, devices)
    dx = max(float(np.abs(np.asarray(out.x)[i] - ref[i]).max())
             for i in range(k))
    _trajectory_check(rep, f"{k} replicas x {base.x.shape[0]} atoms vs "
                      f"one-card runs after {steps} steps", dx, control)


def multi_spatial(rep, mesh, n_molecules, steps):
    """SpatialContext on the 30k PME water: slab-FFT reciprocal sum and
    home-cell force decomposition, against a one-card Context."""
    import jax

    import bench
    from atomsmm_tpu import (
        Context,
        MultipleTimeScaleIntegrator,
        RESPASystem,
        make_state,
    )
    from atomsmm_tpu.forces import NonbondedForce, last_reciprocal_dispatch
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.neighbors import retune_neighbor_specs
    from atomsmm_tpu.ops.pme import choose_pme_parameters
    from atomsmm_tpu.parallel.mesh import SpatialContext
    from atomsmm_tpu.utils import replace

    devices = list(mesh.devices.flat)
    k = len(devices)
    system, x, box = water_system(n_molecules=n_molecules, method="pme",
                                  neighbors=True)
    eq = bench.load_eq("eq_water30k") if n_molecules == 10000 else None
    v = None
    if eq is not None:
        x, v, box = eq
    [nb] = [f for f in system.forces if isinstance(f, NonbondedForce)]
    _, grid, _ = choose_pme_parameters(float(nb.r_cut), np.asarray(box),
                                       multiple_of=k)
    system = system.replace_forces([
        replace(f, grid_shape=tuple(grid)) if f is nb else f
        for f in system.forces])
    respa = RESPASystem(system, rcut_in=bench.HEADLINE_RCUT_IN,
                        rswitch_in=bench.HEADLINE_RCUT_IN - 0.1)
    respa = retune_neighbor_specs(respa, x, box)

    def integ():
        return MultipleTimeScaleIntegrator(
            bench.HEADLINE_DT, bench.HEADLINE_LOOPS, temperature=300.0,
            time_scale=0.1, degrees_of_freedom=3 * system.num_particles - 3)

    with jax.default_device(devices[0]):
        one = Context(respa, integ(), make_state(x, v=v, box=box))
        if v is None:
            one.set_velocities_to_temperature(300.0, seed=7)
        v0 = np.asarray(one.state.v)
        f_one = np.asarray(one.get_state().forces, np.float64)
        ref = np.asarray(one.step(steps).state.x)
        ctl = Context(respa, integ(), make_state(_perturbed(x), v=v0,
                                                 box=box))
        control = float(np.abs(np.asarray(ctl.step(steps).state.x)
                               - ref).max())
    sctx = SpatialContext(respa, integ(), make_state(x, v=v0, box=box),
                          mesh=mesh)
    f_sp = np.asarray(sctx.get_state().forces, np.float64)
    scale = max(float(np.abs(f_one).max()), 1.0)
    rep.check(f"spatial vs one-card forces at the start, max|dF|/max|F| "
              f"(scale {scale:.1e} kJ/mol/nm)",
              float(np.abs(f_sp - f_one).max()) / scale, F_REL)
    t0 = time.perf_counter()
    jax.block_until_ready(sctx.step(steps).state)
    print(f"spatial: {steps} steps incl. compile "
          f"{time.perf_counter() - t0:.1f} s, grid {tuple(grid)} over {k} "
          "devices")
    dispatch = last_reciprocal_dispatch()
    ok = dispatch == "slab_fft"
    print(f"{'PASS' if ok else 'FAIL'}  reciprocal dispatch: {dispatch}")
    if not ok:
        rep.failed.append("spatial dispatch")
    xs = sctx.state.x
    print(f"spatial state x lives on devices "
          f"{sorted(d.id for d in xs.sharding.device_set)}")
    _trajectory_check(rep, f"spatial vs one-card Context, {x.shape[0]} "
                      f"atoms, after {steps} steps",
                      float(np.abs(np.asarray(xs) - ref).max()), control)


def multi_hrex(rep, mesh, n_water, steps):
    """HREX (parallel/hrex.py): one λ replica per card, sampling chunks and
    a swap step, against the same sampler on one card."""
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu import SolvationSystem
    from atomsmm_tpu.alchemy import coupling_path
    from atomsmm_tpu.models import phenol_in_water
    from atomsmm_tpu.parallel.hrex import HREXSampler

    devices = list(mesh.devices.flat)
    k = len(devices)
    system, x, box, solute = phenol_in_water(n_water=n_water, neighbors=True,
                                             skin=0.2)
    solv = SolvationSystem(system, solute_atoms=solute)
    lams = coupling_path(jnp.linspace(0.0, 1.0, k))
    out = {}
    for name, m in (("one card", None), ("mesh", mesh)):
        with jax.default_device(devices[0]):
            s = HREXSampler(solv, x, box, lams, 300.0, mesh=m, dt=0.001,
                            seed=3)
            s.run(steps)
            s.attempt_swaps()
            s.run(steps)
            jax.block_until_ready(s.states)
        out[name] = s
        print(f"hrex {name}: swap acceptance {s.acceptance_rate}")
    _on_all(rep, f"{k} HREX replica states", out["mesh"].states.x, devices)
    same = out["mesh"].swap_accepts == out["one card"].swap_accepts
    print(f"{'PASS' if same else 'FAIL'}  swap decisions agree "
          f"({out['mesh'].swap_accepts} accepted of "
          f"{out['mesh'].swap_attempts})")
    if not same:
        rep.failed.append("hrex swap decisions")
    rep.check(f"HREX {k} x {x.shape[0]} atoms, mesh vs one card, max|dx| "
              f"after {2 * steps} steps (nm)", float(np.abs(
                  out["mesh"].positions() - out["one card"].positions()
              ).max()), TRAJ_TOL)


# --- entry point -------------------------------------------------------------


def _fail(msg, code):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv):
    want_multi = "--multi" in argv
    # the f64 references run on JAX's CPU backend beside the GPU
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    sys.path.insert(0, HERE)
    try:
        import atomsmm_tpu
    except ImportError as e:
        _fail(f"the atomsmm_tpu package is not beside this script ({e})", 2)
    if os.path.dirname(os.path.abspath(atomsmm_tpu.__file__)) != os.path.join(
            HERE, "atomsmm_tpu"):
        _fail(f"atomsmm_tpu was imported from {atomsmm_tpu.__file__}, not "
              "from this checkout", 2)

    import jax

    from atomsmm_tpu.profiling import require_gpu
    from atomsmm_tpu.utils import enable_compile_cache

    try:
        device = require_gpu()
    except RuntimeError as e:
        _fail(str(e), 2)
    devices = jax.devices()
    print(f"jax {jax.__version__}; device {device['kind']} x "
          f"{device['count']}")
    print(f"card (name, power limit): {device['card']}", flush=True)
    print(f"compile cache: {enable_compile_cache()}")
    rep = Report()
    t_start = time.perf_counter()
    if want_multi:
        if len(devices) < MULTI:
            _fail(f"--multi needs {MULTI} GPUs, JAX sees {len(devices)}", 2)
        devices = devices[:MULTI]
        multi(rep, devices)
    else:
        cpu = jax.devices("cpu")[0]
        rep.phase("gate", gate, devices[0], cpu)
        rep.phase("headline (cutoff)", main_path, "cutoff", device["card"])
        rep.phase("pme", main_path, "pme", device["card"])
    print(f"\ntotal {time.perf_counter() - t_start:.1f} s; card "
          f"{device['card']}")
    if rep.failed:
        print(f"FAILED: {rep.failed}", flush=True)
        sys.exit(1)
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
