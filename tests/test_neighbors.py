"""M2: cell-list production path vs. the dense reference path.

The invariant (SURVEY.md §7 M2): the cell-block path must reproduce the dense
path's energies and forces to floating-point roundoff on the same systems,
including small boxes whose periodic cell grid degenerates (<3 cells/dim,
where naive stencil maps double count).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
from atomsmm_tpu.models import argon_system, water_system
from atomsmm_tpu.ops.neighbors import (
    NBR_BUCKET,
    build_cell_buckets,
    make_aux,
    neighbor_list_extras,
)
from atomsmm_tpu.potential import force_fn, potential_energy


def _aux(system, x, box):
    extra = neighbor_list_extras(system.neighbors, x, box)
    assert not bool(extra["nbr_overflow"])
    return make_aux(system, extra)


@pytest.mark.parametrize("n,jitter", [(216, 0.05), (216, 0.3)])
def test_argon_cell_vs_dense(n, jitter):
    system, x, box = argon_system(n=n, jitter=jitter, seed=1, neighbors=True)
    aux = _aux(system, x, box)
    e_dense = potential_energy(system, x, box)
    e_nbr = potential_energy(system, x, box, aux=aux)
    np.testing.assert_allclose(float(e_nbr), float(e_dense), rtol=1e-12)

    _, f_dense = force_fn(system)(x, box)
    _, f_nbr = force_fn(system)(x, box, aux=aux)
    np.testing.assert_allclose(
        np.asarray(f_nbr), np.asarray(f_dense), rtol=1e-9, atol=1e-9
    )


@pytest.mark.parametrize("cpc", [1, 2])
def test_water_cell_vs_dense_small_box(cpc):
    # 64 molecules -> ~1.2 nm box: grid degenerates to 1-2 cells per dim,
    # exercising the deduplicated stencil map; cpc=2 exercises fine cells.
    from atomsmm_tpu.ops.neighbors import make_neighbor_spec

    system, x, box = water_system(n_molecules=64, r_cut=0.55, r_switch=0.45, neighbors=True)
    if cpc == 2:
        nb = system.forces[0]
        spec = make_neighbor_spec(
            np.asarray(box), x.shape[0], float(nb.r_cut),
            exclusions=nb.exclusions, cells_per_cutoff=2,
        )
        system = system.with_neighbors(spec)
    aux = _aux(system, x, box)
    e_dense = potential_energy(system, x, box)
    e_nbr = potential_energy(system, x, box, aux=aux)
    np.testing.assert_allclose(float(e_nbr), float(e_dense), rtol=1e-12)
    _, f_dense = force_fn(system)(x, box)
    _, f_nbr = force_fn(system)(x, box, aux=aux)
    np.testing.assert_allclose(
        np.asarray(f_nbr), np.asarray(f_dense), rtol=1e-8, atol=1e-8
    )


def test_cell_explicit_forces_match_autodiff():
    system, x, box = argon_system(n=216, jitter=0.1, seed=2, neighbors=True)
    aux = _aux(system, x, box)
    force = system.forces[0]
    e, f_explicit = force.energy_and_forces(x, box, {}, aux)
    e2, g = jax.value_and_grad(lambda xx: force.energy(xx, box, {}, aux))(x)
    np.testing.assert_allclose(float(e), float(e2), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(f_explicit), -np.asarray(g), rtol=1e-9, atol=1e-10
    )


def test_buckets_cover_all_atoms():
    system, x, box = argon_system(n=216, jitter=0.2, seed=3, neighbors=True)
    bucket, overflow = build_cell_buckets(system.neighbors, x, box)
    assert not bool(overflow)
    ids = np.asarray(bucket).ravel()
    real = ids[ids < 216]
    assert len(real) == 216 and len(set(real.tolist())) == 216


def test_nve_with_cell_rebuilds():
    """Dynamics on the cell path: conserved energy across rebuilds."""
    system, x, box = argon_system(n=216, jitter=0.05, seed=1, neighbors=True)
    ctx = Context(system, VelocityVerletIntegrator(dt=0.002), make_state(x, box=box))
    ctx.set_velocities_to_temperature(120.0, seed=42)
    e0 = float(ctx.conserved_energy())
    ctx.step(300)
    e1 = float(ctx.conserved_energy())
    assert abs(e1 - e0) / 216 < 1e-4, (e0, e1)


def test_dense_and_cell_trajectories_agree():
    """Same initial conditions, both paths: trajectories should track each
    other closely over a short run (identical physics, different summation
    order)."""
    common = dict(n=125, jitter=0.05, seed=1)
    sys_d, x, box = argon_system(**common, neighbors=False)
    sys_n, _, _ = argon_system(**common, neighbors=True)
    ctxs = []
    for system in (sys_d, sys_n):
        ctx = Context(system, VelocityVerletIntegrator(dt=0.002), make_state(x, box=box))
        ctx.set_velocities_to_temperature(120.0, seed=9)
        ctx.step(50)
        ctxs.append(ctx)
    dx = np.asarray(ctxs[0].state.x) - np.asarray(ctxs[1].state.x)
    assert np.abs(dx).max() < 1e-7, np.abs(dx).max()


def test_overflow_detection():
    system, x, box = argon_system(n=216, jitter=0.05, seed=1, neighbors=True)
    spec = dataclasses.replace(system.neighbors, cell_capacity=8)
    _, overflow = build_cell_buckets(spec, x, box)
    assert bool(overflow)


def test_half_stencil_matches_full_and_dense():
    """Newton half-stencil path (active on grids >= 2*reach+1) must match the
    full-stencil and dense paths."""
    import dataclasses

    from atomsmm_tpu.ops.neighbors import cell_pair_energy_forces

    system, x, box = argon_system(n=1000, jitter=0.3, seed=4, neighbors=True)
    spec = system.neighbors
    assert spec.half_stencil, spec.grid
    extra = neighbor_list_extras(spec, x, box)
    bucket = extra[NBR_BUCKET]
    force = system.forces[0]
    pair_fn = force._pair_fn({})
    pp = force._per_particle({})

    e_h, f_h = cell_pair_energy_forces(pair_fn, x, box, pp, spec, bucket, force.r_cut)
    full_spec = dataclasses.replace(spec, half_stencil=False)
    e_f, f_f = cell_pair_energy_forces(pair_fn, x, box, pp, full_spec, bucket, force.r_cut)
    np.testing.assert_allclose(float(e_h), float(e_f), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(f_h), np.asarray(f_f), rtol=1e-9, atol=1e-10)

    e_d = potential_energy(system, x, box)
    np.testing.assert_allclose(float(e_h), float(e_d), rtol=1e-12)


def test_coverage_loss_detection():
    """ADVICE r01 (medium): an NPT box shrink can make reach*cell_width <
    r_cut, silently dropping pairs. The rebuild must flag under-coverage —
    but ONLY along dims where the stencil does not wrap the whole grid
    (r4: on a wrapping dim every cell pair is a candidate, so nothing can
    be dropped and flagging would be a false fatal error)."""
    from atomsmm_tpu.ops.neighbors import (
        coverage_deficient,
        make_aux,
        update_neighbors,
    )
    from atomsmm_tpu.potential import potential_energy

    # constrained grid (needs 2*reach+1 < grid): 4096 atoms -> grid >= 4
    system, x, box = argon_system(n=4096, jitter=0.05, seed=2,
                                  neighbors=True)
    spec = system.neighbors
    assert min(spec.grid) > 2 * max(spec.reach) + 1
    assert not bool(coverage_deficient(spec, box))
    extra = neighbor_list_extras(spec, x, box)
    assert not bool(extra["nbr_undercover"])

    # shrink far enough to break coverage at the fixed reach
    r_cut = float(spec.r_build - spec.skin)
    w_min = float(np.min(np.asarray(box) / np.asarray(spec.grid)))
    factor = 0.95 * r_cut / (w_min * max(spec.reach))
    small = box * factor
    assert bool(coverage_deficient(spec, small))
    out = update_neighbors(spec, extra, x * factor, small)
    assert bool(out["nbr_undercover"])

    # wrapping grid (512 atoms -> 3^3 cells, stencil spans all 3 per dim):
    # the same relative shrink loses nothing — prove it by energy parity
    # with the dense path at the shrunken box, and the flag stays quiet
    system3, x3, box3 = argon_system(n=512, jitter=0.05, seed=2,
                                     neighbors=True)
    spec3 = system3.neighbors
    assert max(spec3.grid) <= 2 * max(spec3.reach) + 1
    r_cut3 = float(spec3.r_build - spec3.skin)
    w3 = float(np.min(np.asarray(box3) / np.asarray(spec3.grid)))
    f3 = 0.95 * r_cut3 / (w3 * max(spec3.reach))
    small3, xs3 = box3 * f3, x3 * f3
    assert not bool(coverage_deficient(spec3, small3))
    aux = make_aux(system3, neighbor_list_extras(spec3, xs3, small3))
    e_cell = float(potential_energy(system3, xs3, small3, aux=aux))
    e_dense = float(potential_energy(system3, xs3, small3))
    np.testing.assert_allclose(e_cell, e_dense, rtol=1e-10)


def test_grouped_neighbor_updates_match_per_step():
    """Context(neighbor_update_every=2): same physics as per-step updates —
    trajectories agree to integration precision over a short run, and the
    staleness guard stays quiet at normal temperatures."""
    from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
    from atomsmm_tpu.models import argon_system

    system, x, box = argon_system(n=216, jitter=0.1, seed=3, neighbors=True)
    integ = VelocityVerletIntegrator(0.002)
    c1 = Context(system, integ, make_state(x, box=box))
    c1.set_velocities_to_temperature(120.0, seed=5)
    v0 = c1.state.v
    c2 = Context(system, integ, make_state(x, v=v0, box=box),
                 neighbor_update_every=2)
    c1.step(31)
    c2.step(31)
    np.testing.assert_allclose(np.asarray(c2.state.x), np.asarray(c1.state.x),
                               atol=1e-10)


def test_staleness_flags_single_atom():
    """N == 1 has no two-largest-displacement pair bound: top_k(d2, 2) used
    to fail outright (ADVICE r3); the fallback 2*max bound must evaluate."""
    from atomsmm_tpu.models import argon_system
    from atomsmm_tpu.ops.neighbors import (
        neighbor_list_extras,
        staleness_flags,
    )

    system, x, box = argon_system(n=1, jitter=0.0, seed=0, neighbors=True,
                                  r_cut=0.15, r_switch=0.1)
    spec = system.neighbors
    extra = neighbor_list_extras(spec, x, box)
    flags = staleness_flags(system, extra, x, box)
    assert not bool(flags["nbr_stale"])  # no motion -> not stale
    x_moved = x + 2.0 * float(spec.skin)
    flags = staleness_flags(system, extra, x_moved, box)
    assert bool(flags["nbr_stale"])  # 2*max bound trips


def test_staleness_guard_raises():
    """An atom crossing the full skin between grouped updates must raise,
    not silently drop pairs."""
    import pytest

    from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
    from atomsmm_tpu.models import argon_system

    system, x, box = argon_system(n=216, jitter=0.05, seed=3, neighbors=True)
    ctx = Context(system, VelocityVerletIntegrator(0.002),
                  make_state(x, box=box), neighbor_update_every=8)
    # absurd velocities: ~0.2 nm per step >> skin
    ctx.set_velocities(jnp.full_like(ctx.state.v, 100.0))
    with pytest.raises(RuntimeError, match="staleness"):
        ctx.step(8)


def test_coverage_wrap_aware_and_effective_skin():
    """r4: along dims where the stencil wraps the whole periodic grid
    (2*reach+1 >= grid) EVERY cell pair is a candidate, so coverage can
    never be lost there — a small-grid NPT compression must not raise the
    fatal coverage error. And the displacement margin (effective skin)
    must tighten with the box: after a shrink the geometric margin above
    the cutoff is smaller than the setup-time spec.skin."""
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.neighbors import (
        coverage_deficient,
        effective_skin,
    )

    # grid 2^3 -> full wrap: no compression can lose coverage
    system, x, box = water_system(n_molecules=64, r_cut=0.5, r_switch=0.4,
                                  neighbors=True)
    spec = system.neighbors
    assert max(spec.grid) <= 3  # premise: wrapping stencil
    assert not bool(coverage_deficient(spec, box * 0.7))
    np.testing.assert_allclose(float(effective_skin(spec, box * 0.7)),
                               float(spec.skin), rtol=1e-12)

    # constrained grid: effective skin == spec.skin at the setup box,
    # shrinks linearly with compression, hits 0 at the coverage boundary
    system2, x2, box2 = argon_system(n=4096, jitter=0.05, seed=2,
                                     neighbors=True)
    spec2 = system2.neighbors
    assert min(spec2.grid) >= 4
    np.testing.assert_allclose(float(effective_skin(spec2, box2)),
                               float(spec2.skin), rtol=1e-10)
    r_cut = float(spec2.r_build - spec2.skin)
    w_min = float(np.min(np.asarray(box2) / np.asarray(spec2.grid)))
    s_half = (r_cut + 0.5 * float(spec2.skin)) / (w_min * max(spec2.reach))
    eff = float(effective_skin(spec2, box2 * s_half))
    assert 0.0 < eff < float(spec2.skin)
    s_edge = 0.95 * r_cut / (w_min * max(spec2.reach))
    assert float(effective_skin(spec2, box2 * s_edge)) == 0.0
    assert bool(coverage_deficient(spec2, box2 * s_edge))


def test_retune_grow_only_floors_capacity():
    """Overflow auto-recovery retunes on the PRE-chunk state and replays the
    chunk with the same RNG; a retune that shrinks (or reproduces) capacity
    would overflow again deterministically (the r4 NPT livelock). grow_only
    must floor every capacity at current + 4 even when the measured
    occupancy says less."""
    from atomsmm_tpu.ops.neighbors import make_neighbor_spec, retune_spec

    box = np.asarray([4.0, 4.0, 4.0])
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 4.0, (500, 3))
    spec = make_neighbor_spec(box, n=500, r_cut_max=0.9, density_safety=3.0)
    shrunk = retune_spec(spec, x, box, safety=1.05)
    assert shrunk.cell_capacity < spec.cell_capacity  # retune CAN shrink
    floored = retune_spec(spec, x, box, safety=1.05,
                          floor=spec.cell_capacity + 4)
    assert floored.cell_capacity >= spec.cell_capacity + 4


def test_retune_neighbor_specs_grow_only():
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.neighbors import iter_specs, retune_neighbor_specs

    system, x, box = water_system(n_molecules=216, neighbors=True)
    caps0 = [s.cell_capacity for _, s in iter_specs(system)]
    grown = retune_neighbor_specs(system, x, box, safety=1.0, grow_only=True)
    caps1 = [s.cell_capacity for _, s in iter_specs(grown)]
    assert all(b >= a + 4 for a, b in zip(caps0, caps1))


def test_retune_refuses_nonfinite_positions():
    """A diverged trajectory (NaN positions) must fail loudly at retune: NaN
    atoms all clip into cell 0, so the 'measured' occupancy is ~N and the
    retuned capacity would size a pair matrix quadratic in N (observed as a
    66 GB compile-time allocation on the 30k rigid-water bench)."""
    from atomsmm_tpu.ops.neighbors import make_neighbor_spec, retune_spec

    box = np.asarray([4.0, 4.0, 4.0])
    x = np.random.RandomState(0).uniform(0, 4.0, (500, 3))
    spec = make_neighbor_spec(box, n=500, r_cut_max=0.9)
    xbad = x.copy()
    xbad[17] = np.nan
    with pytest.raises(FloatingPointError, match="diverged"):
        retune_spec(spec, xbad, box)
