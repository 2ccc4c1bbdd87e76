"""M8: Monte Carlo barostat (BASELINE.md config 5, NPT).

Physics oracle: for an ideal gas (no interactions) under MC-NPT, <V> =
(N_mol + 1) kT / P exactly. Plus structural invariants: molecular scaling
preserves intramolecular geometry, acceptance bookkeeping advances, NPT water
stays finite with a sane density trend.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from atomsmm_tpu import (
    Context,
    MonteCarloBarostat,
    System,
    VelocityVerletIntegrator,
    make_state,
)
from atomsmm_tpu.integrate.barostat import (
    BARO_NACC,
    BARO_NATT,
    molecular_scale,
)
from atomsmm_tpu.units import BOLTZMANN, PRESSURE_IN_BAR


def test_molecular_scale_preserves_geometry():
    from atomsmm_tpu.models import water_system

    system, x, box = water_system(n_molecules=27, r_cut=0.4, r_switch=0.3)
    s = 1.07
    x2 = molecular_scale(
        x, system.molecule, system.num_molecules, system.masses, jnp.asarray(s)
    )
    d1 = np.asarray(x).reshape(-1, 3, 3)
    d2 = np.asarray(x2).reshape(-1, 3, 3)
    # O-H vectors unchanged
    np.testing.assert_allclose(
        d2[:, 1] - d2[:, 0], d1[:, 1] - d1[:, 0], atol=1e-12
    )
    # COMs scaled by s
    m = np.asarray(system.masses).reshape(-1, 3)
    com1 = (d1 * m[..., None]).sum(1) / m.sum(1)[:, None]
    com2 = (d2 * m[..., None]).sum(1) / m.sum(1)[:, None]
    np.testing.assert_allclose(com2, s * com1, rtol=1e-10)


def test_ideal_gas_equation_of_state():
    """<V> = (N + 1) kT / P for ideal-gas MC-NPT."""
    n = 128
    temp = 300.0
    p_bar = 200.0
    kT = BOLTZMANN * temp
    p_int = p_bar / PRESSURE_IN_BAR
    v_expected = (n + 1) * kT / p_int

    box0 = jnp.full((3,), v_expected ** (1 / 3), jnp.float64)
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.uniform(0, float(box0[0]), (n, 3)))
    system = System(
        masses=jnp.full((n,), 40.0),
        forces=(MonteCarloBarostat(pressure=p_bar, temperature=temp, frequency=1),),
        molecule=jnp.arange(n, dtype=jnp.int32),
        default_box=box0,
        num_molecules=n,
    )
    ctx = Context(system, VelocityVerletIntegrator(0.002), make_state(x, box=box0))
    ctx.set_velocities_to_temperature(temp, seed=1)

    vols = []
    ctx.step(500)  # equilibrate move size
    for _ in range(60):
        ctx.step(50)
        vols.append(float(jnp.prod(ctx.state.box)))
    v_mean = np.mean(vols)
    np.testing.assert_allclose(v_mean, v_expected, rtol=0.1)
    n_att = int(ctx.state.extra[BARO_NATT])
    n_acc = int(ctx.state.extra[BARO_NACC])
    assert n_att >= 3000 and 0 < n_acc <= n_att


@pytest.mark.slow
def test_npt_water_stays_finite():
    from atomsmm_tpu import GlobalThermostatIntegrator, RESPASystem
    from atomsmm_tpu.integrate.propagators import VelocityRescalingPropagator
    from atomsmm_tpu.minimize import minimize_energy
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.utils import replace as dreplace

    system, x, box = water_system(n_molecules=64, r_cut=0.55, r_switch=0.45,
                                  neighbors=True)
    system = system.add_force(
        MonteCarloBarostat(pressure=1.0, temperature=300.0, frequency=5)
    )
    thermo = VelocityRescalingPropagator(300.0, 3 * 192 - 3, 0.1)
    ctx = Context(
        system, GlobalThermostatIntegrator(0.001, thermo), make_state(x, box=box)
    )
    minimize_energy(ctx, steps=200)
    ctx.set_velocities_to_temperature(300.0, seed=2)
    v0 = float(jnp.prod(ctx.state.box))
    ctx.step(500)
    v1 = float(jnp.prod(ctx.state.box))
    assert np.isfinite(np.asarray(ctx.state.x)).all()
    assert 0.5 * v0 < v1 < 2.0 * v0, (v0, v1)
    assert int(ctx.state.extra[BARO_NATT]) == 100


@pytest.mark.slow
def test_overflowing_trial_is_rejected_not_mispriced():
    """r4: a volume-move trial rebuilds the pair list in-jit at fixed
    capacity; a compressing trial can overflow it and the trial energy
    would be computed on a truncated pair list. Such trials must be
    rejected (accept &= ~trial_bad) and counted in BARO_NBAD, and the
    sticky overflow flag must hand the chunk to Context's retune
    auto-recovery — never silently accepted on a wrong energy."""
    import dataclasses

    from atomsmm_tpu.integrate.barostat import BARO_NBAD
    from atomsmm_tpu.models import argon_system
    from atomsmm_tpu.ops.neighbors import _max_cell_occupancy

    system, x, box = argon_system(n=256, jitter=0.05, seed=1, neighbors=True)
    # squeeze the capacity to the exact current occupancy: ANY compression
    # that shifts one atom across a cell boundary overflows the trial bucket
    occ = _max_cell_occupancy(np.asarray(x), np.asarray(box),
                              system.neighbors.grid)
    tight = dataclasses.replace(system.neighbors, cell_capacity=int(occ))
    system = system.with_neighbors(tight)
    system = dataclasses.replace(
        system,
        forces=tuple(system.forces)
        + (MonteCarloBarostat(pressure=5000.0, temperature=120.0,
                              frequency=1),),
    )

    ctx = Context(
        system,
        VelocityVerletIntegrator(dt=0.002),
        make_state(x, box=box, seed=7),
    )
    ctx.set_velocities_to_temperature(120.0, seed=3)
    ctx.step(30)
    st = ctx.state
    # the run survived (auto-recovery retuned instead of wedging), positions
    # finite, and the persistent pair list is healthy again
    assert np.isfinite(np.asarray(st.x)).all()
    n_att = int(st.extra[BARO_NATT])
    n_bad = int(st.extra[BARO_NBAD])
    assert n_att >= 30
    assert 0 <= n_bad <= n_att
    for key, val in st.extra.items():
        if key.startswith("nbr") and key.endswith("overflow"):
            assert not bool(val), key


def test_attempt_rejects_overflowing_trial_directly():
    """Pin the trial-validity semantics at the unit level (the integration
    test above can pass on auto-recovery alone): find a volume move whose
    compressed configuration overflows the trial bucket, call _attempt
    directly, and assert the move is REJECTED and counted in BARO_NBAD —
    never accepted on the truncated-pair-list energy."""
    import dataclasses
    import types

    import jax
    import jax.random as jr

    from atomsmm_tpu.context import refresh_force_caches
    from atomsmm_tpu.integrate.barostat import (
        BARO_NBAD,
        MonteCarloBarostatPropagator,
        box_volume,
        molecular_scale,
    )
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.neighbors import (
        _max_cell_occupancy,
        all_neighbor_extras,
    )

    # r_cut chosen so the cell grid is 4+ per dim: with a 2-3 cell grid the
    # stencil wraps the whole box and coverage can never be deficient
    system, x, box = water_system(n_molecules=216, r_cut=0.35,
                                  r_switch=0.3, neighbors=True)
    assert min(system.neighbors.grid) >= 4
    occ = _max_cell_occupancy(np.asarray(x), np.asarray(box),
                              system.neighbors.grid)
    system = system.with_neighbors(
        dataclasses.replace(system.neighbors, cell_capacity=int(occ))
    )
    # dv_max large enough that some seed compresses past the coverage
    # boundary (reach*w < r_cut needs s < r_cut/w ~ 0.75 here)
    baro = MonteCarloBarostatPropagator(pressure_bar=1.0, temperature=300.0,
                                        frequency=1,
                                        initial_dv_fraction=0.75)
    ctx = types.SimpleNamespace(system=system, globals={})

    def make_state_for(seed):
        st = make_state(x, box=box, seed=seed)
        st = st.with_extra(**all_neighbor_extras(system, st.x, st.box))
        st = st.with_extra(**baro.extra_variables(system, st))
        return refresh_force_caches(system, st, {})

    from atomsmm_tpu.ops.neighbors import coverage_deficient

    grid = system.neighbors.grid
    cap = system.neighbors.cell_capacity
    hit = None
    for seed in range(200):
        st = make_state_for(seed)
        # replicate _attempt's RNG stream to predict the trial box
        _, k_dv, _ = jr.split(st.rng, 3)
        dv = jr.uniform(k_dv, (), st.x.dtype, minval=-1.0, maxval=1.0) \
            * st.extra["baro_dv"]
        s = ((box_volume(st.box) + dv) / box_volume(st.box)) ** (1.0 / 3.0)
        x_new = molecular_scale(st.x, system.molecule, system.num_molecules,
                                system.masses, s)
        box_new = st.box * s
        over = _max_cell_occupancy(np.asarray(x_new), np.asarray(box_new),
                                   grid) > cap
        under = bool(coverage_deficient(system.neighbors, box_new))
        if over or under:
            hit = (st, over, under)
            break
    assert hit is not None, "no invalid trial found in 200 seeds"
    st, over, under = hit

    out = baro._attempt(ctx, st)
    np.testing.assert_allclose(np.asarray(out.box), np.asarray(st.box),
                               atol=0)  # rejected: box unchanged
    assert int(out.extra[BARO_NBAD]) == 1
    if under and not over:
        # an undercover-only rejection must NOT contaminate the sticky
        # overflow flags (capacity retune cannot fix coverage; Context
        # would loop restore/retune and abort with a wrong diagnosis)
        for key, val in out.extra.items():
            if key.startswith("nbr") and key.endswith("overflow"):
                assert not bool(val), key


def test_attempt_segmentation_matches_frequency():
    """Context._advance runs volume attempts via host-side frequency
    segmentation (the r5 replacement for the in-program lax.cond, which
    keeps the rarely taken trial out of the hot loop). Attempts
    must land exactly at post-increment step % freq == freq-1, whatever
    chunk sizes step() is called with, and the plain/attempt program split
    must agree with the monolithic count."""
    import jax.numpy as jnp

    from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
    from atomsmm_tpu.integrate.barostat import BARO_NATT
    from atomsmm_tpu.system import System
    from atomsmm_tpu.forces import MonteCarloBarostat

    n, freq = 16, 7
    box0 = jnp.full((3,), 4.0)
    rs = np.random.RandomState(3)
    x = jnp.asarray(rs.uniform(0, 4.0, (n, 3)))
    system = System(
        masses=jnp.full((n,), 40.0),
        forces=(MonteCarloBarostat(pressure=1.0, temperature=120.0,
                                   frequency=freq),),
        molecule=jnp.arange(n, dtype=jnp.int32),
        default_box=box0,
        num_molecules=n,
    )
    ctx = Context(system, VelocityVerletIntegrator(0.002),
                  make_state(x, box=box0))
    ctx.set_velocities_to_temperature(120.0, seed=2)
    total = 0
    for chunk in (3, 1, 11, 6, 20, 2, 30):
        ctx.step(chunk)
        total += chunk
        # attempts completed = steps whose post-increment counter hit
        # freq-1 (mod freq) = floor((total + 1) / freq) with counter from 0
        expected = (total - (freq - 1) + freq) // freq if total >= freq - 1 \
            else 0
        assert int(ctx.state.extra[BARO_NATT]) == expected, (
            f"after {total} steps at freq {freq}: "
            f"{int(ctx.state.extra[BARO_NATT])} attempts != {expected}")
    assert int(ctx.state.step) == total
