"""Parallel paths (SURVEY.md §2c): DP replicas over a device mesh (virtual
8-CPU mesh from conftest) and vmapped lambda ensembles. Plus the
jit-vs-nojit consistency check (SURVEY.md §5, the race-detector analog).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from atomsmm_tpu import (
    Context,
    VelocityVerletIntegrator,
    make_state,
)
from atomsmm_tpu.context import refresh_force_caches
from atomsmm_tpu.models import argon_system
from atomsmm_tpu.parallel import make_replicated_step, replicate_state


def _flagship(n=64):
    system, x, box = argon_system(n=n, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4)
    integ = VelocityVerletIntegrator(0.002)
    state = make_state(x, box=box, seed=0)
    state = integ.initialize(system, state)
    state = refresh_force_caches(system, state, {})
    return integ.make_step(), system, state


def test_replicated_step_matches_single():
    """Each sharded replica must evolve exactly like a single-box run with
    the same RNG key (deterministic NVE: identical trajectories)."""
    n_dev = 8
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    step, system, state = _flagship()
    states = replicate_state(state, n_dev)
    sharding = NamedSharding(mesh, P("dp"))
    states = jax.tree.map(lambda a: jax.device_put(a, sharding), states)
    run = jax.jit(make_replicated_step(step, mesh))
    for _ in range(5):
        states = run(system, states, {})

    single = state
    for _ in range(5):
        single = step(system, single, {})

    # NVE step is RNG-independent: every replica equals the single run
    for k in range(n_dev):
        np.testing.assert_allclose(
            np.asarray(states.x[k]), np.asarray(single.x), rtol=1e-12
        )


def test_replicas_diverge_with_stochastic_dynamics():
    """Replicas carry distinct RNG keys: stochastic thermostats decorrelate
    them (the point of multi-box throughput sampling)."""
    from atomsmm_tpu import GlobalThermostatIntegrator
    from atomsmm_tpu.integrate.propagators import OrnsteinUhlenbeckPropagator

    n_dev = 4
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    system, x, box = argon_system(n=64, jitter=0.05, seed=1, r_cut=0.5,
                                  r_switch=0.4)
    integ = GlobalThermostatIntegrator(
        0.002, OrnsteinUhlenbeckPropagator(120.0, 5.0)
    )
    state = make_state(x, box=box, seed=0)
    state = integ.initialize(system, state)
    state = refresh_force_caches(system, state, {})
    states = replicate_state(state, n_dev)
    sharding = NamedSharding(mesh, P("dp"))
    states = jax.tree.map(lambda a: jax.device_put(a, sharding), states)
    run = jax.jit(make_replicated_step(integ.make_step(), mesh))
    for _ in range(20):
        states = run(system, states, {})
    v = np.asarray(states.v)
    assert not np.allclose(v[0], v[1])
    assert not np.allclose(v[1], v[2])


def test_jit_vs_nojit_consistency():
    """The step function must produce identical results jitted and unjitted
    (SURVEY.md §5: jit-vs-nojit as the sanitizer analog)."""
    step, system, state = _flagship()
    jstep = jax.jit(step)
    s1 = step(system, state, {})
    s2 = jstep(system, state, {})
    np.testing.assert_allclose(np.asarray(s1.x), np.asarray(s2.x), atol=1e-14)
    np.testing.assert_allclose(np.asarray(s1.v), np.asarray(s2.v), atol=1e-13)


def test_f32_vs_f64_consistency():
    """One step in f32 must track the f64 trajectory at f32 precision."""
    import jax.numpy as jnp

    step64, system64, state64 = _flagship()
    s64 = step64(system64, state64, {})

    to32 = lambda t: jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and a.dtype == jnp.float64
        else a,
        t,
    )
    system32, state32 = to32(system64), to32(state64)
    s32 = step64(system32, state32, {})
    np.testing.assert_allclose(
        np.asarray(s32.x), np.asarray(s64.x), atol=5e-6
    )


# --------------------------------------------------------------------------
# Spatial decomposition (parallel/spatial.py — SURVEY.md §2c optional row)
# --------------------------------------------------------------------------


def test_sharded_cell_forces_match_single_device():
    """Force decomposition over home cells on the 8-device virtual mesh must
    reproduce the single-device full-stencil cell path exactly."""
    import dataclasses

    from atomsmm_tpu.ops.neighbors import (
        build_cell_buckets,
        cell_pair_energy_forces,
    )
    from atomsmm_tpu.parallel import sharded_cell_pair_energy_forces

    system, x, box = argon_system(n=512, jitter=0.2, seed=5, neighbors=True)
    spec = system.neighbors
    bucket, ov = build_cell_buckets(spec, x, box)
    assert not bool(ov)
    force = system.forces[0]
    pair_fn = force._pair_fn({})
    pp = force._per_particle({})

    full = dataclasses.replace(spec, half_stencil=False)
    e_ref, f_ref = cell_pair_energy_forces(
        pair_fn, x, box, pp, full, bucket, force.r_cut
    )

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    e_sh, f_sh = sharded_cell_pair_energy_forces(
        pair_fn, x, box, pp, spec, bucket, force.r_cut, mesh
    )
    np.testing.assert_allclose(float(e_sh), float(e_ref), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(f_sh), np.asarray(f_ref), rtol=1e-10, atol=1e-12
    )


@pytest.mark.slow
def test_sharded_pme_matches_single_device():
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.pme import pme_reciprocal_energy
    from atomsmm_tpu.parallel import sharded_pme_reciprocal_energy

    system, x, box = water_system(
        n_molecules=64, method="pme", r_cut=0.55, r_switch=0.45
    )
    nb = system.forces[0]
    q = nb.charge
    e_ref = pme_reciprocal_energy(
        x, box, q, nb.ewald_alpha, nb.grid_shape, nb.spline_order
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    e_sh = sharded_pme_reciprocal_energy(
        x, box, q, nb.ewald_alpha, nb.grid_shape, mesh,
        order=nb.spline_order,
    )
    np.testing.assert_allclose(float(e_sh), float(e_ref), rtol=1e-11)

    # gradient (forces) flows through the shard_map
    g_ref = jax.grad(
        lambda xx: pme_reciprocal_energy(
            xx, box, q, nb.ewald_alpha, nb.grid_shape, nb.spline_order
        )
    )(x)
    g_sh = jax.grad(
        lambda xx: sharded_pme_reciprocal_energy(
            xx, box, q, nb.ewald_alpha, nb.grid_shape, mesh,
            order=nb.spline_order,
        )
    )(x)
    np.testing.assert_allclose(
        np.asarray(g_sh), np.asarray(g_ref), rtol=1e-9, atol=1e-11
    )


@pytest.mark.slow
def test_slab_fft_pme_matches_single_device():
    """The fully distributed reciprocal path (spreading reduce-scatter +
    slab-decomposed FFT + sharded convolution — VERDICT r3 #5) must match
    the single-device rfftn path to roundoff, energies AND forces, on
    orthorhombic and triclinic cells."""
    from atomsmm_tpu.ops.pbc import triclinic_from_lengths_angles
    from atomsmm_tpu.ops.pme import pme_reciprocal_energy
    from atomsmm_tpu.parallel import sharded_pme_reciprocal_energy_fft

    rs = np.random.RandomState(2)
    n = 64
    q = jnp.asarray(rs.uniform(-1, 1, n))
    q = q - q.mean()
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    grid = (16, 8, 15)  # K1, K2 divisible by 8; K3 odd (rfft edge case)
    alpha = 3.0
    box_o = jnp.asarray([2.0, 2.2, 1.9])
    box_t = jnp.asarray(triclinic_from_lengths_angles(
        2.2, 2.0, 2.4, 90.0, 105.0, 80.0))
    # orthorhombic + triclinic energy parity through the collectives
    x = jnp.asarray(rs.uniform(0, 1, (n, 3))) * box_o
    e_ref = pme_reciprocal_energy(x, box_o, q, alpha, grid, order=6)
    e_sh = sharded_pme_reciprocal_energy_fft(
        x, box_o, q, alpha, grid, mesh, order=6)
    np.testing.assert_allclose(float(e_sh), float(e_ref), rtol=1e-12)
    xt = jnp.asarray(rs.uniform(0, 1, (n, 3))) @ box_t
    e_ref_t = pme_reciprocal_energy(xt, box_t, q, alpha, grid, order=6)
    e_sh_t = sharded_pme_reciprocal_energy_fft(
        xt, box_t, q, alpha, grid, mesh, order=6)
    np.testing.assert_allclose(float(e_sh_t), float(e_ref_t), rtol=1e-12)
    # indivisible grids are rejected loudly, never silently wrong
    with pytest.raises(ValueError, match="divisible"):
        sharded_pme_reciprocal_energy_fft(
            jnp.zeros((8, 3)), box_o, jnp.zeros(8), alpha, (25, 16, 15),
            mesh)


@pytest.mark.slow
def test_slab_fft_pme_gradient_parity():
    """Forces through the slab path: grad flows through psum_scatter and
    all_to_all (their transposes are collectives too) and matches the
    single-device gradient to roundoff."""
    from atomsmm_tpu.ops.pme import pme_reciprocal_energy
    from atomsmm_tpu.parallel import sharded_pme_reciprocal_energy_fft

    rs = np.random.RandomState(3)
    n = 64
    q = jnp.asarray(rs.uniform(-1, 1, n))
    q = q - q.mean()
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    grid = (16, 8, 15)
    alpha = 3.0
    box = jnp.asarray([2.0, 2.2, 1.9])
    x = jnp.asarray(rs.uniform(0, 1, (n, 3))) * box
    g_ref = jax.grad(lambda xx: pme_reciprocal_energy(
        xx, box, q, alpha, grid, order=6))(x)
    g_sh = jax.grad(lambda xx: sharded_pme_reciprocal_energy_fft(
        xx, box, q, alpha, grid, mesh, order=6))(x)
    np.testing.assert_allclose(np.asarray(g_sh), np.asarray(g_ref),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.slow
def test_spatial_context_trajectory_parity():
    """VERDICT r2 #6: spatial DD as a *feature* — a SpatialContext runs the
    sharded pair sweep (+ neighbor rebuild) end-to-end through the normal
    Context surface, and its trajectory matches a single-device Context
    running the same full-stencil path (f64 CPU mesh)."""
    import dataclasses

    from atomsmm_tpu.parallel.mesh import SpatialContext
    from atomsmm_tpu.utils import replace as dreplace

    system, x, box = argon_system(n=512, jitter=0.2, seed=5, neighbors=True)
    # single-device reference on the full stencil (the sharded sweep's tiles)
    full_spec = dataclasses.replace(system.neighbors, half_stencil=False)
    system_full = dreplace(system, neighbors=full_spec)
    integ = VelocityVerletIntegrator(0.002)

    ref = Context(system_full, integ, make_state(x, box=box, seed=0))
    ref.step(10)

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    ctx = SpatialContext(system, integ, make_state(x, box=box, seed=0),
                         mesh=mesh)
    ctx.step(10)

    np.testing.assert_allclose(
        np.asarray(ctx.state.x), np.asarray(ref.state.x), rtol=0, atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(ctx.state.v), np.asarray(ref.state.v), rtol=0, atol=1e-13
    )
    # observe path (energies) is also sharded and must agree
    snap_s, snap_r = ctx.get_state(), ref.get_state()
    np.testing.assert_allclose(
        float(snap_s.potential_energy), float(snap_r.potential_energy),
        rtol=1e-12,
    )


@pytest.mark.slow
def test_spatial_context_rigid_water_settle():
    """Composition: spatial decomposition + closed-form SETTLE — the sharded
    pair sweep runs under a constrained integrator and the trajectory
    matches the single-device full-stencil path."""
    import dataclasses

    from atomsmm_tpu.models import rigid_water_system
    from atomsmm_tpu.ops.settle import settle_residual
    from atomsmm_tpu.parallel.mesh import SpatialContext
    from atomsmm_tpu.utils import replace as dreplace

    system, x, box = rigid_water_system(n_molecules=64, r_cut=0.5,
                                        r_switch=0.42, neighbors=True,
                                        seed=3)
    full_spec = dataclasses.replace(system.neighbors, half_stencil=False)
    system_full = dreplace(system, neighbors=full_spec)
    integ = VelocityVerletIntegrator(0.002)

    ref = Context(system_full, integ, make_state(x, box=box, seed=0))
    ref.step(8)

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    ctx = SpatialContext(system, integ, make_state(x, box=box, seed=0),
                         mesh=mesh)
    ctx.step(8)

    np.testing.assert_allclose(
        np.asarray(ctx.state.x), np.asarray(ref.state.x), rtol=0, atol=1e-12
    )
    assert float(settle_residual(system.settle, ctx.state.x)) < 1e-12


@pytest.mark.slow
def test_spatial_context_pme_water():
    """Spatial DD with a PME far force: sharded direct sweep + atom-sharded
    reciprocal spreading through the Context surface."""
    import dataclasses

    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.parallel.mesh import SpatialContext
    from atomsmm_tpu.utils import replace as dreplace

    system, x, box = water_system(n_molecules=40, method="pme", r_cut=0.5,
                                  r_switch=0.45, neighbors=True)
    full_spec = dataclasses.replace(system.neighbors, half_stencil=False)
    system_full = dreplace(system, neighbors=full_spec)
    integ = VelocityVerletIntegrator(0.001)

    ref = Context(system_full, integ, make_state(x, box=box, seed=0))
    ref.step(5)

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    ctx = SpatialContext(system, integ, make_state(x, box=box, seed=0),
                         mesh=mesh)
    ctx.step(5)

    np.testing.assert_allclose(
        np.asarray(ctx.state.x), np.asarray(ref.state.x), rtol=0, atol=1e-12
    )
    snap_s, snap_r = ctx.get_state(), ref.get_state()
    np.testing.assert_allclose(
        float(snap_s.potential_energy), float(snap_r.potential_energy),
        rtol=1e-11,
    )
