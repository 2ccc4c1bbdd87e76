"""Triclinic periodic boxes (the round-2 verdict's last capability gap vs
the reference's OpenMM substrate).

Box (3, 3) REDUCED cell matrices (rows = lattice vectors; a along x, b in
the xy plane, off-diagonals at most half the diagonals — the OpenMM
convention) run on the dense pair path, bonded terms, PME, virials, the
MC barostat, and (round 4) the production cell-list path.

Oracles:
  * minimum image vs a brute-force 125-image search (valid wherever the
    image distance is below half the smallest perpendicular width);
  * the supercell identity E(2x2x2 cell) = 8 E(cell) — any correct periodic
    implementation must satisfy it on a genuinely sheared cell, with no
    second implementation to agree with;
  * mesh PME vs the direct plane-wave Ewald sum on a sheared cell
    (validates fractional spreading + the reciprocal metric);
  * NVE conservation and the scaling-virial consistency under (3, 3) boxes.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
from atomsmm_tpu.models import argon_system
from atomsmm_tpu.ops.pbc import (
    box_volume,
    max_cutoff,
    minimum_image,
    triclinic_from_lengths_angles,
    wrap_positions,
)
from atomsmm_tpu.potential import potential_energy
from atomsmm_tpu.utils import InputError, replace


def _reduced_cell():
    # monoclinic-ish, genuinely sheared, reduced
    return jnp.asarray(triclinic_from_lengths_angles(
        2.2, 2.0, 2.4, 90.0, 105.0, 80.0))


def test_minimum_image_matches_brute_force():
    h = _reduced_cell()
    hn = np.asarray(h)
    rc = max_cutoff(hn)
    rs = np.random.RandomState(0)
    dx = rs.uniform(-4, 4, (256, 3))
    shifts = np.array([(i, j, k) for i in range(-2, 3)
                       for j in range(-2, 3) for k in range(-2, 3)]) @ hn
    imgs = dx[:, None, :] - shifts[None, :, :]
    brute = imgs[np.arange(len(dx)),
                 np.argmin(np.linalg.norm(imgs, axis=2), axis=1)]
    ours = np.asarray(minimum_image(jnp.asarray(dx), h))
    # wherever the true image is within the safe radius, we must find it
    sel = np.linalg.norm(brute, axis=1) < rc
    assert sel.sum() > 50
    np.testing.assert_allclose(ours[sel], brute[sel], atol=1e-10)


def test_wrap_positions_in_cell():
    h = _reduced_cell()
    rs = np.random.RandomState(1)
    x = jnp.asarray(rs.uniform(-5, 5, (32, 3)))
    xw = wrap_positions(x, h)
    s = np.asarray(xw) @ np.linalg.inv(np.asarray(h))
    assert (s >= -1e-12).all() and (s < 1 + 1e-12).all()
    # wrapping moves atoms by exact lattice vectors
    ds = (np.asarray(x) - np.asarray(xw)) @ np.linalg.inv(np.asarray(h))
    np.testing.assert_allclose(ds, np.round(ds), atol=1e-10)


def test_volume_and_max_cutoff():
    h = triclinic_from_lengths_angles(2.0, 2.0, 2.0, 90.0, 109.47, 90.0)
    np.testing.assert_allclose(
        float(box_volume(jnp.asarray(h))),
        8.0 * np.sin(np.radians(109.47)), rtol=1e-6,
    )
    assert 0.0 < max_cutoff(h) < 1.0
    np.testing.assert_allclose(max_cutoff([2.0, 3.0, 4.0]), 1.0)


def test_cutoff_beyond_minimum_image_bound_rejected():
    """Context construction must reject r_cut > max_cutoff(box): skewed
    cells have perpendicular widths far below their edge lengths, and a
    too-large cutoff silently returns non-minimum images (ADVICE r3)."""
    from atomsmm_tpu import VelocityVerletIntegrator

    system, x, _ = argon_system(n=216, jitter=0.1, seed=0, r_cut=1.0,
                                r_switch=0.9)
    # strongly sheared: edge lengths 2.2 nm but perpendicular width << 2.2
    h = jnp.asarray(triclinic_from_lengths_angles(
        2.2, 2.2, 2.2, 90.0, 120.0, 60.0))
    assert max_cutoff(h) < 1.0
    rs = np.random.RandomState(7)
    xs = jnp.asarray(rs.uniform(0, 1, (216, 3))) @ h
    with pytest.raises(InputError, match="minimum-image bound"):
        Context(system, VelocityVerletIntegrator(dt=0.002),
                make_state(xs, box=h))
    # the same system in a roomy orthorhombic box is fine
    Context(system, VelocityVerletIntegrator(dt=0.002),
            make_state(x, box=jnp.asarray([4.0, 4.0, 4.0])))


def _supercell_argon(system, x, h, reps=2):
    """Tile an argon System into a reps^3 supercell of the (3,3) cell h."""
    n = x.shape[0]
    shifts = jnp.asarray(
        [(i, j, k) for i in range(reps) for j in range(reps)
         for k in range(reps)], x.dtype) @ h
    xs = (x[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    m = reps ** 3
    nb = system.forces[0]
    nb_s = replace(
        nb,
        charge=jnp.tile(nb.charge, m),
        sigma=jnp.tile(nb.sigma, m),
        epsilon=jnp.tile(nb.epsilon, m),
        exclusions=jnp.tile(nb.exclusions, (m, 1)),
    )
    sys_s = replace(
        system,
        masses=jnp.tile(system.masses, m),
        molecule=jnp.arange(n * m, dtype=jnp.int32),
        num_molecules=n * m,
        forces=(nb_s,),
    )
    return sys_s, xs


def test_supercell_identity_on_sheared_cell():
    """E(2x2x2 supercell) == 8 E(cell) for LJ argon in a genuinely sheared
    reduced cell — a correctness oracle with no second implementation."""
    system, x, box = argon_system(n=48, jitter=0.12, seed=2, r_cut=0.5,
                                  r_switch=0.4)
    h = _reduced_cell() * 0.9  # lengths ~2 nm; r_cut 0.5 << max_cutoff
    rs = np.random.RandomState(4)
    x = jnp.asarray(rs.uniform(0, 1, (48, 3))) @ h
    e1 = potential_energy(system, x, h)
    sys_s, xs = _supercell_argon(system, x, h)
    e8 = potential_energy(sys_s, xs, 2.0 * h)
    np.testing.assert_allclose(float(e8), 8.0 * float(e1), rtol=1e-10)
    # and the forces on the first copy match the single-cell forces
    g1 = jax.grad(lambda xx: potential_energy(system, xx, h))(x)
    g8 = jax.grad(lambda xx: potential_energy(sys_s, xx, 2.0 * h))(xs)
    np.testing.assert_allclose(np.asarray(g8)[:48], np.asarray(g1),
                               atol=1e-9)


def test_pme_reciprocal_matches_ewald_on_sheared_cell():
    """Mesh PME must match the direct plane-wave Ewald sum on a sheared
    cell — validates fractional spreading and the metric G = invH^T invH."""
    from atomsmm_tpu.ops.pme import ewald_reference_energy, pme_reciprocal_energy

    h = _reduced_cell()
    rs = np.random.RandomState(3)
    n = 24
    x = jnp.asarray(rs.uniform(0, 1, (n, 3))) @ h
    q = jnp.asarray(rs.uniform(-1, 1, (n,)))
    q = q - q.mean()
    alpha = 3.0
    e_pme = pme_reciprocal_energy(x, h, q, alpha, (32, 32, 32), 6)
    e_ref = ewald_reference_energy(x, h, q, alpha, kmax=14)
    np.testing.assert_allclose(float(e_pme), float(e_ref), rtol=2e-5)


@pytest.mark.slow
def test_md_and_virial_on_triclinic_cell():
    """NVE dynamics + the isotropic-scaling virial on a (3, 3) box (the
    barostat/pressure machinery shares the same volume/scaling helpers)."""
    from atomsmm_tpu.computers import atomic_pressure, atomic_virial

    system, x, box = argon_system(n=64, jitter=0.1, seed=2, r_cut=0.5,
                                  r_switch=0.4)
    h = _reduced_cell()
    rs = np.random.RandomState(5)
    x = jnp.asarray(rs.uniform(0, 1, (64, 3))) @ h
    from atomsmm_tpu.minimize import minimize_energy

    ctx = Context(system, VelocityVerletIntegrator(0.002),
                  make_state(x, box=h))
    minimize_energy(ctx, steps=150)
    ctx.set_velocities_to_temperature(120.0, seed=1)
    e0 = float(ctx.conserved_energy())
    ctx.step(50)
    e1 = float(ctx.conserved_energy())
    assert abs(e1 - e0) / 64 < 1e-3
    # virial consistency: W = -dU/ds == finite difference
    w = float(atomic_virial(system, ctx.state.x, ctx.state.box))
    eps = 1e-6
    up = float(potential_energy(system, (1 + eps) * ctx.state.x,
                                (1 + eps) * ctx.state.box))
    um = float(potential_energy(system, (1 - eps) * ctx.state.x,
                                (1 - eps) * ctx.state.box))
    np.testing.assert_allclose(w, -(up - um) / (2 * eps), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(float(atomic_pressure(system, ctx.state)))


def test_triclinic_cell_list_matches_dense():
    """r4: cell lists on a genuinely sheared (3, 3) cell — grid/stencil
    sized from PERPENDICULAR widths, fractional binning, triclinic minimum
    image in the sweep. Oracle: the dense triclinic path (itself validated
    against brute-force images and the supercell identity above)."""
    from atomsmm_tpu.ops.neighbors import (
        all_neighbor_extras,
        assert_neighbor_health,
        make_aux,
        make_neighbor_spec,
    )
    from atomsmm_tpu.ops.pbc import perp_widths
    from atomsmm_tpu.potential import force_fn

    h = 3.0 * _reduced_cell()
    rs = np.random.RandomState(7)
    g = 12
    frac = np.stack(np.meshgrid(*[np.arange(g)] * 3,
                                indexing="ij"), -1).reshape(-1, 3) / g
    frac = frac + rs.uniform(-0.015, 0.015, frac.shape)
    x = jnp.asarray(frac @ np.asarray(h))
    n = x.shape[0]

    system, _, _ = argon_system(n=n, jitter=0.0, seed=2, r_cut=0.7,
                                r_switch=0.6)
    system = replace(system, default_box=h)
    spec = make_neighbor_spec(np.asarray(h), n, 0.7,
                              occupancy_floor_from=x)
    # grid sized from perpendicular widths: each covered span >= r_build
    w_perp = np.asarray(perp_widths(h)) / np.asarray(spec.grid)
    assert (w_perp * np.asarray(spec.reach) >= float(spec.r_build) - 1e-12
            ).all()
    assert min(spec.grid) >= 3
    system = system.with_neighbors(spec)

    extras = all_neighbor_extras(system, x, h)
    assert_neighbor_health(extras)
    aux = make_aux(system, extras)
    e_cell = float(potential_energy(system, x, h, aux=aux))
    e_dense = float(potential_energy(system, x, h))
    np.testing.assert_allclose(e_cell, e_dense, rtol=1e-10)
    _, f_cell = force_fn(system)(x, h, {}, aux)
    _, f_dense = force_fn(system)(x, h, {}, None)
    scale = np.abs(np.asarray(f_dense)).max()
    np.testing.assert_allclose(np.asarray(f_cell), np.asarray(f_dense),
                               atol=1e-9 * scale)


@pytest.mark.slow
def test_triclinic_cell_list_nve_runs():
    """Short NVE on the triclinic cell-list path through the full Context
    machinery (rebuild gating, staleness, coverage guards on a matrix
    box)."""
    from atomsmm_tpu.ops.neighbors import make_neighbor_spec

    h = 2.0 * _reduced_cell()
    rs = np.random.RandomState(9)
    g = 8
    frac = np.stack(np.meshgrid(*[np.arange(g)] * 3,
                                indexing="ij"), -1).reshape(-1, 3) / g
    frac = frac + rs.uniform(-0.01, 0.01, frac.shape)
    x = jnp.asarray(frac @ np.asarray(h))
    n = x.shape[0]

    system, _, _ = argon_system(n=n, jitter=0.0, seed=2, r_cut=0.6,
                                r_switch=0.5)
    system = replace(system, default_box=h)
    system = system.with_neighbors(
        make_neighbor_spec(np.asarray(h), n, 0.6, occupancy_floor_from=x)
    )
    from atomsmm_tpu.minimize import minimize_energy

    ctx = Context(system, VelocityVerletIntegrator(0.002),
                  make_state(x, box=h))
    minimize_energy(ctx, steps=100)
    ctx.set_velocities_to_temperature(120.0, seed=1)
    e0 = float(ctx.conserved_energy())
    ctx.step(100)
    e1 = float(ctx.conserved_energy())
    assert np.isfinite(np.asarray(ctx.state.x)).all()
    assert abs(e1 - e0) / n < 1e-3
    # and the cell path keeps matching dense at the evolved configuration
    e_cell = float(potential_energy(system, ctx.state.x, ctx.state.box,
                                    aux=None))
    from atomsmm_tpu.ops.neighbors import all_neighbor_extras, make_aux

    aux = make_aux(system, all_neighbor_extras(system, ctx.state.x,
                                               ctx.state.box))
    e2 = float(potential_energy(system, ctx.state.x, ctx.state.box,
                                aux=aux))
    np.testing.assert_allclose(e2, e_cell, rtol=1e-10)
