"""Atom-block (tile-list) pair path vs. the dense reference path.

Same invariant as tests/test_neighbors.py (SURVEY.md §7 M2): the block-tile
path (ops/blocks.py) must reproduce the dense path's energies and forces to
floating-point roundoff, including exclusion handling and Newton block-pair
weights, plus dynamics across rebuilds.
"""
import dataclasses

import numpy as np
import pytest

# The EXPERIMENTAL alternate backend (ops/blocks.py) is off
# the production path — full parity sweeps run in the slow tier only
pytestmark = pytest.mark.slow

from atomsmm_tpu import Context, VelocityVerletIntegrator, make_state
from atomsmm_tpu.models import argon_system, water_system
from atomsmm_tpu.ops.blocks import (
    build_block_lists,
    make_block_spec,
    block_list_extras,
)
from atomsmm_tpu.ops.neighbors import make_aux
from atomsmm_tpu.potential import force_fn, potential_energy


def _with_blocks(system, x, box, **kw):
    nb = system.forces[0]
    spec = make_block_spec(
        np.asarray(box), x.shape[0], float(nb.r_cut),
        exclusions=np.asarray(nb.exclusions), occupancy_from=np.asarray(x),
        **kw,
    )
    return system.with_neighbors(spec)


def _aux(system, x, box):
    extra = block_list_extras(system.neighbors, x, box)
    assert not bool(extra["nbr_overflow"])
    return make_aux(system, extra)


@pytest.mark.parametrize("n,jitter", [(216, 0.05), (500, 0.3)])
def test_argon_blocks_vs_dense(n, jitter):
    system, x, box = argon_system(n=n, jitter=jitter, seed=1, neighbors=False)
    system = _with_blocks(system, x, box)
    aux = _aux(system, x, box)
    e_dense = potential_energy(system, x, box)
    e_blk = potential_energy(system, x, box, aux=aux)
    np.testing.assert_allclose(float(e_blk), float(e_dense), rtol=1e-12)

    _, f_dense = force_fn(system)(x, box)
    _, f_blk = force_fn(system)(x, box, aux=aux)
    np.testing.assert_allclose(
        np.asarray(f_blk), np.asarray(f_dense), rtol=1e-9, atol=1e-9
    )


@pytest.mark.parametrize("block_size", [32, 64])
def test_water_blocks_vs_dense_exclusions(block_size):
    # water has intramolecular exclusions: the excluded-pair mask must hold
    # across block boundaries in sorted space
    system, x, box = water_system(
        n_molecules=64, r_cut=0.55, r_switch=0.45, neighbors=False
    )
    system = _with_blocks(system, x, box, block_size=block_size)
    aux = _aux(system, x, box)
    e_dense = potential_energy(system, x, box)
    e_blk = potential_energy(system, x, box, aux=aux)
    np.testing.assert_allclose(float(e_blk), float(e_dense), rtol=1e-12)
    _, f_dense = force_fn(system)(x, box)
    _, f_blk = force_fn(system)(x, box, aux=aux)
    np.testing.assert_allclose(
        np.asarray(f_blk), np.asarray(f_dense), rtol=1e-8, atol=1e-8
    )


def test_block_lists_cover_all_atoms():
    system, x, box = argon_system(n=216, jitter=0.2, seed=3, neighbors=False)
    system = _with_blocks(system, x, box)
    order, cand, overflow = build_block_lists(system.neighbors, x, box)
    assert not bool(overflow)
    ids = np.asarray(order)
    real = ids[ids < 216]
    assert len(real) == 216 and len(set(real.tolist())) == 216
    # every block's candidate list starts with itself (self pairs)
    c = np.asarray(cand)
    nb_real = int(np.ceil(216 / system.neighbors.block_size))
    for i in range(nb_real):
        assert c[i, 0] == i, (i, c[i])


def test_block_overflow_detection():
    system, x, box = argon_system(n=512, jitter=0.05, seed=1, neighbors=False)
    system = _with_blocks(system, x, box)
    spec = dataclasses.replace(system.neighbors, max_cand=1)
    _, _, overflow = build_block_lists(spec, x, box)
    assert bool(overflow)


def test_nve_with_block_rebuilds():
    """Dynamics on the block path: conserved energy across rebuilds."""
    system, x, box = argon_system(n=216, jitter=0.05, seed=1, neighbors=False)
    system = _with_blocks(system, x, box)
    ctx = Context(
        system, VelocityVerletIntegrator(dt=0.002), make_state(x, box=box)
    )
    ctx.set_velocities_to_temperature(120.0, seed=42)
    e0 = float(ctx.conserved_energy())
    ctx.step(300)
    e1 = float(ctx.conserved_energy())
    assert abs(e1 - e0) / 216 < 1e-4, (e0, e1)


def test_dense_and_block_trajectories_agree():
    common = dict(n=125, jitter=0.05, seed=1)
    sys_d, x, box = argon_system(**common, neighbors=False)
    sys_b = _with_blocks(sys_d, x, box)
    ctxs = []
    for system in (sys_d, sys_b):
        ctx = Context(
            system, VelocityVerletIntegrator(dt=0.002), make_state(x, box=box)
        )
        ctx.set_velocities_to_temperature(120.0, seed=9)
        ctx.step(50)
        ctxs.append(ctx)
    dx = np.asarray(ctxs[0].state.x) - np.asarray(ctxs[1].state.x)
    assert np.abs(dx).max() < 1e-7, np.abs(dx).max()


def test_respa_blocks_near_far_consistency():
    """RESPA split on the block backend: near + far + exceptions == full."""
    from atomsmm_tpu import RESPASystem
    from atomsmm_tpu.ops.neighbors import all_neighbor_extras

    system, x, box = water_system(
        n_molecules=216, r_cut=0.8, r_switch=0.7, neighbors="blocks"
    )
    respa = RESPASystem(system, rcut_in=0.5, rswitch_in=0.4)
    extra = all_neighbor_extras(respa, x, box)
    aux = make_aux(respa, extra)
    full = potential_energy(system, x, box, aux=None)
    split = potential_energy(respa, x, box, aux=aux)
    np.testing.assert_allclose(float(split), float(full), rtol=1e-10)
