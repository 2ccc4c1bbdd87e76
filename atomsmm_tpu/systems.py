"""System transformations — counterpart of atomsmm/systems.py (SURVEY.md §2a).

The reference deep-copies an openmm.System and rewires its forces; here
systems are immutable pytrees, so each transformation is a pure function
System -> System. Names keep the reference's class-style spelling since they
play the same constructor role.

  RESPASystem      — atomsmm/systems.py::RESPASystem: split the nonbonded
                     force into near (group 1) / far (group 2), bonded and
                     exception terms in group 0, for r-RESPA integration.
  SolvationSystem  — atomsmm/systems.py::SolvationSystem: solute-solvent vdW
                     becomes softcore scaled by lambda_vdw; solute charges
                     scale with lambda_coul (solvation free energies).
  AlchemicalRespaSystem — both transformations combined.
  ComputingSystem  — atomsmm/systems.py::ComputingSystem: per-term evaluable
                     rewiring used by PressureComputer (computers.py).

Examples (executable — the reference's docs double as regression tests,
SURVEY.md §4):

>>> from atomsmm_tpu.models import water_system
>>> from atomsmm_tpu.potential import potential_energy
>>> system, x, box = water_system(n_molecules=27, r_cut=0.45, r_switch=0.35)
>>> respa = RESPASystem(system, rcut_in=0.3, rswitch_in=0.25)
>>> sorted({f.group for f in respa.forces})      # bonded / near / far
[0, 1, 2]
>>> e_full = potential_energy(system, x, box)
>>> e_split = potential_energy(respa, x, box)    # near + far == full
>>> bool(abs(e_split - e_full) < 1e-9 * abs(e_full))
True

>>> comp = ComputingSystem(system)
>>> [f.group for f in comp.forces]               # one group per force term
[0, 1]

>>> import jax.numpy as jnp
>>> solv = SolvationSystem(system, solute_atoms=jnp.arange(3))
>>> e_on = potential_energy(solv, x, box,
...                         {"lambda_vdw": 1.0, "lambda_coul": 1.0})
>>> bool(abs(e_on - e_full) < 1e-9 * abs(e_full))  # identity at lambda = 1
True
"""
from __future__ import annotations

import jax.numpy as jnp

from .forces import (
    FarNonbondedForce,
    NearNonbondedForce,
    NonbondedExceptionsForce,
    NonbondedForce,
    SoftcoreLennardJonesForce,
)
from .system import System
from .utils import InputError, find_nonbonded_force, replace


def RESPASystem(
    system: System,
    rcut_in,
    rswitch_in,
    fast_exceptions: bool = True,
    near_grid: bool = True,
    reciprocal_level: bool = False,
) -> System:
    """Split for r-RESPA (SURVEY.md §3.1):

      group 0 — bonded forces (+ 1-4 exceptions when fast_exceptions)
      group 1 — NearNonbondedForce: shifted-force LJ + damped Coulomb,
                switched over [rswitch_in, rcut_in]
      group 2 — FarNonbondedForce: the original full nonbonded force plus the
                negated near force, so near + far == full holds exactly.
      group 3 — (reciprocal_level=True, PME only) the reciprocal FFT sum as
                its own slowest level (triple split); pass a 4-entry loops
                list to MultipleTimeScaleIntegrator, e.g. [4, 2, 2, 1] at
                8 fs outer. CAUTION (measured, 30k flexible water): the
                reciprocal sum tracks intramolecular charge motion, so with
                FLEXIBLE bonds it hits the same ~5 fs resonance wall as the
                far force (8 fs reciprocal heated 300->560 K in 6 ps); use
                this level only with constrained bonds or resonance-free
                thermostatting (SIN(R): measured stable on emim/BF4 with an
                8-24 fs reciprocal level; +22% throughput at 24 fs with a
                ~1.4% PE discretization shift, +2% at 8 fs).

    The near force's Coulomb damping follows the far method: the PME Ewald
    alpha when the full force uses PME, else undamped.
    """
    idx = find_nonbonded_force(system)
    nb = system.forces[idx]
    alpha = float(nb.ewald_alpha) if nb.method == "pme" else 0.0

    new_forces = []
    for i, f in enumerate(system.forces):
        if i == idx:
            continue
        if isinstance(f, NonbondedExceptionsForce):
            new_forces.append(replace(f, group=0 if fast_exceptions else 1))
        else:
            new_forces.append(replace(f, group=0))

    near = NearNonbondedForce(
        group=1,
        charge=nb.charge,
        sigma=nb.sigma,
        epsilon=nb.epsilon,
        exclusions=nb.exclusions,
        r_cut=jnp.asarray(rcut_in, nb.sigma.dtype),
        r_switch=jnp.asarray(rswitch_in, nb.sigma.dtype),
        lj_type=nb.lj_type,           # NBFIX tables follow the full force
        pair_sigma=nb.pair_sigma,     # so near + far == full stays exact
        pair_epsilon=nb.pair_epsilon,
        alpha=alpha,
        subtract=False,
        chunk=nb.chunk,
    )
    split_recip = bool(reciprocal_level) and nb.method == "pme"
    far = FarNonbondedForce(
        group=2,
        full=replace(nb, group=2),
        minus_near=replace(near, subtract=True, group=2),
        include_reciprocal=not split_recip,
    )
    new_forces += [near, far]
    if split_recip:
        from .forces import PMEReciprocalForce

        new_forces.append(PMEReciprocalForce(
            group=3,
            charge=nb.charge,
            charge_scale_mask=nb.charge_scale_mask,
            ewald_alpha=float(nb.ewald_alpha),
            grid_shape=nb.grid_shape,
            spline_order=nb.spline_order,
            charge_scale_name=nb.charge_scale_name,
        ))
    out = system.replace_forces(new_forces)
    if near_grid and system.neighbors is not None:
        # the near force integrates most often — give it its own finer cell
        # grid / tighter tile list (slot count scales with the build radius
        # cubed)
        import numpy as np

        from .ops.blocks import BlockNeighborSpec, make_block_spec
        from .ops.neighbors import make_neighbor_spec

        if isinstance(system.neighbors, BlockNeighborSpec):
            near_spec = make_block_spec(
                np.asarray(system.default_box),
                system.num_particles,
                float(rcut_in),
                exclusions=np.asarray(nb.exclusions),
                block_size=system.neighbors.block_size,
            )
        else:
            # min_skin 0.09: the finest grid whose cells still leave ~0.1 nm
            # of skin. A hairline skin (e.g. 0.058 at a 12^3 grid for
            # rcut_in 0.5 in a 6.7 nm box) triggers rebuilds every couple of
            # steps and makes grouped neighbor updates (Context
            # neighbor_update_every > 1) unsafe, while one grid step coarser
            # has the SAME slot count at measured caps (12^3 cap 32 vs 11^3
            # cap 36; slots ∝ ncells·cap²) — so the roomier skin is free
            # (KERNELS.md r3).
            near_spec = make_neighbor_spec(
                np.asarray(system.default_box),
                system.num_particles,
                float(rcut_in),
                min_skin=0.09,
                exclusions=np.asarray(nb.exclusions),
            )
        out = out.with_neighbors(system.neighbors, near=near_spec)
        out = out.replace_forces(
            replace(f, neighbor_key="near")
            if isinstance(f, NearNonbondedForce) and not f.subtract
            else f
            for f in out.forces
        )
    return out


def SolvationSystem(
    system: System,
    solute_atoms,
    lambda_vdw_name: str = "lambda_vdw",
    lambda_coul_name: str = "lambda_coul",
) -> System:
    """Alchemical decoupling of a solute (SURVEY.md §3.4):

      * the solute's epsilon in the original nonbonded force is zeroed
        (removing solute-solvent AND solute-solute vdW from it);
      * solute-solvent vdW returns as Beutler softcore scaled by
        `lambda_vdw` (SoftcoreLennardJonesForce, interaction-group cross
        mask);
      * solute-solute vdW returns unscaled through a CustomNonbondedForce
        restricted to solute-solute pairs (intramolecular interactions must
        not change along the path);
      * solute charges in the original force scale with `lambda_coul`
        (per-particle charge-scale hook; solute-solute Coulomb therefore
        scales as lambda_coul^2, as in the reference).

    At lambda_vdw = lambda_coul = 1 the transformed system reproduces the
    original (the invariant the tests check).
    """
    idx = find_nonbonded_force(system)
    nb = system.forces[idx]
    if nb.pair_sigma is not None:
        raise InputError(
            "SolvationSystem does not support NBFIX per-pair LJ tables: the "
            "softcore decoupling path combines per-particle (sigma, epsilon) "
            "with Lorentz-Berthelot"
        )
    n = nb.charge.shape[0]
    solute = jnp.zeros((n,), nb.charge.dtype).at[jnp.asarray(solute_atoms)].set(1.0)

    softcore = SoftcoreLennardJonesForce(
        group=nb.group,
        sigma=nb.sigma,
        epsilon=nb.epsilon,
        solute=solute,
        exclusions=nb.exclusions,
        r_cut=nb.r_cut,
        r_switch=nb.r_switch,
        use_switch=nb.use_switch,
        lambda_name=lambda_vdw_name,
        chunk=nb.chunk,
    )

    from .forces import CustomNonbondedForce
    from .ops import pairfuncs
    from .ops.switching import switch_quintic

    use_switch = nb.use_switch

    def solute_lj(r, pi, pj, globals):
        sigma, epsilon = pairfuncs.lorentz_berthelot(
            pi["sigma"], pj["sigma"], pi["epsilon"], pj["epsilon"]
        )
        u = pairfuncs.lj(r, sigma, epsilon)
        if use_switch:
            u = u * switch_quintic(r, pi["r_switch"], pi["r_cut"])
        return u * pi["solute"] * pj["solute"]

    n_arr = jnp.full((n,), 1.0, nb.sigma.dtype)
    solute_solute = CustomNonbondedForce(
        group=nb.group,
        per_particle={
            "sigma": nb.sigma,
            "epsilon": nb.epsilon,
            "solute": solute,
            "r_switch": n_arr * nb.r_switch,
            "r_cut": n_arr * nb.r_cut,
        },
        exclusions=nb.exclusions,
        r_cut=nb.r_cut,
        energy_function=solute_lj,
        chunk=nb.chunk,
    )

    scaled_nb = replace(
        nb,
        epsilon=nb.epsilon * (1.0 - solute),
        charge_scale_mask=solute,
        charge_scale_name=lambda_coul_name,
    )
    new_forces = [
        scaled_nb if i == idx else f for i, f in enumerate(system.forces)
    ]
    new_forces += [softcore, solute_solute]
    return system.replace_forces(new_forces)


def AlchemicalRespaSystem(
    system: System, rcut_in, rswitch_in, solute_atoms, **kwargs
) -> System:
    """Softcore alchemy + RESPA split
    (atomsmm/systems.py::AlchemicalRespaSystem [M]); the softcore force is
    placed in the near group so lambda sweeps re-use the far force."""
    solvated = SolvationSystem(system, solute_atoms, **kwargs)
    respa = RESPASystem(solvated, rcut_in, rswitch_in)
    # move the softcore force into group 1 (near) — it is short-ranged
    new_forces = tuple(
        replace(f, group=1) if isinstance(f, SoftcoreLennardJonesForce) else f
        for f in respa.forces
    )
    return respa.replace_forces(new_forces)


def ComputingSystem(system: System) -> System:
    """Rewire so individual terms are separately evaluable for the
    PressureComputer / ExtendedStateDataReporter (SURVEY.md §3.3): every force
    gets its own group. Groups are renumbered 0..F-1 in force order."""
    new_forces = tuple(
        replace(f, group=i) for i, f in enumerate(system.forces)
    )
    return system.replace_forces(new_forces)


def HydrogenMassRepartitionedSystem(
    system: System,
    factor: float = 3.0,
    bonds=None,
    h_mass_cutoff: float = 1.5,
    target_mass: float | None = None,
) -> System:
    """Hydrogen mass repartitioning (HMR): scale every hydrogen's mass by
    ``factor`` and remove the added mass from its bonded heavy partner.

    Counterpart of OpenMM's ``createSystem(hydrogenMass=...)`` option on the
    reference's substrate (SURVEY.md §2b N5 context): equilibrium ensemble
    averages are mass-independent, so configurational sampling is unchanged,
    while the fastest (H-X) vibrational/librational periods slow by roughly
    sqrt(factor) — the standard trick that makes a 4 fs single timestep
    stable for rigid water (vs 2 fs at physical masses).

    Connectivity is taken from ``bonds`` ((P, 2) array) when given; otherwise
    it is derived from the system itself: SETTLE triplets (A-B, A-C),
    iterative constraint pairs, and any ``HarmonicBondForce.idx`` tables.
    (``TemplateBondedForce`` stores per-template local indices — pass
    ``bonds`` explicitly for such systems.)

    The SETTLE canonical triangle (ra/rb/rc) is mass-weighted, so the
    SettleSet is rebuilt for the new masses; the target distances d_AB/d_BC
    are recovered exactly from the old triangle (d_BC = 2 rc,
    d_AB = sqrt(rc^2 + (ra+rb)^2)) — molecular geometry is untouched.

    Hydrogens are particles with 0 < m < ``h_mass_cutoff`` amu; massless
    particles (virtual sites) are never touched. Raises InputError when a
    hydrogen has no bonded heavy partner or a heavy atom's mass would go
    non-positive.

    ``target_mass`` selects OpenMM's ``hydrogenMass=`` semantics instead of
    a multiplier: every hydrogen is set to exactly ``target_mass`` amu and
    the difference (positive or negative) is debited from its heavy partner.

    >>> from atomsmm_tpu.models import rigid_water_system
    >>> import numpy as np
    >>> system, x, box = rigid_water_system(n_molecules=64, r_cut=0.55,
    ...                                      r_switch=0.5)
    >>> hmr = HydrogenMassRepartitionedSystem(system, factor=3.0)
    >>> m0 = np.asarray(system.masses, np.float64)
    >>> m1 = np.asarray(hmr.masses, np.float64)
    >>> bool(np.allclose(m1[1::3], 3.0 * m0[1::3]))     # H tripled
    True
    >>> bool(abs(m1.sum() - m0.sum()) < 1e-6 * m0.sum())  # total conserved
    True
    """
    import numpy as np

    if target_mass is not None:
        if target_mass <= 0:
            raise InputError(
                f"HMR target_mass must be positive, got {target_mass}")
    elif factor <= 0:
        raise InputError(f"HMR factor must be positive, got {factor}")
    masses = np.asarray(system.masses, np.float64)
    n = masses.shape[0]

    conn = []
    if bonds is not None:
        conn.append(np.asarray(bonds, np.int64).reshape(-1, 2))
    else:
        if system.settle is not None and system.settle.size:
            t = np.asarray(system.settle.triplets, np.int64)
            conn.append(np.stack([t[:, 0], t[:, 1]], 1))
            conn.append(np.stack([t[:, 0], t[:, 2]], 1))
        if system.constraints is not None and system.constraints.size:
            conn.append(np.asarray(system.constraints.pairs, np.int64))
        from .forces import HarmonicBondForce

        for f in system.forces:
            if isinstance(f, HarmonicBondForce) and f.idx is not None:
                conn.append(np.asarray(f.idx, np.int64))
    if not conn:
        raise InputError(
            "HMR needs connectivity: no SETTLE/constraints/HarmonicBondForce "
            "found and no explicit bonds given"
        )
    pairs = np.concatenate(conn, 0)

    is_h = (masses > 0) & (masses < h_mass_cutoff)
    heavy_of = np.full(n, -1, np.int64)
    for a, b in np.concatenate([pairs, pairs[:, ::-1]], 0):
        if is_h[a] and not is_h[b] and masses[b] > 0 and heavy_of[a] < 0:
            heavy_of[a] = b
    hs = np.where(is_h)[0]
    orphan = hs[heavy_of[hs] < 0]
    if orphan.size:
        raise InputError(
            f"HMR: hydrogens {orphan[:5].tolist()}... have no bonded heavy "
            "partner (H-H constraint pairs do not count; pass bonds=)"
        )
    new = masses.copy()
    if target_mass is not None:
        delta = target_mass - masses[hs]
    else:
        delta = (factor - 1.0) * masses[hs]
    new[hs] += delta
    np.subtract.at(new, heavy_of[hs], delta)
    bad = np.where((masses > 0) & ~is_h & (new <= 0))[0]
    if bad.size:
        what = (f"target_mass {target_mass}" if target_mass is not None
                else f"factor {factor}")
        raise InputError(
            f"HMR {what} drives heavy atoms {bad[:5].tolist()} to "
            f"non-positive mass (worst: {new[bad].min():.4f} amu)"
        )

    settle = system.settle
    if settle is not None and settle.size:
        from .ops.settle import make_settle_set

        ra = np.asarray(settle.ra, np.float64)
        rb = np.asarray(settle.rb, np.float64)
        rc = np.asarray(settle.rc, np.float64)
        d_bc = 2.0 * rc
        d_ab = np.sqrt(rc**2 + (ra + rb) ** 2)
        settle = make_settle_set(
            np.asarray(settle.triplets, np.int32), d_ab, d_bc, new,
            dtype=settle.ra.dtype,
        )
    return replace(
        system,
        masses=jnp.asarray(new, dtype=system.masses.dtype),
        settle=settle,
    )
