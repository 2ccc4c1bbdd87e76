"""Monte Carlo barostat — counterpart of openmm.MonteCarloBarostat
(SURVEY.md §2b N6): isotropic MC volume moves with molecular (COM) scaling,
Metropolis acceptance on dU + P dV - N_mol kT ln(V'/V), adaptive move size.

Jitted end-to-end: the attempt runs inside the step function under lax.cond
(every `frequency` steps), the trial energy uses a freshly built cell list
for the scaled box, and on acceptance the force caches are recomputed so the
next RESPA kick never sees pre-scaling forces.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.pbc import box_volume
from ..potential import potential_energy
from ..units import BOLTZMANN, PRESSURE_IN_BAR
from ..utils import replace
from .propagators import Propagator

BARO_DV = "baro_dv"          # current volume-move size [nm^3]
BARO_NACC = "baro_naccepted"
BARO_NATT = "baro_nattempted"
BARO_NBAD = "baro_nbadtrials"   # trials rejected for an invalid pair list


def molecular_scale(x, molecule, num_molecules, masses, s):
    """Scale molecule centers of mass by s, keeping intramolecular geometry."""
    mw = masses[:, None]
    com_num = jax.ops.segment_sum(mw * x, molecule, num_segments=num_molecules)
    com_den = jax.ops.segment_sum(mw, molecule, num_segments=num_molecules)
    com = com_num / com_den
    return x + (s - 1.0) * com[molecule]


class MonteCarloBarostatPropagator(Propagator):
    """Apply after the MD step; attempts a volume move every `frequency`
    outer steps (matching openmm.MonteCarloBarostat semantics)."""

    def __init__(self, pressure_bar, temperature, frequency: int = 25,
                 initial_dv_fraction: float = 0.01):
        self.pressure = float(pressure_bar) / PRESSURE_IN_BAR  # kJ/mol/nm^3
        self.temperature = float(temperature)
        self.frequency = int(frequency)
        self.dv0 = float(initial_dv_fraction)

    def extra_variables(self, system, state):
        v0 = box_volume(state.box)
        return {
            BARO_DV: (self.dv0 * v0).astype(state.x.dtype),
            BARO_NACC: jnp.zeros((), jnp.int32),
            BARO_NATT: jnp.zeros((), jnp.int32),
            BARO_NBAD: jnp.zeros((), jnp.int32),
        }

    def _attempt(self, ctx, state):
        system = ctx.system
        kT = BOLTZMANN * self.temperature
        rng, k_dv, k_acc = jax.random.split(state.rng, 3)
        dv_max = state.extra[BARO_DV]

        def energy_of(x, box):
            """Trial energy + per-kind validity flags: the trial bucket is
            rebuilt in-jit at fixed capacity, so a compressing move can
            overflow it (or undercover the build radius) and the energy
            would be computed on a silently truncated pair list. Flagged
            trials are rejected below; overflow additionally marks the
            sticky flag so the step loop's capacity retune gives the move a
            fair re-try. The two kinds stay separate — capacity retune
            cannot fix undercoverage, so marking overflow for an
            undercovering trial would send auto-recovery into a futile
            restore/retune loop ending in a misdiagnosed abort."""
            overflow = undercover = jnp.zeros((), bool)
            aux = None
            if system.neighbors is not None:
                from ..ops.neighbors import (
                    all_neighbor_extras,
                    make_aux,
                    unhealthy_flags,
                )

                extras = all_neighbor_extras(system, x, box)
                overflow, undercover = unhealthy_flags(extras)
                aux = make_aux(system, extras)
            return (potential_energy(system, x, box, ctx.globals, aux=aux),
                    overflow, undercover)

        def energy_current():
            # the step loop maintains valid neighbor structures for the
            # CURRENT x/box in state.extra — no rebuild for e_old
            aux = None
            if system.neighbors is not None:
                from ..ops.neighbors import make_aux

                aux = make_aux(system, state.extra)
            return potential_energy(
                system, state.x, state.box, ctx.globals, aux=aux
            )

        v_old = box_volume(state.box)
        dv = jax.random.uniform(
            k_dv, (), state.x.dtype, minval=-1.0, maxval=1.0
        ) * dv_max
        v_new = v_old + dv
        s = (v_new / v_old) ** (1.0 / 3.0)

        x_new = molecular_scale(
            state.x, system.molecule, system.num_molecules, system.masses, s
        )
        box_new = state.box * s

        e_old = energy_current()
        e_new, trial_overflow, trial_undercover = energy_of(x_new, box_new)
        trial_bad = trial_overflow | trial_undercover
        n_mol = system.num_molecules
        w = (
            e_new - e_old
            + self.pressure * dv
            - n_mol * kT * jnp.log(v_new / v_old)
        )
        accept = jax.random.uniform(k_acc, (), state.x.dtype) < jnp.exp(
            jnp.minimum(-w / kT, 0.0)
        )
        accept = accept & ~trial_bad

        x = jnp.where(accept, x_new, state.x)
        box = jnp.where(accept, box_new, state.box)

        # adaptive move size (openmm's heuristic), evaluated every 10 attempts
        n_acc = state.extra[BARO_NACC] + accept.astype(jnp.int32)
        n_att = state.extra[BARO_NATT] + 1
        window = n_att % 10 == 0
        rate = n_acc.astype(state.x.dtype) / jnp.maximum(n_att, 1)
        grow = window & (rate > 0.5)
        shrink = window & (rate < 0.25)
        dv_max = jnp.where(grow, dv_max * 1.1, dv_max)
        dv_max = jnp.where(shrink, dv_max * 0.9, dv_max)
        dv_max = jnp.minimum(dv_max, 0.3 * v_old)

        state = replace(state, x=x, box=box, rng=rng).with_extra(
            **{BARO_DV: dv_max, BARO_NACC: n_acc, BARO_NATT: n_att,
               BARO_NBAD: state.extra[BARO_NBAD]
               + trial_bad.astype(jnp.int32)}
        )
        # rebuild neighbor structures + force caches for the (possibly) new box
        if system.neighbors is not None:
            from ..ops.neighbors import update_all_neighbors

            updated = update_all_neighbors(
                system, state.extra, state.x, state.box
            )
            # a trial rejected for bucket OVERFLOW marks the sticky overflow
            # flags: the step loop's auto-recovery then retunes capacity and
            # re-runs the chunk, giving the move a fair re-try instead of an
            # invisible density wall at the capacity limit. Undercoverage
            # trials are only rejected — retune cannot fix coverage, the
            # PERSISTENT state still covers, and Context treats a sticky
            # undercover flag as fatal; Context warns when BARO_NBAD grows.
            for k in updated:
                if k.endswith("overflow"):
                    updated[k] = updated[k] | trial_overflow
            state = state.with_extra(**updated)
        from ..context import refresh_force_caches

        return refresh_force_caches(system, state, ctx.globals)

    def apply(self, ctx, state, fraction):
        """Propagator-algebra composition hook (lax.cond on the device-side
        step counter). Context does NOT use this path — it dispatches
        _attempt as its own unconditional jitted program at host-segmented
        frequency boundaries (Context._advance), which keeps the rarely
        taken trial branch (a full cell-bucket rebuild and energy) out of
        the hot program. This method remains for propagator composition
        and describe() parity; keeping one of the two is an open design
        item."""
        due = state.step % self.frequency == self.frequency - 1
        return jax.lax.cond(due, lambda s: self._attempt(ctx, s), lambda s: s, state)

    def describe(self, fraction=1.0):
        return [
            f"MC volume move every {self.frequency} steps "
            f"(P={self.pressure * PRESSURE_IN_BAR:.1f} bar, "
            f"T={self.temperature}K, molecular scaling)"
        ]
