"""Context — the execution object binding (System, Integrator, State).

Counterpart of openmm.Context under atomsmm's usage (SURVEY.md §3.2):
`step(n)` runs the jitted step function n times in a single device-side
fori_loop (one Python->device crossing, like the reference's single
Python->C++ crossing); `get_state` is the openmm.Context.getState analog
including per-force-group energy decomposition; `set_parameter` is the global
context-parameter mechanism (lambda_vdw etc. — SURVEY.md §2b N9) implemented
as plain traced arguments, so changing a parameter never recompiles.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import jax
import jax.numpy as jnp

from .potential import (
    force_fn,
    group_energies,
    potential_energy,
    split_potential_energy,
)
from .state import (
    State,
    kinetic_energy,
    make_state,
    maxwell_boltzmann_velocities,
    remove_com_motion,
)
from .utils import count_degrees_of_freedom, pytree_dataclass, replace


def refresh_force_caches(system, state, globals):
    """Recompute every force cache present in State.extra at the current
    positions/parameters (run before each device-side stepping loop, so
    parameter changes — e.g. lambda — can never leave a stale cache)."""
    from .integrate.propagators import parse_force_cache_tag
    from .ops.neighbors import make_aux

    aux = make_aux(system, state.extra)
    updates = {}
    for key in state.extra:
        if key.startswith("fcache_"):
            groups = parse_force_cache_tag(key)
            _, f = force_fn(system, groups)(state.x, state.box, globals, aux)
            updates[key] = f
    return state.with_extra(**updates) if updates else state


@pytree_dataclass
class StateSnapshot:
    """What openmm.State carries (positions/velocities/forces/energies),
    plus the per-group decomposition the reference obtains via
    getState(groups={g})."""

    positions: jnp.ndarray = None
    velocities: jnp.ndarray = None
    box: jnp.ndarray = None
    forces: jnp.ndarray = None
    potential_energy: jnp.ndarray = None
    kinetic_energy: jnp.ndarray = None
    group_energies: Dict[int, jnp.ndarray] = None
    energy_split: Dict[str, jnp.ndarray] = None
    step: jnp.ndarray = None


class Context:
    def __init__(self, system, integrator, state: Optional[State] = None,
                 seed: int = 0, neighbor_update_every: int = 1):
        """neighbor_update_every: run the neighbor maybe-update every K-th
        outer step instead of every step (a forced rebuild at each group
        boundary replaces the per-step lax.cond trigger). Whether K > 1
        buys anything on a GPU is unmeasured. Safety: a
        pair can only be missed if it approaches by more than the full skin
        (r_build - r_cut, where the potential is switched to zero) between
        updates — a sticky staleness flag checks the full-skin bound and
        step() raises on violation. Forced to 1 when a barostat is present
        (volume moves invalidate buckets at accept time)."""
        self.system = system
        self.integrator = integrator
        self.neighbor_update_every = max(int(neighbor_update_every), 1)
        self.parameters: Dict[str, jnp.ndarray] = {}
        if state is None:
            x = jnp.zeros((system.num_particles, 3))
            state = make_state(x, box=system.default_box, seed=seed)
        # Defensive copy: step() donates the state buffers to the device loop,
        # so the Context must own them (user arrays may be shared elsewhere).
        state = jax.tree.map(lambda a: jnp.array(a, copy=True), state)
        from .ops.pbc import validate_cutoffs

        validate_cutoffs(system, state.box)
        if system.virtual_sites is not None:
            # place virtual rows once so neighbor builds / reporters see
            # consistent positions from the start (builder rows may be junk)
            from .ops.virtual_sites import (
                place_virtual_sites,
                zero_virtual_velocities,
            )

            state = replace(
                state,
                x=place_virtual_sites(system.virtual_sites, state.x),
                v=zero_virtual_velocities(system.virtual_sites, state.v),
            )
        if system.neighbors is not None:
            from .ops.neighbors import all_neighbor_extras

            extras = jax.jit(all_neighbor_extras, static_argnums=())(
                system, state.x, state.box
            )
            if any(
                bool(v) for k, v in extras.items()
                if k.startswith("nbr") and k.endswith("overflow")
            ):
                # Cold-start capacity estimate busted (e.g. a clustered
                # lattice): retune every spec to the measured configuration
                # instead of raising — same mechanism as retune_neighbors().
                from .ops.neighbors import retune_neighbor_specs

                self.system = system = retune_neighbor_specs(
                    system, state.x, state.box
                )
                extras = jax.jit(all_neighbor_extras, static_argnums=())(
                    system, state.x, state.box
                )
            state = state.with_extra(**extras)
            if self.neighbor_update_every > 1:
                # seed the sticky staleness flags so the run() input pytree
                # structure is stable from the first call
                from .ops.neighbors import iter_specs

                seeds = {}
                for name, _ in iter_specs(system):
                    key = ("nbr_stale" if name == "default"
                           else f"nbr_{name}_stale")
                    seeds[key] = jnp.zeros((), bool)
                state = state.with_extra(**seeds)
        self.state = integrator.initialize(system, state)
        # openmm semantics: a MonteCarloBarostat force in the system drives
        # MC volume moves after each step (integrate/barostat.py)
        self._barostat = None
        from .forces import MonteCarloBarostat

        for f in system.forces:
            if isinstance(f, MonteCarloBarostat):
                from .integrate.barostat import MonteCarloBarostatPropagator

                self._barostat = MonteCarloBarostatPropagator(
                    float(f.pressure), float(f.temperature), f.frequency
                )
                extras = self._barostat.extra_variables(system, self.state)
                missing = {
                    k: jnp.array(v, copy=True)
                    for k, v in extras.items()
                    if k not in self.state.extra
                }
                if missing:
                    self.state = self.state.with_extra(**missing)
        self._step_fn = integrator.make_step()
        # Seed the sticky PME-coverage flags (zeros) before the first run so
        # the state pytree structure is stable from the first jitted call (a
        # mid-run key addition would force a second compile); run() re-checks
        # against the live box at every chunk start, so a Context built with
        # an already-oversized box still trips on its first step().
        from .forces import _pme_carrier as _pme_c

        pme_seed = {}
        for i, f in enumerate(system.forces):
            g = _pme_c(f)
            if g is None:
                continue
            pme_seed[f"pme_{i}_undercover"] = jnp.zeros((), bool)
            if g.spread_block and not g.spread_pad:
                pme_seed[f"pme_{i}_spread_overflow"] = jnp.zeros((), bool)
        if pme_seed:
            self.state = self.state.with_extra(**pme_seed)
        self._seed_spread_buckets()
        self._run = jax.jit(self._make_run(), donate_argnums=(1,))
        self._attempt_run = (
            jax.jit(self._make_attempt_step(), donate_argnums=(1,))
            if self._barostat is not None else None)
        self._observe = jax.jit(self._make_observe())
        self._observe_lite = jax.jit(self._make_observe(lite=True))
        self.check_overflow = system.neighbors is not None

    def _seed_spread_buckets(self):
        """Seed the amortized PME spreading buckets
        (forces.pme_spread_extras — spread_pad >= 1 set via
        retune_pme_spread(pad=...)) into the state pytree, raising loudly
        on build-time capacity overflow (dropped charges are never
        silent). No-op when no force amortizes its bucket."""
        from .forces import _spread_layouts, pme_spread_extras

        self._has_spread_buckets = bool(_spread_layouts(self.system))
        if not self._has_spread_buckets:
            return
        extras = jax.jit(pme_spread_extras)(
            self.system, self.state.x, self.state.box)
        for k, v in extras.items():
            if k.endswith("spread_overflow") and bool(v):
                raise RuntimeError(
                    f"PME spreading-bucket build overflow ({k}): re-run "
                    "forces.retune_pme_spread at the current configuration "
                    "with a larger safety"
                )
        self.state = self.state.with_extra(**extras)

    # -- construction of jitted entry points -------------------------------

    def _make_run(self):
        step_fn = self._step_fn
        barostat = self._barostat
        k_update = 1 if barostat is not None else self.neighbor_update_every
        from .forces import _pme_carrier

        has_pme_guard = any(
            _pme_carrier(f) is not None for f in self.system.forces
        )
        self._has_pme_guard = has_pme_guard

        has_spread_buckets = getattr(self, "_has_spread_buckets", False)

        def maybe_update_neighbors(system, s, force: bool = False):
            if system.neighbors is not None:
                from .ops.neighbors import update_all_neighbors

                s = s.with_extra(
                    **update_all_neighbors(system, s.extra, s.x, s.box,
                                           force=force)
                )
            if has_spread_buckets:
                # amortized PME spreading buckets ride the same cadence
                # (forces.update_pme_spread: drift > pad/2 cond rebuild,
                # forced at group boundaries, exact-drift sticky flag)
                from .forces import update_pme_spread

                s = s.with_extra(
                    **update_pme_spread(system, s.extra, s.x, s.box,
                                        force=force)
                )
            return s

        def flag_pme(system, s):
            # NPT guard: a grown box can silently exceed the static PME
            # grid's error bound — three comparisons per step (VERDICT r3 #7)
            if not has_pme_guard:
                return s
            from .forces import pme_coverage_flags

            return s.with_extra(
                **pme_coverage_flags(system, s.extra, s.x, s.box))

        def one_step(system, s, globals):
            # NOTE the barostat is NOT applied here: volume moves run as
            # their own UNCONDITIONAL jitted program dispatched by host-side
            # frequency segmentation (Context._advance), so the rarely
            # taken trial (a full cell-bucket rebuild plus an energy) is no
            # lax.cond branch of the hot loop. The cost is one dispatch and
            # one step-counter fetch per barostat period.
            return step_fn(system, s, globals)

        def run(system, state, globals, n):
            # `system` is an argument (not a closed-over constant) so its
            # parameter arrays live as runtime buffers, not baked constants.
            state = flag_pme(system, state)
            state = maybe_update_neighbors(system, state)
            state = refresh_force_caches(system, state, globals)

            if k_update == 1 or (system.neighbors is None
                                 and not has_spread_buckets):
                def body(i, s):
                    return maybe_update_neighbors(
                        system, one_step(system, s, globals)
                    )

                return jax.lax.fori_loop(0, n, body, state)

            # K-grouped updates (see __init__): K steps, then one update;
            # remainder steps run singly with a final update + staleness
            # check on exit
            from .ops.neighbors import staleness_flags

            def body_k(i, s):
                # staleness sampled after EVERY outer step (sticky flags), not
                # just at the group boundary: a transient excursion past the
                # skin mid-group (out and back before the boundary) would
                # otherwise escape detection while forces at those steps may
                # have missed pairs (ADVICE r3). The flag check is a max +
                # top_k over displacements — negligible next to a force eval.
                for _ in range(k_update):
                    s = one_step(system, s, globals)
                    s = s.with_extra(
                        **staleness_flags(system, s.extra, s.x, s.box)
                    )
                    if has_spread_buckets:
                        from .forces import pme_spread_stale_flags

                        s = s.with_extra(**pme_spread_stale_flags(
                            system, s.extra, s.x, s.box))
                # boundary rebuild is FORCED: the conditional skin/2 trigger
                # races the d1+d2 staleness bound (d2 tracks skin/2 right
                # behind d1 at steady state; both cross mid-group and the
                # guard trips on ordinary thermal motion). Forcing resets the
                # reference every K steps, so the guard only ever measures
                # K-step windows — the classic fixed-cadence Verlet list.
                return maybe_update_neighbors(system, s, force=True)

            state = jax.lax.fori_loop(0, n // k_update, body_k, state)

            def body_1(i, s):
                return maybe_update_neighbors(
                    system, one_step(system, s, globals)
                )

            return jax.lax.fori_loop(0, n - (n // k_update) * k_update,
                                     body_1, state)

        return run

    def _make_attempt_step(self):
        """One outer step ENDING in an MC volume-move attempt, as its own
        jitted program with the attempt UNCONDITIONAL (no lax.cond — see
        the note in _make_run.one_step). Context._advance calls
        this exactly at the barostat frequency, so the due-predicate lives
        on the host where it is free, and the device program is straight-
        line. Entry mirrors run()'s entry block so the program is correct
        as the first call after any host-side state change."""
        step_fn = self._step_fn
        barostat = self._barostat
        has_pme_guard = self._has_pme_guard
        has_spread_buckets = getattr(self, "_has_spread_buckets", False)

        def flag_pme(system, s):
            if not has_pme_guard:
                return s
            from .forces import pme_coverage_flags

            return s.with_extra(
                **pme_coverage_flags(system, s.extra, s.x, s.box))

        def maybe_update_neighbors(system, s):
            if system.neighbors is not None:
                from .ops.neighbors import update_all_neighbors

                s = s.with_extra(
                    **update_all_neighbors(system, s.extra, s.x, s.box))
            if has_spread_buckets:
                from .forces import update_pme_spread

                s = s.with_extra(
                    **update_pme_spread(system, s.extra, s.x, s.box))
            return s

        def attempt_step(system, state, globals):
            from .integrate.propagators import StepContext

            state = flag_pme(system, state)
            state = maybe_update_neighbors(system, state)
            state = refresh_force_caches(system, state, globals)
            state = step_fn(system, state, globals)
            ctx = StepContext(system, globals, 0.0)
            state = barostat._attempt(ctx, state)
            state = flag_pme(system, state)
            return maybe_update_neighbors(system, state)

        return attempt_step

    def _make_observe(self, lite: bool = False):
        def observe(system, state, globals):
            if system.neighbors is not None:
                from .ops.neighbors import update_all_neighbors

                state = state.with_extra(
                    **update_all_neighbors(system, state.extra, state.x, state.box)
                )
            from .ops.neighbors import make_aux

            aux = make_aux(system, state.extra)
            if lite:
                # partial-split observe (VERDICT r3 weak #8): the full row
                # evaluates the per-force split + per-group energies +
                # forces (9-12 step-times, KERNELS.md); plain
                # StateDataReporter columns need ONE total-energy pass
                e_pot = potential_energy(system, state.x, state.box,
                                         globals, aux)
                return StateSnapshot(
                    positions=state.x,
                    velocities=state.v,
                    box=state.box,
                    potential_energy=e_pot,
                    kinetic_energy=kinetic_energy(system.masses, state.v),
                    step=state.step,
                )
            e_split = split_potential_energy(
                system, state.x, state.box, globals, aux
            )
            e_groups = group_energies(system, state.x, state.box, globals, aux)
            e_pot = e_split["Total"]
            _, forces = force_fn(system)(state.x, state.box, globals, aux)
            return StateSnapshot(
                positions=state.x,
                velocities=state.v,
                box=state.box,
                forces=forces,
                potential_energy=e_pot,
                kinetic_energy=kinetic_energy(system.masses, state.v),
                group_energies=e_groups,
                energy_split=e_split,
                step=state.step,
            )

        return observe

    # -- openmm.Context-like surface ---------------------------------------

    def set_positions(self, x):
        x = jnp.array(x, self.state.x.dtype, copy=True)
        self.state = replace(self.state, x=x)

    def set_velocities(self, v):
        v = jnp.array(v, self.state.v.dtype, copy=True)
        self.state = replace(self.state, v=v)

    def set_velocities_to_temperature(self, temperature, seed: int = 0):
        rng = jax.random.PRNGKey(seed)
        v = maxwell_boltzmann_velocities(
            rng, self.system.masses, temperature, self.state.x.dtype
        )
        if self.system.remove_com_motion:
            if self.system.virtual_sites is not None:
                from .ops.virtual_sites import zero_virtual_velocities

                # massless rows sample inf from the Maxwell draw; zero them
                # before the COM projection (which would spread them)
                v = zero_virtual_velocities(self.system.virtual_sites, v)
            v = remove_com_motion(self.system.masses, v)
        if self.system.virtual_sites is not None:
            from .ops.virtual_sites import zero_virtual_velocities

            v = zero_virtual_velocities(self.system.virtual_sites, v)
        self.set_velocities(v)

    def set_periodic_box(self, box):
        self.state = replace(self.state, box=jnp.asarray(box, self.state.x.dtype))

    def set_parameter(self, name: str, value):
        self.parameters[name] = jnp.asarray(value, self.state.x.dtype)

    def get_parameter(self, name: str):
        return self.parameters[name]

    def _advance(self, n: int):
        """Run n outer steps: one device-side loop when no barostat is
        attached; otherwise host-side segmentation at the barostat
        frequency — plain-run segments between volume attempts, each
        attempt its own unconditional jitted step (_make_attempt_step).
        The due-predicate is host arithmetic on the step counter (one
        device fetch per _advance), never a device-side lax.cond — see the
        note in _make_run.one_step."""
        if self._barostat is None:
            self.state = self._run(
                self.system, self.state, self.parameters, jnp.int32(n)
            )
            return
        freq = self._barostat.frequency
        s0 = int(self.state.step)
        done = 0
        while done < n:
            # the next attempt belongs to the step whose POST-increment
            # counter hits freq-1 (mod freq) — openmm's step%freq==freq-1
            until = (freq - 1 - (s0 + done + 1)) % freq
            if until >= n - done:
                self.state = self._run(
                    self.system, self.state, self.parameters,
                    jnp.int32(n - done)
                )
                break
            if until > 0:
                self.state = self._run(
                    self.system, self.state, self.parameters,
                    jnp.int32(until)
                )
                done += until
            self.state = self._attempt_run(
                self.system, self.state, self.parameters
            )
            done += 1

    def step(self, n: int):
        """Advance n outer steps entirely on device.

        Capacity overflow auto-recovers: the pre-chunk state is restored,
        capacities retune to the current configuration (static shapes grow,
        one recompile), and the chunk re-runs — so caps can be sized tightly
        (retune_spec) without risking silently-dropped pairs or a hard stop.
        Coverage loss (NPT shrink) and staleness violations still raise.
        """
        for _attempt in range(3):
            backup = None
            if self.check_overflow:
                backup = jax.tree.map(
                    lambda a: jnp.array(a, copy=True), self.state
                )
            self._advance(n)
            if not self.check_overflow:
                break
            overflowed = [
                key for key, flag in self.state.extra.items()
                if key.startswith("nbr") and key.endswith("overflow")
                and bool(flag)
            ]
            if not overflowed:
                break
            if _attempt == 2:
                raise RuntimeError(
                    f"cell-list capacity overflow persists after retuning "
                    f"({overflowed}): increase cell_capacity or "
                    "density_safety in the NeighborSpec"
                )
            import warnings

            warnings.warn(
                f"cell-list overflow ({overflowed}): restoring pre-chunk "
                "state, retuning capacities and re-running (one recompile)",
                stacklevel=2,
            )
            self.state = backup
            # measured on the PRE-chunk state (the replay is deterministic:
            # same RNG, same trajectory, same overflow event), so the
            # capacity must strictly grow and the safety escalates per
            # retry — a retune that shrank or reproduced the old capacity
            # would overflow again by construction (observed: an NPT
            # barostat trial rejected for overflow marks the sticky flag
            # and replays identically; BENCH r4 lost the 100k cutoff row
            # to exactly this livelock)
            self.retune_neighbors(safety=1.15 * (1.2 ** _attempt),
                                  grow_only=True)
        if self.check_overflow:
            for key, flag in self.state.extra.items():
                if key.startswith("nbr") and key.endswith("undercover") and bool(flag):
                    raise RuntimeError(
                        f"cell-list coverage loss ({key}): the box shrank until "
                        "the stencil reach no longer covers the cutoff — pairs "
                        "would be silently dropped. Rebuild the NeighborSpec at "
                        "the current box, or pass a larger min_skin to "
                        "make_neighbor_spec for NPT runs"
                    )
                if key.startswith("nbr") and key.endswith("stale") and bool(flag):
                    raise RuntimeError(
                        f"neighbor staleness ({key}): an atom moved beyond the "
                        "full skin between grouped neighbor updates — reduce "
                        "Context(neighbor_update_every=...) or enlarge the skin"
                    )
        if self.check_overflow:
            from .integrate.barostat import BARO_NATT, BARO_NBAD

            natt = self.state.extra.get(BARO_NATT)
            nbad = self.state.extra.get(BARO_NBAD)
            if (natt is not None and nbad is not None
                    and int(natt) >= 20 and int(nbad) > 0.1 * int(natt)
                    and not getattr(self, "_warned_baro_nbad", False)):
                # an undercovering trial is rejected (never priced on a
                # truncated pair list) but capacity retune cannot fix
                # coverage — a persistently vetoed compression is a silent
                # reflecting wall that would bias <V>. Surface it once.
                import warnings

                self._warned_baro_nbad = True
                warnings.warn(
                    f"MC barostat: {int(nbad)}/{int(natt)} volume-move "
                    "trials were rejected because the trial pair list was "
                    "invalid (bucket overflow/coverage loss at the trial "
                    "box). If this persists the volume distribution is "
                    "biased at the coverage boundary — rebuild the "
                    "NeighborSpec with a larger min_skin for NPT headroom",
                    stacklevel=2,
                )
        # pme_*_undercover flags exist only under the carrier-force guard,
        # but spread buckets are also seeded for a standalone
        # PMEReciprocalForce (_spread_layouts) — gate the spread-flag checks
        # on the buckets themselves or their drops become silent for such
        # systems (ADVICE r4 low)
        if (getattr(self, "_has_pme_guard", False)
                or getattr(self, "_has_spread_buckets", False)):
            for key, flag in self.state.extra.items():
                if key.startswith("pme") and key.endswith("undercover") and bool(flag):
                    raise RuntimeError(
                        f"PME grid coverage loss ({key}): the box grew past "
                        "the validity bound of the static (alpha, grid) "
                        "parameters — reciprocal-space error now exceeds the "
                        "design tolerance. Call retune_pme() to re-derive the "
                        "grid for the current box (one recompile), or build "
                        "with NPT headroom (choose_pme_parameters on a "
                        "volume-inflated box)"
                    )
                if (key.startswith("pme") and key.endswith("spread_overflow")
                        and bool(flag)):
                    raise RuntimeError(
                        f"PME spreading-block overflow ({key}): a spreading "
                        "block held more atoms than its capacity, so charges "
                        "were dropped from the reciprocal sum. Re-run "
                        "forces.retune_pme_spread at the current "
                        "configuration (larger safety), or clear spread_block "
                        "to fall back to the dense spreading path"
                    )
                if (key.startswith("pme") and key.endswith("spread_stale")
                        and bool(flag)):
                    raise RuntimeError(
                        f"PME spreading-bucket staleness ({key}): an atom "
                        "drifted beyond the padded spreading window before "
                        "the bucket rebuilt, so its charge was dropped from "
                        "the reciprocal sum at some step. Increase "
                        "retune_pme_spread(pad=...) or reduce "
                        "Context(neighbor_update_every=...)"
                    )
        return self

    def get_state(self, lite: bool = False) -> StateSnapshot:
        """Full snapshot (per-force split, per-group energies, forces), or
        with lite=True a cheap one (positions/velocities/PE/KE only — one
        total-energy pass instead of the 9-12 step-time full split;
        Simulation picks it automatically when only lite reporters are
        due)."""
        if lite:
            return self._observe_lite(self.system, self.state,
                                      self.parameters)
        return self._observe(self.system, self.state, self.parameters)

    def retune_neighbors(self, safety: float = 1.15,
                         grow_only: bool = False):
        """Resize every neighbor spec's cell capacity to the MEASURED max
        occupancy of the current configuration (ops.neighbors.retune_spec).

        Cold-start sizing must survive lattice clustering; an equilibrated
        liquid needs ~40% less capacity, and pair work scales with cap^2 —
        call this once after equilibration for ~2x faster pair kernels.
        Static shapes change, so the next step() recompiles once.
        grow_only floors each capacity at its current value + 4 (overflow
        auto-recovery: the replayed chunk only stops overflowing if
        capacities actually grow).
        """
        if self.system.neighbors is None:
            return self
        from .ops.neighbors import all_neighbor_extras, retune_neighbor_specs

        self.system = retune_neighbor_specs(
            self.system, self.state.x, self.state.box, safety,
            grow_only=grow_only
        )
        kept = {
            k: v for k, v in self.state.extra.items()
            if not k.startswith("nbr")
        }
        state = replace(self.state, extra=kept)
        self.state = state.with_extra(
            **jax.jit(all_neighbor_extras)(self.system, state.x, state.box)
        )
        return self

    def retune_pme(self):
        """Re-derive every PME force's grid for the CURRENT box (alpha stays
        — it depends only on r_cut and the error tolerance, which volume
        moves do not change). Clears the sticky pme_*_undercover flags.
        Static grid shapes change, so the next step() recompiles once."""
        import numpy as np

        from .forces import PMEReciprocalForce, _pme_carrier
        from .ops.pme import choose_pme_parameters

        new_forces, regrids = [], {}
        for f in self.system.forces:
            g = _pme_carrier(f)
            if g is None:
                new_forces.append(f)
                continue
            # recover the design tolerance from the openmm alpha heuristic
            alpha = float(g.ewald_alpha)
            tol = 0.5 * float(np.exp(-((alpha * float(g.r_cut)) ** 2)))
            _, grid, _ = choose_pme_parameters(
                float(g.r_cut), np.asarray(self.state.box), tol=tol,
                alpha=alpha, grid=None, order=int(g.spline_order),
            )
            # keep the LARGER grid per dimension: shrinking on a small box
            # is allowed but never required for correctness
            grid = tuple(max(a, b) for a, b in zip(grid, g.grid_shape))
            changes = {"grid_shape": grid}
            if g.spread_block:
                # the old blocks need not divide the new grid; re-choose at
                # the current configuration (or fall back to dense)
                from .ops.pme import choose_spread_blocks

                pad = int(getattr(g, "spread_pad", 0))
                block, cap = choose_spread_blocks(
                    grid, int(g.spline_order), int(self.state.x.shape[0]),
                    x=np.asarray(self.state.x), box=np.asarray(self.state.box),
                    pad=pad)
                changes["spread_block"] = block or ()
                changes["spread_cap"] = cap
                changes["spread_pad"] = pad if block else 0
            regrids[float(g.ewald_alpha)] = changes
            if g is f:
                new_forces.append(replace(f, **changes))
            else:  # Far wrapper: regrid the inner full force
                new_forces.append(replace(f, full=replace(f.full, **changes)))
        # PMEReciprocalForce (triple split) shares its companion's
        # alpha/grid (and spreading layout — overflow is checked once, on
        # the carrier, so the two must stay identical)
        new_forces = [
            replace(f, **regrids[float(f.ewald_alpha)])
            if isinstance(f, PMEReciprocalForce)
            and float(f.ewald_alpha) in regrids else f
            for f in new_forces
        ]
        self.system = self.system.replace_forces(new_forces)
        cleared = {
            k: jnp.zeros((), bool)
            for k in self.state.extra if k.startswith("pme")
            and (k.endswith("undercover") or k.endswith("spread_overflow"))
        }
        if cleared:
            self.state = self.state.with_extra(**cleared)
        if getattr(self, "_has_spread_buckets", False):
            # layouts changed with the grid: drop the old bucket extras and
            # reseed at the current configuration (the pytree structure
            # changes, but so did the static grids — recompile regardless)
            extra = {
                k: v for k, v in self.state.extra.items()
                if not k.startswith("pmesp_")
                and not (k.startswith("pme") and (
                    k.endswith("spread_overflow")
                    or k.endswith("spread_stale")))
            }
            self.state = replace(self.state, extra=extra)
            self._seed_spread_buckets()
            self._run = jax.jit(self._make_run(), donate_argnums=(1,))
            if self._barostat is not None:
                self._attempt_run = jax.jit(self._make_attempt_step(),
                                            donate_argnums=(1,))
        return self

    # -- openmm-style camelCase aliases (the reference's users call these
    # spellings; SURVEY.md §3 call stacks) --------------------------------

    def setPositions(self, x):
        return self.set_positions(x)

    def setVelocities(self, v):
        return self.set_velocities(v)

    def setVelocitiesToTemperature(self, temperature, seed: int = 0):
        return self.set_velocities_to_temperature(temperature, seed)

    def setParameter(self, name, value):
        return self.set_parameter(name, value)

    def getParameter(self, name):
        return self.get_parameter(name)

    def setPeriodicBoxVectors(self, box):
        return self.set_periodic_box(box)

    def getState(self, **_ignored) -> StateSnapshot:
        return self.get_state()

    # -- convenience -------------------------------------------------------

    @property
    def degrees_of_freedom(self) -> int:
        return count_degrees_of_freedom(self.system)

    def temperature(self):
        from .units import BOLTZMANN

        ke = kinetic_energy(self.system.masses, self.state.v)
        return 2.0 * ke / (self.degrees_of_freedom * BOLTZMANN)

    def conserved_energy(self):
        """Potential + kinetic + thermostat/extended contributions — the
        quantity whose drift validates an integrator."""
        snap = self.get_state()
        return (
            snap.potential_energy
            + snap.kinetic_energy
            + self.integrator.conserved_extra(self.state)
        )
