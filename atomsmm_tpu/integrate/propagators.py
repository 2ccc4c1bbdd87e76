"""Propagator algebra — the heart of the package
(counterpart of atomsmm/propagators.py; SURVEY.md §2a, §3.2).

In the reference, each Propagator emits openmm.CustomIntegrator variables and
instruction steps; composition mirrors operator-splitting math, and OpenMM's
CustomIntegrator VM executes the program. Here each Propagator's `apply`
emits *traced JAX operations on the State pytree*; composition builds one
jittable step function that `lax.scan`/`fori_loop` executes on the device. The
algebra (Chained / Split / TrotterSuzuki / SuzukiYoshida / Respa) is preserved
exactly, including operator ordering and Suzuki-Yoshida weights — the
"single most important semantic object to replicate" (SURVEY.md §3.2).

Every propagator implements:
  extra_variables(system, state) -> dict of named initial arrays (the analog
      of CustomIntegrator global/per-DOF variables; stored in State.extra)
  apply(ctx, state, fraction) -> new State, advancing time by fraction*ctx.dt
  describe(fraction) -> list of strings (the analog of the reference's
      _AtomsMM_Integrator.__str__ instruction dump — the integrator debugger)

`ctx` is a StepContext carrying the system, the global-parameter dict, the
step size, and cached per-group force evaluators.

Examples — composition mirrors the operator-splitting math:

>>> vv = VelocityVerletPropagator()
>>> for line in vv.describe(1.0):
...     print(line)
VelocityVerlet:
  v <- v + F[all]/m * 0.5 dt, read cache
  x <- x + v * 1 dt (+SETTLE/SHAKE if constrained)
  v <- v + F[all]/m * 0.5 dt, write cache

>>> ts = TrotterSuzukiPropagator(TranslationPropagator(),
...                              BoostPropagator(groups={0}))
>>> for line in ts.describe(1.0):
...     print(line)
TrotterSuzuki:
  v <- v + F[[0]]/m * 0.5 dt
  x <- x + v * 1 dt (+SETTLE/SHAKE if constrained)
  v <- v + F[[0]]/m * 0.5 dt

Suzuki-Yoshida weights sum to 1 at every supported order (1/3/7/15):

>>> [round(sum(_SY_WEIGHTS[n]), 12) for n in (1, 3, 7, 15)]
[1.0, 1.0, 1.0, 1.0]
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from ..potential import force_fn
from ..state import State, kinetic_energy
from ..units import BOLTZMANN
from ..utils import count_degrees_of_freedom, replace


class StepContext:
    """Trace-time context threaded through propagator application."""

    def __init__(self, system, globals, dt):
        self.system = system
        self.globals = dict(globals or {})
        self.dt = dt
        self._force_fns = {}

    def forces(self, state: State, groups=None) -> jnp.ndarray:
        """Forces [kJ/mol/nm] for the given force groups (None = all).

        The per-(frozen)group evaluator is built once per trace; identical
        calls at identical positions are CSE'd by XLA, mirroring how the
        reference's CustomIntegrator caches per-group forces f0/f1/f2.
        The neighbor list (if present) rides in State.extra and is threaded
        through as aux.
        """
        from ..ops.neighbors import make_aux

        key = None if groups is None else frozenset(groups)
        if key not in self._force_fns:
            self._force_fns[key] = force_fn(self.system, key)
        aux = make_aux(self.system, state.extra)
        _, f = self._force_fns[key](state.x, state.box, self.globals, aux)
        return f

    @property
    def masses(self):
        return self.system.masses

    def kT(self, temperature):
        return BOLTZMANN * temperature


def _maybe_loop(n: int, body, state: State, unroll_threshold: int = 2):
    """Repeat `body` (State -> State) n times; unrolled for small n, as a
    lax.fori_loop otherwise (keeps XLA program size bounded for deep RESPA)."""
    if n <= unroll_threshold:
        for _ in range(n):
            state = body(state)
        return state
    return jax.lax.fori_loop(0, n, lambda i, s: body(s), state)


class Propagator:
    """Base class (atomsmm/propagators.py::Propagator)."""

    #: positive marker for bath/thermostat propagators, used by
    #: GlobalThermostatIntegrator's swapped-argument guard (a thermostat in
    #: the trajectory-core slot silently integrates the wrong splitting)
    is_thermostat = False

    def extra_variables(self, system, state) -> Dict[str, jnp.ndarray]:
        return {}

    def apply(self, ctx: StepContext, state: State, fraction: float) -> State:
        raise NotImplementedError

    def describe(self, fraction: float = 1.0):
        return [f"{type(self).__name__}({fraction:g} dt)"]

    def integrator(self, dt):
        """Wrap this propagator as a user-facing integrator
        (atomsmm Propagator.integrator())."""
        from .integrators import PropagatorIntegrator

        return PropagatorIntegrator(dt, self)


class ChainedPropagator(Propagator):
    """Apply propagators in sequence, each over the full fraction:
    exp(t A_n) ... exp(t A_1) — list order [A_1, ..., A_n] is application
    order (atomsmm/propagators.py::ChainedPropagator)."""

    def __init__(self, propagators: Sequence[Propagator]):
        self.propagators = list(propagators)

    def extra_variables(self, system, state):
        out = {}
        for p in self.propagators:
            out.update(p.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        for p in self.propagators:
            state = p.apply(ctx, state, fraction)
        return state

    def describe(self, fraction=1.0):
        lines = [f"Chained({fraction:g} dt):"]
        for p in self.propagators:
            lines += ["  " + l for l in p.describe(fraction)]
        return lines


class SplitPropagator(Propagator):
    """exp(t A) = [exp(t/n A)]^n (atomsmm/propagators.py::SplitPropagator)."""

    def __init__(self, propagator: Propagator, n: int):
        self.propagator = propagator
        self.n = int(n)

    def extra_variables(self, system, state):
        return self.propagator.extra_variables(system, state)

    def apply(self, ctx, state, fraction):
        return _maybe_loop(
            self.n, lambda s: self.propagator.apply(ctx, s, fraction / self.n), state
        )

    def describe(self, fraction=1.0):
        lines = [f"Split x{self.n}:"]
        lines += ["  " + l for l in self.propagator.describe(fraction / self.n)]
        return lines


class TrotterSuzukiPropagator(Propagator):
    """Symmetric splitting exp(t/2 B) exp(t A) exp(t/2 B)
    (atomsmm/propagators.py::TrotterSuzukiPropagator): `outer` is B (half step
    on each side), `inner` is A (full step in the middle)."""

    def __init__(self, inner: Propagator, outer: Propagator):
        self.inner = inner
        self.outer = outer

    def extra_variables(self, system, state):
        out = self.inner.extra_variables(system, state)
        out.update(self.outer.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        state = self.outer.apply(ctx, state, 0.5 * fraction)
        state = self.inner.apply(ctx, state, fraction)
        state = self.outer.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        lines = ["TrotterSuzuki:"]
        lines += ["  " + l for l in self.outer.describe(0.5 * fraction)]
        lines += ["  " + l for l in self.inner.describe(fraction)]
        lines += ["  " + l for l in self.outer.describe(0.5 * fraction)]
        return lines


#: Suzuki-Yoshida composition weights (atomsmm/propagators.py::SuzukiYoshidaPropagator)
_SY_WEIGHTS = {
    1: [1.0],
    3: [1.3512071919596578, -1.7024143839193155, 1.3512071919596578],
    7: [
        0.784513610477560,
        0.235573213359357,
        -1.17767998417887,
        1.3151863206839063,
        -1.17767998417887,
        0.235573213359357,
        0.784513610477560,
    ],
    15: [
        0.102799849391985,
        -1.96061023297549,
        1.93813913762276,
        -0.158240635368243,
        -1.44485223686048,
        0.253693336566229,
        0.914844246229740,
        1.708453070786998,  # central weight = 1 - 2*sum(others)
        0.914844246229740,
        0.253693336566229,
        -1.44485223686048,
        -0.158240635368243,
        1.93813913762276,
        -1.96061023297549,
        0.102799849391985,
    ],
}


class SuzukiYoshidaPropagator(Propagator):
    """Higher-order composition: apply A with the nsy-point Suzuki-Yoshida
    weights (used to sub-split thermostat propagators)."""

    def __init__(self, propagator: Propagator, nsy: int = 3):
        if nsy not in _SY_WEIGHTS:
            raise ValueError(f"nsy must be one of {sorted(_SY_WEIGHTS)}")
        self.propagator = propagator
        self.nsy = nsy

    def extra_variables(self, system, state):
        return self.propagator.extra_variables(system, state)

    def apply(self, ctx, state, fraction):
        for w in _SY_WEIGHTS[self.nsy]:
            state = self.propagator.apply(ctx, state, w * fraction)
        return state

    def describe(self, fraction=1.0):
        lines = [f"SuzukiYoshida(nsy={self.nsy}):"]
        for w in _SY_WEIGHTS[self.nsy]:
            lines += ["  " + l for l in self.propagator.describe(w * fraction)]
        return lines


class TranslationPropagator(Propagator):
    """x <- x + v * t (atomsmm/propagators.py::TranslationPropagator).

    Constrained systems follow the move with the position projection and
    the matching velocity correction (openmm applies constraints inside
    its integrator steps — N5): closed-form SETTLE for 3-site rigid
    molecules (ops/settle.py — exact, one shot), Jacobi SHAKE for any
    remaining general constraints (ops/constraints.py)."""

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        cons = getattr(ctx.system, "constraints", None)
        sset = getattr(ctx.system, "settle", None)
        vsites = getattr(ctx.system, "virtual_sites", None)
        x_unc = state.x + state.v * t
        if cons is None and sset is None:
            if vsites is not None:
                from ..ops.virtual_sites import place_virtual_sites

                x_unc = place_virtual_sites(vsites, x_unc)
            return replace(state, x=x_unc)
        x_new = x_unc
        if sset is not None:
            from ..ops.settle import settle_positions

            x_new = settle_positions(sset, x_new, state.x, ctx.masses)
        if cons is not None:
            from ..ops.constraints import shake_positions

            x_new = shake_positions(cons, x_new, state.x, 1.0 / ctx.masses)
        v = state.v + (x_new - x_unc) / t
        if vsites is not None:
            # keep the stored virtual rows consistent with their parents
            # (forces never read them — they are re-placed at evaluation)
            from ..ops.virtual_sites import (
                place_virtual_sites,
                zero_virtual_velocities,
            )

            x_new = place_virtual_sites(vsites, x_new)
            v = zero_virtual_velocities(vsites, v)
        return replace(state, x=x_new, v=v)

    def describe(self, fraction=1.0):
        return [f"x <- x + v * {fraction:g} dt (+SETTLE/SHAKE if constrained)"]


def _project_velocities(ctx, x, v):
    """Project velocities onto the constraint tangent space: closed-form
    SETTLE for 3-site molecules (exact one-shot 3x3 solve), iterative
    RATTLE for any remaining general constraints; virtual-site rows are
    pinned to zero (they receive no kicks, and stochastic baths must not
    hand them noise)."""
    sset = getattr(ctx.system, "settle", None)
    if sset is not None:
        from ..ops.settle import settle_velocities

        v = settle_velocities(sset, x, v, ctx.masses)
    cons = getattr(ctx.system, "constraints", None)
    if cons is not None:
        from ..ops.constraints import rattle_velocities

        v = rattle_velocities(cons, x, v, 1.0 / ctx.masses)
    vsites = getattr(ctx.system, "virtual_sites", None)
    if vsites is not None:
        from ..ops.virtual_sites import zero_virtual_velocities

        v = zero_virtual_velocities(vsites, v)
    return v


def force_cache_tag(groups) -> str:
    """State.extra key for the cached forces of a force-group set — the analog
    of the CustomIntegrator's per-group force registers f0/f1/f2."""
    if groups is None:
        return "fcache_all"
    return "fcache_" + "_".join(str(g) for g in sorted(groups))


def parse_force_cache_tag(key: str):
    body = key[len("fcache_"):]
    return None if body == "all" else frozenset(int(g) for g in body.split("_"))


class BoostPropagator(Propagator):
    """v <- v + (F_groups / m) * t
    (atomsmm/propagators.py::VelocityBoostPropagator; per-force-group boosts
    are the RESPA levels' kicks).

    cache: None  — always evaluate forces fresh;
           'read' — use the cached forces in State.extra (valid because the
             matching 'write' boost stored them at the current positions —
             mirrors the f0/f1/f2 reuse in the reference's CustomIntegrator VM
             and halves force evaluations per step);
           'write' — evaluate fresh, store into the cache, then boost.
    """

    def __init__(self, groups=None, cache: str | None = None):
        self.groups = None if groups is None else frozenset(groups)
        self.cache = cache

    def extra_variables(self, system, state):
        if self.cache is None:
            return {}
        return {force_cache_tag(self.groups): jnp.zeros_like(state.x)}

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        if self.cache == "read":
            f = state.extra[force_cache_tag(self.groups)]
        else:
            f = ctx.forces(state, self.groups)
        # safe inverse mass: virtual sites are massless AND forceless (the
        # placement vjp zeroes their rows), so 0-mass rows get kick 0, not nan
        m = ctx.masses
        inv_m = jnp.where(m > 0, 1.0 / jnp.where(m > 0, m, 1.0), 0.0)
        v = state.v + f * inv_m[:, None] * t
        v = _project_velocities(ctx, state.x, v)
        state = replace(state, v=v)
        if self.cache == "write":
            state = state.with_extra(**{force_cache_tag(self.groups): f})
        return state

    def describe(self, fraction=1.0):
        g = "all" if self.groups is None else sorted(self.groups)
        c = f", {self.cache} cache" if self.cache else ""
        return [f"v <- v + F[{g}]/m * {fraction:g} dt{c}"]


class VelocityVerletPropagator(Propagator):
    """Velocity Verlet: B(t/2) A(t) B(t/2)
    (atomsmm/propagators.py::VelocityVerletPropagator). The leading kick reads
    the force cache; the trailing kick refreshes it."""

    def __init__(self, groups=None, cached: bool = True):
        self.pre = BoostPropagator(groups, cache="read" if cached else None)
        self.post = BoostPropagator(groups, cache="write" if cached else None)
        self.move = TranslationPropagator()

    def extra_variables(self, system, state):
        out = self.pre.extra_variables(system, state)
        out.update(self.post.extra_variables(system, state))
        return out

    def apply(self, ctx, state, fraction):
        state = self.pre.apply(ctx, state, 0.5 * fraction)
        state = self.move.apply(ctx, state, fraction)
        state = self.post.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        return (
            ["VelocityVerlet:"]
            + ["  " + l for l in self.pre.describe(0.5 * fraction)]
            + ["  " + l for l in self.move.describe(fraction)]
            + ["  " + l for l in self.post.describe(0.5 * fraction)]
        )


class RespaPropagator(Propagator):
    """r-RESPA nested multiple-timescale splitting
    (atomsmm/propagators.py::RespaPropagator; Tuckerman/Berne/Martyna 1992).

    loops[k] is the number of substeps at level k (innermost = force group 0).
    At level k > 0, one pass over fraction f performs loops[k] iterations of

        B_k(f'/2)  [bath_k(f'/2)]  level_{k-1}(f')  [bath_k(f'/2)]  B_k(f'/2)

    with f' = f / loops[k], where B_k boosts with the forces of group k. At
    level 0 the innermost motion is `core` (default: velocity-Verlet with
    group-0 forces around a translation).

    `baths` maps level -> Propagator spliced inside that level's boosts (the
    reference's crust/shell thermostat placement); level -1 means outside the
    outermost boost (applied symmetrically around everything).
    """

    def __init__(
        self,
        loops: Sequence[int],
        core: Optional[Propagator] = None,
        baths: Optional[Dict[int, Propagator]] = None,
        boost_cls=BoostPropagator,
    ):
        self.loops = [int(n) for n in loops]
        self.levels = len(self.loops)
        self.core = core
        self.baths = dict(baths or {})
        self.boost_cls = boost_cls

    def extra_variables(self, system, state):
        out = {}
        if self.core is not None:
            out.update(self.core.extra_variables(system, state))
        for b in self.baths.values():
            out.update(b.extra_variables(system, state))
        for k in range(self.levels):
            out.update(
                self.boost_cls(groups={k}, cache="write").extra_variables(
                    system, state
                )
            )
        return out

    def _level(self, ctx, state, k: int, fraction: float):
        n = self.loops[k]
        sub = fraction / n
        bath = self.baths.get(k)
        boost_pre = self.boost_cls(groups={k}, cache="read")
        boost_post = self.boost_cls(groups={k}, cache="write")

        def iteration(s):
            s = boost_pre.apply(ctx, s, 0.5 * sub)
            if bath is not None:
                s = bath.apply(ctx, s, 0.5 * sub)
            if k == 0:
                if self.core is not None:
                    s = self.core.apply(ctx, s, sub)
                else:
                    s = TranslationPropagator().apply(ctx, s, sub)
            else:
                s = self._level(ctx, s, k - 1, sub)
            if bath is not None:
                s = bath.apply(ctx, s, 0.5 * sub)
            s = boost_post.apply(ctx, s, 0.5 * sub)
            return s

        return _maybe_loop(n, iteration, state)

    def apply(self, ctx, state, fraction):
        outer_bath = self.baths.get(-1)
        if outer_bath is not None:
            state = outer_bath.apply(ctx, state, 0.5 * fraction)
        state = self._level(ctx, state, self.levels - 1, fraction)
        if outer_bath is not None:
            state = outer_bath.apply(ctx, state, 0.5 * fraction)
        return state

    def describe(self, fraction=1.0):
        lines = [f"RESPA(loops={self.loops}):"]

        def level(k, f, indent):
            pad = "  " * indent
            n = self.loops[k]
            sub = f / n
            lines.append(pad + f"repeat x{n}:")
            lines.append(pad + f"  v <- v + F[{k}]/m * {0.5*sub:g} dt")
            if k in self.baths:
                lines.append(pad + f"  bath[{k}]({0.5*sub:g} dt)")
            if k == 0:
                if self.core is not None:
                    for l in self.core.describe(sub):
                        lines.append(pad + "  " + l)
                else:
                    lines.append(pad + f"  x <- x + v * {sub:g} dt")
            else:
                level(k - 1, sub, indent + 1)
            if k in self.baths:
                lines.append(pad + f"  bath[{k}]({0.5*sub:g} dt)")
            lines.append(pad + f"  v <- v + F[{k}]/m * {0.5*sub:g} dt")

        if -1 in self.baths:
            lines.append(f"  bath[-1]({0.5*fraction:g} dt)")
        level(self.levels - 1, fraction, 1)
        if -1 in self.baths:
            lines.append(f"  bath[-1]({0.5*fraction:g} dt)")
        return lines


class NoseHooverChainPropagator(Propagator):
    """Global Nosé-Hoover chain thermostat
    (atomsmm/propagators.py::NoseHooverPropagator), chain length `nchain`,
    Suzuki-Yoshida sub-splitting with `nsy` weights x `nloops` loops
    (Martyna-Tuckerman-Klein).

    Extended variables (State.extra):
      {tag}_v: (nchain,) chain velocities; {tag}_eta: (nchain,) chain
      positions (only enter the conserved quantity).
    """

    is_thermostat = True

    def __init__(self, temperature, degrees_of_freedom, time_scale,
                 nchain: int = 2, nsy: int = 3, nloops: int = 1, tag="nhc"):
        self.temperature = float(temperature)
        self.dof = int(degrees_of_freedom)
        self.tau = float(time_scale)
        self.nchain = int(nchain)
        self.nsy = int(nsy)
        self.nloops = int(nloops)
        self.tag = tag

    def _q(self, dtype):
        kT = BOLTZMANN * self.temperature
        q = jnp.full((self.nchain,), kT * self.tau**2, dtype)
        return q.at[0].mul(self.dof)

    def extra_variables(self, system, state):
        z = jnp.zeros((self.nchain,), state.v.dtype)
        return {f"{self.tag}_v": z, f"{self.tag}_eta": z}

    def apply(self, ctx, state, fraction):
        kT = BOLTZMANN * self.temperature
        q = self._q(state.v.dtype)
        v_eta = state.extra[f"{self.tag}_v"]
        eta = state.extra[f"{self.tag}_eta"]
        v = state.v
        m = ctx.masses[:, None]

        twok = jnp.sum(m * v * v)  # 2 * kinetic energy
        scale = jnp.ones((), v.dtype)

        def sweep(carry, dt_w):
            twok, scale, v_eta, eta = carry
            h = 0.5 * dt_w
            # update chain tail -> head
            for j in range(self.nchain - 1, -1, -1):
                if j == 0:
                    g = (twok * scale**2 - self.dof * kT) / q[0]
                else:
                    g = (q[j - 1] * v_eta[j - 1] ** 2 - kT) / q[j]
                if j < self.nchain - 1:
                    damp = jnp.exp(-0.25 * dt_w * v_eta[j + 1])
                    v_eta = v_eta.at[j].set(v_eta[j] * damp**2 + g * h * damp)
                else:
                    v_eta = v_eta.at[j].set(v_eta[j] + g * h)
            # scale particle velocities and advance chain positions
            scale = scale * jnp.exp(-dt_w * v_eta[0])
            eta = eta + dt_w * v_eta
            # update chain head -> tail
            for j in range(self.nchain):
                if j == 0:
                    g = (twok * scale**2 - self.dof * kT) / q[0]
                else:
                    g = (q[j - 1] * v_eta[j - 1] ** 2 - kT) / q[j]
                if j < self.nchain - 1:
                    damp = jnp.exp(-0.25 * dt_w * v_eta[j + 1])
                    v_eta = v_eta.at[j].set(v_eta[j] * damp**2 + g * h * damp)
                else:
                    v_eta = v_eta.at[j].set(v_eta[j] + g * h)
            return (twok, scale, v_eta, eta), None

        t = fraction * ctx.dt
        weights = jnp.asarray(
            [w * t / self.nloops for w in _SY_WEIGHTS[self.nsy]] * self.nloops,
            v.dtype,
        )
        (twok, scale, v_eta, eta), _ = jax.lax.scan(
            sweep, (twok, scale, v_eta, eta), weights
        )
        state = replace(state, v=v * scale)
        return state.with_extra(**{f"{self.tag}_v": v_eta, f"{self.tag}_eta": eta})

    def conserved_extra(self, state):
        """Thermostat contribution to the conserved quantity."""
        kT = BOLTZMANN * self.temperature
        q = self._q(state.v.dtype)
        v_eta = state.extra[f"{self.tag}_v"]
        eta = state.extra[f"{self.tag}_eta"]
        e = jnp.sum(0.5 * q * v_eta**2) + self.dof * kT * eta[0]
        if self.nchain > 1:
            e = e + kT * jnp.sum(eta[1:])
        return e

    def describe(self, fraction=1.0):
        return [
            f"NoseHooverChain(T={self.temperature}K, tau={self.tau}ps, "
            f"nchain={self.nchain}, nsy={self.nsy}) over {fraction:g} dt"
        ]


class OrnsteinUhlenbeckPropagator(Propagator):
    """Exact Ornstein-Uhlenbeck update on particle velocities (the Langevin
    friction+noise half: v <- v e^{-gamma t} + sqrt(kT/m (1 - e^{-2 gamma t})) R)
    (atomsmm/propagators.py::OrnsteinUhlenbeckPropagator). Setting
    `variable` updates a named extra array with effective mass `mass` instead.
    """

    is_thermostat = True

    def __init__(self, temperature, friction, variable: Optional[str] = None,
                 mass=None, temperature_global: Optional[str] = None):
        self.temperature = float(temperature)
        self.friction = float(friction)  # 1/ps
        self.variable = variable
        self.mass = mass
        # when set, the bath temperature is read from this traced global
        # parameter at step time (falls back to `temperature`) — lets
        # temperature-REMD replicas carry per-replica bath setpoints
        # through the vmapped globals row with no recompilation
        self.temperature_global = temperature_global

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        t_set = self.temperature
        if self.temperature_global is not None:
            t_set = (ctx.globals or {}).get(self.temperature_global, t_set)
        kT = BOLTZMANN * t_set
        decay = math.exp(-self.friction * t)
        noise = math.sqrt(max(1.0 - decay * decay, 0.0))
        rng, sub = jax.random.split(state.rng)
        if self.variable is None:
            m = ctx.masses[:, None]
            # massless rows (virtual sites, SCF Drude particles) carry no
            # momentum: zero noise, and the projection re-pins them
            sigma = jnp.where(
                m > 0, jnp.sqrt(kT / jnp.where(m > 0, m, 1.0)), 0.0)
            r = jax.random.normal(sub, state.v.shape, state.v.dtype)
            v = state.v * decay + sigma * noise * r
            # Additive noise breaks constraint tangency (d/dt|r_ij| = 0);
            # re-project like BoostPropagator does. Uniform rescalings
            # (NHC/CSVR) preserve tangency and need no projection (ADVICE r01).
            v = _project_velocities(ctx, state.x, v)
            return replace(state, v=v, rng=rng)
        z = state.extra[self.variable]
        sigma = jnp.sqrt(kT / self.mass)
        r = jax.random.normal(sub, z.shape, z.dtype)
        z = z * decay + sigma * noise * r
        return replace(state, rng=rng).with_extra(**{self.variable: z})

    def describe(self, fraction=1.0):
        target = self.variable or "v"
        return [
            f"{target} <- OU(T={self.temperature}K, gamma={self.friction}/ps) "
            f"over {fraction:g} dt"
        ]


class VelocityRescalingPropagator(Propagator):
    """Bussi-Donadio-Parrinello stochastic velocity rescaling (CSVR)
    (atomsmm/propagators.py::VelocityRescalingPropagator)."""

    is_thermostat = True

    def __init__(self, temperature, degrees_of_freedom, time_scale):
        self.temperature = float(temperature)
        self.dof = int(degrees_of_freedom)
        self.tau = float(time_scale)

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        kT = BOLTZMANN * self.temperature
        m = ctx.masses[:, None]
        ke = 0.5 * jnp.sum(m * state.v * state.v)
        ke_bar = 0.5 * self.dof * kT
        c = math.exp(-t / self.tau)
        rng, k1, k2 = jax.random.split(state.rng, 3)
        r1 = jax.random.normal(k1, (), state.v.dtype)
        # sum of (dof-1) squared normals ~ chi^2 = Gamma((dof-1)/2, scale=2)
        rsum = 2.0 * jax.random.gamma(
            k2, 0.5 * (self.dof - 1), dtype=state.v.dtype
        )
        ratio = ke_bar / (self.dof * ke)
        alpha2 = (
            c
            + (1.0 - c) * ratio * (r1 * r1 + rsum)
            + 2.0 * r1 * jnp.sqrt(c * (1.0 - c) * ratio)
        )
        # Bussi's alpha carries a sign: negative when the r1 noise term
        # dominates (sign of r1 + sqrt(c/((1-c)*ratio))) — losing the velocity
        # flip biases the KE distribution at small dof (ADVICE r01).
        sign = jnp.sign(r1 + jnp.sqrt(c / ((1.0 - c) * ratio)))
        alpha = jnp.where(sign == 0, 1.0, sign) * jnp.sqrt(alpha2)
        return replace(state, v=state.v * alpha, rng=rng)

    def describe(self, fraction=1.0):
        return [
            f"v <- CSVR rescale(T={self.temperature}K, tau={self.tau}ps) "
            f"over {fraction:g} dt"
        ]


class GenericBoostPropagator(Propagator):
    """target <- target + rate_fn(ctx, state) * t — building block for
    extended-variable kicks (atomsmm/propagators.py::GenericBoostPropagator).
    target is 'v' or a State.extra key."""

    def __init__(self, rate_fn, target: str = "v"):
        self.rate_fn = rate_fn
        self.target = target

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        rate = self.rate_fn(ctx, state)
        if self.target == "v":
            return replace(state, v=state.v + t * rate)
        z = state.extra[self.target] + t * rate
        return state.with_extra(**{self.target: z})

    def describe(self, fraction=1.0):
        return [f"{self.target} <- {self.target} + rate * {fraction:g} dt"]


class GenericScalingPropagator(Propagator):
    """v <- v * exp(-t * rate_fn(state)) — building block for extended-variable
    couplings (atomsmm/propagators.py::GenericScalingPropagator)."""

    def __init__(self, rate_fn, target: str = "v"):
        self.rate_fn = rate_fn
        self.target = target

    def apply(self, ctx, state, fraction):
        t = fraction * ctx.dt
        rate = self.rate_fn(ctx, state)
        if self.target == "v":
            return replace(state, v=state.v * jnp.exp(-t * rate))
        z = state.extra[self.target] * jnp.exp(-t * rate)
        return state.with_extra(**{self.target: z})

    def describe(self, fraction=1.0):
        return [f"{self.target} <- {self.target} * exp(-{fraction:g} dt * rate)"]
