"""Replica-parallel λ-state sampling + Hamiltonian replica exchange (HREX).

The sequential alchemical workflow (alchemy.sample_lambda_states) visits K
λ-states one after another in a single Context — K× the wall clock of one
state. The K states are embarrassingly parallel (SURVEY.md §2c DP row:
"cross-replica reductions (e.g. replica-exchange swaps) via psum/pmax"),
so here they run as data-parallel replicas: every replica holds its OWN
traced globals row (λ_k), all K step in one vmapped/jitted call, and
the batch is sharded over a `jax.sharding.Mesh` when one is given (XLA
inserts the collectives; on a single chip the same code is a pure vmap
batch, which already wins over the sequential visit by keeping the chip
full with K small systems at once).

Between sampling chunks, neighbor-swap Hamiltonian replica exchange runs
device-side: a jitted Metropolis criterion over alternating even/odd pairs
(k, k+1),

    P_acc = min(1, exp(-β [U_k(x_{k+1}) + U_{k+1}(x_k)
                           - U_k(x_k) - U_{k+1}(x_{k+1})])),

with configurations (x, v, neighbor extras) exchanged through one gather by
a permutation computed from the accept mask — under a sharded batch the
gather compiles to a collective permute. λ stays pinned to its
replica row, so row k always samples state k and the MBAR bookkeeping is
unchanged; the swaps only decorrelate the chain (mixing across the λ
ladder), which is exactly their statistical job.
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..potential import potential_energy
from ..state import make_state, maxwell_boltzmann_velocities
from ..units import BOLTZMANN
from ..utils import replace
from .replicas import replicate_state

# State.extra keys that travel WITH the configuration on an accepted swap:
# neighbor machinery describes x; force caches are recomputed at the next
# chunk's refresh (they depend on both x and the row's λ, so moving them is
# merely a placeholder — nothing reads them before the refresh).
_CONFIG_PREFIXES = ("nbr", "fcache")


def _energy_fn(system):
    from ..ops.neighbors import make_aux

    def energy_one(x, box, extra, globals):
        return potential_energy(system, x, box, globals,
                                aux=make_aux(system, extra))

    return energy_one


def make_hrex_swap(system, temperature):
    """swap(states, globalss, key, parity) -> (states, n_accept, n_eligible).

    states: replica-stacked State (leading K axis); globalss: dict of (K,)
    λ arrays; parity: 0 swaps pairs (0,1),(2,3)…, 1 swaps (1,2),(3,4)….
    Fully jittable — three vmapped energy batches + one gather.

    `temperature` may be a scalar (Hamiltonian exchange at one T) or a
    (K,) ladder (temperature/combined REMD): the criterion generalizes to

        Δ_k = β_k [U_k(x_{k+1}) - U_k(x_k)]
            + β_{k+1} [U_{k+1}(x_k) - U_{k+1}(x_{k+1})],

    and velocities arriving at row k from row j are rescaled by
    sqrt(T_k / T_j) so the exchanged configuration lands with kinetic
    energy canonical at its NEW temperature (the standard T-REMD move).
    """
    temperature = jnp.asarray(temperature)
    beta = 1.0 / (BOLTZMANN * temperature)  # scalar or (K,)
    energy_one = _energy_fn(system)

    def swap(states, globalss, key, parity):
        k_states = states.x.shape[0]
        idx = jnp.arange(k_states)

        def up(a):  # row k <- row k+1 (periodic; last row masked out below)
            return jnp.roll(a, -1, axis=0)

        def dn(a):  # row k <- row k-1
            return jnp.roll(a, 1, axis=0)

        e_own = jax.vmap(energy_one)(states.x, states.box, states.extra,
                                     globalss)
        # U_k(x_{k+1}): my λ at the upper neighbor's configuration (and its
        # matching neighbor-list extras)
        e_up = jax.vmap(energy_one)(
            up(states.x), up(states.box), jax.tree.map(up, states.extra),
            globalss,
        )
        # U_k(x_{k-1})
        e_dn = jax.vmap(energy_one)(
            dn(states.x), dn(states.box), jax.tree.map(dn, states.extra),
            globalss,
        )
        delta = beta * (e_up - e_own) + up(beta * (e_dn - e_own))
        eligible = (idx % 2 == parity) & (idx < k_states - 1)
        r = jax.random.uniform(key, (k_states,))
        accept = eligible & (jnp.log(r) < -delta)
        acc_prev = jnp.concatenate([jnp.zeros((1,), bool), accept[:-1]])
        perm = idx + accept.astype(idx.dtype) - acc_prev.astype(idx.dtype)

        def take(a):
            return jnp.take(a, perm, axis=0)

        v_new = take(states.v)
        if temperature.ndim:  # T ladder: rescale v to the new row's T
            t_arr = jnp.asarray(temperature, states.v.dtype)
            scale = jnp.sqrt(t_arr / jnp.take(t_arr, perm))
            v_new = v_new * scale[:, None, None]
        new_extra = {
            k: (take(v) if k.startswith(_CONFIG_PREFIXES) else v)
            for k, v in states.extra.items()
        }
        states = replace(states, x=take(states.x), v=v_new,
                         box=take(states.box), extra=new_extra)
        return states, accept.sum(), eligible.sum()

    return swap


def make_replica_run(system_template, integrator, update_every: int = 1):
    """run(system, states, globalss, n): advance every replica n steps with
    its OWN globals row — the replica analog of Context._make_run (chunk-
    start neighbor update + force-cache refresh, then a device-side
    fori_loop).

    update_every > 1 groups neighbor rebuilds like
    Context(neighbor_update_every=K): K steps, one rebuild, with the sticky
    per-step staleness bound sampled after EVERY step (same guard as
    context.py — a transient skin excursion mid-group must not escape).
    The rebuild is the dominant per-step cost for small replicas, so this
    is the main single-chip HREX throughput lever; HREXSampler.run raises
    on a tripped flag."""
    from ..context import refresh_force_caches
    from ..forces import _spread_layouts

    step_fn = integrator.make_step()
    has_neighbors = system_template.neighbors is not None
    has_spread_buckets = bool(_spread_layouts(system_template))
    k_update = max(int(update_every), 1)

    def maybe_update(system, s, force: bool = False):
        if has_neighbors:
            from ..ops.neighbors import update_all_neighbors

            s = s.with_extra(
                **update_all_neighbors(system, s.extra, s.x, s.box,
                                       force=force)
            )
        if has_spread_buckets:
            # amortized PME spreading buckets (forces.update_pme_spread);
            # the cond rebuild + drift guard run per replica under the vmap
            from ..forces import update_pme_spread

            s = s.with_extra(
                **update_pme_spread(system, s.extra, s.x, s.box,
                                    force=force)
            )
        return s

    def run(system, states, globalss, n):
        def one(s, g):
            s = maybe_update(system, s)
            s = refresh_force_caches(system, s, g)

            if k_update == 1 or (not has_neighbors
                                 and not has_spread_buckets):
                def body(i, s):
                    return maybe_update(system, step_fn(system, s, g))

                return jax.lax.fori_loop(0, n, body, s)

            from ..ops.neighbors import staleness_flags

            def body_k(i, s):
                for _ in range(k_update):
                    s = step_fn(system, s, g)
                    s = s.with_extra(
                        **staleness_flags(system, s.extra, s.x, s.box))
                    if has_spread_buckets:
                        from ..forces import pme_spread_stale_flags

                        s = s.with_extra(**pme_spread_stale_flags(
                            system, s.extra, s.x, s.box))
                # forced boundary rebuild — see ops.neighbors
                # .update_neighbors: the conditional skin/2 trigger races
                # the d1+d2 staleness bound in grouped mode
                return maybe_update(system, s, force=True)

            s = jax.lax.fori_loop(0, n // k_update, body_k, s)

            def body_1(i, s):
                return maybe_update(system, step_fn(system, s, g))

            return jax.lax.fori_loop(0, n - (n // k_update) * k_update,
                                     body_1, s)

        return jax.vmap(one)(states, globalss)

    return run


class HREXSampler:
    """K λ-states stepping as a replica batch with periodic exchange moves.

    lambdas: dict name -> (K,) per-state values. mesh: optional Mesh whose
    first axis shards the replica batch (None = single-device vmap batch).
    """

    def __init__(self, system, x0, box, lambdas: Dict[str, jnp.ndarray],
                 temperature, mesh: Optional[Mesh] = None, axis: str = "dp",
                 dt=0.001, friction=5.0, seed: int = 0,
                 temperatures=None, neighbor_update_every: int = 1):
        """temperatures: optional (K,) ladder for temperature-REMD — each
        replica's OU bath reads its own setpoint from the traced globals
        row ('bath_T'), and swaps use the per-row β criterion with
        sqrt(T_new/T_old) velocity rescaling. lambdas may be {} for pure
        T-REMD (one Hamiltonian, many temperatures).

        neighbor_update_every: group neighbor rebuilds every K steps (the
        Context(neighbor_update_every=...) analog; guarded by the same
        per-step sticky staleness bound, which run() checks)."""
        from ..integrate.integrators import GlobalThermostatIntegrator
        from ..integrate.propagators import (
            OrnsteinUhlenbeckPropagator,
            VelocityVerletPropagator,
        )

        self.system = system
        self.temperature = float(temperature)
        self.lambdas = {k: jnp.asarray(v) for k, v in lambdas.items()}
        self.temperatures = (None if temperatures is None
                             else jnp.asarray(temperatures))
        if self.lambdas:
            self.k_states = len(next(iter(self.lambdas.values())))
        else:
            self.k_states = len(self.temperatures)
        self.mesh, self.axis = mesh, axis
        integ = GlobalThermostatIntegrator(
            dt,
            VelocityVerletPropagator(),
            OrnsteinUhlenbeckPropagator(
                self.temperature, friction,
                temperature_global=("bath_T" if temperatures is not None
                                    else None),
            ),
        )

        self.neighbor_update_every = max(int(neighbor_update_every), 1)
        state = make_state(x0, box=box, seed=seed)
        if system.neighbors is not None:
            from ..ops.neighbors import all_neighbor_extras, iter_specs

            state = state.with_extra(
                **all_neighbor_extras(system, state.x, state.box))
            if self.neighbor_update_every > 1:
                # seed the sticky staleness flags so the run() input pytree
                # structure is stable from the first call (context.py does
                # the same)
                state = state.with_extra(**{
                    ("nbr_stale" if name == "default"
                     else f"nbr_{name}_stale"): jnp.zeros((), bool)
                    for name, _ in iter_specs(system)
                })
        from ..forces import _spread_layouts, pme_spread_extras

        if _spread_layouts(system):
            state = state.with_extra(
                **pme_spread_extras(system, state.x, state.box))
        state = integ.initialize(system, state)
        states = replicate_state(state, self.k_states, seed)
        # independent Maxwell-Boltzmann draw PER REPLICA — a tiled single
        # draw starts the ladder perfectly correlated, so short n_equil
        # runs understate cross-replica statistical error
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), self.k_states)
        v_rows = jax.vmap(lambda k: maxwell_boltzmann_velocities(
            k, system.masses, self.temperature, x0.dtype))(keys)
        if self.temperatures is not None:  # per-row Maxwell temperature
            scale = jnp.sqrt(self.temperatures / self.temperature)
            v_rows = v_rows * scale[:, None, None].astype(v_rows.dtype)
        if system.virtual_sites is not None:
            # dummy-mass rows carry no momentum (Context's
            # set_velocities_to_temperature does the same)
            from ..ops.virtual_sites import zero_virtual_velocities

            v_rows = jax.vmap(
                lambda v: zero_virtual_velocities(system.virtual_sites, v)
            )(v_rows)
        states = replace(states, v=v_rows)
        self.states = self._shard(states)
        self._run = jax.jit(make_replica_run(
            system, integ, update_every=self.neighbor_update_every))
        self._swap = jax.jit(make_hrex_swap(
            system,
            self.temperature if temperatures is None else self.temperatures,
        ))
        self._key = jax.random.PRNGKey(seed + 2)
        self._last_globalss = None
        self._parity = 0
        self.swap_attempts = 0
        self.swap_accepts = 0

    def _shard(self, tree):
        if self.mesh is None:
            return tree
        sh = NamedSharding(self.mesh, P(self.axis))
        return jax.tree.map(lambda a: jax.device_put(a, sh), tree)

    def _globals(self, values: Dict[str, jnp.ndarray]):
        g = dict(values)
        if self.temperatures is not None:
            g.setdefault("bath_T", self.temperatures)
        return self._shard(g)

    def run(self, n_steps: int, globalss=None):
        g = self._globals(globalss if globalss is not None else self.lambdas)
        self._last_globalss = g
        self.states = self._run(self.system, self.states, g, n_steps)
        if self.system.neighbors is not None:
            # replicas run without Context's overflow auto-recovery: check
            # the sticky flags so a busted cell capacity raises instead of
            # silently dropping pairs in some replica
            for key, flag in self.states.extra.items():
                if not key.startswith("nbr"):
                    continue
                if key.endswith("overflow") and bool(jnp.any(flag)):
                    raise RuntimeError(
                        f"cell-list capacity overflow in a replica ({key}): "
                        "retune the NeighborSpec capacities (e.g. "
                        "retune_neighbor_specs on an equilibrated "
                        "configuration) before HREX sampling"
                    )
                if key.endswith("stale") and bool(jnp.any(flag)):
                    raise RuntimeError(
                        f"neighbor staleness in a replica ({key}): an atom "
                        "moved beyond the full skin between grouped "
                        "neighbor updates — reduce neighbor_update_every "
                        "or enlarge the skin"
                    )
        for key, flag in self.states.extra.items():
            if (key.startswith("pme") and (key.endswith("spread_overflow")
                                           or key.endswith("spread_stale"))
                    and bool(jnp.any(flag))):
                raise RuntimeError(
                    f"PME spreading-bucket flag in a replica ({key}): "
                    "rebuild with a larger retune_pme_spread safety/pad "
                    "or reduce neighbor_update_every"
                )

    def anneal(self, n_steps: int, chunks: int = 8):
        """Gentle decoupling: every replica starts at the COUPLED λ (the
        last ladder row — the condensed-phase structure the sequential path
        inherits by visiting states coupled-end first) and interpolates to
        its own target over `chunks` chunks."""
        target = self.lambdas
        coupled = {k: jnp.full((self.k_states,), v[-1]) for k, v in
                   target.items()}
        per = max(n_steps // chunks, 1)
        for c in range(chunks):
            t = (c + 1) / chunks
            g = {k: (1.0 - t) * coupled[k] + t * target[k] for k in target}
            self.run(per, g)

    def attempt_swaps(self):
        # Detailed balance: the Metropolis criterion below evaluates U at
        # the LADDER globals, which is only valid if the replicas were last
        # propagated under those same globals. Refuse a swap mid-anneal (or
        # after a custom-globals run) instead of silently biasing the
        # ensemble.
        if self._last_globalss is not None:
            target = self._globals(self.lambdas)
            for k, v in target.items():
                last = self._last_globalss.get(k)
                if last is None or not np.allclose(np.asarray(last),
                                                   np.asarray(v)):
                    raise RuntimeError(
                        f"attempt_swaps: replicas were last propagated "
                        f"under globals[{k!r}] != the ladder values; "
                        "finish the anneal (or re-run at the ladder) "
                        "before exchanging, or the acceptance test biases "
                        "the sampled ensemble")
        self._key, sub = jax.random.split(self._key)
        self.states, acc, att = self._swap(
            self.states, self._globals(self.lambdas), sub, self._parity)
        self._parity ^= 1
        self.swap_attempts += int(att)
        self.swap_accepts += int(acc)

    @property
    def acceptance_rate(self):
        return (self.swap_accepts / self.swap_attempts
                if self.swap_attempts else float("nan"))

    def positions(self):
        return np.asarray(self.states.x)  # (K, N, 3)


def hrex_sample_lambda_states(system, x0, box, lambdas, temperature,
                              mesh: Optional[Mesh] = None, dt=0.001,
                              friction=5.0, n_equil=200, n_samples=20,
                              sample_interval=25, swap_every=1, seed=0,
                              neighbor_update_every: int = 1):
    """Drop-in replica-parallel replacement for
    alchemy.sample_lambda_states: same (xs, n_k) contract (samples ordered
    by state index), K-fold fewer sequential MD steps, plus HREX mixing.

    swap_every: attempt neighbor swaps every `swap_every` sampling chunks
    (0 disables exchange — pure parallel sampling). Returns (xs, n_k, info)
    with info carrying the swap acceptance statistics.
    """
    sampler = HREXSampler(system, x0, box, lambdas, temperature, mesh=mesh,
                          dt=dt, friction=friction, seed=seed,
                          neighbor_update_every=neighbor_update_every)
    # melt at the coupled state, then anneal each replica to its own λ
    sampler.run(2 * n_equil, {
        k: jnp.full((sampler.k_states,), v[-1])
        for k, v in sampler.lambdas.items()
    })
    sampler.anneal(n_equil)
    sampler.run(n_equil)
    if swap_every:
        sampler.attempt_swaps()
    samples = []
    for s in range(n_samples):
        sampler.run(sample_interval)
        if swap_every and (s + 1) % swap_every == 0:
            sampler.attempt_swaps()
        samples.append(sampler.positions())  # (K, N, 3)
    stacked = np.stack(samples)  # (S, K, N, 3)
    xs = jnp.asarray(np.concatenate(
        [stacked[:, k] for k in range(sampler.k_states)]))
    n_k = jnp.full((sampler.k_states,), n_samples, jnp.int32)
    info = {
        "swap_attempts": sampler.swap_attempts,
        "swap_accepts": sampler.swap_accepts,
        "acceptance": sampler.acceptance_rate,
    }
    return xs, n_k, info
