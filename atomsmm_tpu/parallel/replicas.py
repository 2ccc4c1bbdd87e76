"""Data-parallel replicated simulation boxes across a device mesh.

The reference has no distributed execution at all (SURVEY.md §2c); this
build's first-class parallel axis is replicated multi-box throughput
(BASELINE.md config 5): independent replicas sharded over a `jax.sharding.Mesh`
via shard_map, stepping in lockstep with zero per-step communication (MD, not
training — no gradient sync). Cross-replica reductions (replica-exchange
acceptance, ensemble averages) ride the interconnect via psum/pmax when needed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..state import State


def replicate_state(state: State, n: int, seed: int = 0) -> State:
    """Stack n copies of a state along a leading replica axis, with distinct
    RNG keys per replica."""
    stacked = jax.tree.map(lambda x: jnp.stack([x] * n), state)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        state.rng, jnp.arange(n, dtype=jnp.uint32)
    )
    from ..utils import replace

    return replace(stacked, rng=keys)


def make_replicated_step(step_fn, mesh: Mesh, axis: str = "dp"):
    """Wrap a single-box step (system, state, globals) -> state into a
    replica-sharded step over `mesh`: states carry a leading replica axis
    sharded along `axis`; the system and globals are replicated."""

    def local(system, states, globals):
        return jax.vmap(lambda s: step_fn(system, s, globals))(states)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )
