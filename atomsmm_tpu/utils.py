"""Shared helpers (counterpart of atomsmm/utils.py — see SURVEY.md §2a).

The reference exposes `InputError`, `countDegreesOfFreedom`, `findNonbondedForce`,
`hijackForce`, and `splitPotentialEnergy` (atomsmm/utils.py). Here the energy
splitting lives in `atomsmm_tpu.potential.split_potential_energy`; this module
holds the small pure-Python utilities plus the pytree-dataclass helper used by
the whole package.

Examples:

>>> from atomsmm_tpu.models import water_system
>>> system, x, box = water_system(n_molecules=8, r_cut=0.3, r_switch=0.25)
>>> count_degrees_of_freedom(system)   # 3N - 3 (COM motion removed)
69
>>> find_nonbonded_force(system)       # index of the NonbondedForce
0
>>> from atomsmm_tpu.models import rigid_water_system
>>> rigid, _, _ = rigid_water_system(n_molecules=8, r_cut=0.3, r_switch=0.25)
>>> count_degrees_of_freedom(rigid)    # 3N - 3 constraints/molecule - 3
45
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import jax


class InputError(Exception):
    """Invalid user input (mirror of atomsmm/utils.py::InputError)."""

    def __init__(self, msg: str):
        super().__init__(msg)


def pytree_dataclass(cls=None, *, frozen: bool = False):
    """Decorator: dataclass registered as a JAX pytree.

    Fields with ``metadata={'static': True}`` become aux (meta) fields — they
    must be hashable and participate in jit caching; all other fields are
    pytree children (arrays / nested pytrees).
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=frozen)(c)
        data_fields = []
        meta_fields = []
        for f in dataclasses.fields(c):
            if f.metadata.get("static", False):
                meta_fields.append(f.name)
            else:
                data_fields.append(f.name)
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=meta_fields
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def static_field(**kwargs):
    """A dataclass field treated as static (aux) pytree metadata."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def replace(obj, **changes):
    """dataclasses.replace that works through the pytree dataclasses."""
    return dataclasses.replace(obj, **changes)


def count_degrees_of_freedom(system) -> int:
    """Number of kinetic degrees of freedom (atomsmm/utils.py::countDegreesOfFreedom).

    3*N minus 3 if center-of-mass motion is removed, minus constraints,
    minus 3 per virtual site (massless interaction points carry no kinetic
    degrees of freedom — their velocities are pinned to zero)."""
    n = system.num_particles
    dof = 3 * n - system.num_constraints
    vs = getattr(system, "virtual_sites", None)
    if vs is not None:
        dof -= 3 * vs.size
    if getattr(system, "remove_com_motion", True):
        dof -= 3
    return dof


def find_nonbonded_force(system, position: int = 0):
    """Index of the (position-th) NonbondedForce in the system
    (atomsmm/utils.py::findNonbondedForce)."""
    from .forces import NonbondedForce

    hits = [i for i, f in enumerate(system.forces) if type(f) is NonbondedForce]
    if len(hits) <= position:
        raise InputError("system does not contain the requested NonbondedForce")
    return hits[position]


def hijack_force(system, index: int):
    """Detach and return the force at `index` (atomsmm/utils.py::hijackForce).

    Returns (force, new_system) — systems are immutable pytrees here, so unlike
    the reference this does not mutate in place.
    """
    force = system.forces[index]
    new_forces = tuple(f for i, f in enumerate(system.forces) if i != index)
    new_system = replace(system, forces=new_forces)
    return force, new_system


CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache(root: str = CHECKOUT) -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and
    nothing is set here. Otherwise the cache lives at ``<root>/.jax_cache``
    (the checkout by default): a fixed path, since the path is part of
    what makes a later process find an entry again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
