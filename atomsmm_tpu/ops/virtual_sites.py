"""Virtual sites (massless interaction sites) — TIP4P/TIP5P-style extra
points (OpenMM-substrate capability; SURVEY.md §2b, VERDICT r3 missing #5).

OpenMM reconstructs virtual-site positions in C++ before every force
evaluation and redistributes their forces onto the parent atoms by the
chain rule. The formulation here is a COORDINATE TRANSFORMATION:
the potential is evaluated at `place_virtual_sites(x)` (virtual rows
replaced by their construction from parents), so

  * autodiff forces flow through the placement automatically — the
    chain-rule force redistribution IS the vjp of the placement, exact
    for every site type with no hand-written redistribution code;
  * the gradient w.r.t. a virtual row is identically zero (the placed
    value does not depend on it), so virtual sites never receive kicks.

One parametrization covers all three OpenMM site types:

    x_v = w1 p1 + w2 p2 + w3 p3 + oop * ((p2 - p1) x (p3 - p1))

  TwoParticleAverage:   w3 = 0, oop = 0
  ThreeParticleAverage: oop = 0            (TIP4P's M site)
  OutOfPlane:           any w, oop != 0    (TIP5P's lone pairs)

Virtual sites carry a positive DUMMY mass (builders use 1 amu): their
forces are exactly zero after the pullback, their velocities are pinned
to zero by the velocity projection (propagators._project_velocities), and
they contribute no degrees of freedom (utils.count_degrees_of_freedom).

Examples — a TIP4P-like M site 0.015 nm from O along the HOH bisector:

>>> import numpy as np
>>> import jax.numpy as jnp
>>> r_oh, theta, d_om = 0.09572, 1.82421813, 0.015
>>> x = jnp.asarray([[0.0, 0.0, 0.0],
...                  [ r_oh * np.sin(theta / 2), r_oh * np.cos(theta / 2), 0.0],
...                  [-r_oh * np.sin(theta / 2), r_oh * np.cos(theta / 2), 0.0],
...                  [99.0, 99.0, 99.0]])      # garbage M row — replaced
>>> c = d_om / (2 * r_oh * np.cos(theta / 2))
>>> vs = VirtualSiteSet(
...     sites=jnp.asarray([3]),
...     parents=jnp.asarray([[0, 1, 2]]),
...     weights=jnp.asarray([[1.0 - 2 * c, c, c]]),
...     oop=jnp.zeros(1),
... )
>>> xp = place_virtual_sites(vs, x)
>>> bool(jnp.allclose(jnp.linalg.norm(xp[3] - xp[0]), d_om, atol=1e-12))
True
>>> bool(jnp.allclose(xp[3][0], 0.0, atol=1e-12))   # on the bisector
True
>>> bool(jnp.allclose(xp[:3], x[:3]))               # parents untouched
True
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree_dataclass


@pytree_dataclass
class VirtualSiteSet:
    """sites (V,) int32 — virtual atom indices; parents (V, 3) int32;
    weights (V, 3) linear coefficients; oop (V,) out-of-plane coefficient
    [1/nm] multiplying (p2-p1) x (p3-p1)."""

    sites: jnp.ndarray = None
    parents: jnp.ndarray = None
    weights: jnp.ndarray = None
    oop: jnp.ndarray = None

    @property
    def size(self) -> int:
        return 0 if self.sites is None else self.sites.shape[0]


def validate_virtual_sites(vs: VirtualSiteSet):
    """Host-side construction check: placement is a SINGLE gather-and-set
    pass over the original coordinates, so a virtual site whose parent is
    itself a virtual site (legal in OpenMM, which places sites in
    dependency order) would silently read the stale stored row. Reject
    chained sites loudly; also reject duplicate site rows.

    Returns vs unchanged, for builder call-through.
    """
    import numpy as np

    from ..utils import InputError

    if vs is None or vs.size == 0:
        return vs
    sites = np.asarray(vs.sites)
    if len(np.unique(sites)) != len(sites):
        raise InputError("duplicate virtual-site indices")
    chained = np.intersect1d(sites, np.asarray(vs.parents).ravel())
    if chained.size:
        raise InputError(
            f"virtual sites {chained.tolist()} are parents of other virtual "
            "sites; chained (dependent) virtual sites are not supported by "
            "the single-pass placement — express the dependent site "
            "directly in terms of real atoms")
    return vs


def place_virtual_sites(vs: VirtualSiteSet, x):
    """x with every virtual-site row replaced by its construction."""
    p1 = x[vs.parents[:, 0]]
    p2 = x[vs.parents[:, 1]]
    p3 = x[vs.parents[:, 2]]
    w = vs.weights
    pos = w[:, 0:1] * p1 + w[:, 1:2] * p2 + w[:, 2:3] * p3
    pos = pos + vs.oop[:, None] * jnp.cross(p2 - p1, p3 - p1)
    return x.at[vs.sites].set(pos)


def zero_virtual_velocities(vs: VirtualSiteSet, v):
    """Pin virtual-site velocity rows to zero (they carry a dummy mass and
    receive no kicks; stochastic baths must not give them noise)."""
    return v.at[vs.sites].set(0.0)
