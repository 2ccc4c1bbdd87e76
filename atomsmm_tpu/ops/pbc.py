"""Periodic boundary helpers (orthorhombic and reduced triclinic boxes).

Box representation is shape-polymorphic, resolved at trace time:

* ``(3,)``  — orthorhombic edge lengths; minimum image is the branch-free
  ``dx - box*round(dx/box)`` form that XLA fuses into the pair kernels.
* ``(3, 3)`` — triclinic cell matrix H, rows = lattice vectors (a, b, c) in
  OpenMM reduced form (a along x, b in the xy plane, off-diagonal elements
  at most half the corresponding diagonal). Minimum image maps through
  fractional coordinates: s = dx @ inv(H); s -= round(s); dx = s @ H —
  exact for reduced cells whenever the cutoff is at most half the smallest
  perpendicular width (``max_cutoff``).

Every subsystem accepts both forms: the dense pair path, bonded terms, PME,
virials, the MC barostat, and (since r4) the production cell-list path —
make_neighbor_spec sizes the grid/stencil from PERPENDICULAR widths,
build_cell_buckets bins in fractional coordinates, and the pair sweep's
displacements go through this module's triclinic minimum image.

Examples:

>>> import jax.numpy as jnp
>>> box = jnp.asarray([2.0, 2.0, 2.0])
>>> [round(v, 6) for v in minimum_image(jnp.asarray([1.9, -1.9, 0.4]), box).tolist()]
[-0.1, 0.1, 0.4]
>>> float(minimum_image(jnp.asarray([1.0, 0.0, 0.0]), box)[0])  # half-box edge
1.0

A sheared cell that generates the SAME lattice as the cube above (b -> a+b)
produces identical minimum images:

>>> h = jnp.asarray([[2.0, 0.0, 0.0], [2.0, 2.0, 0.0], [0.0, 0.0, 2.0]])
>>> [round(v, 6) for v in minimum_image(jnp.asarray([1.9, -1.9, 0.4]), h).tolist()]
[-0.1, 0.1, 0.4]
>>> float(box_volume(box)), float(box_volume(h))
(8.0, 8.0)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def cell_matrix(box: jnp.ndarray) -> jnp.ndarray:
    """(3, 3) cell matrix H (rows = lattice vectors) for either box form."""
    box = jnp.asarray(box)
    return jnp.diag(box) if box.ndim == 1 else box


def box_volume(box: jnp.ndarray) -> jnp.ndarray:
    """Cell volume [nm^3] for either box form."""
    box = jnp.asarray(box)
    if box.ndim == 1:
        return jnp.prod(box)
    return jnp.abs(jnp.linalg.det(box))


def is_triclinic(box) -> bool:
    """Trace-time box-form test (shape is static under jit)."""
    return jnp.asarray(box).ndim == 2


def minimum_image(dx: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Minimum-image displacement; dx (..., 3), box (3,) or (3, 3).

    Orthorhombic: multiplies by the (3,)-vector reciprocal instead of
    dividing elementwise — the reciprocal is hoisted out of the pair tile,
    the per-slot op is a mul. Triclinic: round in fractional coordinates
    (inv(H) is loop-invariant; XLA hoists it). The (..., 3) x (3, 3)
    matmuls pin Precision.HIGHEST: a GPU's default f32 matmul rounds its
    INPUTS to TF32 (10-bit mantissa, rel ~1e-3) — displacements through a
    TF32 matmul would corrupt every triclinic pair force; these
    contractions are tiny, so full precision costs nothing.
    """
    box = jnp.asarray(box)
    if box.ndim == 1:
        return dx - box * jnp.round(dx * (1.0 / box))
    inv_h = jnp.linalg.inv(box)
    s = jnp.matmul(dx, inv_h, precision=jax.lax.Precision.HIGHEST)
    return dx - jnp.matmul(jnp.round(s), box,
                           precision=jax.lax.Precision.HIGHEST)


def wrap_positions(x: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Wrap positions into the primary cell (full-precision matmuls on the
    triclinic path — see minimum_image)."""
    box = jnp.asarray(box)
    if box.ndim == 1:
        return x - box * jnp.floor(x / box)
    inv_h = jnp.linalg.inv(box)
    s = jnp.matmul(x, inv_h, precision=jax.lax.Precision.HIGHEST)
    return x - jnp.matmul(jnp.floor(s), box,
                          precision=jax.lax.Precision.HIGHEST)


def pair_displacement(xi: jnp.ndarray, xj: jnp.ndarray, box: jnp.ndarray):
    """Minimum-image displacement xi - xj, any broadcastable shapes (...,3)."""
    return minimum_image(xi - xj, box)


def perp_widths(box) -> jnp.ndarray:
    """(3,) perpendicular widths of the cell along each lattice direction
    (traced; either box form). For a vector box these ARE the edge lengths;
    for a matrix box, d_i = V / |a_j x a_k| — the distance between the two
    cell faces spanned by the other two lattice vectors. Cell-list sizing
    and coverage guards must use these, not edge lengths: a sheared cell's
    perpendicular widths are smaller than its edges."""
    box = jnp.asarray(box)
    if box.ndim == 1:
        return box
    vol = jnp.abs(jnp.linalg.det(box))
    areas = jnp.stack([
        jnp.linalg.norm(jnp.cross(box[1], box[2])),
        jnp.linalg.norm(jnp.cross(box[2], box[0])),
        jnp.linalg.norm(jnp.cross(box[0], box[1])),
    ])
    return vol / areas


def max_cutoff(box) -> float:
    """Largest cutoff the minimum-image convention supports: half the
    smallest perpendicular width of the cell (host-side helper)."""
    import numpy as np

    h = np.asarray(cell_matrix(jnp.asarray(box)))
    vol = abs(np.linalg.det(h))
    widths = [
        vol / np.linalg.norm(np.cross(h[(i + 1) % 3], h[(i + 2) % 3]))
        for i in range(3)
    ]
    return 0.5 * float(min(widths))


def validate_cutoffs(system, box) -> None:
    """Enforce the minimum-image validity bound r_cut <= max_cutoff(box).

    Skewed cells have perpendicular widths much smaller than their edge
    lengths, so a cutoff that looks safe by edge length can silently return
    non-minimum images (wrong/missed pair interactions — ADVICE r3). Checked
    at Context construction, where the concrete box first meets the forces.
    """
    import numpy as np

    from ..utils import InputError

    bound = max_cutoff(box)
    seen = []

    def visit(f):
        if getattr(f, "method", None) == "nocutoff":
            return
        rc = getattr(f, "r_cut", None)
        if rc is not None:
            try:
                seen.append((type(f).__name__, float(rc)))
            except (TypeError, ValueError):
                pass  # traced/symbolic cutoff: caller's responsibility
        inner = getattr(f, "full", None)
        if inner is not None:
            visit(inner)

    for f in getattr(system, "forces", ()):
        visit(f)
    for name, rc in seen:
        if np.isfinite(rc) and rc > bound + 1e-9:
            raise InputError(
                f"{name}.r_cut = {rc:.4f} nm exceeds the minimum-image bound "
                f"max_cutoff(box) = {bound:.4f} nm (half the smallest "
                f"perpendicular width of the cell); shrink the cutoff or "
                f"use a larger box"
            )


def triclinic_from_lengths_angles(a, b, c, alpha, beta, gamma):
    """Reduced (3, 3) cell matrix from lengths [nm] and angles [degrees]
    (the CRYST1 / AMBER box convention; a along x, b in the xy plane)."""
    import numpy as np

    al, be, ga = (np.radians(v) for v in (alpha, beta, gamma))
    bx, by = b * np.cos(ga), b * np.sin(ga)
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    h = np.array([[a, 0.0, 0.0], [bx, by, 0.0], [cx, cy, cz]])
    h[np.abs(h) < 1e-12] = 0.0
    return h
