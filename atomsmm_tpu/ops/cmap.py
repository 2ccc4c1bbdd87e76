"""CMAP cross-term correction (CHARMM's 2-D dihedral-dihedral grids).

A CMAP term couples two consecutive backbone dihedrals phi = (i,j,k,l) and
psi = (j,k,l,m) through a periodic 2-D correction surface tabulated on an
n x n grid over [-180, 180)^2 (n = 24 for the CHARMM36 tables). The
evaluation is a C1 periodic bicubic patch: grid-value AND derivative
tables are precomputed host-side by fitting C2 periodic cubic splines
along each row/column and taking their knot derivatives — the same
construction OpenMM's CMAPTorsionForceImpl uses on raw CHARMM grids
(centered differences, the earlier build here, systematically deviate
from the spline interpolant wherever the surface curves). The per-term
evaluation is four corner gathers + the classic 16-coefficient bicubic,
vectorized over all terms. Forces come from jax.grad straight through
the gathers and polynomials.

Examples — a separable analytic surface is reproduced by its sampled
bicubic to interpolation accuracy:

>>> import numpy as np
>>> import jax.numpy as jnp
>>> res = 24
>>> ang = -np.pi + 2 * np.pi * np.arange(res) / res
>>> grid = np.cos(ang)[:, None] + np.sin(ang)[None, :]   # f(phi, psi)
>>> table = build_cmap_table(grid[None])                  # (1, res, res, 4)
>>> phi, psi = jnp.asarray([0.7]), jnp.asarray([-1.9])
>>> e = cmap_interpolate(table, jnp.asarray([0]), phi, psi)
>>> bool(abs(float(e[0]) - (np.cos(0.7) + np.sin(-1.9))) < 1e-3)
True
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .bonded import dihedral_angle

# the classic bicubic coefficient matrix: coeff = A @ F @ A.T with
# F = [[f00, f01, fy00, fy01], [f10, f11, fy10, fy11],
#      [fx00, fx01, fxy00, fxy01], [fx10, fx11, fxy10, fxy11]]
_A = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [-3.0, 3.0, -2.0, -1.0],
    [2.0, -2.0, 1.0, 1.0],
])


def _periodic_spline_derivatives(y, axis) -> np.ndarray:
    """Knot derivatives of the C2 periodic cubic spline through `y` along
    `axis` (unit knot spacing): the cyclic tridiagonal system

        m_{i-1} + 4 m_i + m_{i+1} = 3 (y_{i+1} - y_{i-1})

    solved densely (n is 24 for CHARMM grids; the matrix is strictly
    diagonally dominant, so a direct inverse is exact and stable)."""
    n = y.shape[axis]
    m = 4.0 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
    m[0, -1] = m[-1, 0] = 1.0  # periodic wrap
    rhs = 3.0 * (np.roll(y, -1, axis) - np.roll(y, 1, axis))
    moved = np.moveaxis(rhs, axis, -1)
    sol = moved @ np.linalg.inv(m)  # m symmetric: solves m x = b rowwise
    return np.moveaxis(sol, -1, axis)


def build_cmap_table(grids) -> np.ndarray:
    """(T, n, n) value grids -> (T, n, n, 4) [f, df/dphi, df/dpsi, d2f]
    with derivatives in GRID units (per cell) from periodic cubic-spline
    fits along each axis (cross term: psi-splines of the phi-derivative
    grid, OpenMM's construction) — host-side, once per topology."""
    g = np.asarray(grids, np.float64)
    gp = _periodic_spline_derivatives(g, axis=1)
    gq = _periodic_spline_derivatives(g, axis=2)
    gpq = _periodic_spline_derivatives(gp, axis=2)
    return np.stack([g, gp, gq, gpq], axis=-1)


def cmap_interpolate(table, type_index, phi, psi):
    """Bicubic surface value per term; phi/psi in radians, table from
    build_cmap_table (jnp or np). Periodic in both axes."""
    table = jnp.asarray(table)
    n = table.shape[1]
    dtype = phi.dtype

    def cell(angle):
        u = (angle + jnp.pi) * (n / (2.0 * jnp.pi))
        i0 = jnp.floor(u)
        t = (u - i0).astype(dtype)
        i0 = jnp.mod(i0.astype(jnp.int32), n)
        return i0, jnp.mod(i0 + 1, n), t

    i0, i1, t = cell(phi)
    j0, j1, s = cell(psi)

    def corner(ii, jj):
        return table[type_index, ii, jj]  # (C, 4): f, fp, fq, fpq

    c00, c01 = corner(i0, j0), corner(i0, j1)
    c10, c11 = corner(i1, j0), corner(i1, j1)
    # assemble F per term: rows (f, fx), cols (f, fy) blocks
    f_mat = jnp.stack([
        jnp.stack([c00[:, 0], c01[:, 0], c00[:, 2], c01[:, 2]], -1),
        jnp.stack([c10[:, 0], c11[:, 0], c10[:, 2], c11[:, 2]], -1),
        jnp.stack([c00[:, 1], c01[:, 1], c00[:, 3], c01[:, 3]], -1),
        jnp.stack([c10[:, 1], c11[:, 1], c10[:, 3], c11[:, 3]], -1),
    ], -2)  # (C, 4, 4)
    a = jnp.asarray(_A, dtype)
    # HIGHEST: the GPU default would run these f32 contractions in TF32
    hi = jax.lax.Precision.HIGHEST
    coeff = jnp.einsum("ij,cjk,lk->cil", a, f_mat.astype(dtype), a,
                       precision=hi)
    tv = jnp.stack([jnp.ones_like(t), t, t * t, t * t * t], -1)
    sv = jnp.stack([jnp.ones_like(s), s, s * s, s * s * s], -1)
    return jnp.einsum("ci,cij,cj->c", tv, coeff, sv, precision=hi)


def cmap_energy(x, idx5, type_index, table):
    """Total CMAP energy: idx5 (C, 5) atoms (i,j,k,l,m) — phi on the first
    four, psi on the last four; table (T, n, n, 4) [kJ/mol]."""
    phi = dihedral_angle(x, idx5[:, :4])
    psi = dihedral_angle(x, idx5[:, 1:])
    return jnp.sum(cmap_interpolate(table, type_index, phi, psi))
