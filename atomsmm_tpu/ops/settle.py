"""SETTLE — closed-form constraints for 3-site rigid molecules (water).

OpenMM (the reference's substrate) applies SETTLE to every 3-site rigid
water and falls back to iterative methods for general topologies
(SURVEY.md §2b N5); this module is the equivalent. The position
stage is the Miyamoto & Kollman (1992) geometric construction — an exact,
branch-free sequence of rotations, vectorized over all molecules at once
(one (M, ...) batch, no per-molecule loops, jit/scan friendly). The
velocity stage solves the 3-constraint RATTLE system EXACTLY with one
batched 3x3 adjugate solve — no memorized special-case coefficients, valid
for any triangle.

Compared with the Jacobi SHAKE path (ops/constraints.py, ~50-60 sweeps of
scatter-adds per innermost move), SETTLE is one shot and exact to machine
precision: both the geometry error and the per-step cost drop by orders of
magnitude, which is why every production MD engine special-cases water.

Eligibility (checked host-side in partition_constraints): molecules whose
three constraints form a triangle with an apex atom A and two symmetric
satellite atoms B, C — m_B == m_C and d_AB == d_AC (every rigid 3-site
water model). Anything else stays on SHAKE/RATTLE.

Examples — one TIP3P-like water, displaced then reset exactly:

>>> import numpy as np
>>> import jax.numpy as jnp
>>> masses = jnp.asarray([15.9994, 1.008, 1.008])
>>> ss = make_settle_set(np.array([[0, 1, 2]], np.int32),
...                      d_ab=0.09572, d_bc=0.15139, masses=masses)
>>> ra, rb, rc = float(ss.ra[0]), float(ss.rb[0]), float(ss.rc[0])
>>> x0 = jnp.asarray([[0.0, ra, 0.0],          # apex on the symmetry axis
...                   [-rc, -rb, 0.0], [rc, -rb, 0.0]])
>>> float(settle_residual(ss, x0)) < 1e-12     # on the manifold already
True
>>> x1 = x0 + 0.004 * jnp.asarray([[0.3, -1.0, 0.2],
...                                [-0.8, 0.5, -0.1], [0.6, 0.4, 0.9]])
>>> x = settle_positions(ss, x1, x0, masses)
>>> float(settle_residual(ss, x)) < 1e-12      # exact in ONE shot
True
>>> com1 = (masses[:, None] * x1).sum(0)       # COM is never moved
>>> com = (masses[:, None] * x).sum(0)
>>> bool(jnp.allclose(com, com1, atol=1e-15))
True
>>> v = jnp.asarray([[0.1, 0.4, -0.2], [1.5, -0.3, 0.8], [-0.9, 0.2, 0.1]])
>>> vv = settle_velocities(ss, x0, v, masses)
>>> r_ab = x0[0] - x0[1]                       # exact tangency after one solve
>>> bool(abs(jnp.dot(vv[0] - vv[1], r_ab)) < 1e-14)
True
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import pytree_dataclass


@pytree_dataclass
class SettleSet:
    """triplets (M, 3) int32 atom indices (apex A, satellites B, C);
    ra/rb/rc (M,) canonical-triangle geometry [nm]:
      ra — |A - COM| along the symmetry axis,
      rb — distance from the COM plane to the BC line,
      rc — half the B-C distance.
    """

    triplets: jnp.ndarray = None
    ra: jnp.ndarray = None
    rb: jnp.ndarray = None
    rc: jnp.ndarray = None

    @property
    def size(self) -> int:
        return 0 if self.triplets is None else self.triplets.shape[0]


def _settle_equal(a, b, rtol=1e-9):
    """Shared SETTLE-eligibility equality test (leg lengths, satellite
    masses). partition_constraints and make_settle_set must agree on it:
    a looser check in one used to accept groups the other rejected,
    turning a near-equal-mass topology into a hard ValueError instead of
    the documented SHAKE fallback."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(a),
                                                          np.abs(b))))


def make_settle_set(triplets, d_ab, d_bc, masses, dtype=None):
    """Geometry parameters from target distances (host-side).

    d_ab: apex-satellite distance (== d_ac); d_bc: satellite-satellite.
    Scalars or (M,) arrays. masses: full (N,) array — used for the
    mass-weighted apex/COM split m_A * ra == (m_B + m_C) * rb.
    """
    triplets = np.asarray(triplets, np.int32)
    m = triplets.shape[0]
    dtype = dtype or jnp.result_type(float)
    d_ab = np.broadcast_to(np.asarray(d_ab, np.float64), (m,))
    d_bc = np.broadcast_to(np.asarray(d_bc, np.float64), (m,))
    mass = np.asarray(masses, np.float64)
    ma = mass[triplets[:, 0]]
    mb = mass[triplets[:, 1]]
    mc = mass[triplets[:, 2]]
    if not _settle_equal(mb, mc):
        raise ValueError("SETTLE requires equal satellite masses (m_B == m_C)")
    rc = 0.5 * d_bc
    h2 = d_ab * d_ab - rc * rc
    if not np.all(h2 > 1e-6 * d_ab * d_ab):
        raise ValueError(
            "SETTLE requires a non-degenerate triangle (d_BC < 2 d_AB): a "
            "linear or impossible geometry has no apex height and would "
            "produce NaN dynamics")
    h = np.sqrt(h2)  # apex height above the BC line
    ra = (mb + mc) * h / (ma + mb + mc)
    rb = h - ra
    return SettleSet(
        triplets=jnp.asarray(triplets),
        ra=jnp.asarray(ra, dtype),
        rb=jnp.asarray(rb, dtype),
        rc=jnp.asarray(rc, dtype),
    )


def partition_constraints(cons, masses, rtol=1e-9):
    """Split a ConstraintSet into (SettleSet | None, ConstraintSet | None).

    Host-side (numpy) analysis, the analog of OpenMM's constraint
    classification at System creation: groups constraints by connected
    atoms; any group of exactly 3 constraints over 3 atoms forming an
    isoceles triangle (two equal distances from a common apex, equal
    satellite masses) becomes a SETTLE molecule; everything else stays
    iterative.
    """
    from .constraints import ConstraintSet

    if cons is None or cons.size == 0:
        return None, cons
    pairs = np.asarray(cons.pairs)
    d0 = np.asarray(cons.d0, np.float64)
    mass = np.asarray(masses, np.float64)

    # union-find over constrained atoms
    parent = {}

    def find(a):
        while parent.setdefault(a, a) != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in pairs:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[ri] = rj
    groups = {}
    for k, (i, j) in enumerate(pairs):
        groups.setdefault(find(int(i)), []).append(k)

    settle_rows, settle_dab, settle_dbc, rest = [], [], [], []
    for ks in groups.values():
        ok = False
        if len(ks) == 3:
            atoms = sorted({int(a) for k in ks for a in pairs[k]})
            if len(atoms) == 3:
                # distances keyed by the excluded atom (the one NOT in the
                # constraint) -> d[v] is the side opposite vertex v
                opp = {}
                for k in ks:
                    i, j = (int(a) for a in pairs[k])
                    (v,) = set(atoms) - {i, j}
                    opp[v] = d0[k]
                # a duplicated pair leaves opp short — not a triangle,
                # route to the iterative path instead of KeyError
                if len(opp) == 3:
                    for apex in atoms:
                        b, c = (a for a in atoms if a != apex)
                        d_ab, d_ac, d_bc = opp[c], opp[b], opp[apex]
                        # eligibility must imply a non-degenerate canonical
                        # triangle: equal apex legs, equal satellite masses
                        # (the same _settle_equal predicate make_settle_set
                        # asserts, so acceptance here never crashes there),
                        # and strictly positive apex height h — a linear
                        # arrangement (d_bc == 2 d_ab, e.g. constrained CO2)
                        # gives h = 0 and NaN dynamics, d_bc > 2 d_ab gives
                        # sqrt(<0); both stay on SHAKE/RATTLE
                        h2 = d_ab * d_ac - 0.25 * d_bc * d_bc
                        if (_settle_equal(d_ab, d_ac)
                                and _settle_equal(mass[b], mass[c])
                                and h2 > 1e-6 * d_ab * d_ac):
                            settle_rows.append((apex, b, c))
                            settle_dab.append(d_ab)
                            settle_dbc.append(d_bc)
                            ok = True
                            break
        if not ok:
            rest.extend(ks)

    sset = None
    if settle_rows:
        sset = make_settle_set(np.asarray(settle_rows, np.int32),
                               np.asarray(settle_dab),
                               np.asarray(settle_dbc), mass,
                               dtype=cons.d0.dtype)
    rest_cons = None
    if rest:
        rest = np.asarray(sorted(rest))
        rest_cons = ConstraintSet(pairs=jnp.asarray(pairs[rest]),
                                  d0=jnp.asarray(d0[rest], cons.d0.dtype))
    return sset, rest_cons


def _normalize(v, eps=1e-30):
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, -1, keepdims=True),
                                         eps))


def settle_positions(ss: SettleSet, x, x_ref, masses):
    """Exact position projection after an unconstrained move.

    x: unconstrained positions; x_ref: positions before the move (on the
    constraint manifold). Returns x with every SETTLE molecule reset to its
    rigid geometry — the analytic solution of the same equations Jacobi
    SHAKE iterates on (corrections consistent with momentum conservation:
    the molecular center of mass is untouched).
    """
    tr = ss.triplets
    ia, ib, ic = tr[:, 0], tr[:, 1], tr[:, 2]
    a0, b0, c0 = x_ref[ia], x_ref[ib], x_ref[ic]
    a1, b1, c1 = x[ia], x[ib], x[ic]
    ma = masses[ia][:, None]
    mb = masses[ib][:, None]
    mc = masses[ic][:, None]
    ra, rb, rc = ss.ra, ss.rb, ss.rc

    com = (ma * a1 + mb * b1 + mc * c1) / (ma + mb + mc)

    # primed frame: origin at the new COM, ẑ ⊥ old molecular plane,
    # x̂ ⊥ (ẑ, apex) so the apex lies in the y-z plane
    b0v, c0v = b0 - a0, c0 - a0
    a1v, b1v, c1v = a1 - com, b1 - com, c1 - com
    n0 = _normalize(jnp.cross(b0v, c0v))
    n1 = _normalize(jnp.cross(a1v, n0))
    n2 = jnp.cross(n0, n1)  # unit by construction

    def to_primed(v):
        return (jnp.sum(v * n1, -1), jnp.sum(v * n2, -1),
                jnp.sum(v * n0, -1))

    xb0, yb0, _ = to_primed(b0v)
    xc0, yc0, _ = to_primed(c0v)
    _, ya1, za1 = to_primed(a1v)  # x-component is 0 by construction
    xb1, yb1, zb1 = to_primed(b1v)
    xc1, yc1, zc1 = to_primed(c1v)

    # tilt (phi about x̂, psi about ŷ) matching the out-of-plane motion:
    # with the COM constraint m_A ra == (m_B + m_C) rb, matching za1 and
    # (zb1 - zc1) reproduces zb1/zc1 exactly (telescoping through the COM)
    sinphi = jnp.clip(za1 / ra, -1.0, 1.0)
    cosphi = jnp.sqrt(1.0 - sinphi * sinphi)
    sinpsi = jnp.clip((zb1 - zc1) / (2.0 * rc * cosphi), -1.0, 1.0)
    cospsi = jnp.sqrt(1.0 - sinpsi * sinpsi)

    ya2 = ra * cosphi
    xb2 = -rc * cospsi
    yb2 = -rb * cosphi - rc * sinpsi * sinphi
    yc2 = -rb * cosphi + rc * sinpsi * sinphi

    # in-plane rotation theta from the SHAKE condition (corrections along
    # the OLD bond directions — Miyamoto & Kollman eqs. A5-A9)
    alpha = xb2 * (xb0 - xc0) + yb0 * yb2 + yc0 * yc2
    beta = xb2 * (yc0 - yb0) + xb0 * yb2 + xc0 * yc2
    gamma = xb0 * yb1 - xb1 * yb0 + xc0 * yc1 - xc1 * yc0
    a2b2 = alpha * alpha + beta * beta
    sinth = (alpha * gamma
             - beta * jnp.sqrt(jnp.maximum(a2b2 - gamma * gamma, 0.0))) / a2b2
    costh = jnp.sqrt(jnp.maximum(1.0 - sinth * sinth, 0.0))

    xa3, ya3, za3 = -ya2 * sinth, ya2 * costh, za1
    xb3 = xb2 * costh - yb2 * sinth
    yb3 = xb2 * sinth + yb2 * costh
    xc3 = -xb2 * costh - yc2 * sinth
    yc3 = -xb2 * sinth + yc2 * costh

    def back(px, py, pz):
        return (com + px[:, None] * n1 + py[:, None] * n2
                + pz[:, None] * n0)

    x = x.at[ia].set(back(xa3, ya3, za3))
    x = x.at[ib].set(back(xb3, yb3, zb1))
    x = x.at[ic].set(back(xc3, yc3, zc1))
    return x


def settle_velocities(ss: SettleSet, x, v, masses):
    """Exact velocity projection (the RATTLE stage) for every triangle.

    Solves the 3x3 linear system for the three Lagrange multipliers in
    closed form (batched adjugate) — one shot instead of ~60 Jacobi sweeps,
    exact for ANY triangle (no isoceles assumption needed here).
    """
    tr = ss.triplets
    ia, ib, ic = tr[:, 0], tr[:, 1], tr[:, 2]
    xa, xb, xc = x[ia], x[ib], x[ic]
    va, vb, vc = v[ia], v[ib], v[ic]
    im_a = 1.0 / masses[ia]
    im_b = 1.0 / masses[ib]
    im_c = 1.0 / masses[ic]

    # constraint bond vectors: 1 = (A,B), 2 = (B,C), 3 = (C,A)
    r1, r2, r3 = xa - xb, xb - xc, xc - xa

    def d(u, w):
        return jnp.sum(u * w, -1)

    # A_lk = w_lk * (r_l . r_k): + (im_i + im_j) on the diagonal, - im of
    # the shared atom off-diagonal (each shared atom appears crossed —
    # first slot of one constraint, second slot of the other)
    a11 = (im_a + im_b) * d(r1, r1)
    a22 = (im_b + im_c) * d(r2, r2)
    a33 = (im_c + im_a) * d(r3, r3)
    a12 = -im_b * d(r1, r2)
    a13 = -im_a * d(r1, r3)
    a23 = -im_c * d(r2, r3)
    rhs1 = -d(va - vb, r1)
    rhs2 = -d(vb - vc, r2)
    rhs3 = -d(vc - va, r3)

    det = (a11 * (a22 * a33 - a23 * a23)
           - a12 * (a12 * a33 - a23 * a13)
           + a13 * (a12 * a23 - a22 * a13))
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    # symmetric adjugate
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    l1 = (c11 * rhs1 + c12 * rhs2 + c13 * rhs3) * inv_det
    l2 = (c12 * rhs1 + c22 * rhs2 + c23 * rhs3) * inv_det
    l3 = (c13 * rhs1 + c23 * rhs2 + c33 * rhs3) * inv_det

    v = v.at[ia].add(im_a[:, None] * (l1[:, None] * r1 - l3[:, None] * r3))
    v = v.at[ib].add(im_b[:, None] * (l2[:, None] * r2 - l1[:, None] * r1))
    v = v.at[ic].add(im_c[:, None] * (l3[:, None] * r3 - l2[:, None] * r2))
    return v


def settle_residual(ss: SettleSet, x):
    """max relative geometry error over all SETTLE molecules."""
    tr = ss.triplets
    a, b, c = x[tr[:, 0]], x[tr[:, 1]], x[tr[:, 2]]
    h = ss.ra + ss.rb  # apex height above the BC line
    d_ab = jnp.sqrt(h * h + ss.rc * ss.rc)  # target apex-satellite
    d_bc = 2.0 * ss.rc

    def err(u, w, d0):
        r = jnp.sqrt(jnp.sum((u - w) ** 2, -1))
        return jnp.abs(r - d0) / d0

    return jnp.max(jnp.stack([err(a, b, d_ab), err(a, c, d_ab),
                              err(b, c, d_bc)]))
