"""Bonded interactions: harmonic bonds / angles, periodic torsions.

Equivalents of openmm's HarmonicBondForce / HarmonicAngleForce /
PeriodicTorsionForce (SURVEY.md §2b N3): pure gathers + reductions, trivially
fused by XLA; forces come from jax.grad. Padded entries carry k = 0 so no
masks are needed in the hot path.

Bonded terms use direct (non-minimum-image) displacements: positions are kept
unwrapped during dynamics so molecules stay whole (wrapping happens only at
reporting/analysis time).
"""
from __future__ import annotations

import jax.numpy as jnp


def harmonic_bond_energy(x, idx, r0, k):
    """E = sum 0.5 k (|x_i - x_j| - r0)^2; idx (B,2), r0/k (B,)."""
    dx = x[idx[:, 0]] - x[idx[:, 1]]
    r = jnp.sqrt(jnp.sum(dx * dx, axis=-1) + 1e-32)
    return jnp.sum(0.5 * k * (r - r0) ** 2)


def harmonic_angle_energy(x, idx, theta0, k):
    """E = sum 0.5 k (theta - theta0)^2; idx (A,3) for atoms i-j-k (j central)."""
    a = x[idx[:, 0]] - x[idx[:, 1]]
    b = x[idx[:, 2]] - x[idx[:, 1]]
    na = jnp.sqrt(jnp.sum(a * a, axis=-1) + 1e-32)
    nb = jnp.sqrt(jnp.sum(b * b, axis=-1) + 1e-32)
    cos_t = jnp.sum(a * b, axis=-1) / (na * nb)
    cos_t = jnp.clip(cos_t, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_t)
    return jnp.sum(0.5 * k * (theta - theta0) ** 2)


def dihedral_angle(x, idx):
    """Signed dihedral phi for atoms i-j-k-l; idx (T, 4)."""
    b1 = x[idx[:, 1]] - x[idx[:, 0]]
    b2 = x[idx[:, 2]] - x[idx[:, 1]]
    b3 = x[idx[:, 3]] - x[idx[:, 2]]
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    m1 = jnp.cross(n1, b2 / jnp.linalg.norm(b2, axis=-1, keepdims=True))
    xc = jnp.sum(n1 * n2, axis=-1)
    yc = jnp.sum(m1 * n2, axis=-1)
    return jnp.arctan2(yc, xc)


def periodic_torsion_energy(x, idx, periodicity, phase, k):
    """E = sum k (1 + cos(n phi - phase)); idx (T,4) for dihedral i-j-k-l."""
    phi = dihedral_angle(x, idx)
    return jnp.sum(k * (1.0 + jnp.cos(periodicity * phi - phase)))


def harmonic_improper_energy(x, idx, phi0, k):
    """CHARMM-style harmonic improper: E = sum k (phi - phi0)^2 with the
    difference wrapped to (-pi, pi] (idx (I,4); k carries NO 1/2 — the
    CHARMM convention, matching CHAMBER prmtop force constants)."""
    phi = dihedral_angle(x, idx)
    dphi = phi - phi0
    dphi = dphi - 2.0 * jnp.pi * jnp.round(dphi / (2.0 * jnp.pi))
    return jnp.sum(k * dphi * dphi)
