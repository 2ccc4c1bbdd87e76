"""r²-native pair evaluation carrier.

Pair distances enter every evaluator as r² (one dot product per slot). The
classic MD identity f = -u'(r)·r̂ = -2·(du/dr²)·Δx lets forces skip the 1/r
divide entirely, and every pair primitive (LJ powers, Coulomb 1/r, switch
radius) derives from ONE reciprocal square root:

    rinv = rsqrt(r²),  r = r²·rinv,  (σ/r)⁶ = (σ·rinv)⁶, ...

Divides and sqrts are the dominant per-slot arithmetic cost (each is a
multi-op sequence); this carrier replaces {sqrt, 1/r in LJ, 1/r in Coulomb,
1/r in fmag} with a single rsqrt. The pairfuncs helpers accept either an Rv
or a plain r array (legacy exact path — the f64 CPU reference and user-
supplied CustomNonbondedForce functions keep plain r semantics).

Builtin force pair functions set `pair.takes_rv = True`; evaluators call
`pair_eval` which differentiates with respect to r² either way, so the
2·du/dr² force identity applies uniformly.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Rv(NamedTuple):
    r2: jnp.ndarray
    rinv: jnp.ndarray
    r: jnp.ndarray


def make_rv(r2) -> Rv:
    # f64 (the CPU reference path) uses the exact 1/sqrt so golden energies
    # stay reproducible to the last ulp; f32 uses the hardware rsqrt.
    if jnp.result_type(r2) == jnp.float64:
        rinv = 1.0 / jnp.sqrt(r2)
    else:
        rinv = jax.lax.rsqrt(r2)
    return Rv(r2, rinv, r2 * rinv)


def rv_parts(r):
    """(r, 1/r, r²) from either an Rv or a plain distance array."""
    if isinstance(r, Rv):
        return r.r, r.rinv, r.r2
    inv = 1.0 / r
    return r, inv, r * r


def pair_eval(pair_fn, r2m, pi, pj, with_tangent: bool):
    """Evaluate pair_fn on masked r² (invalid slots pre-set to 1.0).

    Returns (u, dudr2) with dudr2 = du/d(r²) when with_tangent, else (u, None).
    Force vector on atom i is then  -2·dudr2·Δx_ij  (no 1/r)."""
    takes = getattr(pair_fn, "takes_rv", False)

    def f(s):
        rv = make_rv(s)
        return pair_fn(rv if takes else rv.r, pi, pj)

    if with_tangent:
        return jax.jvp(f, (r2m,), (jnp.ones_like(r2m),))
    return f(r2m), None
