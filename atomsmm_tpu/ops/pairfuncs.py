"""Pairwise energy expressions (the analog of atomsmm's Lepton energy strings).

Each function maps (r, per-pair parameters, globals) -> energy [kJ/mol] and is
finite for r in (0, rcut]; masking of out-of-range / excluded / padded pairs is
the evaluator's job (ops/pairs.py, ops/neighbors.py). JAX tracing + XLA fusion
replace OpenMM's Lepton JIT (SURVEY.md §2b N2).

Combining rules are Lorentz-Berthelot (sigma arithmetic, epsilon geometric),
matching openmm.NonbondedForce, from which the reference forces import their
parameters (atomsmm/forces.py `importFrom` idiom).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..units import ONE_4PI_EPS0
from .rv import Rv, make_rv, rv_parts  # noqa: F401  (re-exported)
from .switching import switch_quintic

# --- erfc dispatch ----------------------------------------------------------
# f32 pair sweeps use a rational approximation (Abramowitz & Stegun 7.1.26,
# |err| <= 1.5e-7 — at f32 roundoff); f64 keeps the exact lax.erfc, so the
# CPU reference path stays at full precision.


@jax.custom_jvp
def erfc_approx(x):
    """A&S 7.1.26 for x >= 0 (pair distances are positive): t-polynomial
    times exp(-x^2); max abs error 1.5e-7. The tangent uses the EXACT
    derivative d/dx erfc = -2/sqrt(pi) e^{-x^2}, so forces don't inherit
    the polynomial's larger derivative error."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    return poly * jnp.exp(-x * x)


@erfc_approx.defjvp
def _erfc_approx_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    return erfc_approx(x), -1.1283791670955126 * jnp.exp(-x * x) * dx


def erfc(x):
    """erfc with a precision-matched fast path.

    f32 inputs (the production path) use the A&S 7.1.26 approximation:
    its 1.5e-7 absolute error sits at f32 roundoff while costing a fraction
    of the exact rational erfc (measured: the erfc term is the dominant
    marginal cost of the PME near/far sweeps — profile_headline r3). f64
    (the CPU reference platform, goldens) keeps the exact lax erfc. Set
    ATOMSMM_EXACT_ERFC=1 to force the exact form everywhere.
    """
    import os

    if jnp.asarray(x).dtype == jnp.float32 and not os.environ.get(
        "ATOMSMM_EXACT_ERFC"
    ):
        return erfc_approx(x)
    return jax.scipy.special.erfc(x)


def lorentz_berthelot(sigma_i, sigma_j, eps_i, eps_j):
    sigma = 0.5 * (sigma_i + sigma_j)
    epsilon = jnp.sqrt(eps_i * eps_j)
    return sigma, epsilon


def lj(r, sigma, epsilon):
    """Lennard-Jones 4 eps [(s/r)^12 - (s/r)^6].

    Minimum at r = 2^(1/6) sigma with depth -epsilon:

    >>> import jax.numpy as jnp
    >>> round(float(lj(jnp.float64(2.0 ** (1 / 6) * 0.34), 0.34, 0.65)), 10)
    -0.65
    >>> float(lj(jnp.float64(0.34), 0.34, 0.65))  # zero crossing at sigma
    0.0
    """
    # single-reciprocal form: every pair primitive multiplies by (1/r) (or an
    # Rv's shared rsqrt — ops/rv.py) so the reciprocal is computed once per
    # slot — divides/sqrts are the dominant per-slot arithmetic cost
    _, rinv, _ = rv_parts(r)
    t = sigma * rinv
    t2 = t * t
    s6 = t2 * t2 * t2
    return 4.0 * epsilon * s6 * (s6 - 1.0)


def hbond_10_12(r, a, b):
    """AMBER legacy 10-12 hydrogen-bond potential A/r^12 - B/r^10
    (HBOND_ACOEF/HBOND_BCOEF slots of the nonbonded parm table).

    Minimum at r* = sqrt(6A/5B) with depth -B^6 (5/6)^5 / (6 A^5) ... checked
    numerically instead: with A = 1e-5 kJ nm^12, B = 1e-3 kJ nm^10 the
    minimum sits at r* = sqrt(6e-5/5e-4) nm:

    >>> import jax.numpy as jnp
    >>> r_star = float(jnp.sqrt(jnp.float64(6e-5 / 5e-3)))  # sqrt(6A/5B)
    >>> u0 = float(hbond_10_12(jnp.float64(r_star), 1e-5, 1e-3))
    >>> ul = float(hbond_10_12(jnp.float64(r_star * 0.99), 1e-5, 1e-3))
    >>> ur = float(hbond_10_12(jnp.float64(r_star * 1.01), 1e-5, 1e-3))
    >>> bool(u0 < ul and u0 < ur)
    True
    """
    _, rinv, _ = rv_parts(r)
    inv2 = rinv * rinv
    inv10 = inv2 * inv2
    inv10 = inv10 * inv10 * inv2  # (1/r^2)^5
    return (a * inv2 - b) * inv10


def coulomb(r, qq):
    """Plain Coulomb k qq / r; qq = qi*qj [e^2]."""
    _, rinv, _ = rv_parts(r)
    return ONE_4PI_EPS0 * qq * rinv


def damped_coulomb(r, qq, alpha):
    """Damped (Wolf-style) Coulomb k qq erfc(alpha r)/r.

    alpha = 0 reduces exactly to plain Coulomb. Used by the reference's
    DampedSmoothedForce / NearNonbondedForce real-space terms and as the PME
    direct-space term.
    """
    rr, rinv, _ = rv_parts(r)
    return ONE_4PI_EPS0 * qq * erfc(alpha * rr) * rinv


def reaction_field_coulomb(r, qq, r_cut, eps_rf):
    """Cutoff Coulomb with reaction-field correction (openmm CutoffPeriodic):

    k qq (1/r + k_rf r^2 - c_rf), k_rf = (eps-1)/((2 eps+1) rc^3), c_rf chosen
    so u(rc) = 0. eps_rf is a traced scalar; pass a large value (~1e15) for a
    conducting boundary (k_rf -> 1/(2 rc^3) numerically).
    """
    k_rf = (eps_rf - 1.0) / ((2.0 * eps_rf + 1.0) * r_cut**3)
    c_rf = 1.0 / r_cut + k_rf * r_cut**2
    _, rinv, r2 = rv_parts(r)
    return ONE_4PI_EPS0 * qq * (rinv + k_rf * r2 - c_rf)


def softcore_lj(r, sigma, epsilon, lamb, alpha=0.5):
    """Beutler-style softcore LJ (atomsmm/forces.py::SoftcoreLennardJonesForce):

    u = 4 eps lambda [ (1/x)^2 - 1/x ],  x = alpha (1-lambda) + (r/sigma)^6.

    lambda = 1 recovers plain LJ; lambda = 0 turns the interaction off with a
    bounded core (finite at r=0):

    >>> import jax.numpy as jnp
    >>> r = jnp.float64(0.38)
    >>> abs(float(softcore_lj(r, 0.34, 0.65, 1.0) - lj(r, 0.34, 0.65))) < 1e-14
    True
    >>> float(softcore_lj(jnp.float64(0.0), 0.34, 0.65, 0.0))
    0.0
    >>> bool(jnp.isfinite(softcore_lj(jnp.float64(1e-6), 0.34, 0.65, 0.5)))
    True
    """
    _, _, r2 = rv_parts(r)
    t = r2 / (sigma * sigma)
    x = alpha * (1.0 - lamb) + t * t * t
    inv = 1.0 / x
    return 4.0 * epsilon * lamb * inv * (inv - 1.0)


# --- Composite near/far forms used by the RESPA split -----------------------


def near_pair_energy(r, sigma, epsilon, qq, alpha, r_switch, r_cut,
                     subtract: bool = False):
    """Inner/short-range RESPA pair energy (atomsmm/forces.py::NearNonbondedForce).

    Shifted-force LJ + shifted-force damped Coulomb, each multiplied by the
    quintic switching function over [r_switch, r_cut] when r_switch < r_cut.
    Energy AND force go continuously to zero at r_cut, which is what makes it
    usable as the high-frequency RESPA level. With `subtract` the negated form
    is returned (the far force's "minus near" half, ::FarNonbondedForce).

    When alpha is a concrete Python 0.0 the erfc damping is skipped at trace
    time (hot-loop transcendental savings; erfc(0 r) == 1 exactly).
    """
    undamped = isinstance(alpha, (int, float)) and float(alpha) == 0.0

    def base(rr):
        _, inv, _ = rv_parts(rr)
        t = sigma * inv
        t2 = t * t
        s6 = t2 * t2 * t2
        u_lj = 4.0 * epsilon * s6 * (s6 - 1.0)
        if undamped:
            u_c = ONE_4PI_EPS0 * qq * inv
        else:
            rr_ = rr.r if isinstance(rr, Rv) else rr
            u_c = ONE_4PI_EPS0 * qq * erfc(alpha * rr_) * inv
        return u_lj + u_c

    # shifted-force: u(r) - u(rc) - u'(rc)(r - rc), derivative via jvp at trace
    # time (replaces the reference's symbolically shifted Lepton strings).
    u_rc, du_rc = jax.jvp(base, (r_cut,), (jnp.ones_like(r_cut),))
    rr_ = r.r if isinstance(r, Rv) else r
    u = (base(r) - u_rc - du_rc * (rr_ - r_cut)) * switch_quintic(
        rr_, r_switch, r_cut
    )
    return -u if subtract else u


def damped_smoothed_energy(r, sigma, epsilon, qq, alpha, r_switch, r_cut):
    """atomsmm/forces.py::DampedSmoothedForce: (LJ + damped Coulomb) * S(r).

    The damped-shifted formulation of Fennell & Gezelter (JCP 2006) with a
    smoothing (switching) polynomial instead of the force shift.
    """
    rr, inv, _ = rv_parts(r)
    t = sigma * inv
    t2 = t * t
    s6 = t2 * t2 * t2
    u_lj = 4.0 * epsilon * s6 * (s6 - 1.0)
    u_c = ONE_4PI_EPS0 * qq * erfc(alpha * rr) * inv
    return (u_lj + u_c) * switch_quintic(rr, r_switch, r_cut)
