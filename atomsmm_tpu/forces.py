"""Force objects — the counterpart of atomsmm/forces.py (SURVEY.md §2a).

In the reference, each force class builds an openmm Custom*Force whose energy
is a Lepton string compiled by OpenMM's C++ JIT. Here each force is a pytree
dataclass whose `energy(x, box, globals, aux)` method is a traced JAX
function; XLA fusion replaces Lepton, `jax.grad` replaces hand-coded force
kernels, and the "force group" integer drives the RESPA split exactly as in
the reference.

Evaluation paths for nonbonded forces:
  * dense — chunked masked O(N^2) (ops/pairs.py); the deterministic reference
    path, used for tests/goldens and when no neighbor list is available;
  * neighbors — fixed-capacity (N, K) neighbor list (ops/neighbors.py), the
    production path; `aux` carries the list (built/updated by Context).
    Forces on this path are explicit gather-only sums, exposed through
    `energy_and_forces` (used by potential.force_fn instead of autodiff).

Implemented classes and their reference counterparts:
  NonbondedForce            — openmm.NonbondedForce (cutoff/RF; PME via ops/pme.py)
  NonbondedExceptionsForce  — atomsmm/forces.py::NonbondedExceptionsForce
  NearNonbondedForce        — atomsmm/forces.py::NearNonbondedForce
  FarNonbondedForce         — atomsmm/forces.py::FarNonbondedForce
  DampedSmoothedForce       — atomsmm/forces.py::DampedSmoothedForce
  SoftcoreLennardJonesForce — atomsmm/forces.py::SoftcoreLennardJonesForce
  HarmonicBondForce / HarmonicAngleForce / PeriodicTorsionForce — openmm bonded
  CustomNonbondedForce / CustomBondForce — openmm Custom*Force (energy function
                              is a Python callable instead of a Lepton string)

All per-particle parameter arrays are dynamic pytree leaves, so jitted step
functions never recompile when parameters (or globals such as lambda) change.

Worked energy examples (the reference's forces docstrings carry the same
kind of hard-coded doctest energies — SURVEY.md §2a Docs row). Two LJ
particles at the potential minimum r = 2^(1/6) sigma see exactly -epsilon
(the quintic switch is 1 below r_switch):

>>> import jax.numpy as jnp
>>> box = jnp.array([5.0, 5.0, 5.0])
>>> no_excl = -jnp.ones((2, 1), jnp.int32)
>>> x = jnp.array([[0.0, 0.0, 0.0], [2.0**(1 / 6) * 0.3, 0.0, 0.0]])
>>> nb = NonbondedForce(charge=jnp.zeros(2), sigma=jnp.full(2, 0.3),
...                     epsilon=jnp.full(2, 1.0), exclusions=no_excl,
...                     r_cut=1.0, r_switch=0.9, method='cutoff')
>>> round(float(nb.energy(x, box, {})), 6)
-1.0

A +1/-1 charge pair without cutoff gives Coulomb's law,
E = -k_e / r = -138.935456 / 0.33674 kJ/mol:

>>> nb2 = NonbondedForce(charge=jnp.array([1.0, -1.0]),
...                      sigma=jnp.full(2, 0.3), epsilon=jnp.zeros(2),
...                      exclusions=no_excl, method='nocutoff')
>>> round(float(nb2.energy(x, box, {})), 3)
-412.591

Bonded terms follow the OpenMM conventions, E = k/2 (r - r0)^2 = 0.2 for
k = 1000, r - r0 = 0.02:

>>> hb = HarmonicBondForce(idx=jnp.array([[0, 1]]), r0=jnp.array([0.1]),
...                        k=jnp.array([1000.0]))
>>> xb = jnp.array([[0.0, 0.0, 0.0], [0.12, 0.0, 0.0]])
>>> round(float(hb.energy(xb, box, {})), 6)
0.2
>>> ha = HarmonicAngleForce(idx=jnp.array([[0, 1, 2]]),
...                         theta0=jnp.array([1.2]), k=jnp.array([100.0]))
>>> xa = jnp.array([[0.1, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.1, 0.0]])
>>> round(float(ha.energy(xa, box, {})), 4)    # 50 (pi/2 - 1.2)^2
6.8745

A 1-4 exception pair (no cutoff): 4 eps [(s/r)^12 - (s/r)^6] + k qq / r
at the LJ-minimum distance = -0.5 - 138.935456 * 0.5 / 0.33674:

>>> ex = NonbondedExceptionsForce(pairs=jnp.array([[0, 1]]),
...                               chargeprod=jnp.array([-0.5]),
...                               sigma=jnp.array([0.3]),
...                               epsilon=jnp.array([0.5]),
...                               valid=jnp.array([True]))
>>> round(float(ex.energy(x, box, {})), 4)
-206.7957

The RESPA split identity: the subtract=True near force is the exact
negation (FarNonbondedForce adds it to the full force, so near + far ==
full by construction):

>>> from atomsmm_tpu.utils import replace
>>> near = NearNonbondedForce(charge=jnp.array([0.5, -0.5]),
...                           sigma=jnp.full(2, 0.3),
...                           epsilon=jnp.full(2, 0.6),
...                           exclusions=no_excl, r_cut=0.5, r_switch=0.4)
>>> xr = jnp.array([[0.0, 0.0, 0.0], [0.33, 0.0, 0.0]])
>>> e_near = float(near.energy(xr, box, {}))
>>> round(e_near, 4)
-12.4435
>>> e_minus = float(replace(near, subtract=True).energy(xr, box, {}))
>>> round(e_near + e_minus, 12)
0.0

DampedSmoothedForce (Fennell-Gezelter DSF, alpha = 2/nm) at the same
geometry:

>>> ds = DampedSmoothedForce(charge=jnp.array([1.0, -1.0]),
...                          sigma=jnp.full(2, 0.3),
...                          epsilon=jnp.full(2, 1.0), exclusions=no_excl,
...                          r_cut=1.0, r_switch=0.9, alpha=2.0)
>>> round(float(ds.energy(x, box, {})), 4)
-141.6415
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from .ops import pairfuncs
from .ops.bonded import (
    harmonic_angle_energy,
    harmonic_bond_energy,
    periodic_torsion_energy,
)
from .ops.neighbors import cell_pair_energy, cell_pair_energy_forces
from .ops.pbc import box_volume
from .ops.pairs import dense_pair_energy, pairlist_energy
from .units import ONE_4PI_EPS0
from .utils import pytree_dataclass, replace, static_field


def _resolve_neighbors(aux, key: str):
    """Aux entry ({'spec', 'bucket'[, 'cand']}) for this force's neighbor
    structure, falling back to the default one; None -> dense path."""
    if not aux:
        return None
    return aux.get(key) or aux.get("default")


def _spatial_mesh():
    """Active spatial-decomposition (mesh, axis) or None (parallel/mesh.py);
    consulted at trace time by the pair and PME paths."""
    from .parallel.mesh import active_spatial_mesh

    return active_spatial_mesh()


def _spread_sig(grid_shape, order, block, cap, pad):
    """Deterministic extras-key signature for an amortized spreading bucket.
    Derived from exactly the static fields that determine the bucket, so a
    Far wrapper and its companion PMEReciprocalForce (same grid/order/
    block/cap/pad) naturally SHARE one bucket."""
    k1, k2, k3 = grid_shape
    b1, b2, b3 = block
    return f"{k1}x{k2}x{k3}o{order}b{b1}x{b2}x{b3}c{cap}p{pad}"


def _spread_bucket_from_aux(aux, grid_shape, order, block, cap, pad):
    """The frozen spreading bucket for this layout, or None (fresh-bucket
    blocked path) when amortization is off or aux has no bucket (direct
    energy calls outside a Context)."""
    if not pad or not block or not isinstance(aux, dict):
        return None
    return aux.get(
        "pmesp_" + _spread_sig(grid_shape, order, block, cap, pad)
        + "_bucket")


def _pme_reciprocal(x, box, q, alpha, grid_shape, order,
                    spread_block=(), spread_cap=0, spread_pad=0,
                    spread_bucket=None):
    """Reciprocal PME sum, sharded over the active spatial mesh when one is
    set (parallel/spatial.py), else single-device (ops/pme.py). On a mesh
    the slab-decomposed FFT path is used whenever the grid divides the
    device count (spreading reduce-scatter + distributed FFT + sharded
    convolution); otherwise spreading is atom-sharded with a grid psum and
    the FFT runs replicated. spread_block/spread_cap (single-device only)
    select block-binned spreading (ops/pme.py::spread_charges_blocked)."""
    mesh = _spatial_mesh()
    if mesh is not None:
        ndev = mesh[0].shape[mesh[1]]
        if grid_shape[0] % ndev == 0 and grid_shape[1] % ndev == 0:
            from .parallel.spatial import sharded_pme_reciprocal_energy_fft

            _RECIPROCAL_DISPATCH["path"] = "slab_fft"
            return sharded_pme_reciprocal_energy_fft(
                x, box, q, alpha, grid_shape, mesh[0], mesh[1], order=order
            )
        from .parallel.spatial import sharded_pme_reciprocal_energy

        _RECIPROCAL_DISPATCH["path"] = "atom_sharded_psum"
        return sharded_pme_reciprocal_energy(
            x, box, q, alpha, grid_shape, mesh[0], mesh[1], order=order
        )
    from .ops.pme import pme_reciprocal_energy

    _RECIPROCAL_DISPATCH["path"] = "single_device"
    return pme_reciprocal_energy(x, box, q, alpha, grid_shape, order,
                                 spread_block=spread_block,
                                 spread_cap=spread_cap,
                                 spread_pad=spread_pad,
                                 spread_bucket=spread_bucket)


# Trace-time record of the most recent reciprocal-path choice above —
# static dispatch on (grid, mesh), so recording it at trace time is exact.
# Lets harnesses (dryrun_multichip) ASSERT the slab-FFT path actually
# engaged instead of inferring it from the grid arithmetic (VERDICT r4 #4).
_RECIPROCAL_DISPATCH = {"path": None}


def last_reciprocal_dispatch():
    """'slab_fft' | 'atom_sharded_psum' | 'single_device' | None — which
    reciprocal-space path the most recent PME trace dispatched to."""
    return _RECIPROCAL_DISPATCH["path"]


def _lj_combiner(pair_sigma, pair_epsilon):
    """LJ parameter combination rule for the pair sweeps: Lorentz-Berthelot
    from per-particle (sigma, epsilon), or — when per-type-pair NBFIX
    tables are attached — a flat-table gather on (lj_type_i, lj_type_j).
    The table path costs two extra gathers per tile slot and engages only
    for force fields whose LJ matrix deviates from combining rules
    (SURVEY.md §2b N1 substrate capability; VERDICT r3 missing #5)."""
    if pair_sigma is None:
        def combine(pi, pj):
            return pairfuncs.lorentz_berthelot(
                pi["sigma"], pj["sigma"], pi["epsilon"], pj["epsilon"]
            )
        return combine

    n_types = pair_sigma.shape[0]
    tab_s = pair_sigma.reshape(-1)
    tab_e = pair_epsilon.reshape(-1)

    def combine(pi, pj):
        idx = pi["lj_type"] * n_types + pj["lj_type"]
        return tab_s[idx], tab_e[idx]

    return combine


@pytree_dataclass
class Force:
    """Base force: subclasses define energy(x, box, globals, aux) -> scalar.

    Subclasses with an explicit force formula also define
    energy_and_forces(x, box, globals, aux) -> (scalar, (N, 3)); others are
    differentiated by potential.force_fn.
    """

    group: int = static_field(default=0)

    @property
    def name(self) -> str:
        return type(self).__name__

    def energy(self, x, box, globals, aux=None):  # pragma: no cover - abstract
        raise NotImplementedError

    def uses_neighbors(self) -> bool:
        return False


class _PairForceMixin:
    """Shared dense/neighbor dispatch for pair forces. Subclasses provide
    _pair_fn(globals) -> (r, pi, pj) -> energy and _per_particle().
    neighbor_key selects which attached grid the force evaluates on
    ('default' = the max-cutoff grid; e.g. the near RESPA force rides a
    finer 'near' grid when one is attached)."""

    neighbor_key = "default"

    def _nb_energy(self, x, box, globals, aux, r_cut):
        pair_fn = self._pair_fn(globals)
        pp = self._per_particle(globals)
        nbr = _resolve_neighbors(aux, self.neighbor_key)
        if nbr is not None:
            mesh = _spatial_mesh()
            if mesh is not None:  # spatial DD (parallel/mesh.py)
                from .parallel.spatial import sharded_cell_pair_energy

                return sharded_cell_pair_energy(
                    pair_fn, x, box, pp, nbr["spec"], nbr["bucket"], r_cut,
                    mesh[0], mesh[1],
                )
            if "cand" in nbr:  # atom-block tile path (ops/blocks.py)
                from .ops.blocks import block_pair_energy

                return block_pair_energy(
                    pair_fn, x, box, pp, nbr["spec"], nbr["bucket"],
                    nbr["cand"], r_cut,
                )
            return cell_pair_energy(
                pair_fn, x, box, pp, nbr["spec"], nbr["bucket"], r_cut
            )
        return dense_pair_energy(
            pair_fn, x, box, pp, self.exclusions, r_cut, chunk=self.chunk
        )

    def _nb_energy_forces(self, x, box, globals, aux, r_cut):
        pair_fn = self._pair_fn(globals)
        pp = self._per_particle(globals)
        nbr = _resolve_neighbors(aux, self.neighbor_key)
        if nbr is not None:
            mesh = _spatial_mesh()
            if mesh is not None:  # spatial DD (parallel/mesh.py)
                from .parallel.spatial import (
                    sharded_cell_pair_energy_forces,
                )

                return sharded_cell_pair_energy_forces(
                    pair_fn, x, box, pp, nbr["spec"], nbr["bucket"], r_cut,
                    mesh[0], mesh[1],
                )
            if "cand" in nbr:
                from .ops.blocks import block_pair_energy_forces

                return block_pair_energy_forces(
                    pair_fn, x, box, pp, nbr["spec"], nbr["bucket"],
                    nbr["cand"], r_cut,
                )
            return cell_pair_energy_forces(
                pair_fn, x, box, pp, nbr["spec"], nbr["bucket"], r_cut
            )
        e, g = jax.value_and_grad(
            lambda xx: dense_pair_energy(
                pair_fn, xx, box, pp, self.exclusions, r_cut, chunk=self.chunk
            )
        )(x)
        return e, -g

    def uses_neighbors(self) -> bool:
        return True


# --------------------------------------------------------------------------
# Nonbonded forces
# --------------------------------------------------------------------------


@pytree_dataclass
class NonbondedForce(_PairForceMixin, Force):
    """Full LJ + Coulomb nonbonded force with per-particle (charge, sigma,
    epsilon), Lorentz-Berthelot combining, and exclusions.

    method:
      'nocutoff' — plain LJ + Coulomb over all pairs (dense only)
      'cutoff'   — switched LJ + reaction-field Coulomb within r_cut
      'pme'      — switched LJ (cutoff) + PME Coulomb: damped direct-space
                   pair term + reciprocal FFT + self/exclusion corrections
                   (ops/pme.py)
    """

    charge: jnp.ndarray = None
    sigma: jnp.ndarray = None
    epsilon: jnp.ndarray = None
    exclusions: jnp.ndarray = None  # (N, M) int32, padded with -1
    r_cut: Any = 1.0
    r_switch: Any = 0.9
    eps_rf: Any = 1e15
    charge_scale_mask: Any = None  # (N,) {0,1}: atoms whose charge scales
    dispersion_coeff: Any = None  # scalar: E_tail = coeff / V (see below)
    lj_type: jnp.ndarray = None   # (N,) int32 — set with the NBFIX tables
    pair_sigma: Any = None        # (T, T) per-type-pair sigma [nm] (NBFIX)
    pair_epsilon: Any = None      # (T, T) per-type-pair epsilon [kJ/mol]
    pair_a1012: Any = None        # (T, T) legacy 10-12 A [kJ/mol nm^12]
    pair_b1012: Any = None        # (T, T) legacy 10-12 B [kJ/mol nm^10]
    # damping constant is static: concrete at trace time so the undamped case
    # skips erfc entirely; it only changes at setup (PME parameterization)
    ewald_alpha: float = static_field(default=0.0)
    method: str = static_field(default="cutoff")
    charge_scale_name: str = static_field(default="lambda_coul")
    use_switch: bool = static_field(default=True)
    grid_shape: Tuple[int, int, int] = static_field(default=(0, 0, 0))
    spline_order: int = static_field(default=4)
    chunk: int = static_field(default=256)
    # block-binned spreading (ops/pme.py::spread_charges_blocked): () = the
    # dense one-hot path; set via forces.retune_pme_spread at setup.
    # spread_pad >= 1 additionally amortizes the bucket across steps
    # (spread_charges_stale; Context maintains the bucket + drift guards)
    spread_block: Tuple[int, ...] = static_field(default=())
    spread_cap: int = static_field(default=0)
    spread_pad: int = static_field(default=0)

    def _effective_charge(self, globals):
        """Per-particle charge, with SolvationSystem's lambda_coul scaling of
        masked (solute) atoms (SURVEY.md §3.4)."""
        q = self.charge
        if self.charge_scale_mask is not None:
            lam = (globals or {}).get(self.charge_scale_name, 1.0)
            q = q * (1.0 - self.charge_scale_mask * (1.0 - lam))
        return q

    def _per_particle(self, globals=None):
        pp = {
            "charge": self._effective_charge(globals),
            "sigma": self.sigma,
            "epsilon": self.epsilon,
        }
        if self.lj_type is not None:
            pp["lj_type"] = self.lj_type
        return pp

    def _pair_fn(self, globals=None):
        method, use_switch = self.method, self.use_switch
        r_cut, r_switch, eps_rf = self.r_cut, self.r_switch, self.eps_rf
        alpha = self.ewald_alpha
        combine = _lj_combiner(self.pair_sigma, self.pair_epsilon)
        hb_a, hb_b = self.pair_a1012, self.pair_b1012
        if hb_a is not None:
            n_types_hb = hb_a.shape[0]
            hb_a_flat, hb_b_flat = hb_a.reshape(-1), hb_b.reshape(-1)

        def pair(r, pi, pj):
            sigma, epsilon = combine(pi, pj)
            qq = pi["charge"] * pj["charge"]
            u_lj = pairfuncs.lj(r, sigma, epsilon)
            if hb_a is not None:
                # legacy AMBER 10-12 hydrogen bonds: per-type-pair A/B
                # tables on the flagged (negative parm index) slots; zero
                # everywhere else. Rides the LJ switch so the total vdW
                # term stays C2 at the cutoff.
                idx = pi["lj_type"] * n_types_hb + pj["lj_type"]
                u_lj = u_lj + pairfuncs.hbond_10_12(
                    r, hb_a_flat[idx], hb_b_flat[idx]
                )
            if method == "nocutoff":
                return u_lj + pairfuncs.coulomb(r, qq)
            if use_switch:
                from .ops.switching import switch_quintic

                rr = r.r if isinstance(r, pairfuncs.Rv) else r
                u_lj = u_lj * switch_quintic(rr, r_switch, r_cut)
            if method == "cutoff":
                u_c = pairfuncs.reaction_field_coulomb(r, qq, r_cut, eps_rf)
            else:  # 'pme': real-space (direct) Ewald term
                u_c = pairfuncs.damped_coulomb(r, qq, alpha)
            return u_lj + u_c

        pair.takes_rv = True
        return pair

    def _recip_energy(self, x, box, globals=None, include_reciprocal=True,
                      aux=None):
        from .ops.pme import pme_corrections

        q = self._effective_charge(globals)
        e = pme_corrections(x, box, q, self.exclusions, self.ewald_alpha)
        if include_reciprocal:
            e = e + _pme_reciprocal(
                x, box, q, self.ewald_alpha, self.grid_shape,
                self.spline_order, self.spread_block, self.spread_cap,
                self.spread_pad,
                _spread_bucket_from_aux(
                    aux, self.grid_shape, self.spline_order,
                    self.spread_block, self.spread_cap, self.spread_pad),
            )
        return e

    def energy(self, x, box, globals, aux=None):
        r_cut = jnp.inf if self.method == "nocutoff" else self.r_cut
        e = self._nb_energy(x, box, globals, aux, r_cut)
        if self.method == "pme":
            e = e + self._recip_energy(x, box, globals, aux=aux)
        if self.dispersion_coeff is not None:
            # long-range LJ tail: E = coeff / V; its box dependence feeds the
            # virial/pressure automatically (computers.py scaling trick)
            e = e + self.dispersion_coeff / box_volume(box)
        return e

    def energy_and_forces(self, x, box, globals, aux=None):
        r_cut = jnp.inf if self.method == "nocutoff" else self.r_cut
        e, f = self._nb_energy_forces(x, box, globals, aux, r_cut)
        if self.method == "pme":
            e2, g2 = jax.value_and_grad(
                lambda xx: self._recip_energy(xx, box, globals, aux=aux)
            )(x)
            e, f = e + e2, f - g2
        if self.dispersion_coeff is not None:
            e = e + self.dispersion_coeff / box_volume(box)  # no position force
        return e, f

    def uses_neighbors(self) -> bool:
        return self.method != "nocutoff"


def compute_dispersion_coefficient(sigma, epsilon, r_switch, r_cut,
                                   use_switch=True, n_quad=512,
                                   lj_type=None, pair_sigma=None,
                                   pair_epsilon=None):
    """Long-range LJ tail coefficient (openmm's dispersion correction):

        E_tail = coeff / V,
        coeff = 2 pi sum_{i<=j pairs} [ integral_0^inf r^2 (u - u_kept) dr ]

    i.e. the mean-field (g = 1) energy the truncated+switched potential
    misses: the full tail beyond r_cut plus the part removed by the switch on
    [r_switch, r_cut]. Computed exactly over unique (sigma, epsilon) type
    pairs on the host (numpy), switched region by quadrature. With NBFIX
    tables (lj_type + pair_sigma/pair_epsilon) the per-pair parameters come
    from the tables instead of Lorentz-Berthelot.
    """
    import numpy as np

    if pair_sigma is not None:
        t_idx = np.asarray(lj_type)
        counts = np.bincount(t_idx, minlength=np.asarray(pair_sigma).shape[0])
        types = None
    else:
        sig = np.asarray(sigma, np.float64)
        eps = np.asarray(epsilon, np.float64)
        types, counts = np.unique(
            np.stack([sig, eps], 1), axis=0, return_counts=True
        )
    rc, rs = float(r_cut), float(r_switch)
    total = 0.0
    for a in range(len(counts)):
        for b in range(len(counts)):
            if types is None:
                s_ab = float(np.asarray(pair_sigma)[a, b])
                e_ab = float(np.asarray(pair_epsilon)[a, b])
            else:
                s_ab = 0.5 * (types[a, 0] + types[b, 0])
                e_ab = np.sqrt(types[a, 1] * types[b, 1])
            if e_ab == 0.0:
                continue
            npairs = counts[a] * counts[b]  # ordered pairs; x1/2 below
            tail = 4.0 * e_ab * (
                s_ab**12 / (9.0 * rc**9) - s_ab**6 / (3.0 * rc**3)
            )
            missed = tail
            if use_switch and rs < rc:
                r = np.linspace(rs, rc, n_quad)
                u = 4.0 * e_ab * ((s_ab / r) ** 12 - (s_ab / r) ** 6)
                t = np.clip((r - rs) / (rc - rs), 0, 1)
                s_of_r = 1 + t**3 * (-10 + t * (15 - 6 * t))
                missed += np.trapezoid(r * r * u * (1.0 - s_of_r), r)
            total += 0.5 * npairs * missed
    # E_tail = (1/2) (N^2/V) * 4 pi * integral r^2 u dr  ->  coeff = 4 pi total
    return 4.0 * np.pi * total


@pytree_dataclass
class NonbondedExceptionsForce(Force):
    """1-4 exception pairs as a bond-like force, so they can live in the
    innermost RESPA group (atomsmm/forces.py::NonbondedExceptionsForce).

    E = 4 eps [(s/r)^12 - (s/r)^6] + k qq / r per listed pair, no cutoff.
    """

    pairs: jnp.ndarray = None       # (P, 2) int32
    chargeprod: jnp.ndarray = None  # (P,) [e^2]
    sigma: jnp.ndarray = None       # (P,)
    epsilon: jnp.ndarray = None     # (P,)
    valid: jnp.ndarray = None       # (P,) bool mask for padding

    def energy(self, x, box, globals, aux=None):
        def pair(r, p):
            return (
                pairfuncs.lj(r, p["sigma"], p["epsilon"])
                + ONE_4PI_EPS0 * p["chargeprod"] / r
            )

        params = {
            "chargeprod": self.chargeprod,
            "sigma": self.sigma,
            "epsilon": self.epsilon,
        }
        return pairlist_energy(pair, x, box, self.pairs, params, self.valid)


@pytree_dataclass
class NearNonbondedForce(_PairForceMixin, Force):
    """Short-range RESPA force (atomsmm/forces.py::NearNonbondedForce):
    shifted-force LJ + shifted-force damped Coulomb, switched over
    [r_switch, r_cut]. With subtract=True the energy is negated — that is the
    "minus near" component inside FarNonbondedForce, making near + far == full
    by construction.
    """

    charge: jnp.ndarray = None
    sigma: jnp.ndarray = None
    epsilon: jnp.ndarray = None
    exclusions: jnp.ndarray = None
    r_cut: Any = 0.8
    r_switch: Any = 0.7
    lj_type: jnp.ndarray = None   # (N,) int32 — set with the NBFIX tables
    pair_sigma: Any = None        # (T, T) per-type-pair sigma (NBFIX)
    pair_epsilon: Any = None      # (T, T)
    alpha: float = static_field(default=0.0)  # Coulomb damping [1/nm]
    subtract: bool = static_field(default=False)
    neighbor_key: str = static_field(default="default")
    chunk: int = static_field(default=256)

    def _per_particle(self, globals=None):
        pp = {
            "charge": self.charge,
            "sigma": self.sigma,
            "epsilon": self.epsilon,
        }
        if self.lj_type is not None:
            pp["lj_type"] = self.lj_type
        return pp

    def _pair_fn(self, globals=None):
        r_cut, r_switch, alpha = self.r_cut, self.r_switch, self.alpha
        subtract = self.subtract
        combine = _lj_combiner(self.pair_sigma, self.pair_epsilon)

        def pair(r, pi, pj):
            sigma, epsilon = combine(pi, pj)
            qq = pi["charge"] * pj["charge"]
            return pairfuncs.near_pair_energy(
                r, sigma, epsilon, qq, alpha, r_switch, r_cut, subtract=subtract
            )

        pair.takes_rv = True
        return pair

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)


@pytree_dataclass
class FarNonbondedForce(_PairForceMixin, Force):
    """Complement force for RESPA (atomsmm/forces.py::FarNonbondedForce):
    the full nonbonded force plus the negated near force, so that
    near (group i) + far (group j) == full nonbonded, exactly.

    When both halves share per-particle parameters (the usual case) the two
    pair functions are FUSED into a single tile pass — one sweep over the
    cell-pair candidates instead of two (the near component is exactly zero
    beyond its own cutoff, so the full force's cutoff bounds the pass).
    PME reciprocal/correction terms are added outside the pair pass.
    """

    full: NonbondedForce = None
    minus_near: NearNonbondedForce = None
    # False when a PMEReciprocalForce carries the reciprocal sum at its own
    # (slower) RESPA level (RESPASystem(reciprocal_level=True)); the fast-
    # varying self/exclusion corrections always stay here
    include_reciprocal: bool = static_field(default=True)

    @property
    def chunk(self):
        return self.full.chunk

    @property
    def exclusions(self):
        return self.full.exclusions

    def _fusable(self) -> bool:
        return self.full.charge_scale_mask is None

    def _per_particle(self, globals=None):
        return self.full._per_particle(globals)

    def _pair_fn(self, globals=None):
        pf = self.full._pair_fn(globals)
        pn = self.minus_near._pair_fn(globals)

        def pair(r, pi, pj):
            return pf(r, pi, pj) + pn(r, pi, pj)

        pair.takes_rv = getattr(pf, "takes_rv", False) and getattr(
            pn, "takes_rv", False
        )
        return pair

    def energy(self, x, box, globals, aux=None):
        if not self._fusable():
            e = self.full._nb_energy(
                x, box, globals, aux, self.full.r_cut
            ) + self.minus_near.energy(x, box, globals, aux)
            if self.full.method == "pme":
                e = e + self.full._recip_energy(
                    x, box, globals, self.include_reciprocal, aux=aux
                )
            if self.full.dispersion_coeff is not None:
                e = e + self.full.dispersion_coeff / box_volume(box)
            return e
        e = self._nb_energy(x, box, globals, aux, self.full.r_cut)
        if self.full.method == "pme":
            e = e + self.full._recip_energy(
                x, box, globals, self.include_reciprocal, aux=aux
            )
        if self.full.dispersion_coeff is not None:
            e = e + self.full.dispersion_coeff / box_volume(box)
        return e

    def energy_and_forces(self, x, box, globals, aux=None):
        if not self._fusable():
            e1, f1 = self.full.energy_and_forces(x, box, globals, aux)
            e2, f2 = self.minus_near.energy_and_forces(x, box, globals, aux)
            if self.full.method == "pme" and not self.include_reciprocal:
                # full.energy_and_forces included the reciprocal sum; remove
                # it again (the PMEReciprocalForce carries it)
                q = self.full._effective_charge(globals)
                er, gr = jax.value_and_grad(
                    lambda xx: _pme_reciprocal(
                        xx, box, q, self.full.ewald_alpha,
                        self.full.grid_shape, self.full.spline_order,
                        self.full.spread_block, self.full.spread_cap,
                        self.full.spread_pad,
                        _spread_bucket_from_aux(
                            aux, self.full.grid_shape,
                            self.full.spline_order, self.full.spread_block,
                            self.full.spread_cap, self.full.spread_pad),
                    )
                )(x)
                e1, f1 = e1 - er, f1 + gr
            return e1 + e2, f1 + f2
        e, f = self._nb_energy_forces(x, box, globals, aux, self.full.r_cut)
        if self.full.method == "pme":
            e2, g2 = jax.value_and_grad(
                lambda xx: self.full._recip_energy(
                    xx, box, globals, self.include_reciprocal, aux=aux
                )
            )(x)
            e, f = e + e2, f - g2
        if self.full.dispersion_coeff is not None:
            e = e + self.full.dispersion_coeff / box_volume(box)
        return e, f

    def uses_neighbors(self) -> bool:
        return True


@pytree_dataclass
class PMEReciprocalForce(Force):
    """The PME reciprocal (FFT) sum as its OWN force group, for a third
    RESPA level (Stuart/Berne-style triple split): it is the smoothest
    component of the potential, so it integrates stably at a multiple of
    the far step. Produced by `RESPASystem(..., reciprocal_level=True)`
    together with `FarNonbondedForce(include_reciprocal=False)` — the fast
    self/exclusion corrections stay at the far level."""

    charge: jnp.ndarray = None
    charge_scale_mask: Any = None
    ewald_alpha: float = static_field(default=3.0)
    grid_shape: Tuple[int, int, int] = static_field(default=(0, 0, 0))
    spline_order: int = static_field(default=4)
    charge_scale_name: str = static_field(default="lambda_coul")
    spread_block: Tuple[int, ...] = static_field(default=())
    spread_cap: int = static_field(default=0)
    spread_pad: int = static_field(default=0)

    def _effective_charge(self, globals):
        q = self.charge
        if self.charge_scale_mask is not None:
            lam = (globals or {}).get(self.charge_scale_name, 1.0)
            q = q * (1.0 - self.charge_scale_mask * (1.0 - lam))
        return q

    def energy(self, x, box, globals, aux=None):
        return _pme_reciprocal(
            x, box, self._effective_charge(globals), self.ewald_alpha,
            self.grid_shape, self.spline_order,
            self.spread_block, self.spread_cap, self.spread_pad,
            _spread_bucket_from_aux(
                aux, self.grid_shape, self.spline_order,
                self.spread_block, self.spread_cap, self.spread_pad),
        )

    def energy_and_forces(self, x, box, globals, aux=None):
        e, g = jax.value_and_grad(
            lambda xx: self.energy(xx, box, globals, aux)
        )(x)
        return e, -g


def _pme_carrier(force):
    """The force (possibly nested under .full) that owns a PME direct-space
    cutoff + static grid, or None."""
    g = force
    while (getattr(g, "method", None) != "pme"
           and getattr(g, "full", None) is not None):
        g = g.full
    if getattr(g, "method", None) != "pme":
        return None
    if not any(getattr(g, "grid_shape", (0, 0, 0))):
        return None
    return g


def pme_coverage_flags(system, extra, x, box):
    """Sticky per-force flags: the box has grown past the validity bound of
    a PME force's STATIC (alpha, grid) — the reciprocal analog of the cell
    list's coverage_deficient guard (VERDICT r3 #7).

    alpha depends only on (r_cut, tol) and stays valid under volume moves;
    the grid rule K >= factor * 2 alpha L / (3 tol^0.2) inverts to a
    per-dimension max box length. tol is recovered from the openmm alpha
    heuristic, traced so NPT box changes are checked every step on device
    at the cost of three comparisons. Checked/raised by Context.step.
    """
    from .ops.pme import _ORDER_SPACING_FACTOR

    out = {}
    b = jnp.asarray(box)
    lengths = b if b.ndim == 1 else jnp.linalg.norm(b, axis=1)
    for idx, f in enumerate(system.forces):
        g = _pme_carrier(f)
        if g is None:
            continue
        alpha = float(g.ewald_alpha)
        order = int(g.spline_order)
        factor = _ORDER_SPACING_FACTOR.get(order, 1.0 if order < 4 else 0.65)
        # r_cut is traced (a runtime buffer of the system argument)
        tol = 0.5 * jnp.exp(-((alpha * g.r_cut) ** 2))
        bounds = (jnp.asarray(g.grid_shape, lengths.dtype) * 3.0
                  * tol ** 0.2 / (2.0 * alpha * factor))
        # 5% grace: the grid rule inverts to tol_eff = tol (L/L_max)^5, so
        # tripping at 1.05 L_max means tol_eff <= 1.28 tol — far inside the
        # measured 3.6x accuracy margin of the order-6 spacing factor
        # (tools/pme_order_study.py). Without grace, _good_fft_size
        # rounding can leave <1% headroom and normal 1-bar fluctuations of
        # small boxes trip a false alarm.
        key = f"pme_{idx}_undercover"
        prev = extra.get(key, jnp.zeros((), bool))
        out[key] = prev | jnp.any(lengths > 1.05 * bounds)
        if g.spread_block and not g.spread_pad:
            # block-binned spreading drops atoms beyond the per-block
            # capacity; flagged-never-silent (one bincount per step).
            # (With spread_pad >= 1 the bucket is FROZEN, so capacity
            # matters only at build time — update_pme_spread carries that
            # flag; a fresh-binning check here would false-positive on
            # transiently overfull blocks that drop nothing.)
            from .ops.pme import spread_block_overflow

            okey = f"pme_{idx}_spread_overflow"
            oprev = extra.get(okey, jnp.zeros((), bool))
            out[okey] = oprev | spread_block_overflow(
                x, box, g.grid_shape, order, g.spread_block, g.spread_cap)
    return out


def _spread_layouts(system):
    """Unique amortized spreading layouts in `system`:
    {sig: (grid_shape, order, block, cap, pad)} over every PME carrier and
    PMEReciprocalForce with spread_pad >= 1."""
    layouts = {}
    for f in system.forces:
        g = _pme_carrier(f)
        if g is None and isinstance(f, PMEReciprocalForce):
            g = f
        if g is None or not g.spread_block or not g.spread_pad:
            continue
        sig = _spread_sig(g.grid_shape, int(g.spline_order),
                          g.spread_block, int(g.spread_cap),
                          int(g.spread_pad))
        layouts[sig] = (g.grid_shape, int(g.spline_order), g.spread_block,
                        int(g.spread_cap), int(g.spread_pad))
    return layouts


def _spread_keys(sig):
    return (f"pmesp_{sig}_bucket", f"pmesp_{sig}_x", f"pmesp_{sig}_box",
            f"pme_{sig}_spread_overflow", f"pme_{sig}_spread_stale")


def pme_spread_extras(system, x, box):
    """Initial State.extra entries for every amortized spreading bucket
    (spread_pad >= 1): the frozen bucket, its reference configuration, and
    the sticky build-overflow / drift-staleness flags. The Context seeds
    these at construction and maintains them via update_pme_spread — the
    PME analog of ops.neighbors.all_neighbor_extras."""
    from .ops.pme import build_spread_bucket

    out = {}
    for sig, (gs, order, block, cap, pad) in _spread_layouts(system).items():
        kb, kx, kbox, kov, kst = _spread_keys(sig)
        bucket, overflow = build_spread_bucket(x, box, gs, order, block, cap)
        out[kb] = bucket
        out[kx] = x
        out[kbox] = jnp.asarray(box)
        out[kov] = overflow
        out[kst] = jnp.zeros((), bool)
    return out


def update_pme_spread(system, extra, x, box, force: bool = False):
    """Conditionally rebuild every amortized spreading bucket (lax.cond —
    static shapes both ways), mirroring ops.neighbors.update_neighbors:
    trigger = some atom drifted beyond pad/2 grid cells since the reference
    build, or the box changed; force=True rebuilds unconditionally (grouped
    update loops use it at group boundaries).

    Like update_all_neighbors, this NEVER samples the exact-drift staleness
    bound: sampling belongs after integration steps (pme_spread_stale_flags
    in Context's grouped loop), where a violation means forces actually ran
    against a stale bucket. Sampling here would instead flag legitimate
    teleports — set_positions / a run-start reference refresh — whose
    rebuild happens before any force evaluation uses the bucket
    (ADVICE r4 medium). The sticky flag passes through unchanged.

    The rebuild branch holds a bucket SORT inside a rarely-taken lax.cond;
    the path is exactness-tested on CPU with sticky drift/overflow guards
    on top. bench/production leave spread_pad=0 (no cond, fresh bucket
    per step); whether amortizing pays on the GPU is unmeasured."""
    from .ops.pme import (
        build_spread_bucket,
        spread_bucket_rebuild_trigger,
    )

    out = {}
    for sig, (gs, order, block, cap, pad) in _spread_layouts(system).items():
        kb, kx, kbox, kov, kst = _spread_keys(sig)
        if kb not in extra:
            continue
        ref_x, ref_box = extra[kx], extra[kbox]
        ov_prev = extra[kov]
        stale = extra[kst]

        def rebuild(_, gs=gs, order=order, block=block, cap=cap,
                    ov_prev=ov_prev):
            bucket, ov = build_spread_bucket(x, box, gs, order, block, cap)
            return bucket, x, jnp.asarray(box), ov_prev | ov

        def keep(_, kb=kb, ref_x=ref_x, ref_box=ref_box, ov_prev=ov_prev):
            return extra[kb], ref_x, ref_box, ov_prev

        if force:
            bucket, xr, br, ov = rebuild(None)
        else:
            bucket, xr, br, ov = jax.lax.cond(
                spread_bucket_rebuild_trigger(x, box, gs, pad, ref_x,
                                              ref_box),
                rebuild, keep, None)
        out[kb], out[kx], out[kbox], out[kov], out[kst] = (
            bucket, xr, br, ov, stale)
    return out


def pme_spread_stale_flags(system, extra, x, box):
    """Sticky exact-drift flags only (no rebuild) — sampled after every
    step inside grouped update loops, the PME analog of
    ops.neighbors.staleness_flags."""
    from .ops.pme import spread_stale_exceeded

    out = {}
    for sig, (gs, order, block, cap, pad) in _spread_layouts(system).items():
        kb, kx, kbox, kov, kst = _spread_keys(sig)
        if kst not in extra:
            continue
        out[kst] = extra[kst] | spread_stale_exceeded(
            x, box, gs, order, block, pad, extra[kx], extra[kbox])
    return out


def retune_pme_spread(system, x, box, safety: float = 1.3, pad: int = 0):
    """Enable/retune block-binned PME charge spreading
    (ops/pme.py::spread_charges_blocked) from measured block occupancy at
    the given configuration — the PME analog of retune_neighbor_specs.
    Returns a system with every PME carrier (and any companion
    PMEReciprocalForce sharing its alpha) switched to the cheapest blocked
    layout, or unchanged forces where blocking cannot beat the dense
    one-hot path (small grids).

    pad >= 1 additionally AMORTIZES the bucket across steps
    (ops/pme.py::spread_charges_stale): spreading windows are padded by
    `pad` grid cells each side and the bucket is rebuilt only when some
    atom drifts beyond pad/2 cells (a Verlet-skin cadence — typically tens
    of steps at 300 K production grids, vs every step at pad=0), at the
    cost of ((B+s+2 pad)/(B+s))^3 more spreading MACs. Requires running
    under a Context (it owns the bucket lifecycle: seeding, conditional
    rebuilds, drift guards); direct energy calls outside a Context fall
    back to per-step fresh buckets and stay exact."""
    from .ops.pme import choose_spread_blocks

    chosen = {}  # alpha -> (block, cap)
    new_forces = []
    for f in system.forces:
        g = _pme_carrier(f)
        if g is None:
            new_forces.append(f)
            continue
        block, cap = choose_spread_blocks(
            g.grid_shape, int(g.spline_order), int(x.shape[0]),
            x=x, box=box, safety=safety, pad=pad)
        if block is None:
            new_forces.append(f)
            continue
        chosen[float(g.ewald_alpha)] = (block, cap)
        changes = {"spread_block": block, "spread_cap": cap,
                   "spread_pad": pad}
        if g is f:
            new_forces.append(replace(f, **changes))
        else:  # Far wrapper: the carrier is the nested full force
            new_forces.append(replace(f, full=replace(f.full, **changes)))
    new_forces = [
        replace(f, spread_block=chosen[float(f.ewald_alpha)][0],
                spread_cap=chosen[float(f.ewald_alpha)][1],
                spread_pad=pad)
        if isinstance(f, PMEReciprocalForce)
        and float(f.ewald_alpha) in chosen else f
        for f in new_forces
    ]
    return system.replace_forces(new_forces)


@pytree_dataclass
class DampedSmoothedForce(_PairForceMixin, Force):
    """Damped-shifted Coulomb + LJ, smoothed over [r_switch, r_cut]
    (atomsmm/forces.py::DampedSmoothedForce; Fennell & Gezelter JCP 2006)."""

    charge: jnp.ndarray = None
    sigma: jnp.ndarray = None
    epsilon: jnp.ndarray = None
    exclusions: jnp.ndarray = None
    r_cut: Any = 1.0
    r_switch: Any = 0.9
    alpha: float = static_field(default=2.0)
    chunk: int = static_field(default=256)

    def _per_particle(self, globals=None):
        return {
            "charge": self.charge,
            "sigma": self.sigma,
            "epsilon": self.epsilon,
        }

    def _pair_fn(self, globals=None):
        r_cut, r_switch, alpha = self.r_cut, self.r_switch, self.alpha

        def pair(r, pi, pj):
            sigma, epsilon = pairfuncs.lorentz_berthelot(
                pi["sigma"], pj["sigma"], pi["epsilon"], pj["epsilon"]
            )
            qq = pi["charge"] * pj["charge"]
            return pairfuncs.damped_smoothed_energy(
                r, sigma, epsilon, qq, alpha, r_switch, r_cut
            )

        pair.takes_rv = True
        return pair

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)


@pytree_dataclass
class SoftcoreLennardJonesForce(_PairForceMixin, Force):
    """Beutler softcore LJ between an interaction group (solute <-> solvent),
    scaled by the global parameter `lambda_vdw`
    (atomsmm/forces.py::SoftcoreLennardJonesForce).
    """

    sigma: jnp.ndarray = None
    epsilon: jnp.ndarray = None
    solute: jnp.ndarray = None  # (N,) {0,1} indicator
    exclusions: jnp.ndarray = None
    r_cut: Any = 1.0
    r_switch: Any = 0.9
    use_switch: bool = static_field(default=True)
    lambda_name: str = static_field(default="lambda_vdw")
    chunk: int = static_field(default=256)

    def _per_particle(self, globals=None):
        return {
            "sigma": self.sigma,
            "epsilon": self.epsilon,
            "solute": self.solute,
        }

    def _pair_fn(self, globals=None):
        lamb = (globals or {}).get(self.lambda_name, 1.0)
        r_cut, r_switch, use_switch = self.r_cut, self.r_switch, self.use_switch

        def pair(r, pi, pj):
            sigma, epsilon = pairfuncs.lorentz_berthelot(
                pi["sigma"], pj["sigma"], pi["epsilon"], pj["epsilon"]
            )
            u = pairfuncs.softcore_lj(r, sigma, epsilon, lamb)
            if use_switch:
                from .ops.switching import switch_quintic

                rr = r.r if isinstance(r, pairfuncs.Rv) else r
                u = u * switch_quintic(rr, r_switch, r_cut)
            # interaction group: exactly one of (i, j) in the solute set
            cross = pi["solute"] + pj["solute"] - 2.0 * pi["solute"] * pj["solute"]
            return u * cross

        pair.takes_rv = True
        return pair

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)


@pytree_dataclass
class CustomNonbondedForce(_PairForceMixin, Force):
    """Arbitrary pair potential: `energy_function(r, pi, pj, globals)` plays
    the role of an openmm.CustomNonbondedForce Lepton string (JAX tracing
    replaces Lepton — SURVEY.md §2b N2). per_particle maps parameter name to
    an (N,) array, gathered into pi/pj dicts per pair."""

    per_particle: Dict[str, jnp.ndarray] = None
    exclusions: jnp.ndarray = None
    r_cut: Any = 1.0
    energy_function: Callable = static_field(default=None)
    chunk: int = static_field(default=256)

    def _per_particle(self, globals=None):
        return self.per_particle

    def _pair_fn(self, globals=None):
        fn = self.energy_function
        g = globals or {}

        def pair(r, pi, pj):
            return fn(r, pi, pj, g)

        return pair

    def energy(self, x, box, globals, aux=None):
        return self._nb_energy(x, box, globals, aux, self.r_cut)

    def energy_and_forces(self, x, box, globals, aux=None):
        return self._nb_energy_forces(x, box, globals, aux, self.r_cut)


@pytree_dataclass
class CustomBondForce(Force):
    """Arbitrary bond-pair potential over an explicit pair list."""

    pairs: jnp.ndarray = None
    per_bond: Dict[str, jnp.ndarray] = None
    valid: jnp.ndarray = None
    energy_function: Callable = static_field(default=None)

    def energy(self, x, box, globals, aux=None):
        fn = self.energy_function
        g = globals or {}

        def pair(r, params):
            return fn(r, params, g)

        return pairlist_energy(pair, x, box, self.pairs, self.per_bond, self.valid)


@pytree_dataclass
class MonteCarloBarostat(Force):
    """Marker force mirroring openmm.MonteCarloBarostat: contributes no
    energy; Context detects it and drives MC volume moves through
    integrate/barostat.py::MonteCarloBarostatPropagator after each step."""

    pressure: Any = 1.0     # bar
    temperature: Any = 300.0
    frequency: int = static_field(default=25)

    def energy(self, x, box, globals, aux=None):
        return jnp.zeros((), x.dtype)


# --------------------------------------------------------------------------
# Bonded forces
# --------------------------------------------------------------------------


@pytree_dataclass
class TemplateBondedForce(Force):
    """Bonds + angles for systems of IDENTICAL, contiguously-indexed
    molecules (e.g. a water box): positions reshape to (M, A, 3) and every
    template term indexes with STATIC local atom indices, so XLA lowers the
    gathers (and their adjoints) to slices instead of row gathers — the
    innermost RESPA group evaluates most often, making this the cheap path.
    Equivalent energy to HarmonicBondForce + HarmonicAngleForce.
    """

    bond_r0: jnp.ndarray = None    # (B,) template bond lengths
    bond_k: jnp.ndarray = None     # (B,)
    angle_t0: jnp.ndarray = None   # (A,)
    angle_k: jnp.ndarray = None    # (A,)
    first_atom: int = static_field(default=0)
    n_molecules: int = static_field(default=0)
    atoms_per_molecule: int = static_field(default=3)
    bond_idx: Tuple = static_field(default=())   # ((a, b), ...) local indices
    angle_idx: Tuple = static_field(default=())  # ((i, j, k), ...) j central

    def energy(self, x, box, globals, aux=None):
        m, a_pm = self.n_molecules, self.atoms_per_molecule
        lo = self.first_atom
        xm = x[lo : lo + m * a_pm].reshape(m, a_pm, 3)
        e = jnp.zeros((), x.dtype)
        for t, (i, j) in enumerate(self.bond_idx):
            d = xm[:, i] - xm[:, j]
            r = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-32)
            e = e + jnp.sum(0.5 * self.bond_k[t] * (r - self.bond_r0[t]) ** 2)
        for t, (i, j, k) in enumerate(self.angle_idx):
            va = xm[:, i] - xm[:, j]
            vb = xm[:, k] - xm[:, j]
            na = jnp.sqrt(jnp.sum(va * va, axis=-1) + 1e-32)
            nb = jnp.sqrt(jnp.sum(vb * vb, axis=-1) + 1e-32)
            ct = jnp.clip(jnp.sum(va * vb, axis=-1) / (na * nb),
                          -1.0 + 1e-7, 1.0 - 1e-7)
            theta = jnp.arccos(ct)
            e = e + jnp.sum(
                0.5 * self.angle_k[t] * (theta - self.angle_t0[t]) ** 2
            )
        return e


@pytree_dataclass
class HarmonicBondForce(Force):
    """E = sum 0.5 k (r - r0)^2 (openmm.HarmonicBondForce; pad with k = 0)."""

    idx: jnp.ndarray = None  # (B, 2)
    r0: jnp.ndarray = None
    k: jnp.ndarray = None

    def energy(self, x, box, globals, aux=None):
        return harmonic_bond_energy(x, self.idx, self.r0, self.k)


@pytree_dataclass
class HarmonicAngleForce(Force):
    """E = sum 0.5 k (theta - theta0)^2 (openmm.HarmonicAngleForce)."""

    idx: jnp.ndarray = None  # (A, 3)
    theta0: jnp.ndarray = None
    k: jnp.ndarray = None

    def energy(self, x, box, globals, aux=None):
        return harmonic_angle_energy(x, self.idx, self.theta0, self.k)


@pytree_dataclass
class PeriodicTorsionForce(Force):
    """E = sum k (1 + cos(n phi - phase)) (openmm.PeriodicTorsionForce)."""

    idx: jnp.ndarray = None  # (T, 4)
    periodicity: jnp.ndarray = None
    phase: jnp.ndarray = None
    k: jnp.ndarray = None

    def energy(self, x, box, globals, aux=None):
        return periodic_torsion_energy(
            x, self.idx, self.periodicity, self.phase, self.k
        )


@pytree_dataclass
class CMAPTorsionForce(Force):
    """CHARMM CMAP cross-term: a periodic bicubic correction surface over
    the (phi, psi) dihedral pair of 5 consecutive atoms (ops/cmap.py).
    `table` is the precomputed (T, n, n, 4) value+derivative tensor from
    `ops.cmap.build_cmap_table` [kJ/mol]."""

    idx: jnp.ndarray = None         # (C, 5) atoms i,j,k,l,m
    type_index: jnp.ndarray = None  # (C,) int32 into table
    table: jnp.ndarray = None       # (T, n, n, 4)

    def energy(self, x, box, globals, aux=None):
        from .ops.cmap import cmap_energy

        return cmap_energy(x, self.idx, self.type_index, self.table)


@pytree_dataclass
class HarmonicImproperForce(Force):
    """CHARMM-style harmonic improper torsion E = k (phi - phi0)^2 with the
    difference wrapped to (-pi, pi] — the CHAMBER prmtop improper term
    (k carries no 1/2, the CHARMM convention)."""

    idx: jnp.ndarray = None   # (I, 4)
    phi0: jnp.ndarray = None  # (I,) [rad]
    k: jnp.ndarray = None     # (I,) [kJ/mol/rad^2]

    def energy(self, x, box, globals, aux=None):
        from .ops.bonded import harmonic_improper_energy

        return harmonic_improper_energy(x, self.idx, self.phi0, self.k)


@pytree_dataclass
class DrudeForce(Force):
    """Drude-oscillator polarizability terms (ops/drude.py): core-Drude
    restoring springs plus Thole-screened dipole-dipole interactions between
    bonded-neighbor dipoles — the counterpart of OpenMM's
    ``DrudeForce`` on the reference's substrate (SURVEY.md §2b input
    breadth). The Drude particles' Coulomb interactions with everything
    else ride the regular NonbondedForce/PME path (they are ordinary
    charged particles there); this force adds only the polarizability-
    specific terms. Bond-like range — belongs in the innermost RESPA group.
    """

    drude: object = None  # ops.drude.DrudeSet

    def energy(self, x, box, globals, aux=None):
        from .ops.drude import drude_spring_energy, thole_screening_energy

        e = drude_spring_energy(self.drude, x)
        if self.drude.num_screened:
            e = e + thole_screening_energy(self.drude, x, box)
        return e
