"""AMBER prmtop / inpcrd readers producing our ``System`` pytree.

Counterpart of the reference's input path: atomsmm builds every test system by
``openmm.app.AmberPrmtopFile(...).createSystem(...)`` +
``AmberInpcrdFile(...)`` (SURVEY.md §2a Tests row, §3.1). Here the parsing is
plain numpy and the output is our native ``System`` — no OpenMM object model
in between.

Format notes (AMBER file formats specification, ambermd.org/FileFormats.php):

* A prmtop is a sequence of ``%FLAG <NAME>`` sections, each with a
  ``%FORMAT(<count><kind><width>[.<prec>])`` line followed by fixed-width data
  records. Kinds: ``I`` int, ``E``/``F`` float, ``a`` string.
* Unit system is Å / kcal/mol / radians, charges pre-multiplied by
  18.2223 = sqrt(332.0522 kcal Å/mol/e²). We convert to the package units
  (nm, kJ/mol, e — units.py) at parse time.
* Energy conventions: AMBER stores bonds/angles as ``k (b - b0)^2`` — twice
  our (OpenMM's) ``k/2 (b - b0)^2`` constant — and torsions as
  ``k (1 + cos(n phi - phase))``, which matches our PeriodicTorsionForce
  directly.
* Bond/angle/dihedral atom entries are ``3 * atom_index``; in dihedrals a
  negative third atom flags "skip the 1-4 pair" (multi-term Fourier series
  and rings) and a negative fourth atom flags an improper.
* LJ is tabulated pairwise (ACOEF/BCOEF via NONBONDED_PARM_INDEX); we
  recover per-type (sigma, epsilon) from the diagonal. When the
  off-diagonal deviates from Lorentz-Berthelot (NBFIX / LJEDIT ion-pair
  overrides), the FULL per-type-pair tables are carried onto the
  NonbondedForce (lj_type + pair_sigma/pair_epsilon) and the pair sweeps
  gather per-pair parameters instead of combining — including the 1-4
  exception values and the dispersion tail.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..utils import InputError

# sqrt(332.0522173 kcal A / (mol e^2)) — AMBER's internal charge unit
_AMBER_CHARGE = 18.2223
_KCAL = 4.184  # kJ per kcal
# AMBER restart velocities are in A per (1/20.455) ps
_AMBER_VEL = 0.1 * 20.455  # -> nm/ps

_FORMAT_RE = re.compile(r"%FORMAT\(\s*(\d*)\s*([aIEFiefg])\s*(\d+)(?:\.\d+)?\s*\)")


def _parse_prmtop_sections(text: str) -> dict:
    """Split prmtop text into {FLAG: list-of-values} honoring fixed widths."""
    sections = {}
    flag, width, kind = None, None, None
    values: list = []
    for line in text.splitlines():
        if line.startswith("%VERSION"):
            continue
        if line.startswith("%FLAG"):
            if flag is not None:
                sections[flag] = values
            flag = line.split()[1].strip()
            values = []
            width = kind = None
            continue
        if line.startswith("%FORMAT"):
            m = _FORMAT_RE.match(line.strip())
            if not m:
                raise InputError(f"unparseable prmtop format line: {line!r}")
            kind = m.group(2).lower()
            width = int(m.group(3))
            continue
        if line.startswith("%COMMENT") or flag is None:
            continue
        # fixed-width chop (atom/residue names may be blank-padded)
        for start in range(0, len(line.rstrip("\n")), width):
            tok = line[start : start + width]
            if not tok.strip() and kind != "a":
                continue
            if kind == "i":
                values.append(int(tok))
            elif kind in ("e", "f", "g"):
                values.append(float(tok.replace("D", "E").replace("d", "e")))
            else:
                values.append(tok.strip())
    if flag is not None:
        sections[flag] = values
    return sections


@dataclass
class AmberPrmtop:
    """Parsed prmtop, already converted to package units (nm, kJ/mol, e).

    Arrays are numpy; ``amber_system`` turns this into a ``System`` pytree.
    """

    natom: int
    charge: np.ndarray        # (N,) [e]
    mass: np.ndarray          # (N,) [amu]
    sigma: np.ndarray         # (N,) [nm]
    epsilon: np.ndarray       # (N,) [kJ/mol]
    atom_name: list
    residue_label: list       # per-residue
    residue_first_atom: np.ndarray  # (R,) 0-based first atom of each residue
    bonds: np.ndarray         # (B, 2) int32
    bond_r0: np.ndarray       # (B,) [nm]
    bond_k: np.ndarray        # (B,) [kJ/mol/nm^2], 1/2 k (r-r0)^2 convention
    angles: np.ndarray        # (A, 3) int32 (central atom second)
    angle_t0: np.ndarray      # (A,) [rad]
    angle_k: np.ndarray       # (A,) [kJ/mol/rad^2], 1/2 k convention
    torsions: np.ndarray      # (T, 4) int32
    torsion_periodicity: np.ndarray  # (T,) int32
    torsion_phase: np.ndarray        # (T,) [rad]
    torsion_k: np.ndarray            # (T,) [kJ/mol]
    pairs14: np.ndarray       # (P, 2) int32 unique 1-4 pairs
    scee: np.ndarray          # (P,) electrostatic 1-4 divisor
    scnb: np.ndarray          # (P,) LJ 1-4 divisor
    box: np.ndarray | None = None      # (3,) [nm] if IFBOX and BOX_DIMENSIONS
    molecule: np.ndarray = field(default=None)  # (N,) connected component id
    # NBFIX: set only when the LJ matrix deviates from Lorentz-Berthelot —
    # full per-type-pair tables + the per-atom type index
    lj_type: np.ndarray | None = None       # (N,) int32
    pair_sigma: np.ndarray | None = None    # (T, T) [nm]
    pair_epsilon: np.ndarray | None = None  # (T, T) [kJ/mol]
    # legacy 10-12 hydrogen bonds (negative parm-index slots)
    pair_a1012: np.ndarray | None = None    # (T, T) [kJ/mol nm^12]
    pair_b1012: np.ndarray | None = None    # (T, T) [kJ/mol nm^10]
    # CHAMBER extras (CHARMM force fields in AMBER format)
    ub_pairs: np.ndarray = field(default=None)   # (U, 2) Urey-Bradley 1-3
    ub_r0: np.ndarray = field(default=None)      # (U,) [nm]
    ub_k: np.ndarray = field(default=None)       # (U,) [kJ/mol/nm^2], 1/2 k
    imp_idx: np.ndarray = field(default=None)    # (I, 4) harmonic impropers
    imp_phi0: np.ndarray = field(default=None)   # (I,) [rad]
    imp_k: np.ndarray = field(default=None)      # (I,) [kJ/mol/rad^2], no 1/2
    pairs14_sigma: np.ndarray | None = None      # (P,) CHARMM 1-4 LJ tables
    pairs14_eps: np.ndarray | None = None        # (P,)
    cmap_idx: np.ndarray | None = None           # (C, 5) CMAP atom quintets
    cmap_type: np.ndarray | None = None          # (C,)
    cmap_table: np.ndarray | None = None         # (T, n, n, 4) [kJ/mol]
    # further (idx, type, table) groups when the prmtop mixes CMAP grid
    # resolutions — each group gets its own stacked CMAPTorsionForce
    cmap_extra: list | None = None
    # TIP4P-style extra points, classified into virtual sites (the frame
    # "bonds"/"angles" stay in the bond/angle lists for exclusion derivation
    # and are filtered out of the bonded FORCES by amber_system)
    vs_sites: np.ndarray | None = None      # (V,) int32
    vs_parents: np.ndarray | None = None    # (V, 3) int32 (O, H1, H2)
    vs_weights: np.ndarray | None = None    # (V, 3)
    vs_oop: np.ndarray | None = None        # (V,) out-of-plane coefficient

    @property
    def num_molecules(self) -> int:
        return int(self.molecule.max()) + 1 if self.natom else 0

    def exclusion_pairs(self):
        """1-2, 1-3 and 1-4 pairs (all fully excluded from the plain nonbonded
        force; the 1-4s re-enter scaled through NonbondedExceptionsForce —
        mirrors the reference's fastExceptions idiom, SURVEY.md §3.1)."""
        neigh = [set() for _ in range(self.natom)]
        for i, j in self.bonds:
            neigh[i].add(int(j))
            neigh[j].add(int(i))
        pairs = set()
        for i in range(self.natom):
            for j in neigh[i]:            # 1-2
                if i < j:
                    pairs.add((i, j))
                for k in neigh[j]:        # 1-3
                    if k != i:
                        pairs.add((min(i, k), max(i, k)))
        for i, j in self.pairs14:         # 1-4
            pairs.add((min(int(i), int(j)), max(int(i), int(j))))
        return sorted(pairs)


def read_prmtop(path_or_text) -> AmberPrmtop:
    """Parse a prmtop file (path, or raw text containing ``%FLAG``)."""
    text = str(path_or_text)
    if "%FLAG" not in text:
        with open(path_or_text) as fh:
            text = fh.read()
    s = _parse_prmtop_sections(text)
    try:
        ptr = s["POINTERS"]
    except KeyError:
        raise InputError("not a prmtop: missing %FLAG POINTERS")
    for req in ("CHARGE", "MASS", "ATOM_TYPE_INDEX", "NONBONDED_PARM_INDEX",
                "LENNARD_JONES_ACOEF", "LENNARD_JONES_BCOEF"):
        if req not in s:
            raise InputError(f"prmtop is missing required %FLAG {req}")
    # explicit rejections for formats/features this reader would otherwise
    # silently mis-parse (VERDICT r2 weak #7): refuse, name the feature
    chamber = "CTITLE" in s or any(k.startswith("CHARMM") for k in s)
    if "POLARIZABILITY" in s or (s.get("IPOL") and s["IPOL"][0]):
        raise InputError("polarizable prmtop (IPOL/POLARIZABILITY) is not supported")
    natom, ntypes = ptr[0], ptr[1]
    # 10-12 hydrogen-bond slots (negative NONBONDED_PARM_INDEX entries) are
    # supported: their A/B coefficients become per-type-pair tables below.
    # NUMEXTRA / zero-mass atoms: TIP4P-style extra points are supported
    # (classified into virtual sites after the bond lists are parsed);
    # anything that does not match the single-parent water-EP pattern still
    # raises a clear error below.
    nbonh, nbona = ptr[2], ptr[12]
    ntheth, ntheta = ptr[4], ptr[13]
    nphih, nphia = ptr[6], ptr[14]
    nptra = ptr[17]
    ifbox = ptr[20] if len(ptr) > 20 else 0

    charge = np.asarray(s["CHARGE"][:natom]) / _AMBER_CHARGE
    mass = np.asarray(s["MASS"][:natom])

    # per-type LJ from the diagonal of the pairwise table
    type_idx = np.asarray(s["ATOM_TYPE_INDEX"][:natom], dtype=np.int64) - 1
    nb_parm = np.asarray(s["NONBONDED_PARM_INDEX"], dtype=np.int64)
    acoef = np.asarray(s["LENNARD_JONES_ACOEF"])
    bcoef = np.asarray(s["LENNARD_JONES_BCOEF"])

    def _pair_ab(ti, tj):
        k = nb_parm[ntypes * ti + tj] - 1
        if k < 0:  # 10-12 hydrogen-bond slot — obsolete, treat as zero LJ
            return 0.0, 0.0
        return acoef[k], bcoef[k]

    sig_t = np.full(ntypes, 0.1)  # harmless placeholder for eps = 0 types
    eps_t = np.zeros(ntypes)
    for t in range(ntypes):
        a, b = _pair_ab(t, t)
        if a > 0.0 and b > 0.0:
            sig_t[t] = (a / b) ** (1.0 / 6.0) * 0.1
            eps_t[t] = b * b / (4.0 * a) * _KCAL
    # NBFIX detection: when any off-diagonal deviates from Lorentz-Berthelot
    # (LJEDIT / ion-pair overrides), carry the FULL per-type-pair tables —
    # the pair sweeps then gather (sigma, epsilon) per (type_i, type_j)
    # instead of combining (forces._lj_combiner)
    nbfix = False
    has_hb = False
    pair_sig = np.full((ntypes, ntypes), 0.1)
    pair_eps = np.zeros((ntypes, ntypes))
    hb_a = np.zeros((ntypes, ntypes))
    hb_b = np.zeros((ntypes, ntypes))
    acoef_hb = np.asarray(s.get("HBOND_ACOEF", []))
    bcoef_hb = np.asarray(s.get("HBOND_BCOEF", []))
    for ti in range(ntypes):
        for tj in range(ntypes):
            raw = int(nb_parm[ntypes * ti + tj])
            if raw < 0:  # legacy 10-12 hydrogen-bond slot
                kk = -raw - 1
                a_12 = float(acoef_hb[kk]) if kk < len(acoef_hb) else 0.0
                b_10 = float(bcoef_hb[kk]) if kk < len(bcoef_hb) else 0.0
                if a_12 != 0.0 or b_10 != 0.0:
                    # kcal A^12 -> kJ nm^12 and kcal A^10 -> kJ nm^10
                    hb_a[ti, tj] = a_12 * _KCAL * 1e-12
                    hb_b[ti, tj] = b_10 * _KCAL * 1e-10
                    has_hb = True
            a, b = _pair_ab(ti, tj)
            if a > 0.0 and b > 0.0:
                pair_sig[ti, tj] = (a / b) ** (1.0 / 6.0) * 0.1
                pair_eps[ti, tj] = b * b / (4.0 * a) * _KCAL
            if tj <= ti or eps_t[ti] == 0.0 or eps_t[tj] == 0.0:
                continue
            sig = 0.5 * (sig_t[ti] + sig_t[tj]) * 10.0  # back to A
            eps = np.sqrt(eps_t[ti] * eps_t[tj]) / _KCAL
            a_lb, b_lb = 4 * eps * sig**12, 4 * eps * sig**6
            if abs(a - a_lb) > 1e-4 * max(a, 1.0) or abs(b - b_lb) > 1e-6 * max(b, 1.0):
                nbfix = True
    # 10-12 terms need the per-type tables/gathers too (the LJ part of the
    # table is then exact LB, so carrying it is free)
    need_tables = nbfix or has_hb
    sigma = sig_t[type_idx]
    epsilon = eps_t[type_idx]

    # bonds / angles / dihedrals: merge the with-H and without-H lists
    def _terms(flag_h, flag_a, n_h, n_a, arity):
        raw = np.asarray(
            s.get(flag_h, [])[: n_h * (arity + 1)]
            + s.get(flag_a, [])[: n_a * (arity + 1)],
            dtype=np.int64,
        ).reshape(-1, arity + 1)
        return raw

    braw = _terms("BONDS_INC_HYDROGEN", "BONDS_WITHOUT_HYDROGEN", nbonh, nbona, 2)
    bond_rk = np.asarray(s.get("BOND_FORCE_CONSTANT", []))
    bond_req = np.asarray(s.get("BOND_EQUIL_VALUE", []))
    bonds = (braw[:, :2] // 3).astype(np.int32)
    bt = braw[:, 2] - 1
    bond_r0 = bond_req[bt] * 0.1 if len(braw) else np.zeros(0)
    bond_k = bond_rk[bt] * 2.0 * _KCAL * 100.0 if len(braw) else np.zeros(0)

    araw = _terms("ANGLES_INC_HYDROGEN", "ANGLES_WITHOUT_HYDROGEN", ntheth, ntheta, 3)
    ang_tk = np.asarray(s.get("ANGLE_FORCE_CONSTANT", []))
    ang_teq = np.asarray(s.get("ANGLE_EQUIL_VALUE", []))
    angles = (araw[:, :3] // 3).astype(np.int32)
    at = araw[:, 3] - 1
    angle_t0 = ang_teq[at] if len(araw) else np.zeros(0)
    angle_k = ang_tk[at] * 2.0 * _KCAL if len(araw) else np.zeros(0)

    draw = _terms(
        "DIHEDRALS_INC_HYDROGEN", "DIHEDRALS_WITHOUT_HYDROGEN", nphih, nphia, 4
    )
    dih_k = np.asarray(s.get("DIHEDRAL_FORCE_CONSTANT", []))
    dih_n = np.asarray(s.get("DIHEDRAL_PERIODICITY", []))
    dih_ph = np.asarray(s.get("DIHEDRAL_PHASE", []))
    scee_t = np.asarray(s.get("SCEE_SCALE_FACTOR", [1.2] * nptra))
    scnb_t = np.asarray(s.get("SCNB_SCALE_FACTOR", [2.0] * nptra))
    torsions = np.abs(draw[:, :4]).astype(np.int32) // 3 if len(draw) else np.zeros((0, 4), np.int32)
    dt_ = draw[:, 4] - 1 if len(draw) else np.zeros(0, np.int64)
    torsion_k = dih_k[dt_] * _KCAL if len(draw) else np.zeros(0)
    torsion_n = np.rint(dih_n[dt_]).astype(np.int32) if len(draw) else np.zeros(0, np.int32)
    torsion_phase = dih_ph[dt_] if len(draw) else np.zeros(0)

    # 1-4 pairs: proper torsions whose third AND fourth entries are >= 0
    pairs14, scee, scnb, seen = [], [], [], set()
    for row, t in zip(draw, dt_):
        if row[2] < 0 or row[3] < 0:
            continue
        i, l = int(row[0] // 3), int(row[3] // 3)
        key = (min(i, l), max(i, l))
        if key in seen:
            continue
        seen.add(key)
        pairs14.append(key)
        scee.append(scee_t[t] if scee_t[t] != 0 else 1.2)
        scnb.append(scnb_t[t] if scnb_t[t] != 0 else 2.0)
    pairs14 = np.asarray(pairs14, np.int32).reshape(-1, 2)

    # CHAMBER (CHARMM-in-AMBER) extras: Urey-Bradley 1-3 springs, harmonic
    # impropers, and the dedicated 1-4 LJ tables (CHARMM scales 1-4 LJ by
    # TYPE PAIR, not by a global divisor). Atom indices in the CHARMM
    # sections are plain 1-based serials (not the 3*(i) AMBER convention).
    ub_pairs = np.zeros((0, 2), np.int32)
    ub_r0 = np.zeros(0)
    ub_k = np.zeros(0)
    imp_idx = np.zeros((0, 4), np.int32)
    imp_phi0 = np.zeros(0)
    imp_k = np.zeros(0)
    pairs14_sigma = pairs14_eps = None
    cmap_table = cmap_idx = cmap_type = cmap_extra = None
    if chamber:
        nub = int(s.get("CHARMM_UREY_BRADLEY_COUNT", [0])[0]) if \
            s.get("CHARMM_UREY_BRADLEY_COUNT") else 0
        if nub:
            raw_ub = np.asarray(
                s["CHARMM_UREY_BRADLEY"][: 3 * nub], np.int64
            ).reshape(-1, 3)
            ubk_t = np.asarray(s["CHARMM_UREY_BRADLEY_FORCE_CONSTANT"])
            ubr_t = np.asarray(s["CHARMM_UREY_BRADLEY_EQUIL_VALUE"])
            ub_pairs = (raw_ub[:, :2] - 1).astype(np.int32)
            ubt = raw_ub[:, 2] - 1
            ub_r0 = ubr_t[ubt] * 0.1
            # CHARMM k (r - r0)^2 -> our 1/2 k' convention
            ub_k = ubk_t[ubt] * 2.0 * _KCAL * 100.0
        nimp = int(s.get("CHARMM_NUM_IMPROPERS", [0])[0]) if \
            s.get("CHARMM_NUM_IMPROPERS") else 0
        if nimp:
            raw_imp = np.asarray(
                s["CHARMM_IMPROPERS"][: 5 * nimp], np.int64
            ).reshape(-1, 5)
            impk_t = np.asarray(s["CHARMM_IMPROPER_FORCE_CONSTANT"])
            impp_t = np.asarray(s["CHARMM_IMPROPER_PHASE"])
            imp_idx = (raw_imp[:, :4] - 1).astype(np.int32)
            impt = raw_imp[:, 4] - 1
            imp_k = impk_t[impt] * _KCAL  # E = k dphi^2 on both sides
            imp_phi0 = impp_t[impt]  # radians (the DIHEDRAL_PHASE convention)
        n_cmap = (int(s["CHARMM_CMAP_COUNT"][0])
                  if s.get("CHARMM_CMAP_COUNT") else 0)
        if n_cmap:
            from ..ops.cmap import build_cmap_table

            n_cmap_types = int(s["CHARMM_CMAP_COUNT"][1])
            resolutions = [int(r) for r in
                           s["CHARMM_CMAP_RESOLUTION"][:n_cmap_types]]
            grids_raw = []
            for t in range(n_cmap_types):
                key = f"CHARMM_CMAP_PARAMETER_{t + 1:02d}"
                if key not in s:
                    raise InputError(f"missing CMAP table %FLAG {key}")
                res_t = resolutions[t]
                grids_raw.append(
                    np.asarray(s[key][: res_t * res_t]).reshape(res_t, res_t)
                    * _KCAL
                )
            raw_cm = np.asarray(
                s["CHARMM_CMAP_INDEX"][: 6 * n_cmap], np.int64
            ).reshape(-1, 6)
            all_idx = (raw_cm[:, :5] - 1).astype(np.int32)
            all_type = (raw_cm[:, 5] - 1).astype(np.int32)
            # Mixed table resolutions (e.g. a 24-grid protein set alongside
            # a 12-grid lipid set — VERDICT r4 #4): a stacked (T, n, n, 4)
            # table needs one grid size, so terms are GROUPED by resolution
            # and each group becomes its own stacked CMAPTorsionForce. The
            # common single-resolution case stays one force.
            groups = []
            for res in sorted(set(resolutions)):
                tsel = [t for t in range(n_cmap_types)
                        if resolutions[t] == res]
                mask = np.isin(all_type, tsel)
                if not mask.any():
                    continue  # tables present but no term references them
                remap = np.full(n_cmap_types, -1, np.int32)
                remap[tsel] = np.arange(len(tsel), dtype=np.int32)
                groups.append((
                    all_idx[mask],
                    remap[all_type[mask]],
                    build_cmap_table(np.stack([grids_raw[t] for t in tsel])),
                ))
            if groups:
                cmap_idx, cmap_type, cmap_table = groups[0]
                cmap_extra = groups[1:] or None
        if "LENNARD_JONES_14_ACOEF" in s and len(pairs14):
            a14_t = np.asarray(s["LENNARD_JONES_14_ACOEF"])
            b14_t = np.asarray(s["LENNARD_JONES_14_BCOEF"])
            ti14 = type_idx[pairs14[:, 0]]
            tj14 = type_idx[pairs14[:, 1]]
            kslot = nb_parm[ntypes * ti14 + tj14] - 1
            a14 = np.where(kslot >= 0, a14_t[np.maximum(kslot, 0)], 0.0)
            b14 = np.where(kslot >= 0, b14_t[np.maximum(kslot, 0)], 0.0)
            good = (a14 > 0.0) & (b14 > 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                pairs14_sigma = np.where(
                    good, (a14 / np.where(good, b14, 1.0)) ** (1 / 6) * 0.1,
                    0.1,
                )
                pairs14_eps = np.where(
                    good, b14 * b14 / (4.0 * np.where(good, a14, 1.0))
                    * _KCAL, 0.0,
                )

    box = None
    if ifbox and "BOX_DIMENSIONS" in s:
        beta, bx, by, bz = s["BOX_DIMENSIONS"][:4]
        if abs(beta - 90.0) > 1e-6:
            # BOX_DIMENSIONS carries one angle (truncated-octahedron style
            # beta applied to all three) — build the reduced cell matrix
            from ..ops.pbc import triclinic_from_lengths_angles

            box = triclinic_from_lengths_angles(
                bx * 0.1, by * 0.1, bz * 0.1, beta, beta, beta
            )
        else:
            box = np.asarray([bx, by, bz]) * 0.1

    # molecules = connected components of the bond graph
    parent = np.arange(natom)

    def _find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in bonds:
        ri, rj = _find(i), _find(j)
        if ri != rj:
            parent[ri] = rj
    roots = np.fromiter((_find(i) for i in range(natom)), np.int64, natom)
    _, molecule = np.unique(roots, return_inverse=True)

    # extra points / zero-mass atoms -> virtual sites, classified from the
    # EQUILIBRIUM frame geometry (bond equil values + angle equilibria) the
    # prmtop carries, exactly as OpenMM's AmberPrmtopFile derives them.
    # Every EP is bonded to exactly one parent; the pattern follows from
    # the parent's massive neighbor count and the EP angles (VERDICT r4 #4
    # closed the non-water patterns):
    #   1 massive neighbor  -> collinear lone pair (halogen sigma-hole /
    #                          carbonyl LP): TwoParticleAverage along the
    #                          parent-neighbor axis, direction from the
    #                          EP-parent-neighbor angle (0 or pi).
    #   2 massive neighbors -> symmetric bisector EP (TIP4P M site) when no
    #                          EP angles are given; otherwise the general
    #                          in-plane solve from the two EP-parent-X
    #                          angles, with an out-of-plane (TIP5P lone
    #                          pair) component when those angles are
    #                          inconsistent with a planar placement.
    ep_idx = np.nonzero(mass == 0.0)[0]
    vs_sites = vs_parents = vs_weights = vs_oop = None
    if len(ep_idx):
        neigh: dict = {}
        bond_len: dict = {}
        for bi, (i, j) in enumerate(bonds):
            i, j = int(i), int(j)
            neigh.setdefault(i, []).append(j)
            neigh.setdefault(j, []).append(i)
            bond_len[(min(i, j), max(i, j))] = bond_r0[bi]
        angle_eq: dict = {}
        for ai, (a, b, c_) in enumerate(angles):
            a, b, c_ = int(a), int(b), int(c_)
            angle_eq[(min(a, c_), b, max(a, c_))] = angle_t0[ai]

        def _blen(a, b):
            return bond_len[(min(a, b), max(a, b))]

        def _aeq(a, b, c_):
            return angle_eq.get((min(a, c_), b, max(a, c_)))

        rows, wrows, oops = [], [], []
        oop_sign: dict = {}  # parent -> sign for the NEXT out-of-plane EP
        for ep in ep_idx:
            ep = int(ep)
            parents = neigh.get(ep, [])
            if len(parents) != 1:
                raise InputError(
                    f"extra point {ep} is framed by {len(parents)} bonds — "
                    "extra points must bond to exactly one parent atom"
                )
            o = parents[0]
            hs = sorted(a for a in neigh[o] if mass[a] > 0.0)
            d_ep = _blen(ep, o)
            if len(hs) == 1:
                n1 = hs[0]
                t0 = _aeq(ep, o, n1)
                if t0 is None:
                    raise InputError(
                        f"extra point {ep}: no EP-parent-neighbor angle to "
                        "orient the lone pair"
                    )
                if not (abs(t0) < 1e-3 or abs(t0 - np.pi) < 1e-3):
                    raise InputError(
                        f"extra point {ep}: single-neighbor frame with "
                        f"non-collinear angle {t0:.4f} rad is "
                        "rotationally underdetermined"
                    )
                f = d_ep / _blen(o, n1)
                if abs(t0 - np.pi) < 1e-3:
                    f = -f  # pointing away from the neighbor
                rows.append((ep, o, n1, n1))
                # p3 == p2 makes the cross term vanish identically
                wrows.append((1.0 - f, f, 0.0))
                oops.append(0.0)
            elif len(hs) == 2:
                h1, h2 = hs
                r1 = _blen(o, h1)
                r2 = _blen(o, h2)
                t0 = _aeq(h1, o, h2)
                if t0 is None:
                    raise InputError(
                        f"extra point {ep}: no {h1}-{o}-{h2} angle to "
                        "derive the frame"
                    )
                th1 = _aeq(ep, o, h1)
                th2 = _aeq(ep, o, h2)
                if th1 is None and th2 is None:
                    # symmetric bisector placement (TIP4P M site)
                    if abs(r1 - r2) > 1e-9:
                        raise InputError(
                            f"extra point {ep}: unequal frame bonds "
                            f"({r1}, {r2}) with no EP angles to resolve "
                            "the asymmetry"
                        )
                    c_w = d_ep / (2.0 * r1 * np.cos(t0 / 2.0))
                    rows.append((ep, o, h1, h2))
                    wrows.append((1.0 - 2.0 * c_w, c_w, c_w))
                    oops.append(0.0)
                else:
                    if th1 is None or th2 is None:
                        raise InputError(
                            f"extra point {ep}: only one EP-parent-X angle "
                            "given; need both (or neither, for the "
                            "symmetric bisector frame)"
                        )
                    # in-plane components from the two dot products
                    #   (EP-O).(Hk-O) = d_ep r_k cos th_k,
                    # Gram matrix of (H1-O, H2-O) from (r1, r2, t0)
                    g12 = r1 * r2 * np.cos(t0)
                    gram = np.asarray([[r1 * r1, g12], [g12, r2 * r2]])
                    rhs = np.asarray([d_ep * r1 * np.cos(th1),
                                      d_ep * r2 * np.cos(th2)])
                    c1, c2 = np.linalg.solve(gram, rhs)
                    # residual normal to the frame plane -> TIP5P-style
                    # out-of-plane component along (H1-O) x (H2-O)
                    resid2 = d_ep * d_ep - float(rhs @ [c1, c2])
                    if resid2 < 1e-12:
                        oop_c = 0.0
                    else:
                        cross = r1 * r2 * np.sin(t0)
                        sign = oop_sign.get(o, 1.0)
                        oop_sign[o] = -sign  # paired lone pairs mirror
                        oop_c = sign * np.sqrt(resid2) / cross
                    rows.append((ep, o, h1, h2))
                    wrows.append((1.0 - c1 - c2, c1, c2))
                    oops.append(float(oop_c))
            else:
                raise InputError(
                    f"extra point {ep}: parent {o} has {len(hs)} massive "
                    "neighbors — supported frames have one (collinear lone "
                    "pair) or two (in-plane / out-of-plane)"
                )
        vs_sites = np.asarray([r[0] for r in rows], np.int32)
        vs_parents = np.asarray([r[1:] for r in rows], np.int32)
        vs_weights = np.asarray(wrows)
        vs_oop = np.asarray(oops)

    res_ptr = np.asarray(s.get("RESIDUE_POINTER", [1]), dtype=np.int64) - 1
    top = AmberPrmtop(
        natom=natom,
        charge=charge,
        mass=mass,
        sigma=sigma,
        epsilon=epsilon,
        atom_name=list(s.get("ATOM_NAME", [])[:natom]),
        residue_label=list(s.get("RESIDUE_LABEL", [])),
        residue_first_atom=res_ptr,
        bonds=bonds,
        bond_r0=bond_r0,
        bond_k=bond_k,
        angles=angles,
        angle_t0=angle_t0,
        angle_k=angle_k,
        torsions=torsions,
        torsion_periodicity=torsion_n,
        torsion_phase=torsion_phase,
        torsion_k=torsion_k,
        pairs14=pairs14,
        scee=np.asarray(scee),
        scnb=np.asarray(scnb),
        box=box,
        molecule=molecule.astype(np.int32),
        lj_type=type_idx.astype(np.int32) if need_tables else None,
        pair_sigma=pair_sig if need_tables else None,
        pair_epsilon=pair_eps if need_tables else None,
        pair_a1012=hb_a if has_hb else None,
        pair_b1012=hb_b if has_hb else None,
        vs_sites=vs_sites,
        vs_parents=vs_parents,
        vs_weights=vs_weights,
        vs_oop=vs_oop,
        ub_pairs=ub_pairs,
        ub_r0=ub_r0,
        ub_k=ub_k,
        imp_idx=imp_idx,
        imp_phi0=imp_phi0,
        imp_k=imp_k,
        pairs14_sigma=pairs14_sigma,
        pairs14_eps=pairs14_eps,
        cmap_idx=cmap_idx,
        cmap_type=cmap_type,
        cmap_table=cmap_table,
        cmap_extra=cmap_extra,
    )
    # The prmtop's EXCLUDED_ATOMS_LIST is authoritative; our exclusions are
    # derived from the bond graph + dihedral 1-4s (equivalent for standard
    # topologies). When the section is present, verify the two agree rather
    # than silently diverging (round-2 advisor finding) — a mismatch means
    # custom exclusions this reader cannot honor.
    if "EXCLUDED_ATOMS_LIST" in s and "NUMBER_EXCLUDED_ATOMS" in s:
        counts = np.asarray(s["NUMBER_EXCLUDED_ATOMS"][:natom], np.int64)
        ex = np.asarray(s["EXCLUDED_ATOMS_LIST"], np.int64)
        listed = set()
        pos = 0
        for i in range(natom):
            for j in ex[pos:pos + counts[i]]:
                if j > 0:  # a single 0 entry means "no exclusions"
                    a, b = (i, int(j) - 1) if i < j - 1 else (int(j) - 1, i)
                    listed.add((a, b))
            pos += counts[i]
        derived = set(map(tuple, top.exclusion_pairs()))
        if listed != derived:
            extra = sorted(listed - derived)[:5]
            missing = sorted(derived - listed)[:5]
            raise InputError(
                "prmtop EXCLUDED_ATOMS_LIST disagrees with the bond-graph "
                f"derived exclusions (custom exclusions are not supported): "
                f"{len(listed - derived)} listed-only (e.g. {extra}), "
                f"{len(derived - listed)} derived-only (e.g. {missing})"
            )
    return top


def read_inpcrd(path_or_text):
    """Parse an AMBER restart (.inpcrd/.rst7): returns (x, v, box) in
    nm / nm/ps / nm; v and box are None when absent. An angled box record
    returns the reduced (3, 3) cell matrix (ops/pbc.py); both box forms run
    on the cell-list path (r4: fractional binning + triclinic images)."""
    text = str(path_or_text)
    if "\n" not in text:
        with open(path_or_text) as fh:
            text = fh.read()
    lines = text.splitlines()
    natom = int(lines[1].split()[0])
    vals = []
    for line in lines[2:]:
        for start in range(0, len(line.rstrip()), 12):
            tok = line[start : start + 12].strip()
            if tok:
                vals.append(float(tok))
    vals = np.asarray(vals)
    x = vals[: 3 * natom].reshape(natom, 3) * 0.1
    rest = vals[3 * natom :]
    v = None
    box = None
    # a trailing block of exactly 3N floats is velocities — except that for
    # N <= 2 a box record (3 or 6 floats) has the same size; prefer the box
    # reading there (a velocity-bearing restart then also has the box after)
    if rest.size >= 3 * natom and not (natom <= 2 and rest.size in (3, 6)):
        v = rest[: 3 * natom].reshape(natom, 3) * _AMBER_VEL
        rest = rest[3 * natom :]
    if rest.size >= 3:
        if rest.size >= 6 and np.any(np.abs(rest[3:6] - 90.0) > 1e-6):
            # triclinic: reduced (3, 3) cell matrix [nm] (ops/pbc.py)
            from ..ops.pbc import triclinic_from_lengths_angles

            box = triclinic_from_lengths_angles(
                *(rest[:3] * 0.1), *rest[3:6]
            )
        else:
            box = rest[:3] * 0.1
    return x, v, box


def amber_system(
    prmtop,
    inpcrd=None,
    *,
    method: str = "cutoff",
    r_cut: float = 0.9,
    r_switch: float | None = None,
    box=None,
    dtype=None,
    chunk: int = 256,
    pme_grid=None,
    pme_alpha: float | None = None,
    neighbors: bool = False,
    skin: float = 0.1,
    dispersion_correction: bool = False,
    constraints: str | None = None,
    rigid_water: bool = False,
    hydrogen_mass: float | None = None,
) -> tuple:
    """Build (System, positions, box) from AMBER files — the
    equivalent of ``AmberPrmtopFile(...).createSystem(...)`` (SURVEY.md §3.1).

    ``prmtop``/``inpcrd`` may be paths or already-parsed objects. All forces
    land in group 0 (use systems.RESPASystem to split); 1-4 interactions go to
    a NonbondedExceptionsForce exactly like the reference moves exceptions to
    the innermost group. Returns positions from the inpcrd (required unless
    you only need the System).

    ``constraints='h-bonds'`` replaces every bond involving a hydrogen by a
    distance constraint at its equilibrium length (createSystem's HBonds).
    ``rigid_water=True`` makes 3-site waters fully rigid — both O-H bonds
    plus the H-H distance implied by the equilibrium angle — and removes
    their bond/angle terms; the resulting triangles are auto-classified onto
    the closed-form SETTLE path (ops/settle.py), everything else onto
    SHAKE/RATTLE. ``hydrogen_mass=3.024`` applies hydrogen mass
    repartitioning with OpenMM's target-mass semantics
    (systems.py::HydrogenMassRepartitionedSystem).
    """
    from ..forces import (
        HarmonicAngleForce,
        HarmonicBondForce,
        NonbondedExceptionsForce,
        NonbondedForce,
        PeriodicTorsionForce,
    )
    from ..system import System, make_exclusions_array

    top = prmtop if isinstance(prmtop, AmberPrmtop) else read_prmtop(prmtop)
    x = v = None
    if inpcrd is not None:
        x, v, crd_box = read_inpcrd(inpcrd)
        if box is None:
            box = crd_box
    if box is None:
        box = top.box
    if box is None:
        raise InputError(
            "no box: pass box=, or an inpcrd/prmtop that records one"
        )
    box = np.asarray(box, dtype=float)
    dtype = dtype or jnp.result_type(float)
    n = top.natom
    if r_cut > 0.5 * float(box.min()):
        raise InputError(
            f"r_cut={r_cut} exceeds half the smallest box edge "
            f"({box.min():.3f}/2)"
        )
    r_switch = r_switch if r_switch is not None else 0.9 * r_cut

    nb_kwargs = dict(
        group=0,
        charge=jnp.asarray(top.charge, dtype),
        sigma=jnp.asarray(top.sigma, dtype),
        epsilon=jnp.asarray(top.epsilon, dtype),
        exclusions=make_exclusions_array(n, top.exclusion_pairs()),
        r_cut=jnp.asarray(r_cut, dtype),
        r_switch=jnp.asarray(r_switch, dtype),
        eps_rf=jnp.asarray(1e15, dtype),
        method=method,
        use_switch=True,
        chunk=chunk,
    )
    if top.pair_sigma is not None:  # NBFIX per-type-pair LJ tables
        nb_kwargs.update(
            lj_type=jnp.asarray(top.lj_type),
            pair_sigma=jnp.asarray(top.pair_sigma, dtype),
            pair_epsilon=jnp.asarray(top.pair_epsilon, dtype),
        )
    if top.pair_a1012 is not None:  # legacy 10-12 hydrogen bonds
        nb_kwargs.update(
            pair_a1012=jnp.asarray(top.pair_a1012, dtype),
            pair_b1012=jnp.asarray(top.pair_b1012, dtype),
        )
    if method == "pme":
        from ..ops.pme import choose_pme_parameters

        alpha, grid, order = choose_pme_parameters(
            r_cut, box, alpha=pme_alpha, grid=pme_grid
        )
        nb_kwargs.update(ewald_alpha=float(alpha), grid_shape=tuple(grid),
                         spline_order=order)
    if dispersion_correction:
        from ..forces import compute_dispersion_coefficient

        nb_kwargs["dispersion_coeff"] = jnp.asarray(
            compute_dispersion_coefficient(
                np.asarray(top.sigma), np.asarray(top.epsilon),
                r_switch, r_cut,
                lj_type=top.lj_type, pair_sigma=top.pair_sigma,
                pair_epsilon=top.pair_epsilon,
            ),
            dtype,
        )
    forces = [NonbondedForce(**nb_kwargs)]

    # frame terms of extra points define virtual-site geometry, not forces:
    # drop any bonded term touching a virtual site (the bonds stayed in the
    # topology so the exclusion graph still covers the EP)
    vs_mask = np.zeros(n, bool)
    if top.vs_sites is not None:
        vs_mask[top.vs_sites] = True

    def _massive(idx2d):
        return ~vs_mask[np.asarray(idx2d)].any(axis=1)

    # --- constraints (createSystem(constraints=HBonds, rigidWater=True)) ---
    mass_np = np.asarray(top.mass, float)
    is_h = (mass_np > 0) & (mass_np < 1.5)
    constrain_bond = np.zeros(len(top.bonds), bool)
    drop_angle = np.zeros(len(top.angles), bool)
    con_pairs: list = []
    con_d0: list = []

    if constraints is not None:
        if constraints.replace("-", "_").lower() not in ("h_bonds", "hbonds"):
            raise InputError(
                f"constraints must be None or 'h-bonds', got {constraints!r}"
            )
        if len(top.bonds):
            sel = is_h[top.bonds].any(axis=1) & _massive(top.bonds)
            constrain_bond |= sel
            for (i, j), r0 in zip(top.bonds[sel], top.bond_r0[sel]):
                con_pairs.append((int(i), int(j)))
                con_d0.append(float(r0))

    if rigid_water and len(top.bonds):
        bond_row = {
            tuple(sorted(map(int, b))): r for r, b in enumerate(top.bonds)
        }
        angle_row = {}
        for r, (i, j, k) in enumerate(top.angles):
            i, j, k = int(i), int(j), int(k)
            angle_row[(min(i, k), j, max(i, k))] = r
        mol_atoms: dict = {}
        for a in range(n):
            if not vs_mask[a] and mass_np[a] > 0:
                mol_atoms.setdefault(int(top.molecule[a]), []).append(a)
        for atoms in mol_atoms.values():
            if len(atoms) != 3:
                continue
            h_at = [a for a in atoms if is_h[a]]
            heavy = [a for a in atoms if not is_h[a]]
            if len(h_at) != 2 or len(heavy) != 1:
                continue
            o, (h1, h2) = heavy[0], h_at
            row1 = bond_row.get(tuple(sorted((o, h1))))
            row2 = bond_row.get(tuple(sorted((o, h2))))
            if row1 is None or row2 is None:
                continue
            r1, r2 = float(top.bond_r0[row1]), float(top.bond_r0[row2])
            row_hh = bond_row.get(tuple(sorted((h1, h2))))
            if row_hh is not None:  # explicit H-H bond (some water FFs)
                if not constrain_bond[row_hh]:
                    constrain_bond[row_hh] = True
                    con_pairs.append((h1, h2))
                    con_d0.append(float(top.bond_r0[row_hh]))
            else:
                a_row = angle_row.get((min(h1, h2), o, max(h1, h2)))
                if a_row is None:
                    continue
                t0 = float(top.angle_t0[a_row])
                drop_angle[a_row] = True
                con_pairs.append((h1, h2))
                con_d0.append(
                    np.sqrt(r1 * r1 + r2 * r2 - 2 * r1 * r2 * np.cos(t0))
                )
            for row, pair, r0 in ((row1, (o, h1), r1), (row2, (o, h2), r2)):
                if not constrain_bond[row]:
                    constrain_bond[row] = True
                    con_pairs.append(pair)
                    con_d0.append(r0)

    if len(top.bonds):
        keep = _massive(top.bonds) & ~constrain_bond
        if keep.any():
            forces.append(
                HarmonicBondForce(
                    group=0,
                    idx=jnp.asarray(top.bonds[keep]),
                    r0=jnp.asarray(top.bond_r0[keep], dtype),
                    k=jnp.asarray(top.bond_k[keep], dtype),
                )
            )
    if len(top.angles):
        keep = _massive(top.angles) & ~drop_angle
        if keep.any():
            forces.append(
                HarmonicAngleForce(
                    group=0,
                    idx=jnp.asarray(top.angles[keep]),
                    theta0=jnp.asarray(top.angle_t0[keep], dtype),
                    k=jnp.asarray(top.angle_k[keep], dtype),
                )
            )
    if len(top.torsions):
        keep = _massive(top.torsions)
        if keep.any():
            forces.append(
                PeriodicTorsionForce(
                    group=0,
                    idx=jnp.asarray(top.torsions[keep]),
                    periodicity=jnp.asarray(top.torsion_periodicity[keep]),
                    phase=jnp.asarray(top.torsion_phase[keep], dtype),
                    k=jnp.asarray(top.torsion_k[keep], dtype),
                )
            )
    if top.ub_pairs is not None and len(top.ub_pairs):
        # CHARMM Urey-Bradley 1-3 springs: a second bond-like force — the
        # pairs are 1-3 (already excluded), so the exclusion graph is
        # untouched
        forces.append(
            HarmonicBondForce(
                group=0,
                idx=jnp.asarray(top.ub_pairs),
                r0=jnp.asarray(top.ub_r0, dtype),
                k=jnp.asarray(top.ub_k, dtype),
            )
        )
    if top.imp_idx is not None and len(top.imp_idx):
        from ..forces import HarmonicImproperForce

        forces.append(
            HarmonicImproperForce(
                group=0,
                idx=jnp.asarray(top.imp_idx),
                phi0=jnp.asarray(top.imp_phi0, dtype),
                k=jnp.asarray(top.imp_k, dtype),
            )
        )
    if top.cmap_idx is not None and len(top.cmap_idx):
        from ..forces import CMAPTorsionForce

        cmap_groups = [(top.cmap_idx, top.cmap_type, top.cmap_table)]
        cmap_groups += list(top.cmap_extra or [])
        for cm_idx, cm_type, cm_table in cmap_groups:
            forces.append(
                CMAPTorsionForce(
                    group=0,
                    idx=jnp.asarray(cm_idx),
                    type_index=jnp.asarray(cm_type),
                    table=jnp.asarray(cm_table, dtype),
                )
            )
    if len(top.pairs14):
        i, j = top.pairs14[:, 0], top.pairs14[:, 1]
        if top.pairs14_sigma is not None:
            # CHAMBER: the dedicated 1-4 LJ type-pair tables ARE the
            # scaling — no scnb divisor
            sig = top.pairs14_sigma
            eps = top.pairs14_eps
        elif top.pair_sigma is not None:  # exact NBFIX values per 1-4 pair
            ti, tj = top.lj_type[i], top.lj_type[j]
            sig = top.pair_sigma[ti, tj]
            eps = top.pair_epsilon[ti, tj] / top.scnb
        else:
            sig = 0.5 * (top.sigma[i] + top.sigma[j])
            eps = np.sqrt(top.epsilon[i] * top.epsilon[j]) / top.scnb
        qq = top.charge[i] * top.charge[j] / top.scee
        forces.append(
            NonbondedExceptionsForce(
                group=0,
                pairs=jnp.asarray(top.pairs14),
                chargeprod=jnp.asarray(qq, dtype),
                sigma=jnp.asarray(sig, dtype),
                epsilon=jnp.asarray(eps, dtype),
                valid=jnp.ones(len(top.pairs14), bool),
            )
        )

    vsites = None
    if top.vs_sites is not None:
        from ..ops.virtual_sites import VirtualSiteSet, validate_virtual_sites

        oop = (jnp.asarray(top.vs_oop, dtype) if top.vs_oop is not None
               else jnp.zeros((len(top.vs_sites),), dtype))
        vsites = validate_virtual_sites(VirtualSiteSet(
            sites=jnp.asarray(top.vs_sites),
            parents=jnp.asarray(top.vs_parents),
            weights=jnp.asarray(top.vs_weights, dtype),
            oop=oop,
        ))
    cset = sset = None
    if con_pairs:
        from ..ops.constraints import ConstraintSet
        from ..ops.settle import partition_constraints

        cset = ConstraintSet(
            pairs=jnp.asarray(np.asarray(con_pairs, np.int32)),
            d0=jnp.asarray(np.asarray(con_d0), dtype),
        )
        sset, cset = partition_constraints(cset, mass_np)
        if cset is not None and cset.size == 0:
            cset = None
    system = System(
        masses=jnp.asarray(top.mass, dtype),
        forces=tuple(forces),
        molecule=jnp.asarray(top.molecule, jnp.int32),
        default_box=jnp.asarray(box, dtype),
        virtual_sites=vsites,
        constraints=cset,
        settle=sset,
        num_molecules=top.num_molecules,
        num_constraints=len(con_pairs),
    )
    if hydrogen_mass is not None:
        from ..systems import HydrogenMassRepartitionedSystem

        system = HydrogenMassRepartitionedSystem(
            system, target_mass=hydrogen_mass, bonds=top.bonds
        )
    if neighbors:
        from ..ops.neighbors import make_neighbor_spec

        spec = make_neighbor_spec(
            box, n, r_cut, skin=skin, exclusions=nb_kwargs["exclusions"],
            occupancy_floor_from=x,
        )
        system = system.with_neighbors(spec)
    x = jnp.asarray(x, dtype) if x is not None else None
    return system, x, jnp.asarray(box, dtype)
