"""Per-atom Verlet-list (gather) formulation study.

Context: the production cell-pair far sweep runs at ~7% slot occupancy —
mask padding (cap² × stencil volume vs true neighbors) is the dominant
inefficiency. The alternative formulation is the classic per-atom Verlet
list: an (N, K) index matrix of
each atom's true neighbors within r_cut + skin, evaluated by GATHERING rows
instead of staging regular tiles. Expected trade:

  + slots drop from s_half·cap² per cell (≈167M full-equivalent at 30k) to
    N·K ≈ 11-12M (occupancy inside a row is count/K ≈ 80-90%),
  + no scatter at eval: a full (not Newton) list accumulates each atom's own
    force only — 2× the pair evaluations, still ~7× fewer than padded slots,
  + per-pair params (sigma_ij-style inputs) are STATIC between rebuilds, so
    only positions (N, K, 3) need gathering per step,
  - the gather itself is the risk: gathers of small irregular rows run
    below streaming memory speed, and this study exists to measure that.

Run on the GPU from the frozen state:  python tools/verlet_study.py
Writes ms/eval for the production far sweep vs the Verlet variants plus the
list build cost, and checks force parity between the formulations. No
GPU measurement of it exists yet.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import HEADLINE_RCUT_IN, load_eq  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(fn, x, reps=20, tries=3):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(x):
        def body(i, acc):
            return acc + fn(x + 1e-30 * acc)
        return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(x))

    out = loop(x)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        out = loop(x)
        float(out[0, 0])
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def build_verlet_np(spec, bucket_np, x_np, box_np, r_build, k_cap):
    """Host-side (N, K) int32 per-atom neighbor rows (full list, N-padded),
    from the cell buckets' FULL stencil; exclusions applied at build time.

    The study builds on the host: the JITTED sort-compaction build hit a
    pathological multi-minute compile, and the eval-side
    gather cost is the question this study answers — a production backend
    would need the device build solved separately (or amortized across the
    rebuild interval)."""
    n = x_np.shape[0]
    ncells, cap = bucket_np.shape
    exc = np.asarray(spec.exclusions)
    rb2 = float(r_build) ** 2
    nbr = np.full((n, k_cap), n, np.int32)
    max_cnt = 0
    box_diag = np.asarray(box_np, np.float64)
    for c in range(ncells):
        home = bucket_np[c]
        home = home[home < n]
        if home.size == 0:
            continue
        cand_cells = spec.nbr_cells[c]
        cand_cells = np.asarray(cand_cells)[np.asarray(cand_cells) >= 0]
        cand = bucket_np[cand_cells].reshape(-1)
        cand = cand[cand < n]
        dx = x_np[home][:, None, :] - x_np[cand][None, :, :]
        dx -= box_diag * np.round(dx / box_diag)
        r2 = (dx * dx).sum(-1)
        mask = (r2 < rb2) & (home[:, None] != cand[None, :])
        # exclusions
        for row, a in enumerate(home):
            ex_ids = exc[a]
            ex_ids = ex_ids[ex_ids >= 0]
            if ex_ids.size:
                mask[row] &= ~np.isin(cand, ex_ids)
            js = cand[mask[row]]
            max_cnt = max(max_cnt, js.size)
            nbr[a, : min(js.size, k_cap)] = js[:k_cap]
    return nbr, max_cnt


def main():
    # usage: verlet_study.py [method] [variants]  — variants is any subset
    # of "abc" (default all); the host-built list is cached in /tmp so a
    # follow-up run (e.g. B/C after A hit a wall-clock budget) skips the
    # ~2-minute rebuild.
    method = sys.argv[1] if len(sys.argv) > 1 else "cutoff"
    variants = sys.argv[2] if len(sys.argv) > 2 else "abc"
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu import RESPASystem
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.neighbors import (
        build_cell_buckets,
        cell_pair_energy_forces,
        retune_spec,
    )
    from atomsmm_tpu.ops.pbc import minimum_image
    from atomsmm_tpu.ops.rv import pair_eval

    system, _, _ = water_system(n_molecules=10000, method=method,
                                neighbors=True)
    respa = RESPASystem(system, rcut_in=HEADLINE_RCUT_IN,
                        rswitch_in=HEADLINE_RCUT_IN - 0.1)
    ex, _, ebox = load_eq("eq_water30k")
    x = jnp.asarray(ex)
    box = jnp.asarray(ebox)
    n = x.shape[0]

    far = next(f for f in respa.forces if f.name == "FarNonbondedForce")
    spec = retune_spec(respa.neighbors, x, box, safety=1.15)
    pair_fn = far._pair_fn({})
    pp = far._per_particle({})
    r_cut = float(far.full.r_cut)
    skin = float(spec.skin)
    r_build = r_cut + skin
    results = {"method": method, "r_cut": r_cut, "skin": skin}

    # --- production baseline -------------------------------------------
    bucket, ov = build_cell_buckets(spec, x, box)
    assert not bool(ov)

    def f_prod(xx):
        _, ff = cell_pair_energy_forces(pair_fn, xx, box, pp, spec, bucket,
                                        r_cut)
        return ff
    ms = timeit(f_prod, x)
    results["prod_far_ms"] = round(ms, 3)
    log(f"production far sweep: {ms:.3f} ms")
    e_ref, f_ref_atoms = cell_pair_energy_forces(pair_fn, x, box, pp, spec,
                                                 bucket, r_cut)  # (N, 3)
    hid = bucket.reshape(-1)  # atoms in cell-scan order (for variant C)

    # --- Verlet list (host build; see build_verlet_np docstring) --------
    cache = f"/tmp/verlet_cache_{method}.npz"
    t0 = time.perf_counter()
    if os.path.exists(cache):
        dat = np.load(cache)
        nbr_np, max_cnt = dat["nbr"], int(dat["max_cnt"])
        log(f"loaded cached list from {cache}")
    else:
        bucket_np = np.asarray(bucket)
        nbr_np, max_cnt = build_verlet_np(
            spec, bucket_np, np.asarray(x), np.asarray(box), r_build, 512)
        np.savez(cache, nbr=nbr_np, max_cnt=max_cnt)
    host_s = time.perf_counter() - t0
    k_cap = -(-int(max_cnt * 1.05 + 2) // 8) * 8
    nbr = jnp.asarray(nbr_np[:, :k_cap])
    results["k_cap"] = k_cap
    results["max_count"] = int(max_cnt)
    results["slots_M"] = round(n * k_cap / 1e6, 1)
    results["host_build_s"] = round(host_s, 2)
    log(f"host list build: max count {max_cnt}, K={k_cap} ({host_s:.1f}s)")

    rc2 = jnp.asarray(r_cut, x.dtype) ** 2
    pp_keys = list(pp.keys())

    # variant A: gather positions + params per step from one fused table
    def f_verlet_all(xx):  # noqa: E306
        tab = jnp.concatenate(
            [xx] + [pp[k][:, None] for k in pp_keys], axis=1)
        tab = jnp.concatenate([tab, jnp.zeros((1, tab.shape[1]), tab.dtype)])
        g = tab[nbr]                                   # (N, K, 3+P) gather
        dx = minimum_image(xx[:, None, :] - g[..., :3], box)
        r2 = jnp.sum(dx * dx, axis=-1)
        mask = (nbr < n) & (r2 < rc2)
        r2m = jnp.where(mask, r2, 1.0)
        pi = {k: pp[k][:, None] for k in pp_keys}
        pj = {k: g[..., 3 + i] for i, k in enumerate(pp_keys)}
        _, dudr2 = pair_eval(pair_fn, r2m, pi, pj, True)
        fmag = jnp.where(mask, 2.0 * dudr2, 0.0)
        return -jnp.sum(fmag[..., None] * dx, axis=1)

    if "a" in variants:
        ms = timeit(f_verlet_all, x)
        results["verlet_gather_all_ms"] = round(ms, 3)
        log(f"verlet gather pos+params: {ms:.3f} ms")

    # variant B: params pre-gathered at build (static between rebuilds);
    # per-step gather is positions only
    pj_static = {}
    for k in pp_keys:
        col = jnp.concatenate([pp[k], jnp.zeros((1,), pp[k].dtype)])
        pj_static[k] = col[nbr]
    x_sentinel = jnp.zeros((1, 3), x.dtype)

    def f_verlet_pos(xx):
        xp = jnp.concatenate([xx, x_sentinel])
        g = xp[nbr]                                    # (N, K, 3) gather
        dx = minimum_image(xx[:, None, :] - g, box)
        r2 = jnp.sum(dx * dx, axis=-1)
        mask = (nbr < n) & (r2 < rc2)
        r2m = jnp.where(mask, r2, 1.0)
        pi = {k: pp[k][:, None] for k in pp_keys}
        _, dudr2 = pair_eval(pair_fn, r2m, pi, pj_static, True)
        fmag = jnp.where(mask, 2.0 * dudr2, 0.0)
        return -jnp.sum(fmag[..., None] * dx, axis=1)

    if "b" in variants:
        ms = timeit(f_verlet_pos, x)
        results["verlet_gather_pos_ms"] = round(ms, 3)
        log(f"verlet gather pos only: {ms:.3f} ms")

        # parity: Verlet force vs production bucket force, atom order
        fv = f_verlet_pos(x)
        err = float(jnp.max(jnp.abs(fv - f_ref_atoms)))
        scale = float(jnp.max(jnp.abs(f_ref_atoms)))
        results["force_maxabs_diff"] = err
        results["force_scale"] = scale
        log(f"force parity |dF|max = {err:.3e} (scale {scale:.3e})")

    # variant C: atoms relabeled in cell-scan order (gather locality —
    # neighbors of nearby atoms then live in nearby table rows)
    order = hid[hid < n]  # atom ids in bucket/cell order (eager, host-side)
    if "c" in variants and order.shape[0] == n:
        perm = order  # new index -> old atom id
        inv = jnp.zeros((n,), jnp.int32).at[perm].set(
            jnp.arange(n, dtype=jnp.int32))
        x2 = x[perm]
        pp2 = {k: v[perm] for k, v in pp.items()}
        remap = jnp.concatenate([inv, jnp.array([n], jnp.int32)])
        nbr2 = remap[nbr][perm]
        pj2 = {}
        for k in pp_keys:
            col = jnp.concatenate([pp2[k], jnp.zeros((1,), pp2[k].dtype)])
            pj2[k] = col[nbr2]

        def f_verlet_sorted(xx):
            xp = jnp.concatenate([xx, x_sentinel])
            g = xp[nbr2]
            dx = minimum_image(xx[:, None, :] - g, box)
            r2 = jnp.sum(dx * dx, axis=-1)
            mask = (nbr2 < n) & (r2 < rc2)
            r2m = jnp.where(mask, r2, 1.0)
            pi = {k: pp2[k][:, None] for k in pp_keys}
            _, dudr2 = pair_eval(pair_fn, r2m, pi, pj2, True)
            fmag = jnp.where(mask, 2.0 * dudr2, 0.0)
            return -jnp.sum(fmag[..., None] * dx, axis=1)

        ms = timeit(f_verlet_sorted, x2)
        results["verlet_gather_sorted_ms"] = round(ms, 3)
        log(f"verlet gather cell-sorted: {ms:.3f} ms")

    print(json.dumps(results))


if __name__ == "__main__":
    main()
