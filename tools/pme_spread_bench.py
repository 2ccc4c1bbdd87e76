"""PME spreading-formulation study: dense one-hot vs block-binned.

The round-4 roofline (KERNELS.md) put the dense one-hot spreading at ~6% of
bf16 MXU peak with cost N*K^3 MACs — the one-hot weight rows span the FULL
grid dimension though only `order` entries are nonzero. The block-binned
formulation (ops/pme.py::spread_charges_blocked) bins atoms by the grid
block holding their spline support base and runs the matmuls inside
(B + order - 1) local windows: nblocks * cap * prod(W) MACs, a 10-50x
reduction at production grids, for the price of one int32 value-sort per
evaluation.

Measures reciprocal energy+gradient (the PME force path) ms/eval on the
GPU for both formulations:
  * 30k-atom frozen water state, order-6 / 48^3 (the PME headline config)
  * 100k-atom synthetic water-density box, order-6 (the NPT PME config)

Run: python tools/pme_spread_bench.py [30k|100k|both]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import load_eq  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_grad(e_fn, x, reps=10, tries=3):
    import jax
    import jax.numpy as jnp

    g = jax.value_and_grad(e_fn)

    @jax.jit
    def loop(x):
        def body(i, acc):
            e, gr = g(x + 1e-30 * acc)
            return acc + gr + e * 1e-30
        return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(x))

    out = loop(x)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x))
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def study(x, box, q, alpha, grid, order, label):
    import jax.numpy as jnp

    from atomsmm_tpu.ops.pme import (
        choose_spread_blocks,
        pme_reciprocal_energy,
    )

    n = x.shape[0]
    block, cap = choose_spread_blocks(grid, order, n,
                                      x=np.asarray(x), box=np.asarray(box))
    nbtot = int(np.prod([k // b for k, b in zip(grid, block)]))
    w = [b + order - 1 for b in block]
    dense_macs = n * int(np.prod(grid))
    blk_macs = nbtot * cap * int(np.prod(w))
    log(f"[{label}] N={n} grid={grid} -> block={block} cap={cap} "
        f"(blocks {nbtot}, windows {w}); MACs {dense_macs/1e9:.2f}G dense "
        f"vs {blk_macs/1e9:.2f}G blocked ({dense_macs/blk_macs:.1f}x fewer)")

    def e_dense(xx):
        return pme_reciprocal_energy(xx, box, q, alpha, grid, order)

    def e_blocked(xx):
        return pme_reciprocal_energy(xx, box, q, alpha, grid, order,
                                     spread_block=block, spread_cap=cap)

    # parity first (f32 on chip): same grid, roundoff-level agreement
    ed, eb = float(e_dense(x)), float(e_blocked(x))
    rel = abs(eb - ed) / max(abs(ed), 1e-30)
    log(f"[{label}] E dense {ed:.6f} vs blocked {eb:.6f} (rel {rel:.2e})")

    ms_d = time_grad(e_dense, x)
    ms_b = time_grad(e_blocked, x)
    log(f"[{label}] E+grad ms/eval: dense {ms_d:.3f}, blocked {ms_b:.3f} "
        f"({ms_d/ms_b:.2f}x)")
    out = {"label": label, "n": n, "grid": list(grid), "block": list(block),
           "cap": cap, "rel_dE": rel, "dense_ms": round(ms_d, 3),
           "blocked_ms": round(ms_b, 3),
           "speedup": round(ms_d / ms_b, 2)}

    # amortized bucket (spread_charges_stale): steady-state cost = stale
    # E+grad (bucket frozen) + build/cadence + the O(N) drift check; the
    # bucket sort (~1.8 ms) drops off the per-step path for the price of
    # ((B+s+2p)/(B+s))^3 more window MACs (KERNELS.md "next lever")
    import jax

    from atomsmm_tpu.ops.pme import build_spread_bucket

    for pad in (1, 2):
        blk_p, cap_p = choose_spread_blocks(
            grid, order, n, x=np.asarray(x), box=np.asarray(box), pad=pad)
        if blk_p is None:
            log(f"[{label}] pad={pad}: blocking declined")
            continue
        build = jax.jit(lambda xx, b=blk_p, c=cap_p: build_spread_bucket(
            xx, box, grid, order, b, c))
        bucket, ov = build(x)
        jax.block_until_ready(bucket)
        assert not bool(ov)
        t0 = time.perf_counter()
        for _ in range(5):
            bucket, ov = build(x)
        jax.block_until_ready(bucket)
        ms_build = (time.perf_counter() - t0) / 5 * 1e3

        def e_stale(xx, b=blk_p, c=cap_p, p=pad, bk=bucket):
            return pme_reciprocal_energy(
                xx, box, q, alpha, grid, order, spread_block=b,
                spread_cap=c, spread_pad=p, spread_bucket=bk)

        es = float(e_stale(x))
        rel_s = abs(es - ed) / max(abs(ed), 1e-30)
        ms_s = time_grad(e_stale, x)
        w_p = [b + order - 1 + 2 * pad for b in blk_p]
        log(f"[{label}] pad={pad} block={blk_p} cap={cap_p} windows={w_p}: "
            f"E rel {rel_s:.2e}; stale E+grad {ms_s:.3f} ms "
            f"+ build {ms_build:.3f} ms/rebuild "
            f"(blocked-every-step {ms_b:.3f})")
        out[f"stale_p{pad}_ms"] = round(ms_s, 3)
        out[f"stale_p{pad}_build_ms"] = round(ms_build, 3)
        out[f"stale_p{pad}_block"] = list(blk_p)
        out[f"stale_p{pad}_rel_dE"] = rel_s
    return out


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    import jax
    import jax.numpy as jnp

    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.pme import choose_pme_parameters

    log(f"backend: {jax.devices()[0].platform}")
    results = []

    if which in ("30k", "both"):
        system, x0, box0 = water_system(n_molecules=10000, method="pme",
                                        neighbors=True)
        ex, ev, ebox = load_eq("eq_water30k")
        x, box = jnp.asarray(ex), jnp.asarray(ebox)
        pme = next(f for f in system.forces
                   if getattr(f, "method", None) == "pme")
        q = pme.charge
        results.append(study(x, box, q, float(pme.ewald_alpha),
                             pme.grid_shape, int(pme.spline_order), "30k"))

    if which in ("100k", "both"):
        # synthetic box at water density (the NPT-config geometry); spreading
        # cost depends only on (N, grid, positions-density), not equilibration
        n_mol = 33334
        rho_spacing = 0.31  # nm, ~water O-O lattice
        n = 3 * n_mol
        l = (n_mol ** (1 / 3)) * rho_spacing
        rs = np.random.RandomState(5)
        xo = rs.uniform(0, l, (n_mol, 3))
        # H atoms near their O so the charge layout is molecular, not uniform
        xh1 = xo + rs.normal(0, 0.06, (n_mol, 3))
        xh2 = xo + rs.normal(0, 0.06, (n_mol, 3))
        x = jnp.asarray(np.concatenate([xo, xh1, xh2]) % l, jnp.float32)
        q = jnp.asarray(np.concatenate([np.full(n_mol, -0.82),
                                        np.full(2 * n_mol, 0.41)]),
                        jnp.float32)
        box = jnp.asarray([l, l, l], jnp.float32)
        alpha, grid, order = choose_pme_parameters(0.9, np.full(3, l))
        results.append(study(x, box, q, alpha, grid, order, "100k"))

    print(json.dumps(results))


if __name__ == "__main__":
    main()
