"""PME (order, grid) accuracy frontier — CPU f64 reference.

In the MXU one-hot spreading formulation (ops/pme.py::spread_charges) the
per-atom cost is INDEPENDENT of the spline order: the dense per-dimension
weight matrices are (C, K_d) whatever the support width. Higher order +
coarser grid therefore trades nothing on the spreading side and shrinks
both the wyz HBM traffic (∝ K²) and the FFT (∝ K³) — the opposite of the
usual scatter-kernel economics where order⁳ dominates.

This study measures, for the frozen 30k water state, the reciprocal-space
accuracy of candidate (order, grid) pairs against a well-converged f64
reference (order 8, 96³), reporting relative energy error and relative
RMS force error. The headline PME tolerance is 5e-4 (openmm default).

Run: python tools/pme_order_study.py   (CPU, f64 — no GPU needed)
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from bench import load_eq  # noqa: E402


def main():
    from atomsmm_tpu.models import water_system
    from atomsmm_tpu.ops.pme import (
        choose_pme_parameters,
        pme_reciprocal_energy,
    )

    system, x0, box0 = water_system(n_molecules=10000, method="pme",
                                    neighbors=True)
    ex, ev, ebox = load_eq("eq_water30k")
    x = jnp.asarray(ex, jnp.float64)
    box = jnp.asarray(ebox, jnp.float64)
    # charges from the system's nonbonded force
    nb = next(f for f in system.forces
              if f.__class__.__name__ == "NonbondedForce")
    q = jnp.asarray(nb.charge, jnp.float64)
    alpha, grid_default, _ = choose_pme_parameters(0.9, np.asarray(ebox))
    print(f"alpha={alpha:.4f} default grid={grid_default}", file=sys.stderr)

    def e_and_f(order, k, dtype):
        xx = x.astype(dtype)
        bb = box.astype(dtype)
        qq = q.astype(dtype)

        def e(y):
            return pme_reciprocal_energy(y, bb, qq, dtype(alpha),
                                         (k, k, k), order=order)

        ee, ff = jax.value_and_grad(e)(xx)
        return np.float64(ee), np.asarray(ff, np.float64)

    e_ref, f_ref = e_and_f(8, 96, jnp.float64)
    f_scale = np.sqrt(np.mean(f_ref**2))
    print(f"reference (order 8, 96^3, f64): E={e_ref:.6f}", file=sys.stderr)

    print(f"{'order':>5} {'grid':>5} {'rel dE':>10} {'rel F rms':>10}"
          f" {'wyz MB/chunk':>12} {'fft pts':>9}", file=sys.stderr)
    for order, k in [(4, 64), (4, 60), (5, 54), (6, 48), (6, 45),
                     (7, 45), (8, 40), (8, 36), (10, 32)]:
        ee, ff = e_and_f(order, k, jnp.float32)
        de = abs(ee - e_ref) / abs(e_ref)
        df = np.sqrt(np.mean((ff - f_ref) ** 2)) / f_scale
        mb = 2048 * k * k * 4 / 1e6
        print(f"{order:>5} {k:>5} {de:10.2e} {df:10.2e} {mb:12.1f}"
              f" {k**3:>9}", file=sys.stderr)


if __name__ == "__main__":
    main()
