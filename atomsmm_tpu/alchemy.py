"""Alchemical free-energy machinery: vmapped lambda batches + MBAR.

The reference's workflow (SURVEY.md §3.4): run MD at each lambda state,
periodically evaluate the potential at ALL lambda' states to build a K x K
(or K x n_samples) reduced-energy matrix, then post-process with MBAR (the
reference defers to external pymbar; pymbar is not available here, so the
solver is implemented as a plain JAX fixed point — SURVEY.md §7 M7).

Shape: lambda is a traced scalar inside the potential, so the multi-state
energy evaluation is ONE vmap over the globals dict — no recompilation, no
loops (SURVEY.md §2b N9).

Examples:

>>> import jax.numpy as jnp
>>> from atomsmm_tpu import SolvationSystem
>>> from atomsmm_tpu.models import water_system
>>> from atomsmm_tpu.potential import potential_energy
>>> system, x, box = water_system(n_molecules=27, r_cut=0.45, r_switch=0.35)
>>> solv = SolvationSystem(system, solute_atoms=jnp.arange(3))
>>> lams = jnp.asarray([0.0, 0.5, 1.0])
>>> es = multistate_energies(solv, x, box,
...                          {"lambda_vdw": lams, "lambda_coul": lams})
>>> es.shape
(3,)
>>> e_mid = potential_energy(solv, x, box,
...                          {"lambda_vdw": 0.5, "lambda_coul": 0.5})
>>> bool(abs(es[1] - e_mid) < 1e-10)             # vmap == scalar evaluation
True

MBAR on an analytically solvable case — two identical states have zero free
energy difference:

>>> u_kn = jnp.stack([jnp.asarray([1.0, 2.0, 3.0, 4.0])] * 2)
>>> f = mbar_free_energies(u_kn, jnp.asarray([2, 2]))
>>> bool(abs(f[1] - f[0]) < 1e-10)
True
"""
from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from .potential import potential_energy
from .units import BOLTZMANN


def multistate_energies(system, x, box, lambdas: Dict[str, jnp.ndarray],
                        aux=None):
    """Potential energy of configuration x at every lambda state.

    lambdas maps parameter name -> (K,) array; returns (K,) energies via one
    vmap over the globals dict.
    """

    def e_of(globals):
        return potential_energy(system, x, box, globals, aux=aux)

    return jax.vmap(e_of)(lambdas)


def reduced_energy_matrix(system, xs, box, lambdas: Dict[str, jnp.ndarray],
                          temperature, aux=None):
    """u[k, n] = beta * U(x_n; lambda_k) for a batch of configurations
    xs (Nsamples, N, 3) — the MBAR input (SURVEY.md §3.4). vmapped over both
    axes."""
    beta = 1.0 / (BOLTZMANN * temperature)

    def u_one(x):
        return beta * multistate_energies(system, x, box, lambdas, aux)

    return jax.vmap(u_one, out_axes=1)(xs)  # (K, Nsamples)


def mbar_free_energies(u_kn: jnp.ndarray, n_k: jnp.ndarray,
                       n_iter: int = 200, damping: float = 1.0):
    """Solve the MBAR equations by damped self-consistent iteration.

    Args:
      u_kn: (K, Ntot) reduced energies of every sample evaluated in every
        state k (samples concatenated across states).
      n_k: (K,) number of samples drawn from each state.
      n_iter: fixed iteration count (jit-friendly lax.scan).

    Returns (K,) dimensionless free energies f_k with f_0 = 0.

    f_k = -log sum_n exp(-u_kn) / sum_l N_l exp(f_l - u_ln)
    """
    u_kn = jnp.asarray(u_kn)
    n_k = jnp.asarray(n_k, u_kn.dtype)
    log_nk = jnp.log(n_k)

    def step(f, _):
        # log denominator per sample: logsumexp_l [log N_l + f_l - u_ln]
        log_denom = jax.scipy.special.logsumexp(
            log_nk[:, None] + f[:, None] - u_kn, axis=0
        )  # (Ntot,)
        new_f = -jax.scipy.special.logsumexp(-u_kn - log_denom[None, :], axis=1)
        new_f = new_f - new_f[0]
        return f + damping * (new_f - f), None

    f0 = jnp.zeros(u_kn.shape[0], u_kn.dtype)
    f, _ = jax.lax.scan(step, f0, None, length=n_iter)
    return f


def mbar_overlap_weights(u_kn, n_k, f_k):
    """W[n, k]: sample weights in each state (for reweighted observables)."""
    log_nk = jnp.log(jnp.asarray(n_k, u_kn.dtype))
    log_denom = jax.scipy.special.logsumexp(
        log_nk[:, None] + f_k[:, None] - u_kn, axis=0
    )
    log_w = f_k[:, None] - u_kn - log_denom[None, :]
    return jnp.exp(log_w)  # (K, Ntot)


def ti_gradient(system, x, box, lambda_name: str, lambda_value,
                globals=None, aux=None):
    """dU/dlambda at a configuration — thermodynamic-integration integrand
    (lambda is a traced argument, so this is one jax.grad)."""
    globals = dict(globals or {})

    def e_of(lam):
        g = dict(globals)
        g[lambda_name] = lam
        return potential_energy(system, x, box, g, aux=aux)

    return jax.grad(e_of)(jnp.asarray(lambda_value, x.dtype))


# ---------------------------------------------------------------------------
# End-to-end solvation free energy (SURVEY.md §3.4; BASELINE config 3).
# The reference stops at the reduced-energy matrix and defers to pymbar;
# here the full loop — sampling per lambda state, K-state reweighting, MBAR
# AND TI with cross-validation — runs natively.
# ---------------------------------------------------------------------------


def coupling_path(s):
    """The standard two-stage coupling path: vdW grows over s in [0, 1/2]
    (softcore handles the overlap), charges only after the repulsive core is
    in place (s in [1/2, 1]) — switching Coulomb on while vdW is still soft
    is the classic charge-collapse failure. Returns per-name (K,) schedules
    for a master grid s."""
    s = jnp.asarray(s)
    return {
        "lambda_vdw": jnp.clip(2.0 * s, 0.0, 1.0),
        "lambda_coul": jnp.clip(2.0 * s - 1.0, 0.0, 1.0),
    }


def sample_lambda_states(system, x0, box, lambdas, temperature, dt=0.001,
                         friction=5.0, n_equil=200, n_samples=20,
                         sample_interval=25, seed=0):
    """Sequential NVT sampling at each lambda state.

    `lambdas` maps parameter name -> (K,) per-state values. One Context is
    built and reused for every state (lambda values are traced globals — no
    recompilation, SURVEY.md §2b N9). States are visited from the COUPLED end
    (last state first): each starts from the previous state's configuration,
    so the decoupled states inherit an equilibrated condensed-phase structure
    instead of growing overlaps. Sampling uses velocity Verlet with an exact
    Ornstein-Uhlenbeck bath (BAOAB-like splitting).

    Returns (xs, n_k): xs (K * n_samples, N, 3) configurations ordered by
    state index (matching the lambdas arrays), n_k (K,) samples per state.
    """
    import numpy as np

    from .context import Context
    from .integrate.integrators import GlobalThermostatIntegrator
    from .integrate.propagators import (
        OrnsteinUhlenbeckPropagator,
        VelocityVerletPropagator,
    )
    from .state import make_state

    integ = GlobalThermostatIntegrator(
        dt,
        VelocityVerletPropagator(),
        OrnsteinUhlenbeckPropagator(temperature, friction),
    )
    ctx = Context(system, integ, make_state(x0, box=box, seed=seed))
    ctx.set_velocities_to_temperature(temperature, seed=seed + 1)
    k_states = len(next(iter(lambdas.values())))
    xs = [None] * k_states
    for name, values in lambdas.items():
        ctx.set_parameter(name, float(values[k_states - 1]))
    ctx.step(3 * n_equil)  # melt the builder lattice at the coupled state
    for k in reversed(range(k_states)):
        for name, values in lambdas.items():
            ctx.set_parameter(name, float(values[k]))
        ctx.step(n_equil)
        samples = []
        for _ in range(n_samples):
            ctx.step(sample_interval)
            samples.append(np.asarray(ctx.state.x))
        xs[k] = np.stack(samples)
    return (jnp.asarray(np.concatenate(xs)),
            jnp.full((k_states,), n_samples, jnp.int32))


def solvation_free_energy(system, x0, box, schedule, temperature,
                          lambdas=None, n_blocks=4, aux=None,
                          mbar_iter=1000, mesh=None, hrex=False,
                          swap_every=1, **sample_kwargs):
    """Coupling free energy ΔG(s: schedule[0] -> schedule[-1]) by MBAR and
    TI on the same trajectories, with block-wise error estimates.

    `schedule` is the master path parameter s (K,); `lambdas` maps parameter
    name -> (K,) values along the path (default: the two-stage
    `coupling_path` — vdW first, then charges). TI integrates each
    mean dU/dlambda_name profile against its OWN lambda grid and sums —
    exact quadrature over a piecewise-linear path (segments where a lambda
    is constant contribute nothing).

    Returns a dict:
      dg_mbar, dg_ti          [kJ/mol] (MBAR is the headline estimator)
      err_mbar, err_ti        block standard errors (n_blocks blocks)
      f_k                     (K,) dimensionless MBAR free energies
      ti_profile              {name: (K,) mean dU/dlambda_name per state}

    The MBAR/TI cross-check is the validity test: both estimators on the same
    samples must agree within their joint error bars (tests/test_alchemy.py).

    Sampling backends: the default visits the K states sequentially in one
    Context; with hrex=True (or a `mesh`) the K states run as data-parallel
    replicas with Hamiltonian-replica-exchange mixing (parallel/hrex.py —
    K-fold fewer sequential MD steps, replica batch sharded over the mesh
    when one is given). The returned dict then also carries
    `swap_acceptance`.
    """
    import numpy as np

    schedule = jnp.asarray(schedule)
    k_states = schedule.shape[0]
    lambdas = dict(lambdas) if lambdas is not None else coupling_path(schedule)
    swap_info = None
    if hrex or mesh is not None:
        from .parallel.hrex import hrex_sample_lambda_states

        xs, n_k, swap_info = hrex_sample_lambda_states(
            system, x0, box, lambdas, temperature, mesh=mesh,
            swap_every=swap_every, **sample_kwargs
        )
    else:
        xs, n_k = sample_lambda_states(
            system, x0, box, lambdas, temperature, **sample_kwargs
        )
    kT = BOLTZMANN * temperature

    u_kn = reduced_energy_matrix(system, xs, box, lambdas, temperature,
                                 aux=aux)
    n_samples = int(n_k[0])

    def dudl_at(name, k, x):
        g = {nm: values[k] for nm, values in lambdas.items()}
        return ti_gradient(system, x, box, name, lambdas[name][k], globals=g,
                           aux=aux)

    # per-name mean dU/dlambda over each state's own samples
    dudl = {}
    for name in lambdas:
        rows = []
        for k in range(k_states):
            own = xs[k * n_samples:(k + 1) * n_samples]
            rows.append(jax.vmap(lambda x: dudl_at(name, k, x))(own))
        dudl[name] = jnp.stack(rows)  # (K, n_samples)

    def mbar_dg(u):
        f = mbar_free_energies(u, n_k, n_iter=mbar_iter)
        return float((f[-1] - f[0]) * kT)

    def ti_dg(sample_slice):
        return float(sum(
            jnp.trapezoid(jnp.mean(dudl[name][:, sample_slice], axis=1),
                          lambdas[name])
            for name in lambdas
        ))

    dg_mbar = mbar_dg(u_kn)
    dg_ti = ti_dg(slice(None))

    # block error estimates: split each state's samples into n_blocks
    # contiguous blocks, re-estimate per block
    blocks_mbar, blocks_ti = [], []
    bs = n_samples // n_blocks
    if bs >= 1:
        for b in range(n_blocks):
            sel = np.concatenate([
                np.arange(k * n_samples + b * bs,
                          k * n_samples + (b + 1) * bs)
                for k in range(k_states)
            ])
            blocks_mbar.append(mbar_dg(u_kn[:, sel]))
            blocks_ti.append(ti_dg(slice(b * bs, (b + 1) * bs)))
    err = lambda v: float(np.std(v, ddof=1) / np.sqrt(len(v))) if len(v) > 1 else float("nan")  # noqa: E731
    out = {
        "dg_mbar": dg_mbar,
        "dg_ti": dg_ti,
        "err_mbar": err(blocks_mbar),
        "err_ti": err(blocks_ti),
        "f_k": mbar_free_energies(u_kn, n_k, n_iter=mbar_iter),
        "ti_profile": {k: jnp.mean(v, axis=1) for k, v in dudl.items()},
        "n_samples_total": int(xs.shape[0]),
    }
    if swap_info is not None:
        out["swap_acceptance"] = swap_info["acceptance"]
        out["swap_attempts"] = swap_info["swap_attempts"]
    return out
