"""Profiling / tracing utilities (SURVEY.md §5).

The reference has essentially no profiling story (its only hooks are the
CustomIntegrator dump and reporter); the BASELINE metric however is literally
"pair-force kernel ms/step", so the harness ships one: in-loop timers that
measure each force group's evaluation and the whole step on the device
(dispatch-overhead-free: the measured function is iterated inside one jitted
fori_loop with a forced data dependency), plus a jax.profiler trace helper.
"""
from __future__ import annotations

import subprocess
import time
from typing import Dict

import jax
import jax.numpy as jnp

from .ops.neighbors import make_aux
from .potential import force_fn


def _inloop_time(fn, x, reps: int = 30, tries: int = 3) -> float:
    """Best-of wall time per call of fn(x)->(N,3), measured inside one jitted
    loop with a serializing dependency. Returns milliseconds."""

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
        jax.block_until_ready(loop(x))
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def profile_forces(context, reps: int = 30) -> Dict[str, float]:
    """ms per evaluation for every force group of a Context's system (the
    'pair-force kernel ms/step' metric), plus the measurement floor."""
    system = context.system
    state = context.state
    aux = make_aux(system, state.extra)
    out = {"overhead": _inloop_time(lambda xx: xx * 1.0, state.x, reps)}
    for g in system.force_groups:
        out[f"group {g}"] = _inloop_time(
            lambda xx, g=g: force_fn(system, {g})(
                xx, state.box, context.parameters, aux
            )[1],
            state.x,
            reps,
        )
    return out


def profile_step(context, steps: int = 100, tries: int = 3) -> float:
    """ms per integrator step, end to end (includes neighbor rebuilds,
    thermostats, barostat attempts)."""
    jax.block_until_ready(context.step(1).state)
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        jax.block_until_ready(context.step(steps).state)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best * 1e3


def trace(path: str):
    """Context manager writing a jax.profiler trace (view with XProf or
    TensorBoard): `with trace('/tmp/tb'): ctx.step(100)`."""
    return jax.profiler.trace(path)


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (one line per card), from a child process that stays off JAX.
    Every timing is reported beside it: a card set below its maximum power
    runs slower under load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return (out.stdout.strip() if out.returncode == 0
            else f"nvidia-smi failed ({out.stderr.strip()})")


def require_gpu() -> Dict:
    """The device record every measurement names — platform, device_kind,
    device count and the card (see card()) — or RuntimeError when JAX's
    default device is not a GPU. A measurement never falls back to the
    CPU."""
    try:
        devices = jax.devices()
    except RuntimeError as e:  # JAX_PLATFORMS names a backend it lacks
        raise RuntimeError(f"no GPU: JAX could not start ({e})") from e
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {d.platform} ({d.device_kind}); "
            "this needs an NVIDIA GPU and JAX's CUDA plugin")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices), "card": card()}
