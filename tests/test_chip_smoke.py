"""chip_smoke.py and the device/cache helpers it rests on, checked on the
CPU: the refusal paths (no GPU, no package beside the script), the last
line's keys, the gate's comparison on a small system, and the compile-cache
location. One test runs the script itself and needs an NVIDIA GPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(script, env_updates, cwd=ROOT, timeout=600):
    env = {**os.environ, **env_updates}
    return subprocess.run([sys.executable, script], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_device_check_refuses_cpu():
    r = _run(SCRIPT, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_script_alone_refuses_to_run(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    r = _run(str(lone), {"JAX_PLATFORMS": "cpu"}, cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "atomsmm_tpu" in r.stderr


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line(jax.devices())
    rec = json.loads(line)
    assert set(rec) == {"ok", "device"}
    assert rec["ok"] is True
    assert set(rec["device"]) == {"platform", "kind", "count"}
    assert rec["device"]["platform"] == jax.devices()[0].platform
    assert rec["device"]["count"] == len(jax.devices())
    assert "\n" not in line


def test_gate_compare_f32_cells_against_f64_dense():
    """The gate's comparison run CPU-f32 (cell lists) against CPU-f64
    (dense) on argon 256: inside its tolerances, and a perturbed force
    fails it."""
    import jax.numpy as jnp

    [(label, build, _)] = [
        s for s in chip_smoke.gate_systems(argon_n=256)
        if s[0].startswith("argon")]
    system, x, box = build(np.float64)
    x = np.asarray(x, np.float64).astype(np.float32).astype(np.float64)
    ref = chip_smoke._evaluate(system, jnp.asarray(x), jnp.asarray(box),
                               cells=False)
    system32, _, box32 = build(np.float32)
    got = chip_smoke._evaluate(system32, jnp.asarray(x, jnp.float32),
                               jnp.asarray(box32, jnp.float32), cells=True)
    rep = chip_smoke.Report()
    for g in ref:
        chip_smoke._compare(rep, f"{label}, group {g}", ref[g], got[g])
    assert rep.failed == []
    e, f = got[0]
    chip_smoke._compare(rep, "perturbed", ref[0], (e, f + 1.0))
    assert len(rep.failed) == 1


def test_report_phase_counts_an_exception_as_failure(capsys):
    rep = chip_smoke.Report()

    def boom(_rep):
        raise ValueError("x")

    rep.phase("boom", boom)
    assert rep.failed == ["boom (exception)"]
    assert "FAIL  boom" in capsys.readouterr().out


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    from atomsmm_tpu.utils import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compile_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from atomsmm_tpu.utils import CHECKOUT, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert os.path.samefile(CHECKOUT, ROOT)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    from atomsmm_tpu.profiling import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


@pytest.fixture
def gpu_present():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (no nvidia-smi on this host)")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_present):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, SCRIPT], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["ok"] is True and rec["device"]["platform"] == "gpu"
