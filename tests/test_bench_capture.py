"""Unit tests for bench.py's capture machinery (no device, no MD): the JSON
emission contract (last-line-wins re-emission, always-parseable records),
the self-asserting telemetry bands (VERDICT r4 #3), and the opt-in
capacity-replay floors. bench.py's module level imports only stdlib, numpy
and jax (no backend is initialized), so importing it here never touches a
device."""
import importlib
import io
import json
import sys

import pytest


@pytest.fixture()
def bench(monkeypatch):
    monkeypatch.delenv("BENCH_CAPS_REPLAY", raising=False)
    monkeypatch.delenv("BENCH_RECORD_CAPS", raising=False)
    import bench as b

    return importlib.reload(b)


def test_emit_lines_are_independent_parseable_records(bench, capsys):
    bench.emit(28.17, {"a": 1})
    bench.emit(28.17, {"a": 1, "b": 2})
    bench.emit(0.0, {"a": 1}, error="killed by signal 15")
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 3
    recs = [json.loads(l) for l in lines]  # every line parses on its own
    assert recs[0]["value"] == 28.17
    assert recs[0]["vs_baseline"] == pytest.approx(
        28.17 / bench.COMPARATOR_NS_DAY, abs=1e-3)
    assert recs[1]["extras"] == {"a": 1, "b": 2}  # last line wins
    assert "signal 15" in recs[2]["error"]
    assert {"metric", "value", "unit", "vs_baseline", "extras"} <= set(recs[1])


def test_grade_flags_out_of_band_telemetry(bench):
    extras = {
        "water30k_respa_cutoff_T_K": 300.6,
        "water30k_respa_cutoff_PE_per_atom": -14.23,
        "water30k_respa_cutoff_drift_kJ_mol_atom_ps": -0.024,
    }
    bench.grade("water30k_respa_cutoff", extras)
    assert extras["water30k_respa_cutoff_ok"] is True
    assert "telemetry_misses" not in extras

    bad = {
        "water30k_respa_cutoff_T_K": 350.0,  # thermostat failure
        "water30k_respa_cutoff_PE_per_atom": -14.23,
        "water30k_respa_cutoff_drift_kJ_mol_atom_ps": -0.024,
    }
    bench.grade("water30k_respa_cutoff", bad)
    assert bad["water30k_respa_cutoff_ok"] is False
    assert bad["telemetry_misses"] == ["water30k_respa_cutoff"]
    # the bands ride along so the JSON is self-explanatory
    assert "T" in bad["water30k_respa_cutoff_expected"]


def test_grade_swm4_uses_per_bath_temperatures(bench):
    """The generic T_K for SWM4 is the MIXED kinetic temperature (~204 K);
    the physical pass/fail is the per-bath split (r5 capture fix)."""
    extras = {
        "swm4_10k_drude_el_T_K": 204.5,
        "swm4_10k_drude_el_T_atoms_K": 299.0,
        "swm4_10k_drude_el_T_drude_K": 1.5,
    }
    bench.grade("swm4_10k_drude_el", extras)
    assert extras["swm4_10k_drude_el_ok"] is True
    hot = dict(extras, swm4_10k_drude_el_T_drude_K=40.0)
    hot.pop("swm4_10k_drude_el_ok")
    bench.grade("swm4_10k_drude_el", hot)
    assert hot["swm4_10k_drude_el_ok"] is False


def test_caps_floors_opt_in(monkeypatch):
    """Capacity-replay floors engage only under BENCH_CAPS_REPLAY=1 — the
    default capture measures at tight snapshot caps (replay was measured
    to cost 17% on the headline; see the caps comment block)."""
    monkeypatch.delenv("BENCH_CAPS_REPLAY", raising=False)
    import bench as b

    b = importlib.reload(b)
    b._CAPS["some_tag"] = {"default": 128, "near": 40}
    assert b.caps_floors("some_tag") == {}

    monkeypatch.setenv("BENCH_CAPS_REPLAY", "1")
    b = importlib.reload(b)
    b._CAPS["some_tag"] = {"default": 128, "near": 40}
    assert b.caps_floors("some_tag") == {"default": 128, "near": 40}
    assert b.caps_floors(None) == {}
    # restore pristine module state for other tests
    monkeypatch.delenv("BENCH_CAPS_REPLAY")
    importlib.reload(b)


def test_expected_bands_cover_every_telemetry_config(bench):
    """Every MD config that records telemetry has an EXPECT band, so no
    row in the capture is ungradeable."""
    for tag in ("water30k_respa_cutoff", "water30k_respa_pme",
                "water30k_sinr", "emim_bf4_sinr_pme", "tip3p30k_settle_nvt",
                "tip3p30k_settle_hmr_respa16fs", "tip3p30k_settle_hmr_4fs",
                "argon4k_nve", "water100k_npt", "water100k_npt_pme",
                "swm4_10k_drude_el"):
        assert tag in bench.EXPECT, f"no telemetry band for {tag}"
