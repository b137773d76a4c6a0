"""chip_smoke.py: its phases at tiny sizes on the CPU (the device gate is
bypassed by building the phase context directly, so the card-vs-CPU
comparisons compare the CPU with itself), and its refusal to run
without a GPU or without the package beside it.  The `gpu`-marked test
runs the same phases on a card (MQS_TEST_PLATFORM=gpu)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def ctx():
    with chip_smoke.Smoke(jax.devices()[0], "cpu test") as c:
        yield c


def _assert_ok(rec):
    assert rec["ok"], json.dumps(rec)
    for run in rec["runs"].values():
        assert run["first_call_s"] > 0
        assert run["compile_s"] >= 0


def test_replay_phase(ctx):
    rec = chip_smoke.phase_replay(ctx, B=16, T=128, n_golden=2, n_cpu=10)
    _assert_ok(rec)
    assert rec["check"]["golden_flights"] == [0, 1] + list(range(8, 16))
    assert rec["check"]["recenters_on_drift_flights"] > 0
    assert set(rec["runs"]) == {"xla", "hybrid"}


def test_cli_phase(ctx):
    rec = chip_smoke.phase_cli(ctx, frames=40)
    _assert_ok(rec)
    assert rec["check"]["rcs"] == [0] * 5


def test_ekf_phase(ctx):
    rec = chip_smoke.phase_ekf(ctx, B=8, T=32, n_cpu=4)
    _assert_ok(rec)
    assert rec["check"]["max_abs_dpos_m"] == 0.0   # CPU vs itself


def test_swarm_phase(ctx):
    rec = chip_smoke.phase_swarm(ctx, B=4, ticks=120, n_cpu=2, cpu_ticks=110)
    _assert_ok(rec)
    assert rec["check"]["vs_cpu_first_diff"] == {}


def test_sharded_phase_on_four_virtual_devices(ctx):
    assert len(jax.devices()) >= 4, "conftest must provide CPU devices"
    rec = chip_smoke.phase_sharded(ctx, 4, B_replay=16, B_slam=4, B_ekf=8,
                                   B_swarm=8, T=20, ticks=110)
    assert rec["ok"], json.dumps(rec)
    assert set(rec["runs"]) == {"replay_xla", "replay_hybrid", "ekf",
                                "slam", "swarm"}


def test_main_refuses_cpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    assert chip_smoke.main([]) != 0


def test_script_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_phases_on_gpu(gpu):
    with chip_smoke.Smoke(gpu, "test") as c:
        for rec in (chip_smoke.phase_replay(c, B=64, T=64, n_cpu=16),
                    chip_smoke.phase_cli(c, frames=60),
                    chip_smoke.phase_ekf(c, B=64, T=64, n_cpu=16),
                    chip_smoke.phase_swarm(c, B=16, ticks=300, n_cpu=8,
                                           cpu_ticks=300)):
            _assert_ok(rec)
