"""chip_smoke.py rehearsed at tiny sizes on the CPU: every phase runs
its real code path and its own checks (the four-card phase on four
virtual devices), and the script refuses to report success without a
GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

NB = 16
TINY = dict(poisson_big=10, poisson_mid=8, poisson_splu=6, circuit_n=500,
            complex_n=200, four_poisson=8, four_circuit_n=400)


@pytest.mark.parametrize("ordering,dtype", [("rcm", "r32"), ("nd", "r32"),
                                            ("rcm", "r64"), ("nd", "r64")])
def test_phase_poisson(ordering, dtype):
    rec = cs.phase_poisson(8, ordering, dtype, nb=NB)
    assert rec["engine"] in ("fused", "segmented")
    assert rec["gstrf_s"] > 0 and rec["residual"] > 0


def test_phase_poisson_prints_memory_analysis(capsys):
    cs.phase_poisson(6, "nd", "r32", nb=NB, memory_analysis=True)
    assert "memory_analysis(" in capsys.readouterr().out


def test_phase_vs_splu():
    assert cs.phase_vs_splu(6, nb=NB)["vs_splu"] <= cs.TOL_SPLU


def test_phase_reuse():
    rec = cs.phase_reuse(8, nb=NB, nrhs=4)
    assert rec["multi_rhs_residual"] <= cs.TOL_R32


def test_phase_circuit():
    rec = cs.phase_circuit(TINY["circuit_n"], nb=NB)
    assert max(rec["residual"], rec["refactor_residual"]) <= cs.TOL_R64
    assert rec["refactor_s"] > 0


@pytest.mark.parametrize("dtype", ["cr64", "cr32"])
def test_phase_complex(dtype):
    rec = cs.phase_complex(TINY["complex_n"], dtype, nb=NB)
    assert rec["engine"] in ("fused", "segmented")


def test_phase_compressed():
    assert cs.phase_compressed(8, nb=NB)["engine"] == "CompressedLU"


def test_phase_four_on_virtual_devices(capsys):
    cs.phase_four(TINY["four_poisson"], TINY["four_circuit_n"], nb=NB)
    out = capsys.readouterr().out
    assert out.count("engine=distributed-2d") == 2
    assert out.count("refactor_residual=") == 2 and "x4_vs_x1=" in out


def test_one_card_phase_list_and_failure_reporting(capsys):
    names = [n for n, _ in cs.one_card_phases(TINY, nb=NB)]
    assert len(names) == len(set(names)) == 11

    def boom():
        raise RuntimeError("phase broke")

    failed = cs.run_phases([("ok", lambda: {"x": 1.0}), ("bad", boom)])
    assert failed == ["bad"]
    out = capsys.readouterr().out
    assert "[ok] x=1" in out and "[bad] FAILED" in out


def test_refuses_without_gpu(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    with pytest.raises(ValueError):
        json.loads(last)
