"""chip_smoke.py's contract, checked where there is no GPU: it exits
non-zero and prints no result line without a GPU or outside a checkout,
runs its one-GPU phases in order, and `--four` runs only the four-GPU
path."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run_smoke(cwd: pathlib.Path, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py"), *argv],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("argv", [[], ["--four"]], ids=["one", "four"])
def test_exits_nonzero_without_gpu(argv):
    proc = _run_smoke(REPO, *argv)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _fake(monkeypatch, calls, count):
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": count, "jax": "0"}

    def phase_child(phase, timeout):
        calls.append(phase)
        if phase == "four":
            return json.dumps(device) + "\n[four] serving ok\n"
        return json.dumps(device) + "\n"

    monkeypatch.setattr(chip_smoke, "_phase_child", phase_child)
    monkeypatch.setattr(chip_smoke, "nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("phase_kernels", "phase_train", "phase_serve"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda name=name: calls.append(name))


def test_one_gpu_runs_every_phase_in_order(monkeypatch, capsys):
    calls = []
    _fake(monkeypatch, calls, 1)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    chip_smoke.main()
    assert calls == ["device", "phase_kernels", "phase_train", "phase_serve"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[-2] + lines[-3]
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_four_runs_only_its_phase(monkeypatch, capsys):
    calls = []
    _fake(monkeypatch, calls, 4)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--four"])
    chip_smoke.main()
    assert calls == ["four"]
    out = capsys.readouterr().out.strip().splitlines()
    assert "[four] serving ok" in out
    assert json.loads(out[-1])["device"]["count"] == 4
