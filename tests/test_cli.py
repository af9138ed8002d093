"""CLI surface via real subprocesses: run_all + reports + demos + probes."""

import json
import pathlib
import subprocess
import sys

import pytest

from tests.test_train_all_e2e import MINI_VIT_HPARAMS

REPO = pathlib.Path(__file__).parent.parent


def _run(*args, check=True):
    return subprocess.run(
        [sys.executable, str(REPO / "main.py"), *args],
        capture_output=True, text=True, timeout=1200, check=check,
    )


@pytest.fixture(scope="module")
def cli_exp(tmp_path_factory) -> pathlib.Path:
    exp = tmp_path_factory.mktemp("cli") / "vit_mini"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))
    return exp


def test_run_all_and_reports(cli_exp: pathlib.Path):
    _run("run_all", str(cli_exp), "--device", "cpu")
    produced = sorted(p.name for p in (cli_exp / ".reports").iterdir())
    assert "faithfulness.json" in produced
    assert "performance.json" in produced


def test_image_explanation_cmd(cli_exp: pathlib.Path):
    out = cli_exp / "img.json"
    _run("run_image_explanation", str(cli_exp), "--device", "cpu",
         "--into", str(out), "--limit", "2")
    data = json.loads(out.read_text())
    assert "items" in data


def test_unknown_command_fails_cleanly():
    proc = _run("not_a_command", "/tmp", check=False)
    assert proc.returncode != 0
    assert "invalid choice" in proc.stderr


def test_show_fridge_cmd(cli_exp: pathlib.Path):
    # no --device flag: the fridge viewer is a host-side param table
    proc = _run("__show_fridge__", str(cli_exp))
    assert "surrogate_null" in proc.stdout


def test_estimate_train_time_cmd(cli_exp: pathlib.Path):
    proc = subprocess.run(
        [sys.executable, str(REPO / "main.py"), "estimate_train_time",
         str(cli_exp), "--device", "cpu"],
        input="8\n", capture_output=True, text=True, timeout=1200, check=True,
    )
    assert "estimated training time" in proc.stdout


@pytest.mark.parametrize("device", ["gpu", "cuda:0", ""],
                         ids=["gpu", "cuda0", "default"])
def test_gpu_device_without_a_gpu_exits_nonzero(cli_exp, device):
    """The CLI runs on the GPU unless the host is asked for: with JAX held
    to the CPU backend (no CUDA plugin here), `--device gpu`/`cuda:N` and
    the default (JAX_PLATFORMS unset) refuse instead of falling back."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    argv = ["train_all", str(cli_exp)] + (["--device", device] if device
                                          else [])
    proc = subprocess.run([sys.executable, str(REPO / "main.py"), *argv],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert "NEW RUN" not in proc.stdout  # stopped before any stage ran


def test_unknown_device_is_refused(cli_exp):
    proc = _run("train_all", str(cli_exp), "--device", "rocm", check=False)
    assert proc.returncode != 0
    assert "unknown --device 'rocm'" in proc.stderr


def test_module_entry_and_packaging_metadata():
    # `python -m autognothi` is the installed-distribution entry
    # (pyproject [project.scripts] routes `autognothi` to the same main)
    proc = subprocess.run(
        [sys.executable, "-m", "autognothi", "--help"],
        capture_output=True, text=True, timeout=120, check=True, cwd=REPO,
    )
    assert "run_all" in proc.stdout and "export_final" in proc.stdout

    import tomllib

    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert meta["project"]["scripts"]["autognothi"] == "autognothi.cli:main"
    assert meta["project"]["requires-python"] == ">=3.12"
    assert not any(d.startswith("pydantic")
                   for d in meta["project"]["dependencies"])
    # the native cores ship as source (built on first use) and the offline
    # assets ride as package data — an sdist/wheel must include them
    assert "*.cpp" in meta["tool"]["setuptools"]["package-data"][
        "autognothi.native"]
