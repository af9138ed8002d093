"""bench.py contract: main() emits ONE JSON line with the headline metric,
the device it ran on and all six families' throughput + three ratios; a
child that fails fails the run; with no GPU nothing is measured."""

import json
import os
import subprocess
import sys

import pytest

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_children(values, fail=()):
    def run_child(model):
        if model in fail:
            raise SystemExit(f"bench child {model!r} failed (rc=1)")
        return {"expl_per_sec": values[model], "batch": 8, "platform": "gpu",
                "device_kind": "NVIDIA H100 80GB HBM3", "count": 1}

    return run_child


VALUES = {"ltt": 2600.0, "vanilla": 1450.0, "froyo": 3800.0,
          "bert": 400.0, "ltt_bert": 670.0, "froyo_bert": 885.0}


@pytest.fixture(autouse=True)
def _no_nvidia_smi(monkeypatch):
    monkeypatch.setattr(bench, "gpu_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")


def test_main_emits_six_families_with_ratios(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_run_child", _fake_children(VALUES))
    bench.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert out["metric"] == "ltt_vit_base_224_explanations_per_sec_per_gpu"
    assert out["value"] == 2600.0
    assert out["device"] == {"platform": "gpu",
                             "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                             "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}
    for fam in ("vanilla", "froyo", "bert", "ltt_bert", "froyo_bert"):
        assert out[f"{fam}_expl_per_sec"] == VALUES[fam]
        for ratio in ("vs_baseline", "vs_baseline_matched",
                      "vs_ref_cpu_measured"):
            assert out[f"{fam}_{ratio}"] > 0
    # per-track cross-architecture anchoring: the vanilla family of each
    # track IS its own baseline, so vs_baseline == vs_baseline_matched
    assert out["vanilla_vs_baseline"] == out["vanilla_vs_baseline_matched"]
    assert out["bert_vs_baseline"] == out["bert_vs_baseline_matched"]
    # and the non-vanilla families' cross-architecture ratio exceeds their
    # matched one (they do less work per explanation than the 3-tower)
    assert out["ltt_bert_vs_baseline"] > out["ltt_bert_vs_baseline_matched"]


def test_main_fails_when_a_child_fails(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_run_child",
                        _fake_children(VALUES, fail={"froyo_bert"}))
    with pytest.raises(SystemExit, match="froyo_bert"):
        bench.main()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv", [["--child", "ltt"], []],
                         ids=["child", "main"])
def test_bench_exits_nonzero_without_gpu(argv):
    """With JAX held to the CPU the child refuses to time anything, and
    main() fails with it: no result line is printed."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "bench.py", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"metric"' not in proc.stdout and "expl_per_sec" not in proc.stdout
