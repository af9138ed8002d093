"""Measurement suite over a trained mini experiment: all reports produce,
cache, and reload."""

import json
import pathlib

import pytest

from tests.test_train_all_e2e import MINI_VIT_HPARAMS


@pytest.fixture(scope="module")
def trained_exp(tmp_path_factory) -> pathlib.Path:
    exp = tmp_path_factory.mktemp("measured") / "vit_mini"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    train_all(ExpEnv(exp))
    return exp


def test_measure_all_produces_reports(trained_exp: pathlib.Path):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.measure_all import measure_all

    env = ExpEnv(trained_exp)
    measure_all(env)
    reports = trained_exp / ".reports"
    produced = sorted(p.name for p in reports.iterdir())
    assert produced == [
        "accuracy.json",
        "branches_cka.json",
        "cls_acc.json",
        "faithfulness.json",
        "performance.json",
        "train_resources.json",
    ]  # dual_task_similarity gated off for vanilla recipes

    # basic sanity of headline numbers
    faith = json.loads((reports / "faithfulness.json").read_text())
    assert 0.0 <= faith["insertion"]["auc"] <= 1.0
    assert 0.0 <= faith["deletion"]["auc"] <= 1.0
    acc = json.loads((reports / "accuracy.json").read_text())
    assert len(acc["masked_players"]) == len(acc["accuracy"]) == 3
    perf = json.loads((reports / "performance.json").read_text())
    assert perf["final"]["time_avg"] > 0
    assert perf["final"]["params_all"] > perf["classifier"]["params_all"]
    # per-stage device working set, labeled (extension; CPU exposes XLA's
    # static memory analysis)
    for stage in ("classifier", "surrogate", "explainer", "final"):
        assert perf[stage]["mem_mib"] > 0, stage
        assert perf[stage]["mem_estimator"] == "compiled_memory_analysis"

    # CPU has no device allocator stats: the MiB cells must come from the
    # labeled XLA memory-analysis fallback, never silent zeros
    trn = json.loads((reports / "train_resources.json").read_text())
    assert trn["mem_estimator"] == "compiled_memory_analysis"
    assert trn["init_mem"] > 0
    assert trn["srg_mem"]["avg"] > 0
    assert trn["exp_mem"]["avg"] > 0

    # caching: mutate a cached file, re-run, it must NOT be recomputed
    sentinel = dict(acc)
    sentinel["accuracy"] = [0.123] * 3
    (reports / "accuracy.json").write_text(json.dumps(sentinel))
    measure_all(env)
    acc2 = json.loads((reports / "accuracy.json").read_text())
    assert acc2["accuracy"] == [0.123] * 3


def test_estimate_train_time(trained_exp: pathlib.Path):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.estimate_train_time import estimate_train_time

    env = ExpEnv(trained_exp)
    estimate_train_time(env)
    log = (trained_exp / ".log.txt").read_text()
    assert "estimated training time" in log
