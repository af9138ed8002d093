"""AUTOGNOTHI_DEFER_LOSS_FETCH log parity: deferring the per-batch
device->host loss transfers to one fetch per epoch (pipeline/training.py
LossDrain) must not change a single log line — only *when* lines print."""

import json
import pathlib
import re

import pytest

from tests.test_train_all_e2e import MINI_VIT_HPARAMS

_TS = re.compile(r"^\[[^\]]*\] ")
_DURATION = re.compile(r"done in \d+\.\d+s")


def _train_logs(tmp_path: pathlib.Path, name: str, deferred: bool,
                monkeypatch) -> list:
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    if deferred:
        monkeypatch.setenv("AUTOGNOTHI_DEFER_LOSS_FETCH", "1")
    else:
        monkeypatch.delenv("AUTOGNOTHI_DEFER_LOSS_FETCH", raising=False)
    exp = tmp_path / name
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))
    train_all(ExpEnv(exp))
    lines = (exp / ".log.txt").read_text().splitlines()
    return [
        _DURATION.sub("done in Xs", _TS.sub("", ln))
        for ln in lines if "// " in ln
    ]


@pytest.mark.slow
def test_deferred_loss_fetch_logs_are_identical(tmp_path, monkeypatch):
    live = _train_logs(tmp_path, "live", False, monkeypatch)
    deferred = _train_logs(tmp_path, "deferred", True, monkeypatch)
    assert live, "no per-batch log lines captured"
    assert live == deferred
