"""The wandb branch of ExpEnv (pipeline/env.py:118-163; parity:
/root/reference/scripts/env.py:73-125) exercised with a mock module: init
with resume semantics, run-id persisted back into the config file, monotone
global step, finish on context exit, console fallback when disabled."""

import json
import pathlib
import sys
import types

from tests.test_train_all_e2e import MINI_VIT_HPARAMS


class _FakeRun:
    def __init__(self, id):
        self.id = id
        self.finished = False

    def finish(self):
        self.finished = True


def _install_fake_wandb(monkeypatch):
    calls = {"init": [], "log": []}
    mod = types.ModuleType("wandb")

    def init(**kw):
        calls["init"].append(kw)
        mod.run = _FakeRun(kw.get("id") or "generated-run-id")

    def log(data, step=None):
        calls["log"].append((dict(data), step))

    mod.init, mod.log, mod.run = init, log, None
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod, calls


def _exp_with_logger(tmp_path: pathlib.Path) -> pathlib.Path:
    hp = json.loads(json.dumps(MINI_VIT_HPARAMS))
    hp["logger_explainer"] = {
        "wandb_enabled": True,
        "wandb_project": "proj",
        "wandb_name": "name",
    }
    exp = tmp_path / "wandb_exp"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    return exp


def test_wandb_lifecycle_and_metrics(tmp_path, monkeypatch):
    mod, calls = _install_fake_wandb(monkeypatch)
    from autognothi.pipeline.env import ExpEnv

    exp = _exp_with_logger(tmp_path)
    env = ExpEnv(exp).fork(lambda c: c.logger_explainer)
    with env:
        env.metrics({"epoch": 1, "loss": 0.5})
        env.metrics({"epoch": 2, "loss": 0.25})
        env.flush_cfg()  # trainers flush after each kept checkpoint

    # init carried project/name/resume and the flattened config
    (init_kw,) = calls["init"]
    assert init_kw["project"] == "proj" and init_kw["name"] == "name"
    assert init_kw["resume"] == "allow"
    assert init_kw["config"]["net.kind"] == "vanilla_vit"

    # the generated run id was persisted into .hparams.json for resumption
    saved = json.loads((exp / ".hparams.json").read_text())
    assert saved["logger_explainer"]["wandb_run_id"] == "generated-run-id"

    # metrics hit wandb.log with a monotone step
    assert [s for _, s in calls["log"]] == [1, 2]
    assert calls["log"][0][0]["loss"] == 0.5

    # context exit finished the run
    assert mod.run.finished

    # a later session resumes under the SAME id
    calls["init"].clear()
    env2 = ExpEnv(exp).fork(lambda c: c.logger_explainer)
    with env2:
        env2.metrics({"epoch": 3, "loss": 0.1})
    assert calls["init"][0]["id"] == "generated-run-id"
    # global step continues past the persisted counter
    assert calls["log"][-1][1] == 3


def test_wandb_disabled_falls_back_to_console(tmp_path, monkeypatch):
    _, calls = _install_fake_wandb(monkeypatch)
    from autognothi.pipeline.env import ExpEnv

    exp = tmp_path / "console_exp"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))
    env = ExpEnv(exp).fork(lambda c: getattr(c, "logger_explainer", None))
    with env:
        env.metrics({"loss": 1.0})
    assert not calls["init"] and not calls["log"]
    assert "METRICS:" in (exp / ".log.txt").read_text()
