"""Resumable-stage semantics: interrupted runs pick up at the newest
checkpoint with per-epoch re-derived seeds (SURVEY §5.3/§5.4)."""

import json
import pathlib

from tests.test_train_all_e2e import MINI_VIT_HPARAMS


def test_training_resumes_from_latest_epoch(tmp_path: pathlib.Path):
    import copy

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    hp = copy.deepcopy(MINI_VIT_HPARAMS)
    hp["train_explainer"]["epochs"] = 3
    exp = tmp_path / "resume"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp))

    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "explainer-epoch-3.ckpt").exists()
    assert (exp / "final-epoch-0.ckpt").exists()

    # simulate an interruption: final + last explainer epoch lost
    (exp / "final-epoch-0.ckpt").unlink()
    (exp / "explainer-epoch-3.ckpt").unlink()

    env2 = ExpEnv(exp)
    train_all(env2)
    assert (exp / "explainer-epoch-3.ckpt").exists()
    assert (exp / "final-epoch-0.ckpt").exists()
    log = (exp / ".log.txt").read_text()
    # stage detection resumed at 5 (explainer partially trained), and the
    # resumed run trained ONLY epoch 3 (not 1/2) in the second pass
    assert "current stage: 5 / 7" in log


def test_ckpt_retention_follows_cadence(tmp_path: pathlib.Path):
    import copy

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    hp = copy.deepcopy(MINI_VIT_HPARAMS)
    hp["train_explainer"]["epochs"] = 4
    hp["train_explainer"]["ckpt_when"] = "_:%2==0"  # keep even epochs
    exp = tmp_path / "cadence"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp))

    train_all(ExpEnv(exp))
    kept = sorted(
        int(p.name.split("-epoch-")[1].split(".")[0])
        for p in exp.glob("explainer-epoch-*.ckpt")
    )
    # epoch 0 (initial), evens by cadence, final epoch
    assert kept == [0, 2, 4]


def test_orbax_backend_roundtrip(tmp_path, monkeypatch):
    """Orbax directories interchange with npz files under the same paths."""
    import numpy as np

    from autognothi.pipeline.resources import (
        latest_epoch,
        load_params_file,
        save_params,
        _ckpt_path,
    )

    params = {
        "layer.0.weight": np.arange(6, dtype=np.float32).reshape(2, 3),
        "head.bias": np.ones((4,), dtype=np.float32),
    }
    monkeypatch.setenv("AUTOGNOTHI_CKPT_BACKEND", "orbax")
    file = _ckpt_path(tmp_path, "surrogate", 1)
    save_params(file, params)
    assert file.is_dir()  # orbax payloads are directories
    assert latest_epoch(tmp_path, "surrogate", 5) == 1
    got = load_params_file(file)
    assert set(got) == set(params)
    for k in params:
        np.testing.assert_array_equal(got[k], params[k])

    # npz written beside it still loads (mixed-format experiment dir)
    monkeypatch.setenv("AUTOGNOTHI_CKPT_BACKEND", "npz")
    file2 = _ckpt_path(tmp_path, "surrogate", 2)
    save_params(file2, params)
    assert file2.is_file()
    assert latest_epoch(tmp_path, "surrogate", 5) == 2
    got2 = load_params_file(file2)
    np.testing.assert_array_equal(got2["head.bias"], params["head.bias"])


def test_orbax_retention_deletes_directories(tmp_path, monkeypatch):
    """Cadence retention unlinks Orbax directory payloads like npz files."""
    import numpy as np

    from autognothi.pipeline.config import Config_Train
    from autognothi.pipeline.resources import (
        get_epoch_ckpts,
        save_epoch_ckpt,
    )

    monkeypatch.setenv("AUTOGNOTHI_CKPT_BACKEND", "orbax")
    cfg = Config_Train(epochs=4, ckpt_when="_:%2==0", lr=0.1, batch_size=1)
    params = {"w": np.zeros((2,), dtype=np.float32)}
    for epoch in range(5):
        save_epoch_ckpt(tmp_path, "surrogate", cfg, epoch, params)
    # epochs 0, 2, 4 kept (cadence + first/last); 1 and 3 deleted
    assert get_epoch_ckpts(tmp_path, "surrogate", 4) == [0, 2, 4]
