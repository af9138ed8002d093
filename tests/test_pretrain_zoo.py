"""Base-model fine-tuning round trip through the zoo store (inventory row 31,
SURVEY §2.8): `pretrain_classifier` on a random_init experiment exports an
internal-layout `ft_*` base (parity: /root/reference/scripts/
pretrain_classifier.py:57-63), and a second experiment consumes it through
`conv_pretrained_classifier` — the offline (zero-egress) leg of the
reference's params/loader.py:135-182 fine-tuned-base loop."""

import copy
import json
import pathlib

import numpy as np
import pytest

from tests.test_train_all_e2e import MINI_VIT_HPARAMS


@pytest.fixture()
def tmp_store(tmp_path, monkeypatch):
    # the zoo store lives inside the package; tests must not write there
    import autognothi.zoo.loader as zoo

    store = tmp_path / "store"
    monkeypatch.setattr(zoo, "_STORE", store)
    return store


def test_pretrain_export_and_reuse(tmp_path: pathlib.Path, tmp_store):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.pretrain_classifier import pretrain_classifier
    from autognothi.pipeline.resources import load_epoch_model, get_recipe
    from autognothi.pipeline.train_all import conv_pretrained_classifier

    ft_exp = tmp_path / "ft_vit_tiny_imagenette"
    ft_exp.mkdir()
    (ft_exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))
    env = ExpEnv(ft_exp)
    pretrain_classifier(env)

    dest = tmp_store / "ft_vit_tiny_imagenette"
    assert (dest / "params.npz").exists()
    assert (dest / "model.json").exists()
    exported = dict(np.load(dest / "params.npz"))

    # a second experiment bootstraps from the exported ft_ base: its stage-0
    # classifier ckpt must carry the fine-tuned weights verbatim
    cfg2 = copy.deepcopy(MINI_VIT_HPARAMS)
    cfg2["net"]["base_model"] = "ft_vit_tiny_imagenette"
    exp2 = tmp_path / "vit_from_ft"
    exp2.mkdir()
    (exp2 / ".hparams.json").write_text(json.dumps(cfg2, indent=2))
    env2 = ExpEnv(exp2)
    conv_pretrained_classifier(env2)

    recipe, _ = get_recipe(env2.config)
    epoch, params = load_epoch_model(env2, recipe, "classifier")
    assert epoch == 0
    assert sorted(params) == sorted(exported)
    for name, value in exported.items():
        np.testing.assert_array_equal(np.asarray(params[name]), value)


def test_unknown_ft_base_fails_closed(tmp_store):
    from autognothi.zoo.loader import load_params

    with pytest.raises(FileNotFoundError, match="pretrain_classifier"):
        load_params("ft_nonexistent", num_labels=2)
