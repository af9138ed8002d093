"""Migration path: checkpoints saved by the torch reference pipeline
(`torch.save(state_dict)` as `{section}-epoch-{e}.ckpt`) load directly into
our pipeline and drive measurements."""

import json
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, "/root")

from tests.test_train_all_e2e import MINI_VIT_HPARAMS


def test_torch_saved_reference_ckpts_load_and_measure(tmp_path: pathlib.Path,
                                                     torch_reference):
    import torch
    from reference.models.vanilla_vit import (
        VanillaViTClassifier,
        VanillaViTConfig as TorchCfg,
        VanillaViTExplainer,
        VanillaViTFinal,
        VanillaViTSurrogate,
    )

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.measure_accuracy import measure_accuracy
    from autognothi.pipeline.resources import (
        get_recipe,
        load_epoch_model,
        load_params_file,
    )

    exp = tmp_path / "torch_ckpts"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))

    params = MINI_VIT_HPARAMS["net"]["params"]
    tcfg = TorchCfg(**params)
    torch.manual_seed(0)
    epochs = {
        "classifier": (VanillaViTClassifier(tcfg), 1),
        "surrogate": (VanillaViTSurrogate(tcfg), 1),
        "explainer": (VanillaViTExplainer(tcfg), 2),
        "final": (VanillaViTFinal(tcfg), 0),
    }
    for section, (model, epoch) in epochs.items():
        torch.save(model.state_dict(), exp / f"{section}-epoch-{epoch}.ckpt")

    # torch file loads through the generic loader
    loaded = load_params_file(exp / "classifier-epoch-1.ckpt")
    assert "vit.embeddings.cls_token" in loaded

    env = ExpEnv(exp)
    recipe, m_config = get_recipe(env.config)
    epoch, cls_params = load_epoch_model(env, recipe, "classifier")
    assert epoch == 1

    # the imported torch-trained classifier produces the same outputs in JAX
    import jax.numpy as jnp

    xs = np.random.RandomState(0).randn(2, 3, 16, 16).astype(np.float32)
    mask = np.ones((2, 4), dtype=np.int64)
    ours, _ = recipe.fw_classifier(m_config, cls_params, jnp.asarray(xs),
                                   jnp.asarray(mask))
    t_model = epochs["classifier"][0].eval()
    with torch.no_grad():
        theirs = t_model(
            torch.tensor(xs),
            torch.cat([torch.ones(2, 1, dtype=torch.long),
                       torch.tensor(mask)], dim=1),
        ).numpy()
    np.testing.assert_allclose(np.asarray(ours), theirs, atol=2e-5, rtol=1e-4)

    # a measurement runs end-to-end off the torch checkpoints
    report = measure_accuracy(env)
    assert len(report.accuracy) == 3
