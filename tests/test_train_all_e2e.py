"""End-to-end mini slice: vanilla ViT on a synthetic image set, through all
seven stages (conv -> classifier -> surrogate KL -> explainer Shapley ->
final merge + numeric coherency check) — the reference's mini-config
integration-test strategy (SURVEY §4.3)."""

import json
import pathlib

import numpy as np
import pytest


MINI_VIT_HPARAMS = {
    "seed": 42,
    "dataset": {
        "kind": "cv_samples",
        "train_size": 8,
        "test_size": 4,
        "img_px_size": 16,
        "num_classes": 3,
        "seed": 7,
    },
    "net": {
        "kind": "vanilla_vit",
        "version": "beta.1.01",
        "base_model": "random_init",
        "params": {
            "attention_probs_dropout_prob": 0.0,
            "explainer_attn_num_layers": 1,
            "explainer_head_hidden_size": 16,
            "explainer_normalize": True,
            "hidden_dropout_prob": 0.0,
            "hidden_size": 32,
            "intermediate_size": 64,
            "layer_norm_eps": 1e-12,
            "num_attention_heads": 4,
            "num_hidden_layers": 2,
            "num_labels": 3,
            "img_channels": 3,
            "img_px_size": 16,
            "img_patch_size": 8,
        },
    },
    "train_classifier": {
        "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
    },
    "train_surrogate": {
        "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
    },
    "train_explainer": {
        "epochs": 2, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
        "n_mask_samples": 2, "lambda_efficiency": 0.0, "lambda_norm": 0.0,
    },
    "eval_accuracy": {"dataset": None, "batch_size": 4, "resolution": 3},
    "eval_faithfulness": {"dataset": None, "batch_size": 4, "resolution": 3},
    "eval_cls_acc": {"dataset": None, "on_exp_epochs": "_:%1==0", "batch_size": 4},
    "eval_performance": {"dataset": None, "loops": 1},
    "eval_train_resources": {"dataset": None, "batch_size": 4, "max_samples": 4},
    "eval_branches_cka": {"dataset": None, "batch_size": 4},
}


@pytest.fixture()
def vit_exp(tmp_path: pathlib.Path) -> pathlib.Path:
    exp = tmp_path / "vit_mini"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))
    return exp


def test_train_all_end_to_end(vit_exp: pathlib.Path):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    env = ExpEnv(vit_exp)
    train_all(env)

    # all stage checkpoints exist
    assert (vit_exp / "classifier-epoch-1.ckpt").exists()
    assert (vit_exp / "surrogate-epoch-1.ckpt").exists()
    assert (vit_exp / "explainer-epoch-2.ckpt").exists()
    assert (vit_exp / "final-epoch-0.ckpt").exists()

    # re-running is a no-op (stage detection -> 7)
    train_all(env)

    # the final model emits (probs, per-player attributions) in one pass
    import jax.numpy as jnp

    from autognothi.pipeline.resources import get_recipe, load_epoch_model

    recipe, m_config = get_recipe(env.config)
    _, final_params = load_epoch_model(env, recipe, "final")
    xs = jnp.asarray(np.random.RandomState(0).randn(2, 3, 16, 16), jnp.float32)
    probs, attr = recipe.fw_final(m_config, final_params, xs)
    assert probs.shape == (2, 3)
    assert attr.shape == (2, 3, 4)  # <B, n_classes, n_players=4 patches>
    np.testing.assert_allclose(np.asarray(probs.sum(-1)), np.ones(2), atol=1e-5)
    # final == composition of the stored parts (coherency beyond the null input)
    srg_params = {k[len("surrogate."):]: v for k, v in final_params.items()
                  if k.startswith("surrogate.")}
    exp_params = {k[len("explainer."):]: v for k, v in final_params.items()
                  if k.startswith("explainer.")}
    mask_1 = jnp.ones((2, 4), jnp.int32)
    grand, _ = recipe.fw_surrogate(m_config, srg_params, xs, mask_1)
    attr_ref, _ = recipe.fw_explainer(
        m_config, exp_params, xs, mask_1, grand, final_params["surrogate_null"]
    )
    np.testing.assert_allclose(np.asarray(attr), np.asarray(attr_ref), atol=1e-5)
    # NOTE: normalization runs over tokens INCLUDING CLS before CLS is
    # dropped (reference behavior) — player sums differ from grand - null by
    # exactly the CLS share, so no efficiency identity is asserted here.


def test_explainer_training_reduces_loss(vit_exp: pathlib.Path):
    """The Shapley regression loss must drop over epochs on the train set."""
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    # stretch training for signal
    cfg = json.loads((vit_exp / ".hparams.json").read_text())
    cfg["train_explainer"]["epochs"] = 4
    cfg["train_explainer"]["lr"] = 3e-3
    (vit_exp / ".hparams.json").write_text(json.dumps(cfg))

    env = ExpEnv(vit_exp)
    train_all(env)
    log = (vit_exp / ".log.txt").read_text()
    losses = []
    for line in log.splitlines():
        if "done in" in line and "train_loss: shap" in line:
            losses.append(float(line.split("train_loss: shap")[1].split("//")[0]))
    assert len(losses) >= 4
    assert losses[-1] < losses[0]
