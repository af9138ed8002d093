"""LTT (ladder side tuning) end-to-end: fused backbone+ladder scan, 3-way
branch merge into the Final, progressive training, and coherency."""

import copy
import json
import pathlib

import pytest

from tests.test_bert_e2e import make_bert_hparams
from tests.test_train_all_e2e import MINI_VIT_HPARAMS


def _ltt_vit_hparams() -> dict:
    hp = copy.deepcopy(MINI_VIT_HPARAMS)
    hp["net"]["kind"] = "ltt_vit"
    params = hp["net"]["params"]
    params.pop("explainer_attn_num_layers")
    params.pop("explainer_head_hidden_size")
    params["explainer_s_attn_num_layers"] = 1
    params["explainer_s_head_hidden_size"] = 16
    params["s_attn_hidden_size"] = 16
    params["s_attn_intermediate_size"] = 32
    params.pop("layer_norm_eps")
    params["layer_norm_eps"] = 1e-12
    # progressive training on the surrogate stage
    hp["train_surrogate"]["EXPERIMENTAL_progressive_training"] = True
    hp["train_surrogate"]["epochs"] = 2
    return hp


def test_ltt_vit_end_to_end(tmp_path: pathlib.Path):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    exp = tmp_path / "ltt_vit"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(_ltt_vit_hparams(), indent=2))
    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()
    log = (exp / ".log.txt").read_text()
    assert "verified final model is coherent" in log
    assert "freeze side branches exc. first 1 layers" in log

    # the final carries BOTH ladders over one backbone
    import numpy as np

    with np.load(exp / "final-epoch-0.ckpt") as data:
        keys = set(data.files)
    assert "vit.encoder.s_attn_maps.0_0.weight" in keys
    assert "vit.encoder.s_attn_maps.1_0.weight" in keys
    assert "vit.s_attn_layernorm.0.weight" in keys
    assert "vit.s_attn_layernorm.1.weight" in keys
    # backbone appears exactly once (no duplicated trunks)
    assert sum(1 for k in keys if k == "vit.embeddings.cls_token") == 1


def test_ltt_bert_end_to_end(tmp_path: pathlib.Path):
    import autognothi.data.loader as dl
    from autognothi.data.tokenizer import WordPieceTokenizer, build_vocab
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    hp = make_bert_hparams(0)
    hp["net"]["kind"] = "ltt_bert"
    params = hp["net"]["params"]
    params.pop("explainer_attn_num_layers")
    params.pop("explainer_head_hidden_size")
    params["explainer_s_attn_num_layers"] = 1
    params["explainer_s_head_hidden_size"] = 16
    params["s_attn_hidden_size"] = 16
    params["s_attn_intermediate_size"] = 32

    exp = tmp_path / "ltt_bert"
    exp.mkdir()
    samples = json.loads(
        (pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text()
    )
    vocab = build_vocab([s["inputs"] for s in samples], max_size=400)
    WordPieceTokenizer(vocab).save(exp / "tokenizer")
    hp["net"]["params"]["vocab_size"] = len(vocab)
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))

    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()
    assert "verified final model is coherent" in (exp / ".log.txt").read_text()


def test_ltt_active_layers_gates_ladder(tmp_path: pathlib.Path):
    """ltt_active_layers=k must equal running only the first k side layers."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from autognothi.models.ltt_vit import (
        LttViTConfig,
        init_ltt_vit_surrogate,
        ltt_vit_backbone,
    )

    cfg = LttViTConfig(
        attention_probs_dropout_prob=0.0,
        explainer_s_attn_num_layers=1,
        explainer_s_head_hidden_size=16,
        explainer_normalize=True,
        hidden_dropout_prob=0.0,
        hidden_size=32,
        intermediate_size=64,
        layer_norm_eps=1e-12,
        num_attention_heads=4,
        num_hidden_layers=3,
        num_labels=2,
        s_attn_hidden_size=16,
        s_attn_intermediate_size=32,
        img_channels=3,
        img_px_size=16,
        img_patch_size=8,
    )
    params = init_ltt_vit_surrogate(jax.random.PRNGKey(0), cfg)
    xs = jnp.asarray(np.random.RandomState(0).randn(2, 3, 16, 16), jnp.float32)
    mask = jnp.ones((2, 5), jnp.int32)

    _, (side_full,) = ltt_vit_backbone(params, cfg, xs, mask, (0,))
    _, (side_k1,) = ltt_vit_backbone(
        params, cfg, xs, mask, (0,), ltt_active_layers=jnp.asarray(1)
    )
    # different depths -> different side outputs
    assert not np.allclose(np.asarray(side_full), np.asarray(side_k1))
    # full depth == explicit full depth
    _, (side_k3,) = ltt_vit_backbone(
        params, cfg, xs, mask, (0,), ltt_active_layers=jnp.asarray(3)
    )
    np.testing.assert_allclose(
        np.asarray(side_full), np.asarray(side_k3), atol=1e-6
    )
