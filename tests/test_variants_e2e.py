"""End-to-end runs of the variant families (froyo / duo / kernel_shap) on
mini configs, exercising their conversion chains, trainers and reports."""

import copy
import json
import pathlib

import pytest

from tests.test_bert_e2e import make_bert_hparams
from tests.test_train_all_e2e import MINI_VIT_HPARAMS


def _write_exp(root: pathlib.Path, hparams: dict) -> pathlib.Path:
    root.mkdir(parents=True, exist_ok=True)
    (root / ".hparams.json").write_text(json.dumps(hparams, indent=2))
    return root


def _vit_variant(kind: str) -> dict:
    hp = copy.deepcopy(MINI_VIT_HPARAMS)
    hp["net"]["kind"] = kind
    return hp


def test_froyo_vit_end_to_end(tmp_path):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    exp = _write_exp(tmp_path / "froyo", _vit_variant("froyo_vit"))
    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()
    assert "verified final model is coherent" in (exp / ".log.txt").read_text()

    # the froyo final shares ONE trunk: params contain a single vit tower
    import numpy as np

    with np.load(exp / "final-epoch-0.ckpt") as data:
        keys = set(data.files)
    assert "vit.embeddings.cls_token" in keys
    assert not any(k.startswith("surrogate.vit.") for k in keys)
    assert "srg_classifier.weight" in keys


def test_duo_vit_end_to_end_and_dual_task(tmp_path):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.measure_dual_task_similarity import (
        measure_dual_task_similarity,
    )
    from autognothi.pipeline.train_all import train_all

    exp = _write_exp(tmp_path / "duo", _vit_variant("duo_vanilla_vit"))
    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()
    # joint objective: duo trainer logs both cls and shap losses
    log = (exp / ".log.txt").read_text()
    assert "train duo explainer" in log

    report = measure_dual_task_similarity(env)
    assert len(report.epochs) >= 1
    assert all(-1.0 <= v <= 1.0 for v in report.cos_sim_avg)


@pytest.mark.parametrize("kind", ["froyo_bert", "duo_vanilla_bert"])
def test_bert_variant_end_to_end(tmp_path, kind):
    import json as _json
    import pathlib as _pathlib

    import autognothi.data.loader as dl
    from autognothi.data.tokenizer import WordPieceTokenizer, build_vocab
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    hp = make_bert_hparams(0)
    hp["net"]["kind"] = kind
    exp = tmp_path / kind
    exp.mkdir()
    samples = _json.loads(
        (_pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text()
    )
    vocab = build_vocab([s["inputs"] for s in samples], max_size=400)
    WordPieceTokenizer(vocab).save(exp / "tokenizer")
    hp["net"]["params"]["vocab_size"] = len(vocab)
    (exp / ".hparams.json").write_text(_json.dumps(hp, indent=2))

    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()
    log = (exp / ".log.txt").read_text()
    if kind == "froyo_bert":
        assert "verified final model is coherent" in log
        import numpy as np

        with np.load(exp / "final-epoch-0.ckpt") as data:
            keys = set(data.files)
        assert "srg_bert_pooler.dense.weight" in keys
        assert not any(k.startswith("surrogate.bert.") for k in keys)
    else:  # duo: no coherency check, no classifier branch in the final
        assert "train duo explainer" in log
        import numpy as np

        with np.load(exp / "final-epoch-0.ckpt") as data:
            keys = set(data.files)
        assert not any(k.startswith("classifier.") for k in keys)
        assert any(k.startswith("explainer.explainer_attn.") for k in keys)


def test_kernel_shap_bert_end_to_end(tmp_path):
    import numpy as np

    from autognothi.data.tokenizer import WordPieceTokenizer, build_vocab
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.resources import get_recipe, load_epoch_model
    from autognothi.pipeline.train_all import train_all
    import autognothi.data.loader as dl

    hp = make_bert_hparams(0)  # vocab patched below
    hp["net"]["kind"] = "kernel_shap_bert"
    hp["net"]["params"]["max_position_embeddings"] = 8
    hp["net"]["params"]["kernel_shap_n_samples"] = 64
    hp["net"]["params"]["kernel_shap_data_size"] = 3
    hp["train_classifier"]["epochs"] = 0
    hp["train_surrogate"]["epochs"] = 0
    hp["train_explainer"]["epochs"] = 1

    exp = tmp_path / "kshap"
    exp.mkdir()
    samples = json.loads(
        (pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text()
    )
    vocab = build_vocab([s["inputs"] for s in samples], max_size=300)
    WordPieceTokenizer(vocab).save(exp / "tokenizer")
    hp["net"]["params"]["vocab_size"] = len(vocab)
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))

    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()

    recipe, m_config = get_recipe(env.config)
    _, final_params = load_epoch_model(env, recipe, "final")
    # stored background has the compressed shape
    assert final_params["explainer.Xs_train"].shape == (3, 8)

    # one WLS explanation through fw_final
    import jax.numpy as jnp

    m_misc = recipe.load_misc(env.model_path, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)
    xs, _ = gen_input([samples[0]["inputs"]], [samples[0]["targets"]])
    probs, attr = recipe.fw_final(m_config, final_params, jnp.asarray(xs))
    assert np.asarray(probs).shape == (1, 2)
    assert np.asarray(attr).shape == (1, 2, 7)  # players = 8 - 1
    assert np.isfinite(np.asarray(attr)).all()

    # faithfulness must run on the HOST-side final (regression: the report
    # used to jax.jit(fw_final), which traces the numpy WLS solver and
    # raises TracerArrayConversionError; the reference allows faithfulness
    # for KernelSHAP — recipes/kernel_shap_bert.py:77 upstream)
    assert recipe.fw_final_host
    from autognothi.pipeline.measure_faithfulness import (
        measure_faithfulness,
    )

    report = measure_faithfulness(env, resolution=2)
    assert np.isfinite(report.insertion.auc)
    assert np.isfinite(report.deletion.auc)
