"""Text-track end-to-end: vanilla BERT on the bundled nlp_samples with an
offline-built WordPiece vocab, through train_all + text explanation demo."""

import json
import pathlib

import pytest


def make_bert_hparams(vocab_size: int) -> dict:
    return {
        "seed": 11,
        "dataset": {"kind": "nlp_samples"},
        "net": {
            "kind": "vanilla_bert",
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
                "max_position_embeddings": 16,
                "num_attention_heads": 4,
                "num_hidden_layers": 2,
                "num_labels": 2,
                "pad_token_id": 0,
                "type_vocab_size": 2,
                "vocab_size": vocab_size,
            },
        },
        "train_classifier": {
            "epochs": 0, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 8,
        },
        "train_surrogate": {
            "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 8,
        },
        "train_explainer": {
            "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 8,
            "n_mask_samples": 2, "lambda_efficiency": 0.0, "lambda_norm": 0.0,
        },
        "eval_accuracy": {"dataset": None, "batch_size": 8, "resolution": 3},
        "eval_faithfulness": {"dataset": None, "batch_size": 8, "resolution": 3},
        "eval_cls_acc": {"dataset": None, "on_exp_epochs": None, "batch_size": 8},
        "eval_performance": {"dataset": None, "loops": 1},
        "eval_train_resources": {"dataset": None, "batch_size": 8, "max_samples": 8},
    }


@pytest.fixture(scope="module")
def bert_exp(tmp_path_factory) -> pathlib.Path:
    import autognothi.data.loader as dl
    from autognothi.data.tokenizer import WordPieceTokenizer, build_vocab

    exp = tmp_path_factory.mktemp("bert") / "bert_mini"
    exp.mkdir()
    samples = json.loads(
        (pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text()
    )
    vocab = build_vocab([s["inputs"] for s in samples], max_size=400)
    tokenizer = WordPieceTokenizer(vocab)
    tokenizer.save(exp / "tokenizer")
    (exp / ".hparams.json").write_text(
        json.dumps(make_bert_hparams(len(vocab)), indent=2)
    )
    return exp


def test_bert_train_all_and_explain(bert_exp: pathlib.Path):
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.run_text_explanation import run_text_explanation
    from autognothi.pipeline.train_all import train_all

    env = ExpEnv(bert_exp)
    train_all(env)
    assert (bert_exp / "final-epoch-0.ckpt").exists()
    log = (bert_exp / ".log.txt").read_text()
    assert "verified final model is coherent" in log

    out = bert_exp / "text_expl.json"
    run_text_explanation(env, None, out, limit=4)
    results = json.loads(out.read_text())
    # every correctly-predicted sample yields (token, score) pairs
    for item in results["items"].values():
        assert all(isinstance(tok, str) and isinstance(val, float)
                   for tok, val in item)


def test_bert_preview_text_shapley(bert_exp: pathlib.Path):
    from autognothi.data.loader import load_nlp_samples
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.preview_text_shapley import preview_text_shapley

    # restrict to two samples for runtime
    loader = load_nlp_samples()
    full = list(loader.test_raw(1))[:2]
    loader.test_raw = lambda bs: iter(full)
    preview_text_shapley(ExpEnv(bert_exp), loader, reps=2)


def test_bert_serve_texts_round_trip(bert_exp: pathlib.Path):
    """Text serving: tokenization happens server-side; the batcher slabs the
    token-id arrays like image rows (depends on the trained module fixture)."""
    import urllib.request

    import numpy as np

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.serve import serve_in_thread
    from autognothi.pipeline.train_all import train_all

    env = ExpEnv(bert_exp)
    train_all(env)  # no-op when the earlier tests already trained this dir
    server, service, _ = serve_in_thread(env, port=0, batch_size=2)
    try:
        host, port = server.server_address
        req = urllib.request.Request(
            f"http://{host}:{port}/explain",
            data=json.dumps({"texts": [
                "the service was outstanding",
                "a total waste of time",
                "surprisingly good",
            ]}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        logits = np.asarray(body["logits"])
        attr = np.asarray(body["attributions"])
        assert logits.shape == (3, 2)  # 3 texts (> batch 2: spans slabs)
        # n_players for text = max_position_embeddings - special tokens
        assert attr.shape[0] == 3 and attr.shape[1] == 2
        np.testing.assert_allclose(logits.sum(axis=1), np.ones(3), atol=1e-4)
    finally:
        server.shutdown()
        service.close()


def test_tokenizer_roundtrip(bert_exp: pathlib.Path):
    from autognothi.data.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer.load(bert_exp / "tokenizer")
    ids, attn = tok.encode("the service was outstanding", 16)
    assert ids.shape == (16,)
    assert ids[0] == tok.cls_id
    assert tok.sep_id in ids
    toks = tok.decode_tokens(int(i) for i in ids[: int(attn.sum())])
    assert toks[0] == "[CLS]" and toks[-1] == "[SEP]"
    assert "service" in "".join(toks) or "service" in toks
