"""Numerical parity of the JAX BERT family against the reference torch
implementation: identical params -> identical outputs (fp32, no dropout)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "/root")

from autognothi.models.bert import (
    VanillaBertConfig,
    bert_classifier_fwd,
    bert_explainer_fwd,
    bert_surrogate_coalitions_fwd,
    init_bert_classifier,
    init_bert_explainer,
)

CFG = dict(
    attention_probs_dropout_prob=0.0,
    explainer_attn_num_layers=1,
    explainer_head_hidden_size=16,
    explainer_normalize=True,
    hidden_dropout_prob=0.0,
    hidden_size=32,
    intermediate_size=64,
    layer_norm_eps=1e-12,
    max_position_embeddings=8,
    num_attention_heads=4,
    num_hidden_layers=2,
    num_labels=2,
    pad_token_id=0,
    type_vocab_size=2,
    vocab_size=50,
)


def _torch_model(cls, flat_params):
    import torch
    from reference.models import vanilla_bert as ref

    cfg = ref.VanillaBertConfig(**CFG)
    model = cls(cfg)
    sd = model.state_dict()
    assert set(sd.keys()) == set(flat_params.keys()), (
        sorted(set(sd) - set(flat_params)),
        sorted(set(flat_params) - set(sd)),
    )
    model.load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in flat_params.items()}
    )
    model.eval()
    return model


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 50, (2, 8)).astype(np.int64)
    mask = np.ones((2, 8), dtype=np.int64)
    mask[0, 3] = 0
    mask[1, 6] = 0
    ttype = np.zeros((2, 8), dtype=np.int64)
    return ids, mask, ttype


def test_bert_classifier_matches_reference(inputs, torch_reference):
    import torch
    from reference.models.vanilla_bert import VanillaBertClassifier

    ids, mask, ttype = inputs
    cfg = VanillaBertConfig(**CFG)
    params = init_bert_classifier(jax.random.PRNGKey(0), cfg)

    ours, _ = bert_classifier_fwd(
        params, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ttype)
    )
    t_model = _torch_model(VanillaBertClassifier, params)
    with torch.no_grad():
        theirs = t_model(
            torch.tensor(ids), torch.tensor(mask), torch.tensor(ttype)
        ).numpy()
    np.testing.assert_allclose(np.asarray(ours), theirs, atol=2e-5, rtol=1e-4)


def test_bert_explainer_matches_reference(inputs, torch_reference):
    import torch
    from reference.models.vanilla_bert import VanillaBertExplainer

    ids, mask, ttype = inputs
    cfg = VanillaBertConfig(**CFG)
    params = init_bert_explainer(jax.random.PRNGKey(1), cfg)

    rng = np.random.RandomState(1)
    grand = rng.rand(2, 2).astype(np.float32)
    null = rng.rand(1, 2).astype(np.float32)

    ours, _ = bert_explainer_fwd(
        params, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ttype),
        jnp.asarray(grand), jnp.asarray(null),
    )
    t_model = _torch_model(VanillaBertExplainer, params)
    with torch.no_grad():
        theirs = t_model(
            torch.tensor(ids), torch.tensor(mask), torch.tensor(ttype),
            torch.tensor(grand), torch.tensor(null),
        ).numpy()
    assert np.asarray(ours).shape == (2, 2, 7)  # <B, n_classes, n_players>
    np.testing.assert_allclose(np.asarray(ours), theirs, atol=2e-5, rtol=1e-4)


def test_bert_coalition_fast_path(inputs):
    ids, _, ttype = inputs
    cfg = VanillaBertConfig(**CFG)
    params = init_bert_classifier(jax.random.PRNGKey(2), cfg)

    B, M, T = 2, 4, 8
    key = jax.random.PRNGKey(3)
    masks = jax.random.bernoulli(key, 0.5, (B, M, T - 1)).astype(jnp.int32)
    masks = jnp.concatenate([jnp.ones((B, M, 1), jnp.int32), masks], axis=-1)

    fast = bert_surrogate_coalitions_fwd(
        params, cfg, jnp.asarray(ids), masks, jnp.asarray(ttype)
    )
    ids_ext = jnp.repeat(jnp.asarray(ids), M, axis=0)
    ttype_ext = jnp.repeat(jnp.asarray(ttype), M, axis=0)
    slow, _ = bert_classifier_fwd(
        params, cfg, ids_ext, masks.reshape(B * M, T), ttype_ext
    )
    np.testing.assert_allclose(
        np.asarray(fast).reshape(B * M, -1), np.asarray(slow), atol=1e-5, rtol=1e-5
    )
