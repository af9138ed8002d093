"""LTT coalition fast path == replicated per-coalition evaluation."""

import jax
import jax.numpy as jnp
import numpy as np


def test_ltt_vit_coalition_fast_path():
    from autognothi.models.ltt_vit import (
        LttViTConfig,
        init_ltt_vit_surrogate,
        ltt_vit_surrogate_coalitions_fwd,
        ltt_vit_surrogate_fwd,
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
        num_hidden_layers=2,
        num_labels=2,
        s_attn_hidden_size=16,
        s_attn_intermediate_size=32,
        img_channels=3,
        img_px_size=16,
        img_patch_size=8,
    )
    params = init_ltt_vit_surrogate(jax.random.PRNGKey(0), cfg)
    B, M, T = 2, 3, 5
    xs = jnp.asarray(np.random.RandomState(0).randn(B, 3, 16, 16), jnp.float32)
    masks = jax.random.bernoulli(jax.random.PRNGKey(1), 0.6, (B, M, T - 1))
    masks = jnp.concatenate(
        [jnp.ones((B, M, 1), jnp.int32), masks.astype(jnp.int32)], axis=-1
    )

    fast = ltt_vit_surrogate_coalitions_fwd(params, cfg, xs, masks)
    xs_ext = jnp.repeat(xs, M, axis=0)
    slow, _, _ = ltt_vit_surrogate_fwd(params, cfg, xs_ext, masks.reshape(B * M, T))
    np.testing.assert_allclose(
        np.asarray(fast).reshape(B * M, -1), np.asarray(slow), atol=1e-5
    )


def test_ltt_bert_coalition_fast_path():
    from autognothi.models.ltt_bert import (
        LttBertConfig,
        init_ltt_bert_surrogate,
        ltt_bert_surrogate_coalitions_fwd,
        ltt_bert_surrogate_fwd,
    )

    cfg = LttBertConfig(
        attention_probs_dropout_prob=0.0,
        explainer_s_attn_num_layers=1,
        explainer_s_head_hidden_size=16,
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
        s_attn_hidden_size=16,
        s_attn_intermediate_size=32,
        type_vocab_size=2,
        vocab_size=50,
    )
    params = init_ltt_bert_surrogate(jax.random.PRNGKey(0), cfg)
    B, M, T = 2, 3, 8
    rng = np.random.RandomState(0)
    ids = jnp.asarray(rng.randint(1, 50, (B, T)))
    ttype = jnp.zeros((B, T), jnp.int32)
    masks = jax.random.bernoulli(jax.random.PRNGKey(1), 0.6, (B, M, T - 1))
    masks = jnp.concatenate(
        [jnp.ones((B, M, 1), jnp.int32), masks.astype(jnp.int32)], axis=-1
    )

    fast = ltt_bert_surrogate_coalitions_fwd(params, cfg, ids, masks, ttype)
    ids_ext = jnp.repeat(ids, M, axis=0)
    ttype_ext = jnp.repeat(ttype, M, axis=0)
    slow, _, _ = ltt_bert_surrogate_fwd(
        params, cfg, ids_ext, masks.reshape(B * M, T), ttype_ext
    )
    np.testing.assert_allclose(
        np.asarray(fast).reshape(B * M, -1), np.asarray(slow), atol=1e-5
    )
