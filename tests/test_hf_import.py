"""HF-checkpoint import: the conversion rules map transformers state dicts
(BertForSequenceClassification / bare BertModel / ViTForImageClassification)
into our layouts, and the imported classifier reproduces HF's hidden states.

Models are constructed offline from configs — no hub access."""

import numpy as np
import pytest


def _bert_cfgs():
    from transformers import BertConfig

    from autognothi.models.bert import VanillaBertConfig

    hf = BertConfig(
        vocab_size=60, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=16, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        num_labels=2,
    )
    ours = VanillaBertConfig(
        attention_probs_dropout_prob=0.0,
        explainer_attn_num_layers=1,
        explainer_head_hidden_size=16,
        explainer_normalize=True,
        hidden_dropout_prob=0.0,
        hidden_size=32,
        intermediate_size=64,
        layer_norm_eps=1e-12,
        max_position_embeddings=16,
        num_attention_heads=4,
        num_hidden_layers=2,
        num_labels=2,
        pad_token_id=0,
        type_vocab_size=2,
        vocab_size=60,
    )
    return hf, ours


def _sd_numpy(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def test_bert_seqcls_import_matches_hf():
    import jax
    import jax.numpy as jnp
    import torch
    from transformers import BertForSequenceClassification

    from autognothi.models.bert import bert_backbone
    from autognothi.recipes.vanilla_bert import conv_pretrained_classifier

    hf_cfg, cfg = _bert_cfgs()
    torch.manual_seed(0)
    hf_model = BertForSequenceClassification(hf_cfg).eval()

    params = conv_pretrained_classifier(
        cfg, _sd_numpy(hf_model), jax.random.PRNGKey(0)
    )
    params = {k: jnp.asarray(v) for k, v in params.items()}

    rng = np.random.RandomState(0)
    ids = rng.randint(1, 60, (2, 16)).astype(np.int64)
    mask = np.ones((2, 16), dtype=np.int64)
    ttype = np.zeros((2, 16), dtype=np.int64)

    ours = bert_backbone(
        params, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ttype)
    )
    with torch.no_grad():
        theirs = hf_model.bert(
            input_ids=torch.tensor(ids),
            attention_mask=torch.tensor(mask),
            token_type_ids=torch.tensor(ttype),
        ).last_hidden_state.numpy()
    np.testing.assert_allclose(np.asarray(ours), theirs, atol=3e-5, rtol=1e-4)


def test_bert_bare_import_inits_classifier_head():
    import jax
    import torch
    from transformers import BertModel

    from autognothi.recipes.vanilla_bert import conv_pretrained_classifier

    hf_cfg, cfg = _bert_cfgs()
    torch.manual_seed(1)
    hf_model = BertModel(hf_cfg).eval()

    params = conv_pretrained_classifier(
        cfg, _sd_numpy(hf_model), jax.random.PRNGKey(1)
    )
    # backbone copied, classifier head from fresh init
    np.testing.assert_array_equal(
        params["bert.embeddings.word_embeddings.weight"],
        hf_model.embeddings.word_embeddings.weight.detach().numpy(),
    )
    assert params["classifier.weight"].shape == (2, 32)


def test_vit_import_matches_hf():
    import jax
    import jax.numpy as jnp
    import torch
    from transformers import ViTConfig, ViTForImageClassification

    from autognothi.models.vit import VanillaViTConfig, vit_backbone
    from autognothi.recipes.vanilla_vit import conv_pretrained_classifier

    hf_cfg = ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=16, patch_size=8, num_channels=3,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        num_labels=3,
    )
    cfg = VanillaViTConfig(
        attention_probs_dropout_prob=0.0,
        explainer_attn_num_layers=1,
        explainer_head_hidden_size=16,
        explainer_normalize=True,
        hidden_dropout_prob=0.0,
        hidden_size=32,
        intermediate_size=64,
        layer_norm_eps=1e-12,
        num_attention_heads=4,
        num_hidden_layers=2,
        num_labels=3,
        img_channels=3,
        img_px_size=16,
        img_patch_size=8,
    )
    torch.manual_seed(2)
    hf_model = ViTForImageClassification(hf_cfg).eval()

    params = conv_pretrained_classifier(
        cfg, _sd_numpy(hf_model), jax.random.PRNGKey(2)
    )
    params = {k: jnp.asarray(v) for k, v in params.items()}

    rng = np.random.RandomState(2)
    pixels = rng.randn(2, 3, 16, 16).astype(np.float32)
    mask = np.ones((2, 5), dtype=np.int64)  # multiplicative ones == no mask

    ours = vit_backbone(params, cfg, jnp.asarray(pixels), jnp.asarray(mask))
    with torch.no_grad():
        theirs = hf_model.vit(torch.tensor(pixels)).last_hidden_state.numpy()
    np.testing.assert_allclose(np.asarray(ours), theirs, atol=3e-5, rtol=1e-4)
