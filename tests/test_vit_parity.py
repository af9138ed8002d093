"""Numerical parity of the JAX ViT family against the reference torch
implementation: identical params -> identical outputs (fp32, no dropout)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "/root")  # namespace-import the read-only reference

from autognothi.models.vit import (
    VanillaViTConfig,
    init_vit_classifier,
    init_vit_explainer,
    vit_classifier_fwd,
    vit_explainer_fwd,
    vit_surrogate_coalitions_fwd,
)

CFG = dict(
    attention_probs_dropout_prob=0.0,
    explainer_attn_num_layers=2,
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


def _torch_cfg():
    from reference.models.vanilla_vit import VanillaViTConfig as TorchCfg

    return TorchCfg(**CFG)


def _load_into_torch(module, flat_params):
    import torch

    sd = module.state_dict()
    assert set(sd.keys()) == set(flat_params.keys()), (
        sorted(set(sd) - set(flat_params)),
        sorted(set(flat_params) - set(sd)),
    )
    new_sd = {k: torch.tensor(np.asarray(v)) for k, v in flat_params.items()}
    module.load_state_dict(new_sd)
    module.eval()
    return module


@pytest.fixture(scope="module")
def rng_inputs():
    rng = np.random.RandomState(0)
    pixels = rng.randn(2, 3, 16, 16).astype(np.float32)
    mask = np.ones((2, 5), dtype=np.int64)
    mask[0, 2] = 0
    mask[1, 4] = 0
    return pixels, mask


def test_classifier_matches_reference(rng_inputs, torch_reference):
    import torch
    from reference.models.vanilla_vit import VanillaViTClassifier

    pixels, mask = rng_inputs
    cfg = VanillaViTConfig(**CFG)
    params = init_vit_classifier(jax.random.PRNGKey(0), cfg)

    ours, _ = vit_classifier_fwd(params, cfg, jnp.asarray(pixels), jnp.asarray(mask))

    t_model = _load_into_torch(VanillaViTClassifier(_torch_cfg()), params)
    with torch.no_grad():
        theirs = t_model(torch.tensor(pixels), torch.tensor(mask)).numpy()

    np.testing.assert_allclose(np.asarray(ours), theirs, atol=2e-5, rtol=1e-4)


def test_explainer_matches_reference(rng_inputs, torch_reference):
    import torch
    from reference.models.vanilla_vit import VanillaViTExplainer

    pixels, mask = rng_inputs
    cfg = VanillaViTConfig(**CFG)
    params = init_vit_explainer(jax.random.PRNGKey(1), cfg)

    rng = np.random.RandomState(1)
    grand = rng.rand(2, 3).astype(np.float32)
    null = rng.rand(1, 3).astype(np.float32)

    ours, _ = vit_explainer_fwd(
        params, cfg, jnp.asarray(pixels), jnp.asarray(mask),
        jnp.asarray(grand), jnp.asarray(null),
    )

    t_model = _load_into_torch(VanillaViTExplainer(_torch_cfg()), params)
    with torch.no_grad():
        theirs = t_model(
            torch.tensor(pixels), torch.tensor(mask),
            torch.tensor(grand), torch.tensor(null),
        ).numpy()

    assert np.asarray(ours).shape == (2, 3, 4)  # <B, n_classes, n_players>
    np.testing.assert_allclose(np.asarray(ours), theirs, atol=2e-5, rtol=1e-4)


def test_coalition_fast_path_equals_replication(rng_inputs):
    pixels, _ = rng_inputs
    cfg = VanillaViTConfig(**CFG)
    params = init_vit_classifier(jax.random.PRNGKey(2), cfg)

    B, M, P = 2, 3, cfg.n_patches
    key = jax.random.PRNGKey(3)
    masks = jax.random.bernoulli(key, 0.6, (B, M, P)).astype(jnp.int32)
    masks_cls = jnp.concatenate([jnp.ones((B, M, 1), jnp.int32), masks], axis=-1)

    fast = vit_surrogate_coalitions_fwd(params, cfg, jnp.asarray(pixels), masks_cls)

    # reference semantics: replicate each image M times
    px_ext = jnp.repeat(jnp.asarray(pixels), M, axis=0)
    slow, _ = vit_classifier_fwd(
        params, cfg, px_ext, masks_cls.reshape(B * M, -1)
    )
    np.testing.assert_allclose(
        np.asarray(fast).reshape(B * M, -1), np.asarray(slow), atol=1e-5, rtol=1e-5
    )
