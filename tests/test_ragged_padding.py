"""Ragged-batch pad-and-weight: padding the loaders' short final batch to
the configured batch size (pipeline/training.pad_batch) must change NOTHING
numerically — the weighted-mean losses and the resulting gradients equal the
unpadded computation exactly — while collapsing every trainer to ONE
compiled step shape per loader (the short batch used to retrace)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autognothi.ops.shapley import (
    loss_logits_kl_divergence,
    loss_shapley,
)
from autognothi.pipeline.training import (
    cross_entropy_on_probs,
    make_optimizer,
    make_train_step,
    ones_mask,
    pad_batch,
)

REAL, PADDED = 3, 4
RNG = np.random.RandomState(0)


def _pad(arr):
    return np.concatenate([arr, arr[-1:]], axis=0)


def test_pad_batch_shapes_and_weights():
    xs = RNG.randn(REAL, 5).astype(np.float32)
    zs = np.array([0, 1, 0])
    xs_p, zs_p, w = pad_batch(xs, zs, PADDED)
    assert xs_p.shape == (PADDED, 5) and zs_p.shape == (PADDED,)
    assert w.tolist() == [1.0, 1.0, 1.0, 0.0]
    np.testing.assert_array_equal(xs_p[:REAL], xs)
    # full batches pass through untouched with all-ones weights
    xs_f, _, w_f = pad_batch(xs, None, REAL)
    assert xs_f.shape == (REAL, 5) and w_f.tolist() == [1.0] * REAL


def test_cross_entropy_weighted_equals_unpadded():
    probs = RNG.rand(REAL, 4).astype(np.float32)
    labels = np.array([1, 3, 0])
    ragged = cross_entropy_on_probs(jnp.asarray(probs), jnp.asarray(labels))
    padded = cross_entropy_on_probs(
        jnp.asarray(_pad(probs)), jnp.asarray(_pad(labels)),
        jnp.asarray([1.0, 1.0, 1.0, 0.0]),
    )
    np.testing.assert_allclose(float(ragged), float(padded), rtol=1e-6)


def test_kl_weighted_equals_unpadded():
    ref = RNG.randn(REAL, 4).astype(np.float32)
    cur = RNG.randn(REAL, 4).astype(np.float32)
    ragged = loss_logits_kl_divergence(jnp.asarray(ref), jnp.asarray(cur))
    padded = loss_logits_kl_divergence(
        jnp.asarray(_pad(ref)), jnp.asarray(_pad(cur)),
        jnp.asarray([1.0, 1.0, 1.0, 0.0]),
    )
    np.testing.assert_allclose(float(ragged), float(padded), rtol=1e-6)


def test_shapley_weighted_equals_unpadded():
    m, p, c = 2, 5, 3
    mask = (RNG.rand(REAL, m, p) > 0.5).astype(np.int32)
    v0 = RNG.randn(1, c).astype(np.float32)
    vs = RNG.randn(REAL * m, c).astype(np.float32)
    v1 = RNG.randn(REAL, c).astype(np.float32)
    phi = RNG.randn(REAL, c, p).astype(np.float32)
    ragged = loss_shapley(
        jnp.asarray(mask), jnp.asarray(v0), jnp.asarray(vs),
        jnp.asarray(v1), jnp.asarray(phi),
    )
    vs_pad = np.concatenate([vs, vs[-m:]], axis=0)
    padded = loss_shapley(
        jnp.asarray(_pad(mask)), jnp.asarray(v0), jnp.asarray(vs_pad),
        jnp.asarray(_pad(v1)), jnp.asarray(_pad(phi)),
        jnp.asarray([1.0, 1.0, 1.0, 0.0]),
    )
    np.testing.assert_allclose(float(ragged), float(padded), rtol=1e-6)


def test_gradients_equal_through_optimizer_step():
    """One AdamW step on a toy model: padded batch + weights produces the
    SAME updated params as the ragged batch."""
    params = {"w": jnp.asarray(RNG.randn(5, 4).astype(np.float32))}
    xs = RNG.randn(REAL, 5).astype(np.float32)
    zs = np.array([0, 1, 2])

    def loss_fn(p, xs, labels, weights):
        probs = jax.nn.softmax(xs @ p["w"], axis=-1)
        return cross_entropy_on_probs(probs, labels, weights), probs

    def one_step(xs_in, zs_in, w_in):
        tx, opt_state = make_optimizer(params, lambda n: True)
        step = make_train_step(tx, loss_fn)
        new_params, _, loss, _ = step(
            params, opt_state, jnp.asarray(1e-2), ones_mask(params),
            jnp.asarray(xs_in), jnp.asarray(zs_in), jnp.asarray(w_in),
        )
        return float(loss), np.asarray(new_params["w"])

    loss_r, w_r = one_step(xs, zs, np.ones(REAL, np.float32))
    loss_p, w_p = one_step(_pad(xs), _pad(zs),
                           np.asarray([1, 1, 1, 0], np.float32))
    np.testing.assert_allclose(loss_r, loss_p, rtol=1e-6)
    np.testing.assert_allclose(w_r, w_p, rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_explainer_step_compiles_once_across_ragged_batches():
    """The fused explainer step sees one shape for a [4, 4, 2]-sized epoch
    (2 padded to 4) — one trace, not two."""
    from autognothi.models.vit import VanillaViTConfig, init_vit_classifier, \
        init_vit_explainer
    from autognothi.parallel.train_step import make_explainer_train_step
    from autognothi.pipeline.training import make_optimizer, pad_batch
    from autognothi.recipes.vanilla_vit import fw_surrogate, vanilla_vit_recipe

    cfg = VanillaViTConfig(
        attention_probs_dropout_prob=0.0, explainer_attn_num_layers=1,
        explainer_head_hidden_size=16, explainer_normalize=True,
        hidden_dropout_prob=0.0, hidden_size=32, intermediate_size=64,
        layer_norm_eps=1e-12, num_attention_heads=4, num_hidden_layers=2,
        num_labels=3, img_channels=3, img_px_size=16, img_patch_size=8,
    )
    recipe = vanilla_vit_recipe()
    n_players = recipe.n_players(cfg)
    key = jax.random.PRNGKey(0)
    exp_params = init_vit_explainer(key, cfg)
    srg_params = init_vit_classifier(jax.random.fold_in(key, 1), cfg)
    tx, opt_state = make_optimizer(exp_params, lambda n: True)
    null, _ = fw_surrogate(
        cfg, srg_params, jnp.zeros((1, 3, 16, 16)),
        jnp.ones((1, n_players), jnp.int32),
    )
    step = make_explainer_train_step(recipe, cfg, n_players, 2, tx)
    for size in (4, 4, 2):
        xs = RNG.randn(size, 3, 16, 16).astype(np.float32)
        xs_p, _, w = pad_batch(xs, None, 4)
        exp_params, opt_state, loss = step(
            exp_params, opt_state, srg_params, null, jnp.asarray(xs_p),
            jax.random.PRNGKey(size), jnp.asarray(1e-3),
            ones_mask(exp_params), jnp.asarray(cfg.num_hidden_layers),
            jnp.asarray(w),
        )
        assert np.isfinite(float(loss))
    assert step._cache_size() == 1
