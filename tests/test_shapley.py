import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autognothi.ops.shapley import (
    loss_logits_kl_divergence,
    loss_shapley,
    mask_purely_uniform,
    mask_shapley,
    mask_uniform_selective,
    normalize_shapley_explanation,
    shapley_kernel_probs,
)


def test_shapley_kernel_probs():
    p = np.asarray(shapley_kernel_probs(8))
    k = np.arange(1, 8)
    want = 1.0 / (k * (8 - k))
    want = want / want.sum()
    np.testing.assert_allclose(p, want, rtol=1e-6)


def test_mask_shapley_paired_complements():
    key = jax.random.PRNGKey(0)
    masks = np.asarray(mask_shapley(key, 16, 10))
    assert masks.shape == (16, 10)
    assert set(np.unique(masks)) <= {0, 1}
    # interleaved complements: rows 2i and 2i+1 sum to all-ones
    pairs = masks.reshape(8, 2, 10)
    np.testing.assert_array_equal(pairs.sum(axis=1), np.ones((8, 10), dtype=int))


def test_mask_shapley_odd_raises():
    with pytest.raises(ValueError):
        mask_shapley(jax.random.PRNGKey(0), 3, 10)


def test_mask_shapley_size_distribution():
    # coalition sizes should concentrate at extremes (shapley kernel)
    key = jax.random.PRNGKey(1)
    masks = np.asarray(mask_shapley(key, 4000, 12))
    sizes = masks.sum(axis=1)
    hist = np.bincount(sizes, minlength=13)[1:12]
    assert hist[0] + hist[-1] > hist[5]  # extremes more likely than middle


def test_loss_shapley_matches_torch_formula():
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(0)
    B, M, P, C = 3, 4, 6, 2
    mask = rng.randint(0, 2, (B, M, P)).astype(np.float32)
    v0 = rng.randn(1, C).astype(np.float32)
    vs = rng.randn(B * M, C).astype(np.float32)
    v1 = rng.randn(B, C).astype(np.float32)
    phi = rng.randn(B, C, P).astype(np.float32)

    got = float(
        loss_shapley(jnp.asarray(mask), jnp.asarray(v0), jnp.asarray(vs),
                     jnp.asarray(v1), jnp.asarray(phi))
    )

    t_mask, t_phi = torch.tensor(mask), torch.tensor(phi)
    pred = torch.tensor(v0).reshape(1, 1, -1) + t_mask @ t_phi.permute(0, 2, 1)
    want = P * F.mse_loss(pred.reshape(B * M, -1), torch.tensor(vs)).item()
    assert got == pytest.approx(want, rel=1e-5)


def test_normalize_efficiency():
    rng = np.random.RandomState(1)
    B, T, C = 2, 5, 3
    pred = jnp.asarray(rng.randn(B, T, C).astype(np.float32))
    grand = jnp.asarray(rng.randn(B, C).astype(np.float32))
    null = jnp.asarray(rng.randn(1, C).astype(np.float32))
    out = normalize_shapley_explanation(pred, grand, null)
    sums = np.asarray(out.sum(axis=1))
    np.testing.assert_allclose(sums, np.asarray(grand) - np.asarray(null), atol=1e-5)


def test_kl_orientation_matches_torch():
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(2)
    ref = rng.randn(4, 3).astype(np.float32)
    cur = rng.randn(4, 3).astype(np.float32)
    got = float(loss_logits_kl_divergence(jnp.asarray(ref), jnp.asarray(cur)))
    want = F.kl_div(
        input=F.log_softmax(torch.tensor(ref), dim=-1),
        target=F.softmax(torch.tensor(cur), dim=-1),
        reduction="batchmean",
    ).item()
    assert got == pytest.approx(want, rel=1e-5)


def test_mask_purely_uniform_spread():
    key = jax.random.PRNGKey(3)
    masks = np.asarray(mask_purely_uniform(key, 2000, 16))
    counts = masks.sum(axis=1)
    # masked-out count approx uniform over 0..16: mean of kept ~8
    assert 7.0 < counts.mean() < 9.0
    assert counts.min() <= 1 and counts.max() >= 15


def test_mask_uniform_selective_exact_count():
    key = jax.random.PRNGKey(4)
    masks = np.asarray(mask_uniform_selective(key, 64, 10, 3))
    np.testing.assert_array_equal((masks == 0).sum(axis=1), np.full(64, 3))
