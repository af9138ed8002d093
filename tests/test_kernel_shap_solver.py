"""KernelSHAP solver correctness: for a model whose logit-linked output is
linear in the features, the Shapley values are exactly w_i * (x_i - E[D_i])."""

import numpy as np

from autognothi.ops.kernel_shap import kernel_shap, kmeans_compress


def test_linear_model_exact():
    rng = np.random.RandomState(0)
    M = 6
    w = rng.randn(M)
    b = 0.3

    def sigmoid(z):
        return 1 / (1 + np.exp(-z))

    def fn(rows):
        rows = np.atleast_2d(rows)
        p1 = sigmoid(rows @ w + b)
        return np.stack([1 - p1, p1], axis=1)

    # exactness needs a SINGLE reference row: with one background sample the
    # set function v(S) = logit(sigmoid(w.x_S + b)) is additive in features
    background = rng.randn(1, M)
    bg_w = np.ones(1)
    x = rng.randn(M)

    phi = kernel_shap(fn, background, bg_w, x, n_samples=600, seed=1)
    assert phi.shape == (2, M)
    expected = w * (x - background[0])
    np.testing.assert_allclose(phi[1], expected, atol=1e-5)
    # class-0 logit = -(w.x + b): attributions negate
    np.testing.assert_allclose(phi[0], -expected, atol=1e-5)


def test_efficiency_property():
    rng = np.random.RandomState(2)
    M = 5

    def fn(rows):
        rows = np.atleast_2d(rows)
        z = np.tanh(rows).sum(axis=1) + 0.5 * (rows[:, 0] * rows[:, 1])
        p1 = 1 / (1 + np.exp(-z))
        return np.stack([1 - p1, p1], axis=1)

    background = rng.randn(4, M)
    bg_w = np.asarray([2.0, 1.0, 1.0, 3.0])
    x = rng.randn(M)
    phi = kernel_shap(fn, background, bg_w, x, n_samples=400, seed=3)

    def logit(p):
        p = np.clip(p, 1e-7, 1 - 1e-7)
        return np.log(p / (1 - p))

    bw = bg_w / bg_w.sum()
    f_null = logit((fn(background) * bw[:, None]).sum(0))
    f_x = logit(fn(x[None])[0])
    np.testing.assert_allclose(phi.sum(axis=1), f_x - f_null, atol=1e-6)


def test_kmeans_compress_snaps_to_observed():
    rng = np.random.RandomState(4)
    data = rng.randint(0, 30, (40, 7))
    centers, weights = kmeans_compress(data, 5, seed=0)
    assert centers.shape == (5, 7)
    assert weights.sum() == 40
    for col in range(7):
        observed = set(data[:, col].tolist())
        assert set(centers[:, col].tolist()) <= observed


def test_single_player_gets_full_logit_difference():
    """m=1: no proper coalitions exist — phi must equal the whole logit
    difference (regression: this previously crashed with IndexError)."""

    def fn(rows):
        rows = np.atleast_2d(rows)
        p = 1.0 / (1.0 + np.exp(-rows[:, 0]))
        return np.stack([1 - p, p], axis=1)

    bg = np.zeros((3, 1))
    phi = kernel_shap(fn, bg, np.ones(3), np.array([2.0]), n_samples=8)
    assert phi.shape == (2, 1)
    # efficiency: phi sums (per class) to logit(f(x)) - logit(f(null))
    def logit(p):
        p = np.clip(p, 1e-7, 1 - 1e-7)
        return np.log(p / (1 - p))
    total = logit(fn(np.array([[2.0]]))[0]) - logit(fn(bg).mean(axis=0))
    np.testing.assert_allclose(phi[:, 0], total, atol=1e-6)


def test_sample_coalitions_odd_m_enumerates_each_size_once():
    """Odd player counts: the paired both-ends enumeration must stop at
    m//2 — one further (the old bound) re-enumerated already-covered sizes
    as exact duplicate rows with doubled WLS weight (biased phi)."""
    from autognothi.ops.kernel_shap import _sample_coalitions

    for m in (3, 5, 7):
        rows, w = _sample_coalitions(m, 10_000, np.random.RandomState(0))
        uniq = {tuple(r) for r in rows}
        assert len(uniq) == len(rows) == 2 ** m - 2, m  # no duplicates
        np.testing.assert_allclose(w.sum(), 1.0, atol=1e-9)


def test_linear_model_exact_odd_players():
    """Same additive-exactness contract at an ODD player count — the old
    enumeration bound double-weighted the middle sizes exactly here (the
    repo's experiment configs are all even, so nothing else pins it)."""
    rng = np.random.RandomState(4)
    M = 7
    w = rng.randn(M)

    def fn(rows):
        rows = np.atleast_2d(rows)
        p1 = 1 / (1 + np.exp(-(rows @ w)))
        return np.stack([1 - p1, p1], axis=1)

    background = rng.randn(1, M)
    x = rng.randn(M)
    phi = kernel_shap(fn, background, np.ones(1), x, n_samples=600, seed=5)
    np.testing.assert_allclose(phi[1], w * (x - background[0]), atol=1e-5)
