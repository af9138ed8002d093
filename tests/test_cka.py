import jax.numpy as jnp
import numpy as np
import pytest

from autognothi.ops.cka import kernel_cka, linear_cka


def _torch_reference_linear(x, y):
    import torch

    X, Y = torch.tensor(x), torch.tensor(y)

    def centering(K):
        n = K.shape[0]
        H = torch.eye(n) - torch.ones(n, n) / n
        return H @ K @ H

    def hsic(A, B):
        return torch.sum(centering(A @ A.T) * centering(B @ B.T))

    return (hsic(X, Y) / (torch.sqrt(hsic(X, X)) * torch.sqrt(hsic(Y, Y)))).item()


def test_linear_cka_identity():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 8).astype(np.float32)
    out = np.asarray(linear_cka(jnp.asarray(x), jnp.asarray(x)))
    np.testing.assert_allclose(out, np.ones(2), atol=1e-5)


def test_linear_cka_matches_torch():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 6, 8).astype(np.float32)
    y = rng.randn(3, 6, 5).astype(np.float32)
    got = np.asarray(linear_cka(jnp.asarray(x), jnp.asarray(y)))
    for i in range(3):
        assert got[i] == pytest.approx(_torch_reference_linear(x[i], y[i]), rel=1e-4)


def test_kernel_cka_identity_and_range():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 8).astype(np.float32)
    y = rng.randn(2, 6, 8).astype(np.float32)
    same = np.asarray(kernel_cka(jnp.asarray(x), jnp.asarray(x)))
    np.testing.assert_allclose(same, np.ones(2), atol=1e-4)
    diff = np.asarray(kernel_cka(jnp.asarray(x), jnp.asarray(y)))
    assert np.all(diff > 0) and np.all(diff < 1.0)


def test_kernel_cka_fixed_sigma_matches_torch():
    import torch

    rng = np.random.RandomState(3)
    x = rng.randn(1, 5, 7).astype(np.float32)
    y = rng.randn(1, 5, 7).astype(np.float32)
    sigma = 2.0

    def rbf(X):
        G = X @ X.T
        d = torch.diag(G)
        K = (d[:, None] - G) + (d[None, :] - G)
        return torch.exp(K * (-0.5 / sigma**2))

    def centering(K):
        n = K.shape[0]
        H = torch.eye(n) - torch.ones(n, n) / n
        return H @ K @ H

    def hsic(A, B):
        return torch.sum(centering(rbf(A)) * centering(rbf(B)))

    X, Y = torch.tensor(x[0]), torch.tensor(y[0])
    want = (hsic(X, Y) / (torch.sqrt(hsic(X, X)) * torch.sqrt(hsic(Y, Y)))).item()
    got = float(np.asarray(kernel_cka(jnp.asarray(x), jnp.asarray(y), sigma=sigma))[0])
    assert got == pytest.approx(want, rel=1e-4)
