"""Centered Kernel Alignment (linear and RBF) between representation batches.

Parity with /root/reference/models/cka.py: both operate per batch item on
<heads, features> matrices; HSIC is computed as sum(centering(Kx) *
centering(Ky)); RBF bandwidth defaults to sqrt(median of nonzero pairwise
squared distances).  Compiled-first: per-item computation is vmapped, not a
Python loop, and the double-centering is expressed as mean subtractions
(H K H == K - row_mean - col_mean + grand_mean) to avoid materializing H.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["linear_cka", "kernel_cka"]


def _center(gram: jnp.ndarray) -> jnp.ndarray:
    row = gram.mean(axis=0, keepdims=True)
    col = gram.mean(axis=1, keepdims=True)
    grand = gram.mean()
    return gram - row - col + grand


def _linear_hsic(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(_center(x @ x.T) * _center(y @ y.T))


def _rbf(x: jnp.ndarray, sigma: Optional[float]) -> jnp.ndarray:
    gram = x @ x.T
    diag = jnp.diag(gram)
    sq_dist = (diag[:, None] - gram) + (diag[None, :] - gram)
    if sigma is None:
        flat = sq_dist.reshape(-1)
        nonzero = flat != 0
        # median over nonzero entries: sort with zeros pushed to +inf
        sorted_vals = jnp.sort(jnp.where(nonzero, flat, jnp.inf))
        count = jnp.sum(nonzero)
        # torch.median returns the lower-middle element for even counts
        mid = jnp.clip((count - 1) // 2, 0, flat.size - 1)
        sig_sq = sorted_vals[mid]
    else:
        sig_sq = jnp.asarray(sigma, dtype=x.dtype) ** 2
    return jnp.exp(sq_dist * (-0.5 / sig_sq))


def _kernel_hsic(x: jnp.ndarray, y: jnp.ndarray, sigma: Optional[float]) -> jnp.ndarray:
    return jnp.sum(_center(_rbf(x, sigma)) * _center(_rbf(y, sigma)))


def _linear_cka_single(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    hsic = _linear_hsic(x, y)
    return hsic / (jnp.sqrt(_linear_hsic(x, x)) * jnp.sqrt(_linear_hsic(y, y)))


def _kernel_cka_single(
    x: jnp.ndarray, y: jnp.ndarray, sigma: Optional[float]
) -> jnp.ndarray:
    hsic = _kernel_hsic(x, y, sigma)
    return hsic / (
        jnp.sqrt(_kernel_hsic(x, x, sigma)) * jnp.sqrt(_kernel_hsic(y, y, sigma))
    )


def linear_cka(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """<batch, heads, a> cka <batch, heads, b> -> <batch>."""
    return jax.vmap(_linear_cka_single)(x, y)


def kernel_cka(
    x: jnp.ndarray, y: jnp.ndarray, sigma: Optional[float] = None
) -> jnp.ndarray:
    """RBF-kernel CKA per batch item -> <batch>."""
    return jax.vmap(lambda a, b: _kernel_cka_single(a, b, sigma))(x, y)
