"""Shared functional building blocks for the transformer families.

Parameters are *flat* dicts mapping torch-style dotted names to arrays —
linear weights keep the torch ``(out, in)`` layout so HF checkpoint import
and the reference's conversion rules carry over unchanged (the apply fns
contract against the trailing axis with ``dot_general``, which XLA maps onto
the same GEMM either way).

Per-layer encoder weights are *stored* flat (surgery-friendly) and *stacked*
at trace time into leading-axis arrays consumed by ``lax.scan`` — one
compiled layer body regardless of depth, which keeps compile times flat for
BERT-large and lets the coalition-vmapped forward share code.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import flash_attention

Params = Dict[str, jax.Array]

__all__ = [
    "Params",
    "dense",
    "layer_norm",
    "gelu",
    "dropout",
    "split_heads",
    "merge_heads",
    "additive_mask_bias",
    "self_attention",
    "init_linear",
    "init_layer_norm",
    "init_embedding",
    "subdict",
    "add_prefix",
    "stack_layer_params",
    "cast_tree",
    "stack_branch_params",
]


def dense(x: jax.Array, w: jax.Array, b: Optional[jax.Array]) -> jax.Array:
    """x @ w.T + b with w in torch (out, in) layout.  bf16 inputs accumulate
    in fp32 and cast back down."""
    y = jax.lax.dot_general(
        x, w.astype(x.dtype), (((x.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if b is not None:
        y = y + b.astype(jnp.float32)
    return y.astype(x.dtype)


def layer_norm(x: jax.Array, w: jax.Array, b: jax.Array, eps: float) -> jax.Array:
    """LayerNorm with fp32 statistics — under bf16 activations the mean/var
    math runs in float32 and the result is cast back (free when fp32)."""
    dtype = x.dtype
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    normed = (x32 - mean) * jax.lax.rsqrt(var + eps)
    out = normed * w.astype(jnp.float32) + b.astype(jnp.float32)
    return out.astype(dtype)


def gelu(x: jax.Array) -> jax.Array:
    """Exact (erf) GELU — torch nn.GELU default."""
    return jax.nn.gelu(x, approximate=False)


def dropout(
    key: Optional[jax.Array], x: jax.Array, rate: float, deterministic: bool
) -> jax.Array:
    if deterministic or rate == 0.0:
        return x
    assert key is not None, "dropout in train mode needs an rng key"
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


def split_heads(x: jax.Array, n_heads: int) -> jax.Array:
    """<..., T, H> -> <..., n_heads, T, head_dim>."""
    *lead, t, h = x.shape
    x = x.reshape(*lead, t, n_heads, h // n_heads)
    return jnp.swapaxes(x, -3, -2)


def merge_heads(x: jax.Array) -> jax.Array:
    """<..., n_heads, T, head_dim> -> <..., T, H>."""
    x = jnp.swapaxes(x, -3, -2)
    *lead, t, n, d = x.shape
    return x.reshape(*lead, t, n * d)


def additive_mask_bias(mask: jax.Array, dtype=jnp.float32) -> jax.Array:
    """HF-style extended attention mask: <B, T> 0/1 -> <B, 1, 1, T> bias of
    0 (keep) / finfo.min (drop), added to raw attention scores."""
    bias = (1.0 - mask.astype(dtype)) * jnp.finfo(dtype).min
    return bias[:, None, None, :]


def self_attention(
    h: jax.Array,
    wq: jax.Array,
    bq: jax.Array,
    wk: jax.Array,
    bk: jax.Array,
    wv: jax.Array,
    bv: jax.Array,
    n_heads: int,
    mask: Optional[jax.Array],
    mask_mode: str,
    attn_dropout: float = 0.0,
    dropout_key: Optional[jax.Array] = None,
    deterministic: bool = True,
) -> jax.Array:
    """Multi-head self attention over <B, T, H>.

    mask_mode "additive": `mask` is a <B, 1, 1, T> bias added to scores
    (BERT semantics, /root/reference/models/vanilla_bert.py:521-523).
    mask_mode "multiplicative": `mask` is <B, T> 0/1 *multiplied* into the
    raw scores before softmax (the ViT quirk to reproduce bit-for-bit,
    /root/reference/models/vanilla_vit.py:448-451).

    On the GPU, without attention dropout, the masked attention of a
    <B, T, H> input runs as the fused kernel of ops/flash_attention.py
    where `flash_attention.kernel_applies` picks it; the XLA path below is
    the numerical reference.
    """
    head_dim = h.shape[-1] // n_heads
    q = dense(h, wq, bq)
    k = dense(h, wk, bk)
    v = dense(h, wv, bv)

    no_dropout = deterministic or attn_dropout == 0.0
    mode = {"additive": "add", "multiplicative": "mul"}.get(mask_mode)
    if (
        mask is not None and no_dropout and h.ndim == 3 and mode is not None
        and flash_attention.kernel_applies()
    ):
        heads = h.shape[:2] + (n_heads, head_dim)
        row = mask[:, 0, 0, :] if mode == "add" else mask
        ctx = flash_attention.masked_attention(
            q.reshape(heads), k.reshape(heads), v.reshape(heads), row, mode)
        return ctx.reshape(h.shape)

    q, k, v = (split_heads(x, n_heads) for x in (q, k, v))
    # scores accumulate in fp32; softmax in fp32 for stability
    scores = jnp.einsum(
        "...htd,...hsd->...hts", q, k, preferred_element_type=jnp.float32
    ) / math.sqrt(head_dim)
    if mask is not None:
        if mask_mode == "additive":
            scores = scores + mask.astype(scores.dtype)
        elif mask_mode == "multiplicative":
            scores = scores * mask[..., None, None, :].astype(scores.dtype)
        else:
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    probs = dropout(dropout_key, probs, attn_dropout, deterministic)
    ctx = jnp.einsum("...hts,...hsd->...htd", probs, v)
    return merge_heads(ctx)


# ---------------------------------------------------------------- init


def init_linear(key: jax.Array, d_out: int, d_in: int) -> Tuple[jax.Array, jax.Array]:
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(d_in)
    kw, kb = jax.random.split(key)
    w = jax.random.uniform(kw, (d_out, d_in), minval=-bound, maxval=bound)
    b = jax.random.uniform(kb, (d_out,), minval=-bound, maxval=bound)
    return w, b


def init_layer_norm(d: int) -> Tuple[jax.Array, jax.Array]:
    return jnp.ones((d,)), jnp.zeros((d,))


def init_embedding(key: jax.Array, n: int, d: int) -> jax.Array:
    """torch nn.Embedding default init: N(0, 1)."""
    return jax.random.normal(key, (n, d))


# ---------------------------------------------------------- dict helpers


def subdict(params: Params, prefix: str) -> Params:
    """All entries under `prefix`, with the prefix stripped."""
    return {k[len(prefix) :]: v for k, v in params.items() if k.startswith(prefix)}


def add_prefix(params: Params, prefix: str) -> Params:
    return {prefix + k: v for k, v in params.items()}


def stack_layer_params(
    params: Params, prefix: str, n_layers: int, dtype=None
) -> Params:
    """Gather ``{prefix}.{i}.{suffix}`` entries for i in [0, n_layers) and
    stack each suffix along a new leading axis — the `xs` of a lax.scan."""
    out: Params = {}
    suffixes: List[str] = []
    head = f"{prefix}.0."
    for k in params:
        if k.startswith(head):
            suffixes.append(k[len(head) :])
    for suffix in suffixes:
        leaves = [params[f"{prefix}.{i}.{suffix}"] for i in range(n_layers)]
        stacked = jnp.stack(leaves, axis=0)
        if dtype is not None:
            stacked = stacked.astype(dtype)
        out[suffix] = stacked
    return out


def stack_branch_params(p: Params, branch: int, n_layers: int, dtype):
    """Stack one LTT side branch's ladder params along a leading layer axis
    (the lax.scan layout both LTT models consume) -> (maps, layers)."""
    maps = {
        name: jnp.stack([
            p[f"encoder.s_attn_maps.{branch}_{i}.{name}"]
            for i in range(n_layers)
        ]).astype(dtype)
        for name in ("weight", "bias")
    }
    head = f"encoder.s_attn_layers.{branch}_0."
    layers = {
        suffix: jnp.stack([
            p[f"encoder.s_attn_layers.{branch}_{i}.{suffix}"]
            for i in range(n_layers)
        ]).astype(dtype)
        for suffix in (k[len(head):] for k in p if k.startswith(head))
    }
    return maps, layers


def maybe_remat(body):
    """Wrap a scan body in jax.checkpoint when AUTOGNOTHI_REMAT=1 —
    trades recompute for activation memory on deep/large models
    (per-layer rematerialization, the standard transformer policy)."""
    if os.environ.get("AUTOGNOTHI_REMAT") == "1":
        return jax.checkpoint(body)
    return body


def cast_tree(params: Params, dtype) -> Params:
    return {k: v.astype(dtype) if jnp.issubdtype(v.dtype, jnp.floating) else v
            for k, v in params.items()}
