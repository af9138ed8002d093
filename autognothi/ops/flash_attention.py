"""Pallas/Triton kernel: coalition-masked self attention for the GPU.

The hot path of this framework runs attention over the *coalition* batch
(B x n_mask_samples masked copies).  XLA's lowering writes the
<N, heads, T, T> fp32 scores to device memory and reads them back between
the two matmuls; this kernel keeps them on chip.  ViT's coalition mask
*multiplies* the raw scores (masked keys keep a score of 0 and stay
attended, models/common.py), which no additive bias can express, so the
fused attention of cuDNN cannot take it.

One program per (query block, batch row, head).  It loops over the key
blocks with an online softmax (running max and sum in fp32), loading the
mask row one key block at a time.  Layout is <N, T, heads, d>, the layout
the QKV projections produce, so no head transpose is materialised.  The
wrapper pads T to the key-block size and the head dim to a power of two of
at least 16 (`pl.dot` needs K >= 16, which the LTT ladders' d=8 is not);
padded keys get no probability mass and padded rows are sliced off.

Precision: the dots follow the `jax.default_matmul_precision` scope they
are traced in.  At the card's default, float32 operands multiply in TF32
(10-bit mantissa), as XLA's own float32 matmuls do there; under "highest"
(or "float32") they multiply in full float32.

Gradients: `custom_vjp`.  A differentiated forward is `reference` itself
and its backward is the reference's, so a training step costs what XLA's
attention costs there; the kernel runs where nothing is differentiated
(serving, evaluation, the coalition teacher sweep).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# finite stand-in for -inf: exp2 of (MASK - max) is 0 without inf - inf NaNs
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
_LOG2E = math.log2(math.e)


def reference(q, k, v, mask_row, mode: str):
    """Plain XLA masked attention on <N, T, heads, d> (the kernel's layout),
    computed as the XLA path of `models.common.self_attention` computes it:
    heads moved ahead of T, fp32 scores and softmax, PV in the input dtype.
    `mask_row` <N, T> is an additive bias ("add") or 0/1 factors ("mul")."""
    d = q.shape[-1]
    q, k, v = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
    scores = jnp.einsum(
        "nhtd,nhsd->nhts", q, k, preferred_element_type=jnp.float32
    ) / math.sqrt(d)
    m = mask_row.astype(jnp.float32)[:, None, None, :]
    scores = scores + m if mode == "add" else scores * m
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    return jnp.swapaxes(jnp.einsum("nhts,nhsd->nhtd", probs, v), 1, 2)


def _kernel(q_ref, k_ref, v_ref, mask_ref, o_ref, *, mode: str, t_real: int,
            scale: float, block_k: int, precision):
    t_pad = k_ref.shape[0]
    q = q_ref[...]  # <block_q, dp>
    block_q = q.shape[0]

    def body(j, carry):
        acc, m_prev, l_prev = carry
        start = pl.multiple_of(j * block_k, block_k)
        k = k_ref[pl.ds(start, block_k), :]
        v = v_ref[pl.ds(start, block_k), :]
        mask = mask_ref[pl.ds(start, block_k)].astype(jnp.float32)
        s = pl.dot(q, k, trans_b=True, precision=precision) * scale
        s = s + mask[None, :] if mode == "add" else s * mask[None, :]
        # natural units -> base 2; an fp32-min bias would overflow to -inf
        s = jnp.maximum(s * _LOG2E, _MASK_VALUE)
        col = start + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
        s = jnp.where(col < t_real, s, -jnp.inf)
        m_next = jnp.maximum(m_prev, jnp.max(s, axis=1))
        corr = jnp.exp2(m_prev - m_next)
        p = jnp.exp2(s - m_next[:, None])
        l_next = l_prev * corr + jnp.sum(p, axis=1)
        acc = acc * corr[:, None] + pl.dot(p.astype(v.dtype), v,
                                           precision=precision)
        return acc, m_next, l_next

    acc0 = jnp.zeros((block_q, q.shape[1]), jnp.float32)
    m0 = jnp.full((block_q,), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((block_q,), jnp.float32)
    acc, _, l = jax.lax.fori_loop(0, t_pad // block_k, body, (acc0, m0, l0))
    o_ref[...] = (acc / l[:, None]).astype(o_ref.dtype)


def _pow2_at_least(x: int, floor: int) -> int:
    return max(floor, 1 << (x - 1).bit_length())


def block_sizes(t: int) -> tuple:
    """(block_q, block_k) for sequence length t: 64-row tiles for short
    sequences (ViT's 197), 128 query rows from T=512 on."""
    return (128 if t >= 512 else 64), 64


def _call(q, k, v, mask_row, *, mode: str, interpret: bool, precision):
    n, t, h, d = q.shape
    block_q, block_k = block_sizes(t)
    t_pad = -(-t // max(block_q, block_k)) * max(block_q, block_k)
    dp = _pow2_at_least(d, 16)
    pad = ((0, 0), (0, t_pad - t), (0, 0), (0, dp - d))
    q, k, v = (jnp.pad(x, pad) for x in (q, k, v))
    mask_row = jnp.pad(mask_row.astype(jnp.float32), ((0, 0), (0, t_pad - t)))

    kernel = functools.partial(_kernel, mode=mode, t_real=t,
                               scale=1.0 / math.sqrt(d), block_k=block_k,
                               precision=precision)
    q_spec = pl.BlockSpec((None, block_q, None, dp),
                          lambda i, b, hh: (b, i, hh, 0))
    kv_spec = pl.BlockSpec((None, t_pad, None, dp),
                           lambda i, b, hh: (b, 0, hh, 0))
    out = pl.pallas_call(
        kernel,
        grid=(t_pad // block_q, n, h),
        in_specs=[q_spec, kv_spec, kv_spec,
                  pl.BlockSpec((None, t_pad), lambda i, b, hh: (b, 0))],
        out_specs=q_spec,
        out_shape=jax.ShapeDtypeStruct((n, t_pad, h, dp), q.dtype),
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="masked_attention",
    )(q, k, v, mask_row)
    return out[:, :t, :, :d]


@functools.lru_cache(maxsize=None)
def _make(mode: str, interpret: bool, precision):
    @jax.custom_vjp
    def attn(q, k, v, mask_row):
        return _call(q, k, v, mask_row, mode=mode, interpret=interpret,
                     precision=precision)

    def fwd(*args):
        # differentiated: the reference's forward, whose residuals (the
        # probabilities) its backward reads, as XLA's autodiff would
        return jax.vjp(functools.partial(reference, mode=mode), *args)

    def bwd(vjp, g):
        return vjp(g)

    attn.defvjp(fwd, bwd)
    return attn


def _dot_precision():
    """The kernel's dot precision under the current matmul-precision scope:
    full float32 under "highest" / "float32", else the default (TF32 for
    float32 operands on the card)."""
    if jax.config.jax_default_matmul_precision in ("highest", "float32"):
        return jax.lax.Precision.HIGHEST
    return None


_XLA_SCOPES: list = []


class xla_attention:
    """Trace-time scope in which `self_attention` keeps to the XLA path.

    `sharded=True` wraps model code traced under plain jit whose operands
    are GSPMD-sharded: a pallas_call has no partitioning rule, so GSPMD
    would run it replicated behind all-gathers.  It takes effect only when
    more than one device is visible; under shard_map each device traces its
    own shard and the kernel stays on (parallel.mesh.sharded_call).
    Without it the scope always holds: exported programs must lower for
    every platform they name."""

    def __init__(self, sharded: bool = False):
        self.sharded = sharded

    def __enter__(self):
        _XLA_SCOPES.append(not self.sharded or len(jax.devices()) > 1)
        return self

    def __exit__(self, *exc):
        _XLA_SCOPES.pop()


def _default_platform() -> str:
    # honours `jax.default_device(cpu)` scopes (weight surgery on the host)
    device = jax.config.jax_default_device
    return getattr(device, "platform", None) or jax.default_backend()


def kernel_applies() -> bool:
    """Whether `self_attention` runs the kernel: on the GPU, outside an
    `xla_attention` scope.  It beat XLA's attention in `fw_final` at every
    measured shape and in both mask modes (PERF.md); a differentiated call
    runs the reference instead (module docstring)."""
    return not any(_XLA_SCOPES) and _default_platform() == "gpu"


def masked_attention(q, k, v, mask_row, mode: str, *, interpret: bool = False):
    """-> <N, T, heads, d> masked attention of q, k, v <N, T, heads, d>.

    `mask_row` <N, T>: an additive bias per key (mode "add", BERT) or 0/1
    factors multiplied into the raw scores (mode "mul", ViT).  `interpret`
    runs the kernel in the Pallas interpreter (tests on the CPU)."""
    if mode not in ("add", "mul"):
        raise ValueError(f"unknown mode {mode!r}")
    return _make(mode, interpret, _dot_precision())(q, k, v, mask_row)
