"""Masked attention: the XLA path of `models.common.self_attention` and the
Pallas/Triton kernel (ops/flash_attention.py, in interpret mode here)
against a float64 NumPy reference, plus the kernel's padding, dispatch,
gradient rule and behaviour under a device mesh.

The `gpu`-marked tests compile the kernel for the card and compare it with
the reference in float32 at "highest" precision, at the real widths;
chip_smoke.py runs them (tolerances at GPU_TOL).

Tolerances: float32 runs carry ~1e-7 relative rounding per op through
sums of up to 512 terms, so 1e-4 absolute on outputs of order 1; bfloat16
inputs, projections and probabilities keep 8 mantissa bits (~4e-3
relative per rounding, several roundings deep), so 5e-2 absolute.
"""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autognothi.models import common
from autognothi.ops import flash_attention
from autognothi.ops.flash_attention import (block_sizes, kernel_applies,
                                            masked_attention, reference,
                                            xla_attention)

SHAPES = [(5, 8), (130, 16), (197, 8), (197, 64), (512, 64)]
DTYPES = {"f32": (jnp.float32, 1e-4), "bf16": (jnp.bfloat16, 5e-2)}
FINFO_MIN = float(np.finfo(np.float32).min)


def _np_attention(q, k, v, row, mode):
    """float64 reference on <N, T, heads, d>."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    scores = np.einsum("nthd,nshd->nhts", q, k) / math.sqrt(q.shape[-1])
    m = np.asarray(row, np.float64)[:, None, None, :]
    scores = scores + m if mode == "add" else scores * m
    scores = scores - scores.max(axis=-1, keepdims=True)
    probs = np.exp(scores)
    probs /= probs.sum(axis=-1, keepdims=True)
    return np.einsum("nhts,nshd->nthd", probs, v)


def _mask_row(rng, n, t, mode):
    keep = rng.randint(0, 2, (n, t)).astype(np.float32)
    keep[:, 0] = 1.0  # CLS / first token always present
    if mode == "add":
        return (1.0 - keep) * FINFO_MIN
    return keep


def _qkv(rng, n, t, h, d, dtype):
    return tuple(jnp.asarray(rng.randn(n, t, h, d), jnp.float32).astype(dtype)
                 for _ in range(3))


@pytest.mark.parametrize("dtype", DTYPES, ids=list(DTYPES))
@pytest.mark.parametrize("t,d", SHAPES, ids=[f"T{t}d{d}" for t, d in SHAPES])
@pytest.mark.parametrize("mode", ["add", "mul"])
def test_xla_self_attention_matches_float64(mode, t, d, dtype):
    """The model's XLA path (projections + masked softmax attention)."""
    dt, tol = DTYPES[dtype]
    rng = np.random.RandomState(t + d)
    n, heads = 2, 2
    hidden = heads * d
    h = jnp.asarray(rng.randn(n, t, hidden), jnp.float32).astype(dt)
    ws = [jnp.asarray(rng.randn(hidden, hidden) / math.sqrt(hidden),
                      jnp.float32).astype(dt) for _ in range(3)]
    bs = [jnp.asarray(rng.randn(hidden) * 0.1, jnp.float32).astype(dt)
          for _ in range(3)]
    row = _mask_row(rng, n, t, mode)
    mask = (jnp.asarray(row)[:, None, None, :] if mode == "add"
            else jnp.asarray(row))
    got = common.self_attention(
        h, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], heads, mask,
        "additive" if mode == "add" else "multiplicative")

    h64 = np.asarray(h, np.float64)
    q, k, v = (
        (h64 @ np.asarray(w, np.float64).T + np.asarray(b, np.float64))
        .reshape(n, t, heads, d) for w, b in zip(ws, bs))
    want = _np_attention(q, k, v, row, mode).reshape(n, t, hidden)
    assert got.dtype == dt
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=list(DTYPES))
@pytest.mark.parametrize("t,d", SHAPES, ids=[f"T{t}d{d}" for t, d in SHAPES])
@pytest.mark.parametrize("mode", ["add", "mul"])
def test_kernel_matches_float64(mode, t, d, dtype):
    dt, tol = DTYPES[dtype]
    rng = np.random.RandomState(t * d)
    n, heads = 2, 2
    q, k, v = _qkv(rng, n, t, heads, d, dt)
    row = _mask_row(rng, n, t, mode)
    got = masked_attention(q, k, v, jnp.asarray(row), mode, interpret=True)
    assert got.shape == q.shape and got.dtype == dt
    want = _np_attention(q, k, v, row, mode)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol)


@pytest.mark.parametrize("path", ["xla", "kernel"])
@pytest.mark.parametrize("mode", ["add", "mul"])
def test_fully_masked_rows_attend_uniformly(mode, path):
    """A row whose every key is masked is not NaN: the additive finfo.min
    bias leaves all scores equal and the multiplicative mask zeroes them,
    so both attend uniformly — the mean of v over the real keys."""
    rng = np.random.RandomState(3)
    n, t, heads, d = 2, 70, 2, 16
    q, k, v = _qkv(rng, n, t, heads, d, jnp.float32)
    row = np.full((n, t), FINFO_MIN if mode == "add" else 0.0, np.float32)
    if path == "kernel":
        got = masked_attention(q, k, v, jnp.asarray(row), mode,
                               interpret=True)
    else:
        got = reference(q, k, v, jnp.asarray(row), mode)
    want = np.broadcast_to(np.asarray(v).mean(axis=1, keepdims=True),
                           v.shape)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


@pytest.mark.parametrize("mode", ["add", "mul"])
def test_kernel_gradient_is_the_reference_gradient(mode):
    """custom_vjp: a differentiated call is the XLA reference, forward and
    backward."""
    rng = np.random.RandomState(4)
    n, t, heads, d = 2, 33, 2, 8
    q, k, v = _qkv(rng, n, t, heads, d, jnp.float32)
    row = jnp.asarray(_mask_row(rng, n, t, mode))
    g = jnp.asarray(rng.randn(n, t, heads, d), jnp.float32)

    def loss(fn, q, k, v):
        return jnp.sum(fn(q, k, v) * g)

    kern = functools.partial(
        lambda q, k, v: masked_attention(q, k, v, row, mode, interpret=True))
    ref = functools.partial(lambda q, k, v: reference(q, k, v, row, mode))
    got = jax.grad(functools.partial(loss, kern), argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(functools.partial(loss, ref), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("differentiated", [False, True])
def test_kernel_runs_only_where_nothing_is_differentiated(differentiated):
    """The primal call traces the pallas_call; under jax.grad the whole
    computation is the reference's, so a training step pays no kernel
    forward on top of XLA's forward and backward."""
    row = jnp.ones((1, 8))

    def attn(a):
        return masked_attention(a, a, a, row, "mul", interpret=True).sum()

    fn = jax.grad(attn) if differentiated else attn
    text = str(jax.make_jaxpr(fn)(jnp.ones((1, 8, 1, 8))))
    assert ("pallas_call" in text) is not differentiated


@pytest.mark.parametrize("scope", [None, "highest", "float32"])
def test_kernel_dots_follow_the_precision_scope(scope):
    """Both dots run at the precision of the scope they are traced in: full
    float32 under "highest" (the final-coherency check), else the default
    (TF32 for float32 operands on the card)."""
    row = jnp.ones((1, 8))
    q = jnp.ones((1, 8, 1, 8))

    def trace():
        return str(jax.make_jaxpr(
            lambda a: masked_attention(a, a, a, row, "mul",
                                       interpret=True))(q))

    if scope is None:
        assert "Precision.HIGHEST" not in trace()
    else:
        with jax.default_matmul_precision(scope):
            assert trace().count("precision=(Precision.HIGHEST") == 2


def test_kernel_pads_sequence_and_head_dim():
    """T=197 pads to the 64-row blocks (256) and d=8 to 16; the padding
    never reaches the output."""
    assert block_sizes(197) == (64, 64)
    assert block_sizes(512) == (128, 64)
    rng = np.random.RandomState(5)
    q, k, v = _qkv(rng, 1, 197, 1, 8, jnp.float32)
    row = jnp.ones((1, 197))
    text = str(jax.make_jaxpr(
        lambda a, b, c: masked_attention(a, b, c, row, "mul",
                                         interpret=True))(q, k, v))
    assert "256,1,16" in text.replace(" ", "")
    out = masked_attention(q, k, v, row, "mul", interpret=True)
    assert out.shape == (1, 197, 1, 8)


def test_kernel_rejects_unknown_mode():
    q = jnp.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="unknown mode"):
        masked_attention(q, q, q, jnp.ones((1, 4)), "bias")


def test_kernel_applies_on_the_gpu_only(monkeypatch):
    assert not kernel_applies()  # the CPU backend here
    monkeypatch.setattr(flash_attention, "_default_platform", lambda: "gpu")
    assert kernel_applies()


def test_xla_attention_scope(monkeypatch):
    monkeypatch.setattr(flash_attention, "_default_platform", lambda: "gpu")
    with xla_attention():
        assert not kernel_applies()
        with xla_attention(sharded=True):
            assert not kernel_applies()
    assert kernel_applies()
    # sharded scopes hold only where several devices are visible (8 here)
    with xla_attention(sharded=True):
        assert not kernel_applies()
    monkeypatch.setattr(jax, "devices", lambda *a: [object()])
    with xla_attention(sharded=True):
        assert kernel_applies()


def test_host_scope_keeps_to_xla(monkeypatch):
    """Weight surgery runs under jax.default_device(cpu): no kernel there
    even when the default backend is a GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert not kernel_applies()
    assert kernel_applies()


@pytest.mark.parametrize("mask_mode", ["additive", "multiplicative"])
def test_self_attention_routes_to_the_kernel(monkeypatch, mask_mode):
    """Where the kernel applies, self_attention hands it the projections in
    <N, T, heads, d> layout with the per-key mask row, and its answer
    matches the XLA path; with attention dropout it keeps to XLA."""
    calls = []

    def spy(q, k, v, row, mode):
        calls.append((q.shape, row.shape, mode))
        return masked_attention(q, k, v, row, mode, interpret=True)

    rng = np.random.RandomState(6)
    n, t, heads, d = 2, 12, 3, 8
    h = jnp.asarray(rng.randn(n, t, heads * d), jnp.float32)
    w = [jnp.asarray(rng.randn(heads * d, heads * d) * 0.2, jnp.float32)
         for _ in range(3)]
    b = [jnp.zeros((heads * d,)) for _ in range(3)]
    row = _mask_row(rng, n, t, "add" if mask_mode == "additive" else "mul")
    mask = (jnp.asarray(row)[:, None, None, :] if mask_mode == "additive"
            else jnp.asarray(row))
    args = (h, w[0], b[0], w[1], b[1], w[2], b[2], heads, mask, mask_mode)
    want = common.self_attention(*args)

    monkeypatch.setattr(flash_attention, "_default_platform", lambda: "gpu")
    monkeypatch.setattr(flash_attention, "masked_attention", spy)
    got = common.self_attention(*args)
    mode = "add" if mask_mode == "additive" else "mul"
    assert calls == [((n, t, heads, d), (n, t), mode)]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    common.self_attention(*args, attn_dropout=0.1,
                          dropout_key=jax.random.PRNGKey(0),
                          deterministic=False)
    assert len(calls) == 1


def test_kernel_runs_per_shard_under_shard_map(monkeypatch):
    """sharded_serving_fn over the 8-device mesh traces the kernel on each
    device's batch shard: the compiled program has no collectives, and the
    answer matches the single-device XLA forward."""
    from autognothi.models.vit import VanillaViTConfig, init_vit_final
    from autognothi.parallel.mesh import (make_mesh, replicate_params,
                                          shard_batch, sharded_serving_fn)
    from autognothi.recipes.vanilla_vit import fw_final

    cfg = VanillaViTConfig(
        attention_probs_dropout_prob=0.0, explainer_attn_num_layers=1,
        explainer_head_hidden_size=16, explainer_normalize=True,
        hidden_dropout_prob=0.0, hidden_size=32, intermediate_size=64,
        layer_norm_eps=1e-12, num_attention_heads=4, num_hidden_layers=2,
        num_labels=3, img_channels=3, img_px_size=16, img_patch_size=8)
    params = init_vit_final(jax.random.PRNGKey(0), cfg)
    xs = jnp.asarray(np.random.RandomState(7).randn(8, 3, 16, 16),
                     jnp.float32)
    want = jax.jit(lambda p, x: fw_final(cfg, p, x))(params, xs)

    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return masked_attention(*a, **kw, interpret=True)

    monkeypatch.setattr(flash_attention, "_default_platform", lambda: "gpu")
    monkeypatch.setattr(flash_attention, "masked_attention", spy)
    mesh = make_mesh(8)
    fw = sharded_serving_fn(lambda p, x: fw_final(cfg, p, x), mesh)
    p_rep, x_sh = replicate_params(params, mesh), shard_batch(xs, mesh)
    text = fw.lower(p_rep, x_sh).compile().as_text()
    # traced on one image per device (eval_shape also traces the whole
    # batch once, to lay out the outputs)
    assert (1, 5, 4, 8) in calls
    for op in ("all-gather", "all-reduce", "collective-permute"):
        assert not re.findall(op, text), op
    got = fw(p_rep, x_sh)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


GPU_SHAPES = [  # name, N, T, heads, d, mode: the real widths
    ("vit_b_trunk", 64, 197, 12, 64, "mul"),
    ("ltt_ladder", 64, 197, 12, 8, "mul"),
    ("bert_base", 16, 512, 12, 64, "add"),
]
# dtype case -> (input dtype, the kernel's matmul-precision scope, tolerance
# on max |err| against the float32 "highest" reference):
# - f32_highest: full float32 dots; fp32 rounding (6e-8 relative) through
#   sums of up to 512 terms and the base-2 rescaling stays near 1e-6, and
#   TF32 or bf16 dots (errors of 1e-3 and more here) cannot pass 2e-5;
# - f32: the card's default, TF32 dots (10-bit mantissa): 7.6e-4 to 1.35e-3
#   measured, bf16 3.7e-3 to 3.9e-3 at these shapes (PERF.md), so 2.5e-3
#   also refuses a kernel that rounds float32 operands to bf16;
# - bf16: bf16 inputs and probabilities (8-bit mantissa), several roundings
#   deep.
GPU_TOL = {"f32_highest": (jnp.float32, "highest", 2e-5),
           "f32": (jnp.float32, None, 2.5e-3),
           "bf16": (jnp.bfloat16, None, 3e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_TOL, ids=list(GPU_TOL))
@pytest.mark.parametrize("name,n,t,heads,d,mode", GPU_SHAPES,
                         ids=[s[0] for s in GPU_SHAPES])
def test_compiled_kernel_matches_highest_reference(name, n, t, heads, d,
                                                   mode, dtype):
    dt, scope, tol = GPU_TOL[dtype]
    rng = np.random.RandomState(11)
    q, k, v = _qkv(rng, n, t, heads, d, dt)
    if mode == "add":  # BERT: each sequence's padded tail masked out
        lens = rng.randint(t // 4, t + 1, n)
        row = np.where(np.arange(t)[None, :] < lens[:, None], 0.0,
                       FINFO_MIN).astype(np.float32)
    else:
        row = _mask_row(rng, n, t, mode)
    row = jnp.asarray(row)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda a, b, c: reference(a, b, c, row, mode))(
            *(x.astype(jnp.float32) for x in (q, k, v)))
    with jax.default_matmul_precision(scope or "default"):
        got = jax.jit(lambda a, b, c: masked_attention(a, b, c, row, mode))(
            q, k, v)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)))
    print(f"[kernels] {name} T={t} {heads}x{d} {mode} {dtype}: max |err| "
          f"{err:.2e} vs the float32 'highest' reference (tolerance "
          f"{tol:g})")
    assert err <= tol
