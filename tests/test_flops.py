"""utils/flops.py: jaxpr-walking FLOP counter — exact on matmuls, convs, and
through `lax.scan` trip counts (the case XLA's cost_analysis undercounts)."""

import jax
import jax.numpy as jnp
import numpy as np

from autognothi.utils.flops import fn_flops


def test_plain_matmul():
    a = jnp.zeros((8, 32))
    b = jnp.zeros((32, 16))
    assert fn_flops(lambda x, y: x @ y, a, b) == 2 * 8 * 32 * 16


def test_batched_dot():
    a = jnp.zeros((4, 8, 32))
    b = jnp.zeros((4, 32, 16))
    got = fn_flops(lambda x, y: jnp.einsum("bik,bkj->bij", x, y), a, b)
    assert got == 2 * 4 * 8 * 32 * 16


def test_scan_multiplies_by_trip_count():
    w = jnp.zeros((6, 32, 32))
    x = jnp.zeros((8, 32))

    def fwd(w, x):
        def body(h, layer_w):
            return h @ layer_w, None

        h, _ = jax.lax.scan(body, x, w)
        return h

    assert fn_flops(fwd, w, x) == 6 * (2 * 8 * 32 * 32)


def test_conv():
    x = jnp.zeros((2, 3, 16, 16))
    k = jnp.zeros((8, 3, 4, 4))

    def conv(x, k):
        return jax.lax.conv_general_dilated(
            x, k, window_strides=(4, 4), padding="VALID"
        )

    # out <2, 8, 4, 4>; flops = 2 * prod(out) * C_in * kh * kw
    assert fn_flops(conv, x, k) == 2 * (2 * 8 * 4 * 4) * (3 * 4 * 4)


def test_bert_classifier_flops_close_to_analytic():
    """The scanned BERT encoder must count every layer.  Analytic lower
    bound: 2 * matmul_params * seq (attention QK/PV terms add more)."""
    from autognothi.models.bert import (
        VanillaBertConfig,
        bert_classifier_fwd,
        init_bert_classifier,
    )

    cfg = VanillaBertConfig(
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
        num_hidden_layers=3,
        num_labels=2,
        pad_token_id=0,
        type_vocab_size=2,
        vocab_size=50,
    )
    params = init_bert_classifier(jax.random.PRNGKey(0), cfg)
    xs = jnp.zeros((1, 16), jnp.int32)
    mask = jnp.ones((1, 16), jnp.int32)
    tt = jnp.zeros((1, 16), jnp.int32)
    got = fn_flops(
        lambda p, x, m, t: bert_classifier_fwd(p, cfg, x, m, t)[0],
        params, xs, mask, tt,
    )
    d, layers, seq = cfg.hidden_size, cfg.num_hidden_layers, 16
    per_layer = 4 * d * d + 2 * d * cfg.intermediate_size  # qkvo + mlp
    analytic_min = 2 * per_layer * seq * layers
    # every layer counted: must exceed the all-layers matmul bound and stay
    # within 2x of it (attention score/context terms, pooler, head)
    assert analytic_min <= got < 2 * analytic_min, (got, analytic_min)


def test_cond_counts_max_branch():
    a = jnp.zeros((8, 8))

    def fwd(x):
        return jax.lax.cond(
            True, lambda v: v @ v @ v, lambda v: v @ v, x
        )

    got = fn_flops(fwd, a)
    assert got == 2 * (2 * 8 * 8 * 8)


def test_numpy_inputs_accepted():
    got = fn_flops(lambda x: x @ x, np.zeros((4, 4), np.float32))
    assert got == 2 * 4 * 4 * 4


def test_pallas_call_counts_grid_steps():
    """A Pallas kernel traces ONE grid step; jaxpr_flops must scale by the
    grid product (and the in-kernel key-block loop by its trip count) or
    fn_flops under-reports by ~batch x heads x query blocks.  At a shape
    the masked-attention kernel does not pad, it counts what the XLA
    reference counts."""
    from autognothi.ops.flash_attention import masked_attention, reference

    n, t, h, d = 2, 128, 3, 16
    q = jnp.zeros((n, t, h, d))
    row = jnp.ones((n, t))

    xla = fn_flops(lambda a: reference(a, a, a, row, "mul"), q)
    pallas = fn_flops(
        lambda a: masked_attention(a, a, a, row, "mul", interpret=True), q)
    assert xla == 2 * (2 * n * h * t * t * d)  # QK^T and PV
    assert pallas == xla, (pallas, xla)
