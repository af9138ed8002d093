"""Pipeline parallelism (parallel/pipeline.py): GPipe schedule over the
("data", "pipe") mesh.

The reference is single-device; pp is new capability completing
the parallelism set (dp/tp: parallel/mesh.py, sp: the coalition axis,
ep: n/a — no MoE architectures).  Pinned here:

- forward parity: the pipelined encoder equals the sequential lax.scan
  (ViT and BERT bodies, dp x pp composed on the 8-device CPU mesh);
- grad parity: cotangents flow through the transposed ppermutes — both
  activation grads and stage-sharded weight grads match the sequential
  reference;
- stage-sharded training: the pp classifier step keeps weights, grads and
  Adam moments P("pipe")-sharded while the loss decreases;
- the compiled forward moves activations with collective-permutes and
  never all-gathers a weight slab;
- fail-closed: layer counts / batches that do not divide the mesh raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from autognothi.models.common import stack_layer_params, subdict
from autognothi.models.vit import (
    VanillaViTConfig,
    init_vit_classifier,
    vit_embeddings,
    vit_encoder,
)
from autognothi.parallel.pipeline import (
    make_pipe_mesh,
    make_pp_classifier_train_step,
    pipelined_bert_encoder,
    pipelined_vit_encoder,
    pipelined_vit_encoder_stacked,
    pp_vit_classifier_fwd,
    split_encoder_params,
)


@pytest.fixture(autouse=True)
def _no_persistent_cache():
    """Compile fresh: the XLA:CPU thunk runtime can SIGABRT executing a
    CACHE-LOADED executable that mixes all-reduces with collective-permutes
    (measured on the pp surrogate trainer step — see test_train_pp.py's
    identical fixture).  This module's train-step tests
    compile exactly that program shape, so it opts out of the suite-wide
    persistent cache too."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", old)


def _mini_cfg(layers=4):
    return VanillaViTConfig(
        attention_probs_dropout_prob=0.0,
        explainer_attn_num_layers=1,
        explainer_head_hidden_size=16,
        explainer_normalize=True,
        hidden_dropout_prob=0.0,
        hidden_size=32,
        intermediate_size=64,
        layer_norm_eps=1e-12,
        num_attention_heads=4,
        num_hidden_layers=layers,
        num_labels=3,
        img_channels=3,
        img_px_size=16,
        img_patch_size=8,
    )


@pytest.fixture(scope="module")
def vit_setup():
    cfg = _mini_cfg()
    p = init_vit_classifier(jax.random.PRNGKey(0), cfg)
    vp = subdict(p, "vit.")
    rs = np.random.RandomState(0)
    pixels = jnp.asarray(rs.randn(8, 3, 16, 16).astype(np.float32))
    mask = jnp.asarray(  # token mask incl. CLS (multiplicative score mask)
        rs.randint(0, 2, (8, cfg.n_patches + 1)).astype(np.float32)
    )
    h0 = vit_embeddings(vp, cfg, pixels)
    return cfg, p, vp, pixels, mask, h0


def test_pp_vit_encoder_matches_scan(vit_setup):
    cfg, _, vp, _, mask, h0 = vit_setup
    ref = vit_encoder(vp, cfg, h0, mask)
    for pipe, micro in ((4, 2), (2, 2), (1, 1)):  # batch 8 = data x micro x mb
        mesh = make_pipe_mesh(8, pipe=pipe)
        out = pipelined_vit_encoder(vp, cfg, h0, mask, mesh,
                                    microbatches=micro)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)


def test_pp_vit_encoder_no_mask(vit_setup):
    cfg, _, vp, _, _, h0 = vit_setup
    ref = vit_encoder(vp, cfg, h0, None)
    mesh = make_pipe_mesh(8, pipe=4)
    out = pipelined_vit_encoder(vp, cfg, h0, None, mesh, microbatches=2)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_pp_grads_match(vit_setup):
    cfg, _, vp, _, mask, h0 = vit_setup
    mesh = make_pipe_mesh(8, pipe=4)
    rs = np.random.RandomState(1)
    probe_shape = jax.eval_shape(lambda h: vit_encoder(vp, cfg, h, mask), h0)
    probe = jnp.asarray(rs.randn(*probe_shape.shape).astype(np.float32))

    g_ref = jax.grad(lambda h: jnp.sum(vit_encoder(vp, cfg, h, mask) * probe))(
        h0)
    g_pp = jax.grad(lambda h: jnp.sum(
        pipelined_vit_encoder(vp, cfg, h, mask, mesh, microbatches=2) * probe
    ))(h0)
    np.testing.assert_allclose(np.asarray(g_pp), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-6)

    stacked = stack_layer_params(vp, "encoder.layers", cfg.num_hidden_layers)

    def ref_from_stacked(s):
        q = dict(vp)
        for k, v in s.items():
            for i in range(cfg.num_hidden_layers):
                q[f"encoder.layers.{i}.{k}"] = v[i]
        return jnp.sum(vit_encoder(q, cfg, h0, mask) * probe)

    g_ref_s = jax.grad(ref_from_stacked)(stacked)
    g_pp_s = jax.grad(lambda s: jnp.sum(
        pipelined_vit_encoder_stacked(s, cfg, h0, mask, mesh, microbatches=2)
        * probe
    ))(stacked)
    for k in g_ref_s:
        np.testing.assert_allclose(
            np.asarray(g_pp_s[k]), np.asarray(g_ref_s[k]),
            rtol=1e-4, atol=1e-6, err_msg=k)


def test_pp_classifier_train_step_stage_sharded(vit_setup):
    cfg, p, _, pixels, _, _ = vit_setup
    mesh = make_pipe_mesh(8, pipe=2)
    rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
    spec = stacked["attention.self.query.weight"].sharding.spec
    assert spec[0] == "pipe", spec
    # the 1/P per-rank depth-memory claim, measured on the actual shards
    leaf = stacked["attention.self.query.weight"]
    local = leaf.addressable_shards[0].data.shape
    assert local[0] == cfg.num_hidden_layers // 2, local

    tx = optax.adamw(1e-3)
    opt_state = tx.init((rest, stacked))
    step = make_pp_classifier_train_step(cfg, tx, mesh, microbatches=2)
    rs = np.random.RandomState(2)
    labels = jnp.asarray(rs.randint(0, cfg.num_labels, (8,)))
    ones = jnp.ones((8, cfg.n_patches + 1), jnp.float32)

    losses = []
    for _ in range(4):
        rest, stacked, opt_state, loss = step(
            rest, stacked, opt_state, pixels, ones, labels)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    # weights AND Adam moments stay stage-sharded after the update
    spec = stacked["attention.self.query.weight"].sharding.spec
    assert spec[0] == "pipe", spec
    mu = jax.tree.leaves(opt_state)  # find a moment matching a stacked leaf
    stacked_shapes = {v.shape for v in stacked.values()}
    sharded_moments = [
        m for m in mu
        if hasattr(m, "sharding") and m.shape in stacked_shapes
        and getattr(m.sharding, "spec", None)
        and m.sharding.spec and m.sharding.spec[0] == "pipe"
    ]
    assert sharded_moments, "no pipe-sharded Adam moments found"


def test_pp_fwd_parity_vs_plain_classifier(vit_setup):
    cfg, p, _, pixels, _, _ = vit_setup
    from autognothi.models.vit import vit_classifier_fwd

    mesh = make_pipe_mesh(8, pipe=4)
    rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
    ones = jnp.ones((8, cfg.n_patches + 1), jnp.float32)
    probs = pp_vit_classifier_fwd(rest, stacked, cfg, pixels, ones, mesh,
                                  microbatches=2)
    ref, _ = vit_classifier_fwd(p, cfg, pixels, ones)
    np.testing.assert_allclose(np.asarray(probs), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_pp_vit_explainer_fwd_parity(vit_setup):
    """pp_vit_explainer_fwd vs the sequential vit_explainer_fwd (the hot
    training tower): attributions must match with the backbone encoder
    stage-sharded and the explainer_attn + MLP head on `rest`."""
    from autognothi.models.vit import init_vit_explainer, vit_explainer_fwd
    from autognothi.parallel.pipeline import pp_vit_explainer_fwd

    cfg, _, _, pixels, _, _ = vit_setup
    p = init_vit_explainer(jax.random.PRNGKey(8), cfg)
    rs = np.random.RandomState(9)
    grand = jnp.asarray(rs.randn(8, cfg.num_labels).astype(np.float32))
    null = jnp.asarray(rs.randn(1, cfg.num_labels).astype(np.float32))
    ones = jnp.ones((8, cfg.n_patches + 1), jnp.float32)

    mesh = make_pipe_mesh(8, pipe=4)
    rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
    phi = pp_vit_explainer_fwd(rest, stacked, cfg, pixels, ones, grand, null,
                               mesh, microbatches=2)
    ref, _ = vit_explainer_fwd(p, cfg, pixels, ones, grand, null)
    assert phi.shape == (8, cfg.num_labels, cfg.n_patches)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_pp_bert_explainer_fwd_parity():
    """Text-track pp explainer forward vs the sequential bert_explainer_fwd
    (no final LN — bert_backbone ends at the encoder)."""
    from autognothi.models.bert import (
        bert_explainer_fwd,
        init_bert_explainer,
    )
    from autognothi.parallel.pipeline import pp_bert_explainer_fwd

    cfg = _mini_bert_cfg()
    p = init_bert_explainer(jax.random.PRNGKey(10), cfg)
    rs = np.random.RandomState(12)
    ids = jnp.asarray(rs.randint(0, 64, (8, 12)))
    attn = jnp.ones((8, 12), jnp.int32)
    toktype = jnp.zeros((8, 12), jnp.int32)
    grand = jnp.asarray(rs.randn(8, cfg.num_labels).astype(np.float32))
    null = jnp.asarray(rs.randn(1, cfg.num_labels).astype(np.float32))

    mesh = make_pipe_mesh(8, pipe=2)
    rest, stacked = split_encoder_params(
        p, cfg.num_hidden_layers, mesh, prefix="bert.encoder.layers")
    phi = pp_bert_explainer_fwd(rest, stacked, cfg, ids, attn, toktype,
                                grand, null, mesh, microbatches=2)
    ref, _ = bert_explainer_fwd(p, cfg, ids, attn, toktype, grand, null)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_pp_collective_shape(vit_setup):
    """The compiled pp forward moves activations with collective-permutes
    (inside the schedule loop) and must not all-gather the weight slabs —
    an all-gather of `stacked` would mean every rank materializes every
    stage (the exact replication failure tests/test_pallas_gspmd.py pins
    for GSPMD x pallas)."""
    cfg, _, vp, _, mask, h0 = vit_setup
    mesh = make_pipe_mesh(8, pipe=4)
    stacked = stack_layer_params(vp, "encoder.layers", cfg.num_hidden_layers)

    fn = jax.jit(lambda s, h: pipelined_vit_encoder_stacked(
        s, cfg, h, mask, mesh, microbatches=2))
    txt = fn.lower(stacked, h0).compile().as_text()
    assert txt.count("collective-permute") >= 1, "no pipeline hops compiled"
    import re

    # weight slabs stay stage-local: no all-gather may touch a stacked
    # layer shape (leading dim = layers-per-stage x anything model-sized)
    ags = re.findall(r"all-gather[^\n]*", txt)
    for line in ags:
        assert "f32[1," not in line and "f32[4," not in line, line


def _mini_bert_cfg():
    from autognothi.models.bert import VanillaBertConfig

    return VanillaBertConfig(
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
        num_hidden_layers=4,
        num_labels=2,
        pad_token_id=0,
        type_vocab_size=2,
        vocab_size=64,
    )


def test_pp_bert_encoder_matches_scan():
    from autognothi.models.bert import (
        bert_embeddings,
        bert_encoder,
        init_bert_classifier,
    )
    from autognothi.models.common import additive_mask_bias

    cfg = _mini_bert_cfg()
    p = subdict(init_bert_classifier(jax.random.PRNGKey(1), cfg), "bert.")
    rs = np.random.RandomState(3)
    ids = jnp.asarray(rs.randint(0, 64, (8, 12)))
    attn = jnp.ones((8, 12), jnp.int32)
    toktype = jnp.zeros((8, 12), jnp.int32)
    h0 = bert_embeddings(p, cfg, ids, toktype)
    bias = additive_mask_bias(attn)

    ref = bert_encoder(p, cfg, h0, bias)
    mesh = make_pipe_mesh(8, pipe=2)
    out = pipelined_bert_encoder(p, cfg, h0, bias, mesh, microbatches=2)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_pp_bert_classifier_fwd_parity():
    """Text-track pp classifier (pp_bert_classifier_fwd) vs the sequential
    bert_classifier_fwd, with stage-sharded weights."""
    from autognothi.models.bert import (
        bert_classifier_fwd,
        init_bert_classifier,
    )
    from autognothi.parallel.pipeline import pp_bert_classifier_fwd

    cfg = _mini_bert_cfg()
    p = init_bert_classifier(jax.random.PRNGKey(4), cfg)
    rs = np.random.RandomState(6)
    ids = jnp.asarray(rs.randint(0, 64, (8, 12)))
    attn = jnp.ones((8, 12), jnp.int32)
    toktype = jnp.zeros((8, 12), jnp.int32)

    mesh = make_pipe_mesh(8, pipe=4)
    rest, stacked = split_encoder_params(
        p, cfg.num_hidden_layers, mesh, prefix="bert.encoder.layers")
    probs = pp_bert_classifier_fwd(rest, stacked, cfg, ids, attn, toktype,
                                   mesh, microbatches=2)
    ref, _ = bert_classifier_fwd(p, cfg, ids, attn, toktype)
    np.testing.assert_allclose(np.asarray(probs), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_pp_dropout_iid_across_microbatches_and_ranks():
    """Stochastic pp forwards must draw per-(layer, microbatch, data rank)
    dropout keys: folding by layer index alone hands every microbatch and
    every data rank identical masks (same key, same local shape), silently
    correlating the regularization noise.  With 8 identical input rows on a
    (data=2, pipe=2) x microbatches=2 layout, rows landing in different
    microbatches (0 vs 2) and different data ranks (0 vs 4) must differ,
    and re-running with the same key must reproduce exactly."""
    cfg = dataclasses.replace(_mini_cfg(), hidden_dropout_prob=0.3)
    p = init_vit_classifier(jax.random.PRNGKey(0), cfg)
    vp = subdict(p, "vit.")
    rs = np.random.RandomState(7)
    one = rs.randn(1, 3, 16, 16).astype(np.float32)
    pixels = jnp.asarray(np.repeat(one, 8, axis=0))
    mask = jnp.ones((8, cfg.n_patches + 1), jnp.float32)
    h0 = vit_embeddings(vp, cfg, pixels)
    mesh = make_pipe_mesh(4, pipe=2)  # data=2: rows 0-3 rank0, 4-7 rank1
    rng = jax.random.PRNGKey(11)

    out = pipelined_vit_encoder(vp, cfg, h0, mask, mesh, microbatches=2,
                                deterministic=False, rng=rng)
    out = np.asarray(out)
    assert not np.allclose(out[0], out[2]), "microbatches share dropout masks"
    assert not np.allclose(out[0], out[4]), "data ranks share dropout masks"
    out2 = np.asarray(pipelined_vit_encoder(
        vp, cfg, h0, mask, mesh, microbatches=2,
        deterministic=False, rng=rng))
    np.testing.assert_array_equal(out, out2)  # keyed, not stateful


def test_pp_train_step_pins_pallas_and_quant(vit_setup, monkeypatch):
    """The pp train step's differentiated forward follows the trainer
    discipline (parallel/train_step.py): attention pinned to XLA at trace
    time under the multi-device mesh.  With the platform reported as a GPU
    and the kernel routed to the Pallas interpreter, an unpinned loss would
    trace the kernel, whose online softmax sums in another order — exact
    equality with the default loss proves the pin."""
    import functools

    from autognothi.ops import flash_attention

    cfg, p, _, pixels, _, _ = vit_setup
    mesh = make_pipe_mesh(8, pipe=2)
    rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
    tx = optax.adamw(1e-3)
    step = make_pp_classifier_train_step(cfg, tx, mesh, microbatches=2)
    rs = np.random.RandomState(5)
    labels = jnp.asarray(rs.randint(0, cfg.num_labels, (8,)))
    ones = jnp.ones((8, cfg.n_patches + 1), jnp.float32)

    _, _, _, ref = step(rest, stacked, tx.init((rest, stacked)),
                        pixels, ones, labels)
    monkeypatch.setattr(flash_attention, "_default_platform", lambda: "gpu")
    monkeypatch.setattr(
        flash_attention, "masked_attention",
        functools.partial(flash_attention.masked_attention, interpret=True))
    step2 = make_pp_classifier_train_step(cfg, tx, mesh, microbatches=2)
    _, _, _, pinned = step2(rest, stacked, tx.init((rest, stacked)),
                            pixels, ones, labels)
    assert float(ref) == float(pinned), (float(ref), float(pinned))


def test_pp_per_rank_memory_scales_1_over_p():
    """The memory model pp exists for, MEASURED from the actual addressable
    shard buffers after one real train step: per-rank encoder-stack bytes
    (weights AND Adam moments) are exactly the 1/P slab at P in {2, 4}
    (12 layers), while `rest` stays replicated (constant per rank).
    Full sweep incl. P=3 + the microbatch temp-size table:
    playground/bench_pp_memory.py."""
    from autognothi.parallel.pipeline import (
        make_pp_classifier_train_step,
    )

    cfg = _mini_cfg(layers=12)
    params = init_vit_classifier(jax.random.PRNGKey(0), cfg)

    def rank0_bytes(tree, dev):
        return sum(
            s.data.nbytes
            for leaf in jax.tree.leaves(tree)
            if hasattr(leaf, "addressable_shards")
            for s in leaf.addressable_shards if s.device == dev
        )

    full_stack = sum(
        np.asarray(v).nbytes for k, v in params.items()
        if k.startswith("vit.encoder.layers.")
    )
    per_rank = {}
    for pipe in (2, 4):
        mesh = make_pipe_mesh(pipe, pipe=pipe)  # data=1: pure depth split
        rest, stacked = split_encoder_params(params, 12, mesh)
        tx = optax.adamw(1e-3)
        opt = tx.init((rest, stacked))
        step = make_pp_classifier_train_step(cfg, tx, mesh, microbatches=2)
        xs = jnp.zeros((2, 3, 16, 16), jnp.float32)
        ones = jnp.ones((2, cfg.n_patches + 1), jnp.float32)
        labels = jnp.zeros((2,), jnp.int32)
        rest, stacked, opt, _ = step(rest, stacked, opt, xs, ones, labels)
        dev = mesh.devices.flat[0]
        stack_b = rank0_bytes(stacked, dev)
        assert stack_b == full_stack // pipe, (pipe, stack_b, full_stack)
        per_rank[pipe] = stack_b + rank0_bytes(opt, dev)
    # Adam carries 2 stack-shaped moments per rank + a replicated remainder
    # (rest moments, scalar counts): P=2 -> P=4 must shed at least 40% of
    # the stack-proportional state (exactly 50% minus the constant part)
    assert per_rank[4] < 0.6 * per_rank[2], per_rank


def test_pp_fail_closed(vit_setup):
    cfg, _, vp, _, mask, h0 = vit_setup
    mesh = make_pipe_mesh(8, pipe=4)
    cfg3 = _mini_cfg(layers=3)
    p3 = subdict(init_vit_classifier(jax.random.PRNGKey(0), cfg3), "vit.")
    with pytest.raises(ValueError, match="divide pipe"):
        pipelined_vit_encoder(p3, cfg3, h0, mask, mesh, microbatches=2)
    with pytest.raises(ValueError, match="does not divide"):
        # batch 8 over data=2 x microbatches=3
        pipelined_vit_encoder(vp, cfg, h0, mask, mesh, microbatches=3)
    with pytest.raises(ValueError, match="not divisible by pipe"):
        make_pipe_mesh(8, pipe=3)


# ------------------------------------------------- tp inside pp stages


def test_pp_tp_mesh_and_shardings(vit_setup):
    """make_pipe_mesh(model=T) -> ("data", "pipe", "model"); stacked slabs
    carry the Megatron specs on their hidden dims (column-parallel out
    features, row-parallel in features), so each device holds a
    (L/P, .../T) brick; `rest` (incl. explainer_attn) gets the same specs
    under plain GSPMD."""
    cfg, p, _, _, _, _ = vit_setup
    mesh = make_pipe_mesh(8, pipe=2, model=2)
    assert mesh.axis_names == ("data", "pipe", "model")
    assert dict(mesh.shape) == {"data": 2, "pipe": 2, "model": 2}
    rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
    spec = stacked["attention.self.query.weight"].sharding.spec
    assert tuple(spec) == ("pipe", "model", None), spec
    spec = stacked["attention.output.dense.weight"].sharding.spec
    assert tuple(spec) == ("pipe", None, "model"), spec
    spec = stacked["layernorm_before.weight"].sharding.spec
    assert tuple(spec) == ("pipe", None), spec  # LN replicated over model
    leaf = stacked["attention.self.query.weight"]
    local = leaf.addressable_shards[0].data.shape
    assert local == (cfg.num_hidden_layers // 2, cfg.hidden_size // 2,
                     cfg.hidden_size), local


def test_pp_tp_vit_classifier_fwd_parity(vit_setup):
    """dp=2 x pp=2 x tp=2 on the 8-device mesh: the pipelined classifier
    forward with model-sharded stages must match the sequential reference
    (tolerance admits the TP all-reduce's float reassociation)."""
    cfg, p, _, pixels, _, _ = vit_setup
    from autognothi.models.vit import vit_classifier_fwd

    mesh = make_pipe_mesh(8, pipe=2, model=2)
    rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
    ones = jnp.ones((8, cfg.n_patches + 1), jnp.float32)
    probs = pp_vit_classifier_fwd(rest, stacked, cfg, pixels, ones, mesh,
                                  microbatches=2)
    ref, _ = vit_classifier_fwd(p, cfg, pixels, ones)
    np.testing.assert_allclose(np.asarray(probs), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_pp_tp_vit_explainer_fwd_parity(vit_setup):
    """The hot tower's forward under dp x pp x tp: attributions match the
    sequential explainer (backbone stage-sharded AND model-sharded; the
    explainer_attn + head on `rest` TP via GSPMD)."""
    from autognothi.models.vit import init_vit_explainer, vit_explainer_fwd
    from autognothi.parallel.pipeline import pp_vit_explainer_fwd

    cfg, _, _, pixels, _, _ = vit_setup
    p = init_vit_explainer(jax.random.PRNGKey(8), cfg)
    rs = np.random.RandomState(9)
    grand = jnp.asarray(rs.randn(8, cfg.num_labels).astype(np.float32))
    null = jnp.asarray(rs.randn(1, cfg.num_labels).astype(np.float32))
    ones = jnp.ones((8, cfg.n_patches + 1), jnp.float32)

    mesh = make_pipe_mesh(8, pipe=2, model=2)
    rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
    phi = pp_vit_explainer_fwd(rest, stacked, cfg, pixels, ones, grand, null,
                               mesh, microbatches=2)
    ref, _ = vit_explainer_fwd(p, cfg, pixels, ones, grand, null)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_pp_tp_train_step(vit_setup):
    """The pp classifier train step on the 3-axis mesh: the compiled
    program carries BOTH pipeline hops (collective-permute) and MORE
    all-reduces than the same step at tp=1 (grad syncs over "data" exist
    either way, so a bare all-reduce>0 check would pass even if GSPMD
    silently replicated the bricks — the count delta pins actual TP
    partitioning); the loss decreases; weight bricks keep their
    ("pipe", "model", ...) layout through the update."""
    import re

    cfg, p, _, pixels, _, _ = vit_setup
    rs = np.random.RandomState(2)
    labels = jnp.asarray(rs.randint(0, cfg.num_labels, (8,)))
    ones = jnp.ones((8, cfg.n_patches + 1), jnp.float32)
    tx = optax.adamw(1e-3)

    def compile_step(mesh):
        rest, stacked = split_encoder_params(p, cfg.num_hidden_layers, mesh)
        opt_state = tx.init((rest, stacked))
        step = make_pp_classifier_train_step(cfg, tx, mesh, microbatches=2)
        txt = step.lower(rest, stacked, opt_state, pixels, ones,
                         labels).compile().as_text()
        return rest, stacked, opt_state, step, txt

    _, _, _, _, txt1 = compile_step(make_pipe_mesh(4, pipe=2))
    mesh = make_pipe_mesh(8, pipe=2, model=2)
    rest, stacked, opt_state, step, txt = compile_step(mesh)
    assert "collective-permute" in txt, "no pipeline hops compiled"
    n_ar1 = len(re.findall("all-reduce", txt1))
    n_ar = len(re.findall("all-reduce", txt))
    assert n_ar > n_ar1, (
        f"tp=2 compiled no additional all-reduces over tp=1 "
        f"({n_ar} vs {n_ar1}) — bricks likely replicated")

    losses = []
    for _ in range(4):
        rest, stacked, opt_state, loss = step(
            rest, stacked, opt_state, pixels, ones, labels)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    spec = stacked["attention.self.query.weight"].sharding.spec
    # trailing Nones are dropped in normalized specs — compare the prefix
    assert tuple(spec)[:2] == ("pipe", "model"), spec


def test_pp_tp_fail_closed():
    with pytest.raises(ValueError, match="not divisible by pipe=2 x model=3"):
        make_pipe_mesh(8, pipe=2, model=3)
    # hidden dims that do not divide the model axis fail closed at split
    # time (a silent GSPMD pad would corrupt the Megatron layout)
    cfg = dataclasses.replace(_mini_cfg(), hidden_size=36,
                              intermediate_size=72, num_attention_heads=4)
    p = init_vit_classifier(jax.random.PRNGKey(0), cfg)
    mesh = make_pipe_mesh(8, pipe=1, model=8)
    with pytest.raises(ValueError, match="cannot shard"):
        split_encoder_params(p, cfg.num_hidden_layers, mesh)


def test_pp_tp_bert_classifier_fwd_parity():
    """Text track under dp x pp x tp: pp_bert_classifier_fwd with
    model-sharded stage bricks matches the sequential bert_classifier_fwd."""
    from autognothi.models.bert import (
        bert_classifier_fwd,
        init_bert_classifier,
    )
    from autognothi.parallel.pipeline import pp_bert_classifier_fwd

    cfg = _mini_bert_cfg()
    p = init_bert_classifier(jax.random.PRNGKey(4), cfg)
    rs = np.random.RandomState(6)
    ids = jnp.asarray(rs.randint(0, 64, (8, 12)))
    attn = jnp.ones((8, 12), jnp.int32)
    toktype = jnp.zeros((8, 12), jnp.int32)

    mesh = make_pipe_mesh(8, pipe=2, model=2)
    rest, stacked = split_encoder_params(
        p, cfg.num_hidden_layers, mesh, prefix="bert.encoder.layers")
    spec = stacked["attention.self.query.weight"].sharding.spec
    assert tuple(spec) == ("pipe", "model", None), spec
    probs = pp_bert_classifier_fwd(rest, stacked, cfg, ids, attn, toktype,
                                   mesh, microbatches=2)
    ref, _ = bert_classifier_fwd(p, cfg, ids, attn, toktype)
    np.testing.assert_allclose(np.asarray(probs), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_split_encoder_params_fails_closed_on_ragged_stack(vit_setup):
    """Keys under the prefix that do not form a dense n_layers stack of
    layer 0's suffixes must raise — split/merge would otherwise silently
    DROP them from the flat checkpoint (data loss)."""
    cfg, p, _, _, _, _ = vit_setup
    mesh = make_pipe_mesh(8, pipe=2)
    stray = dict(p)
    stray["vit.encoder.layers.3.extra.weight"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="refusing to silently drop"):
        split_encoder_params(stray, cfg.num_hidden_layers, mesh)
    gap = {k: v for k, v in p.items()
           if k != "vit.encoder.layers.2.attention.self.query.weight"}
    with pytest.raises(ValueError, match="missing"):
        split_encoder_params(gap, cfg.num_hidden_layers, mesh)
