"""Opt-in pipeline-parallel trainer scaffolding (AUTOGNOTHI_PP=P).

All three full-tower training stages — the classifier (incl. the
pretrain_classifier fine-tune, where depth-proportional grads + Adam
moments dominate memory), the surrogate (a complete copy of the
backbone KL-distilled under coalition masks), and the explainer (THE hot
loop — the one vanilla tower trained FULL-DEPTH from scratch, so its
grads + Adam moments are the most depth-proportional state in the
pipeline) — run with the encoder stage-sharded over a ("data", "pipe")
mesh (parallel/pipeline.py): 1/P of the depth state per rank.  With
AUTOGNOTHI_PP_TP=T the mesh gains a "model" axis and each stage's layers
additionally Megatron-shard their attention/MLP blocks T ways (GSPMD
inside the manual data/pipe region — parallel/pipeline.pipelined_scan),
composing dp x pp x tp in one step.  Vanilla tracks only; the
LTT/froyo/duo stages train heads against a frozen trunk, so there is
nothing depth-proportional to split.

Checkpoints stay flat dicts (`to_flat` merges the slabs back), so resume,
conversions, export and migration are pp-oblivious.  Dropout keys fold per
(layer, microbatch, data-rank) inside the pipeline, so a dropout>0 run is
statistically equivalent but not bit-identical to the sequential trainer
(mini configs train dropout-free — exact parity pinned by
tests/test_train_pp.py).

Each setup_pp_* returns step/eval callables with the SAME signatures as the
sequential trainer's, so the epoch loops stay parallelism-agnostic; params
become a (rest, stacked) pair and `to_flat` restores the flat dict for
checkpointing.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..parallel.pipeline import (
    make_pipe_mesh,
    merge_encoder_params,
    pp_bert_classifier_fwd,
    pp_bert_explainer_fwd,
    pp_vit_classifier_fwd,
    pp_vit_explainer_fwd,
    split_encoder_params,
)
from ..ops.flash_attention import xla_attention
from .training import (
    cross_entropy_on_probs,
    make_optimizer_labeled,
    make_train_step,
)


class PPContext(NamedTuple):
    mesh: Any
    params: tuple            # (rest, stacked)
    tx: Any
    opt_state: Any
    # fwd_kind="classifier": (params, xs, mask, *, deterministic, rng);
    # fwd_kind="explainer":  (params, xs, mask, grand, null, *,
    #                         deterministic, rng)
    fwd: Callable
    place_batch: Callable
    place_replicated: Callable
    to_flat: Callable


def _pp_context(env, config, m_config, params, trainable,
                pipe: int, microbatches: int, batch_size: int,
                fwd_kind: str = "classifier", tp: int = 1) -> PPContext:
    kind = config.net.kind
    if kind not in ("vanilla_vit", "vanilla_bert"):
        raise ValueError(
            f"AUTOGNOTHI_PP: unsupported net kind {kind!r} — pipeline "
            "parallelism covers the vanilla tracks; the other recipes train "
            "heads against a frozen trunk and have no depth-proportional "
            "optimizer state to stage-shard")
    n_layers = m_config.num_hidden_layers
    if n_layers % pipe != 0:
        raise ValueError(
            f"AUTOGNOTHI_PP={pipe} does not divide "
            f"num_hidden_layers={n_layers}")
    mesh = make_pipe_mesh(pipe=pipe, model=tp)
    n_data = mesh.shape["data"]
    if batch_size % (n_data * microbatches) != 0:
        raise ValueError(
            f"AUTOGNOTHI_PP: batch_size={batch_size} does not divide "
            f"data={n_data} x microbatches={microbatches} — pad_batch pads "
            "every batch to batch_size, the one static shape the GPipe "
            "schedule sees")
    track = "vit" if kind == "vanilla_vit" else "bert"
    prefix = f"{track}.encoder.layers"
    env.log(f"[[[ pipeline-parallel: {n_data} data x {pipe} pipe"
            + (f" x {tp} model" if tp > 1 else "") + ", "
            f"{microbatches} microbatches, {n_layers // pipe} layers/stage ]]]")
    rest, stacked = split_encoder_params(params, n_layers, mesh,
                                         prefix=prefix)
    params = (rest, stacked)

    def label(name: str) -> str:
        return "train" if trainable(name) else "freeze"

    stacked_labels = {}
    for s in stacked:
        labs = {label(f"{prefix}.{i}.{s}") for i in range(n_layers)}
        if len(labs) != 1:
            raise ValueError(
                f"AUTOGNOTHI_PP: trainability differs across layers for "
                f"{prefix}.*.{s} — a stage-sharded stack carries ONE "
                "optimizer label per weight")
        stacked_labels[s] = labs.pop()
    tx, opt_state = make_optimizer_labeled(
        params, ({k: label(k) for k in rest}, stacked_labels))

    if kind == "vanilla_vit":
        from ..recipes.vanilla_vit import fw_xs_preprocess

        if fwd_kind == "classifier":
            def fwd(p, xs, mask, *, deterministic, rng):
                xs, mask = fw_xs_preprocess(xs, mask)
                return pp_vit_classifier_fwd(
                    p[0], p[1], m_config, xs, mask, mesh,
                    microbatches=microbatches, deterministic=deterministic,
                    rng=rng)
        else:
            def fwd(p, xs, mask, grand, null, *, deterministic, rng):
                xs, mask = fw_xs_preprocess(xs, mask)
                return pp_vit_explainer_fwd(
                    p[0], p[1], m_config, xs, mask, grand, null, mesh,
                    microbatches=microbatches, deterministic=deterministic,
                    rng=rng)
    else:
        from ..recipes.vanilla_bert import fw_xs_preprocess

        if fwd_kind == "classifier":
            def fwd(p, xs, mask, *, deterministic, rng):
                ids, mask, ttype = fw_xs_preprocess(xs, mask)
                return pp_bert_classifier_fwd(
                    p[0], p[1], m_config, ids, mask, ttype, mesh,
                    microbatches=microbatches, deterministic=deterministic,
                    rng=rng)
        else:
            def fwd(p, xs, mask, grand, null, *, deterministic, rng):
                ids, mask, ttype = fw_xs_preprocess(xs, mask)
                return pp_bert_explainer_fwd(
                    p[0], p[1], m_config, ids, mask, ttype, grand, null,
                    mesh, microbatches=microbatches,
                    deterministic=deterministic, rng=rng)

    def place_batch(tree):
        def place(x):
            x = jnp.asarray(x)
            spec = (P("data", *([None] * (x.ndim - 1)))
                    if x.ndim and x.shape[0] % n_data == 0
                    else P(*([None] * x.ndim)))
            return jax.device_put(x, NamedSharding(mesh, spec))

        return jax.tree.map(place, tree)

    def place_replicated(tree):
        sharding = NamedSharding(mesh, P())
        return jax.tree.map(lambda v: jax.device_put(v, sharding), tree)

    def to_flat(p):
        return merge_encoder_params(p[0], p[1], n_layers, prefix)

    return PPContext(mesh, params, tx, opt_state, fwd, place_batch,
                     place_replicated, to_flat)


def setup_pp_classifier(env, config, m_config, params, trainable,
                        pipe: int, microbatches: int, tp: int = 1):
    """-> (params, tx, opt_state, step, eval_fwd, place_batch, to_flat)
    with the sequential train_classifier step/eval signatures."""
    ctx = _pp_context(env, config, m_config, params, trainable,
                      pipe, microbatches, config.train_classifier.batch_size,
                      tp=tp)

    def loss_fn(p, xs, mask, labels, rng, ltt_active, weights):
        # same trainer discipline as the sequential path: XLA attention
        # in the traced model regions under the mesh
        with xla_attention(sharded=True):
            probs = ctx.fwd(p, xs, mask, deterministic=False, rng=rng)
        return cross_entropy_on_probs(probs, labels, weights), probs

    step = make_train_step(ctx.tx, loss_fn)

    def _eval(p, xs, mask, labels, weights, ltt_active):
        with xla_attention(sharded=True):
            probs = ctx.fwd(p, xs, mask, deterministic=True, rng=None)
        return probs, cross_entropy_on_probs(probs, labels, weights)

    return (ctx.params, ctx.tx, ctx.opt_state, step, jax.jit(_eval),
            ctx.place_batch, ctx.to_flat)


def setup_pp_surrogate(env, config, m_config, params, cls_params, trainable,
                       pipe: int, microbatches: int, tp: int = 1):
    """-> (params, cls_params, tx, opt_state, step, eval_fwd, place_batch,
    to_flat) with the sequential train_surrogate step/eval signatures.  The
    frozen teacher stays the trainer's own sequential executable;
    `cls_params` comes back placed on the pipe mesh for it — replicated, or
    Megatron-sharded over "model" when tp > 1."""
    from ..ops.shapley import loss_logits_kl_divergence

    ctx = _pp_context(env, config, m_config, params, trainable,
                      pipe, microbatches, config.train_surrogate.batch_size,
                      tp=tp)
    if tp > 1:
        # the frozen classifier teacher runs GSPMD outside the pipeline:
        # Megatron-shard its weights over "model" so each model rank holds
        # and computes 1/T of the teacher instead of the whole copy (same
        # treatment as the explainer teacher below)
        from ..parallel.mesh import shard_params

        cls_params = shard_params(cls_params, ctx.mesh)
    else:
        cls_params = ctx.place_replicated(cls_params)

    def loss_fn(p, xs, mask, orig_ys, labels, rng, ltt_active, weights):
        with xla_attention(sharded=True):
            adapt_ys = ctx.fwd(p, xs, mask, deterministic=False, rng=rng)
        kld = loss_logits_kl_divergence(orig_ys, adapt_ys, weights)
        cls = cross_entropy_on_probs(adapt_ys, labels, weights)
        return kld, (cls, adapt_ys)

    step = make_train_step(ctx.tx, loss_fn)

    def _eval(p, xs, mask, orig_ys, labels, weights, ltt_active):
        with xla_attention(sharded=True):
            adapt_ys = ctx.fwd(p, xs, mask, deterministic=True, rng=None)
        return (adapt_ys,
                loss_logits_kl_divergence(orig_ys, adapt_ys, weights),
                cross_entropy_on_probs(adapt_ys, labels, weights))

    return (ctx.params, cls_params, ctx.tx,
            ctx.opt_state, step, jax.jit(_eval), ctx.place_batch, ctx.to_flat)


def setup_pp_explainer(env, config, m_config, params, srg_params, recipe,
                       pipe: int, microbatches: int, tp: int = 1):
    """-> (params, srg_params, tx, opt_state, step, eval_step, place_batch,
    to_flat) where step/eval_step carry parallel.train_step's
    make_explainer_{train,eval}_step signatures, so train_explainer's epoch
    loop stays parallelism-agnostic.

    The whole hot step stays ONE XLA program, exactly like the sequential
    make_explainer_train_step: on-device paired-complement coalition
    sampling, the B*M masked surrogate teacher forwards (grad-free — the
    teacher rides train_step._make_teacher's shard_map over the mesh's
    "data" axis against replicated srg_params; nothing depth-proportional
    to stage-shard there), then the pipelined explainer fwd/bwd (backbone
    stage-sharded along "pipe", explainer_attn + MLP head GSPMD on `rest`)
    and the AdamW update with grads + moments in the stage-sharded layout.
    `ltt_active` is accepted and ignored — _pp_context admits vanilla
    recipes only, which have no ladder depth knob."""
    import optax

    from ..ops.shapley import loss_shapley, mask_shapley
    from ..parallel.train_step import _make_teacher

    ctx = _pp_context(env, config, m_config, params,
                      recipe.trainable(m_config, "explainer"),
                      pipe, microbatches, config.train_explainer.batch_size,
                      fwd_kind="explainer", tp=tp)
    n_players = recipe.n_players(m_config)
    n_mask_samples = config.train_explainer.n_mask_samples
    teacher = _make_teacher(recipe, m_config, n_players, ctx.mesh)
    if tp > 1:
        # with a "model" axis the grad-free teacher runs plain GSPMD
        # (_make_teacher's dp_only=False branch): Megatron-shard its frozen
        # surrogate weights so the sweep partitions over "model" too instead
        # of replicating the whole teacher per model rank
        from ..parallel.mesh import shard_params

        srg_params = shard_params(srg_params, ctx.mesh)
    else:
        srg_params = ctx.place_replicated(srg_params)

    def loss_fn(p, xs, masks_bmp, v_0, v_s, v_1, rng, weights):
        b = masks_bmp.shape[0]
        mask_1 = jnp.ones((b, n_players), dtype=jnp.int32)
        with xla_attention(sharded=True):
            phi = ctx.fwd(p, xs, mask_1, v_1, v_0,
                          deterministic=False, rng=rng)
        return loss_shapley(masks_bmp, v_0, v_s, v_1, phi, weights)

    @jax.jit
    def step(p, opt_state, srg_p, surrogate_null, xs, key, lr,
             update_mask, ltt_active, weights=None):
        b = xs.shape[0]
        mask_key, drop_key = jax.random.split(key)
        masks = mask_shapley(mask_key, b * n_mask_samples, n_players)
        masks = masks.reshape(b, n_mask_samples, n_players)
        v_s, v_1 = teacher(srg_p, xs, masks)
        loss, grads = jax.value_and_grad(loss_fn)(
            p, xs, masks, surrogate_null, v_s, v_1, drop_key, weights)
        grads = jax.tree.map(lambda g, m: g * m, grads, update_mask)
        opt_state = optax.tree_utils.tree_set(opt_state, learning_rate=lr)
        updates, opt_state = ctx.tx.update(grads, opt_state, p)
        updates = jax.tree.map(lambda u, m: u * m, updates, update_mask)
        p = optax.apply_updates(p, updates)
        return p, opt_state, loss

    @jax.jit
    def eval_step(p, srg_p, surrogate_null, xs, key, ltt_active,
                  weights=None):
        b = xs.shape[0]
        mask_key, _ = jax.random.split(key)
        masks = mask_shapley(mask_key, b * n_mask_samples, n_players)
        masks = masks.reshape(b, n_mask_samples, n_players)
        v_s, v_1 = teacher(srg_p, xs, masks)
        mask_1 = jnp.ones((b, n_players), dtype=jnp.int32)
        with xla_attention(sharded=True):
            phi = ctx.fwd(p, xs, mask_1, v_1, surrogate_null,
                          deterministic=True, rng=None)
        return loss_shapley(masks, surrogate_null, v_s, v_1, phi, weights)

    return (ctx.params, srg_params, ctx.tx,
            ctx.opt_state, step, eval_step, ctx.place_batch, ctx.to_flat)
