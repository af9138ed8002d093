"""GPipe-style pipeline parallelism (pp) over a ("data", "pipe") mesh.

The reference is single-device (SURVEY §2.9); this completes the rebuild's
parallelism set as new capability:

- dp: batch/coalition axis over "data" (parallel/mesh.py, train_step.py);
- tp: Megatron specs over "model" (parallel/mesh.py);
- sp: the coalition axis (B x n_mask_samples masked forwards) IS this
  workload's sequence-like scaling dimension and shards along "data"
  (SURVEY §5.7) — there is no separate long-context axis to split;
- ep: n/a by design — no reference architecture is MoE;
- pp: THIS MODULE.

Design: the encoders are already a `lax.scan` over stacked per-layer
weights (models/vit.py:318-342, models/bert.py:288-311), so a pipeline
stage is a contiguous slab of that stack.  Inside `shard_map` each pipe
rank holds L/P layers (in_spec P("pipe", ...) on the stacked leaves — the
weights and their optimizer state live stage-sharded, the memory win pp
exists for); activations hop stage-to-stage via `lax.ppermute` on the
GPipe schedule (M microbatches, M+P-1 ticks, bubble fraction
(P-1)/(M+P-1)).  `lax.ppermute` transposes to the reversed permutation,
so one `jax.grad` over the wrapped forward backpropagates through the
pipeline without any hand-written backward schedule.

The finished-microbatch buffer is exposed with an explicit leading "pipe"
axis and the caller slices the last stage's block — an AD-exact choice: a
psum-broadcast of the result would scale replicated-output cotangents by
P under check_vma=False.

Composes with dp: the batch shards along "data" (each pipe rank sees its
data shard replicated across "pipe"), so an N-device mesh splits
(N // pipe) ways on batch and `pipe` ways on depth.

Composes with tp: `make_pipe_mesh(model=T)` adds a third "model" axis.
The GPipe schedule stays manual over data/pipe while "model" is left to
GSPMD (`shard_map(axis_names={"data","pipe"})`): each stage's weight
slabs carry the Megatron specs (parallel/mesh.param_pspec) on their
hidden dims, and the partitioner inserts the per-block all-reduces inside
every stage — full dp x pp x tp with no hand-written TP collectives.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..recipes.types import Params
from .mesh import _smap


def pp_config_from_env() -> Optional[Tuple[int, int, int]]:
    """Opt-in trainer pipeline parallelism: AUTOGNOTHI_PP=P (>= 2) ->
    (P, microbatches, tp), with AUTOGNOTHI_PP_MICROBATCHES tuning the GPipe
    microbatch count (default P — bubble fraction (P-1)/(2P-1)) and
    AUTOGNOTHI_PP_TP=T (default 1) adding Megatron tensor parallelism
    INSIDE each pipeline stage over a third "model" mesh axis.  Unset,
    0 or 1 -> None (the sequential trainer path)."""
    raw = os.environ.get("AUTOGNOTHI_PP", "").strip()
    tp_raw = os.environ.get("AUTOGNOTHI_PP_TP", "").strip()
    if raw in ("", "0", "1"):
        if tp_raw not in ("", "0", "1"):
            # fail closed, don't silently train without the requested TP:
            # PP_TP shards INSIDE pipeline stages, so it needs AUTOGNOTHI_PP
            raise ValueError(
                f"AUTOGNOTHI_PP_TP={tp_raw} requires AUTOGNOTHI_PP>=2 — "
                "tensor parallelism composes inside the pipeline stages; "
                "for TP without PP use the trainer's Megatron path "
                "(parallel/mesh.py)")
        return None
    pipe = int(raw)
    mb = int(os.environ.get("AUTOGNOTHI_PP_MICROBATCHES", str(pipe)))
    tp = int(tp_raw) if tp_raw else 1
    if pipe < 2 or mb < 1 or tp < 1:
        raise ValueError(
            f"AUTOGNOTHI_PP={pipe} / AUTOGNOTHI_PP_MICROBATCHES={mb} / "
            f"AUTOGNOTHI_PP_TP={tp}: pipe must be >= 2, microbatches and "
            "tp >= 1")
    return pipe, mb, tp


def make_pipe_mesh(n_devices: Optional[int] = None, pipe: int = 2,
                   model: int = 1) -> Mesh:
    """Mesh over ("data", "pipe") — or ("data", "pipe", "model") when
    model > 1 (tensor parallelism inside each pipeline stage).  pipe=1
    degenerates to pure dp.  Axis order puts "model" innermost so TP's
    per-layer all-reduces ride the fastest ICI links."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n % (pipe * model) != 0:
        raise ValueError(
            f"{n} devices not divisible by pipe={pipe}" +
            (f" x model={model}" if model > 1 else ""))
    if n > len(devices):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(devices)} device(s) "
            "are visible — shrink the mesh or raise "
            "xla_force_host_platform_device_count")
    if model > 1:
        grid = np.asarray(devices[:n]).reshape(n // (pipe * model), pipe,
                                               model)
        return Mesh(grid, ("data", "pipe", "model"))
    grid = np.asarray(devices[:n]).reshape(n // pipe, pipe)
    return Mesh(grid, ("data", "pipe"))


def pipelined_scan(
    stage_body: Callable,
    stacked: Params,
    h0: jax.Array,
    side,
    mesh: Mesh,
    *,
    microbatches: int,
    rng: Optional[jax.Array] = None,
):
    """Run `h = stage_body(slab, h, side_mb, first_layer, mb_rng)` through a
    GPipe pipeline over the mesh's "pipe" axis.

    stage_body applies ONE stage's layers (typically a lax.scan over the
    slab) to a microbatch; `slab` is the stage-local (L/P, ...) slice of
    `stacked`, `side_mb` the microbatch's slice of `side` (per-sample side
    inputs such as coalition masks; pytree or None), `first_layer` the
    traced global index of the stage's first layer, and `mb_rng` a key
    already folded with the GLOBAL microbatch id (data_rank x M + mb) —
    folding by layer index alone would hand every microbatch and every
    data rank the same dropout masks (same key, same local shape).

    stacked: pytree with leading layer axis L (L % pipe == 0).
    h0: <B, ...> activations; B % (n_data * microbatches) == 0.
    Returns <B, ...> outputs equal to running all L layers sequentially.
    """
    n_pipe = mesh.shape["pipe"]
    n_data = mesh.shape.get("data", 1)
    leaves = jax.tree.leaves(stacked)
    if not leaves:
        raise ValueError("pipelined_scan: empty layer stack")
    n_layers = leaves[0].shape[0]
    if n_layers % n_pipe != 0:
        raise ValueError(
            f"pipelined_scan: {n_layers} layers do not divide pipe={n_pipe} "
            "— pick a pipe that divides num_hidden_layers")
    batch = h0.shape[0]
    if microbatches < 1 or batch % (n_data * microbatches) != 0:
        raise ValueError(
            f"pipelined_scan: batch {batch} does not divide "
            f"data={n_data} x microbatches={microbatches}")
    mb = batch // (n_data * microbatches)
    perm = [(i, i + 1) for i in range(n_pipe - 1)]

    # tp composition: on a mesh with extra (non-schedule) axes — "model" —
    # the schedule stays manual over data/pipe and the extra axes are left
    # to GSPMD (partial-manual shard_map).  That mode requires the VMA
    # (varying-manual-axes) system: check_vma=True, with the scan carries
    # explicitly pvary'd over "pipe" so their vma is loop-invariant.  The
    # plain ("data", "pipe") mesh keeps check_vma=False (the AD-exact
    # last-stage-slice contract documented above, unchanged since r4).
    extra_axes = set(mesh.axis_names) - {"data", "pipe"}

    def per_device(slab, h_loc, side_loc):
        stage = jax.lax.axis_index("pipe")
        data_rank = (jax.lax.axis_index("data")
                     if "data" in mesh.axis_names else 0)
        h_mbs = h_loc.reshape(microbatches, mb, *h_loc.shape[1:])
        side_mbs = jax.tree.map(
            lambda s: s.reshape(microbatches, mb, *s.shape[1:]), side_loc)
        zero = jnp.zeros_like(h_mbs[0])
        outputs0 = jnp.zeros_like(h_mbs)
        if extra_axes:
            zero = jax.lax.pcast(zero, "pipe", to="varying")
            outputs0 = jax.lax.pcast(outputs0, "pipe", to="varying")

        def tick(carry, t):
            recv, outputs = carry
            # stage s processes microbatch (t - s); clamped garbage during
            # bubble ticks is computed but never collected (out_idx guard)
            mb_idx = jnp.clip(t - stage, 0, microbatches - 1)
            inject = jax.lax.dynamic_index_in_dim(
                h_mbs, jnp.clip(t, 0, microbatches - 1), 0, keepdims=False)
            x = jnp.where(stage == 0, inject, recv)
            s_mb = jax.tree.map(
                lambda s: jax.lax.dynamic_index_in_dim(
                    s, mb_idx, 0, keepdims=False),
                side_mbs)
            mb_rng = (None if rng is None else jax.random.fold_in(
                rng, data_rank * microbatches + mb_idx))
            y = stage_body(slab, x, s_mb, stage * (n_layers // n_pipe),
                           mb_rng)
            out_idx = t - (n_pipe - 1)
            valid = jnp.logical_and(stage == n_pipe - 1, out_idx >= 0)
            idx = jnp.clip(out_idx, 0, microbatches - 1)
            cur = jax.lax.dynamic_index_in_dim(outputs, idx, 0,
                                               keepdims=False)
            outputs = jax.lax.dynamic_update_index_in_dim(
                outputs, jnp.where(valid, y, cur), idx, 0)
            nxt = jax.lax.ppermute(y, "pipe", perm) if perm else zero
            return (nxt, outputs), None

        (_, outputs), _ = jax.lax.scan(
            tick, (zero, outputs0),
            jnp.arange(microbatches + n_pipe - 1))
        return outputs[None]  # expose the pipe axis: (1, M, mb, ...)

    slab_specs = jax.tree.map(
        lambda v: P("pipe", *([None] * (v.ndim - 1))), stacked)
    h_spec = P("data", *([None] * (h0.ndim - 1)))
    side_specs = jax.tree.map(
        lambda s: P("data", *([None] * (jnp.asarray(s).ndim - 1))), side)
    out_spec = P("pipe", None, "data", *([None] * (h0.ndim - 1)))
    # On a ("data", "pipe", "model") mesh the schedule stays manual over
    # data/pipe while "model" is left to GSPMD (shard_map axis_names): the
    # stage body's dense ops see their weight slabs model-sharded per the
    # Megatron specs and the partitioner inserts the per-block all-reduces
    # — TP composed INSIDE each pipeline stage, no hand-written collectives.
    smap_kwargs = (
        {"axis_names": frozenset({"data", "pipe"} & set(mesh.axis_names)),
         "check_vma": True}
        if extra_axes else {"check_vma": False})
    outputs = _smap()(
        per_device, mesh=mesh,
        in_specs=(slab_specs, h_spec, side_specs),
        out_specs=out_spec, **smap_kwargs,
    )(stacked, h0, side)
    # global <P, M, n_data*mb, ...>; the last stage's block holds the result
    res = outputs[n_pipe - 1]
    # undo the (data-major, microbatch-minor) interleave back to batch order
    res = res.reshape(microbatches, n_data, mb, *res.shape[2:])
    res = jnp.moveaxis(res, 1, 0)
    return res.reshape(batch, *res.shape[3:])


# ------------------------------------------------------------ model adapters


def _stage_scanner(layer_body, n_local: int):
    """Wrap a per-layer body into a stage body scanning its local slab.
    The per-layer key folds the global layer index into `mb_rng`, which
    pipelined_scan already folded with the global microbatch id — together
    the draw is unique per (layer, microbatch, data rank), matching the
    sequential encoders' iid-per-sample dropout."""
    from ..models.common import maybe_remat

    def stage_body(slab, x, side, first_layer, mb_rng):
        def body(carry, xs):
            layer, local_idx = xs
            layer_rng = (None if mb_rng is None else jax.random.fold_in(
                mb_rng, first_layer + local_idx))
            return layer_body(layer, carry, side, layer_rng), None

        x, _ = jax.lax.scan(maybe_remat(body), x, (slab, jnp.arange(n_local)))
        return x

    return stage_body


def pipelined_vit_encoder(
    p: Params,
    cfg,
    h: jax.Array,
    mask: Optional[jax.Array],
    mesh: Mesh,
    *,
    microbatches: int,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    """Drop-in pipelined models/vit.vit_encoder (flat `vit.` params)."""
    from ..models.common import stack_layer_params

    stacked = stack_layer_params(p, "encoder.layers", cfg.num_hidden_layers,
                                 dtype=h.dtype)
    return pipelined_vit_encoder_stacked(
        stacked, cfg, h, mask, mesh,
        microbatches=microbatches, deterministic=deterministic, rng=rng)


def pipelined_vit_encoder_stacked(
    stacked: Params, cfg, h, mask, mesh, *,
    microbatches: int, deterministic: bool = True, rng=None,
) -> jax.Array:
    from ..models.vit import _vit_layer_body

    def layer_body(layer, x, side, layer_rng):
        return _vit_layer_body(layer, x, side, cfg, has_ln1=True,
                               deterministic=deterministic, rng=layer_rng)

    n_local = cfg.num_hidden_layers // mesh.shape["pipe"]
    return pipelined_scan(_stage_scanner(layer_body, n_local),
                          stacked, h, mask, mesh, microbatches=microbatches,
                          rng=rng)


def pipelined_bert_encoder(
    p: Params,
    cfg,
    h: jax.Array,
    mask_bias: Optional[jax.Array],
    mesh: Mesh,
    *,
    microbatches: int,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    """Drop-in pipelined models/bert.bert_encoder (flat `bert.` params)."""
    from ..models.common import stack_layer_params

    stacked = stack_layer_params(p, "encoder.layers", cfg.num_hidden_layers,
                                 dtype=h.dtype)
    return pipelined_bert_encoder_stacked(
        stacked, cfg, h, mask_bias, mesh,
        microbatches=microbatches, deterministic=deterministic, rng=rng)


# ------------------------------------------------- stage-sharded training


def split_encoder_params(
    params: Params, n_layers: int, mesh: Mesh,
    prefix: str = "vit.encoder.layers",
) -> tuple:
    """-> (rest, stacked): the encoder's per-layer weights stacked along a
    leading layer axis and device_put stage-sharded along "pipe" (each rank
    materializes ONLY its L/P slab — the pp memory model); everything else
    replicated.  The pp train step keeps grads and optimizer moments in the
    same layout, so per-rank weight+state memory scales 1/P with depth.

    On a mesh with a "model" axis (make_pipe_mesh(model=T)) the hidden dims
    additionally carry the Megatron specs — stacked bricks are
    (L/P, .../T) per device, and `rest` (embeddings, explainer_attn, heads)
    gets the same specs under plain GSPMD; fails closed when a sharded dim
    does not divide its mesh axis."""
    head = f"{prefix}.0."
    suffixes = [k[len(head):] for k in params if k.startswith(head)]
    if not suffixes:
        raise ValueError(f"split_encoder_params: no params under {prefix!r}")
    # fail closed on ragged layer stacks: every {prefix}.* key must be one
    # of layer 0's suffixes at a layer index < n_layers — anything else
    # would be silently DROPPED from (rest, stacked) and vanish from the
    # flat dict after merge_encoder_params (checkpoint data loss)
    expected = {f"{prefix}.{i}.{s}"
                for i in range(n_layers) for s in suffixes}
    stray = [k for k in params
             if k.startswith(f"{prefix}.") and k not in expected]
    if stray:
        raise ValueError(
            "split_encoder_params: keys under "
            f"{prefix!r} do not form a dense {n_layers}-layer stack of "
            f"layer 0's suffixes — refusing to silently drop: "
            + ", ".join(sorted(stray)[:8])
            + ("..." if len(stray) > 8 else ""))
    missing = [k for k in expected if k not in params]
    if missing:
        raise ValueError(
            "split_encoder_params: layer stack is missing "
            + ", ".join(sorted(missing)[:8])
            + ("..." if len(missing) > 8 else ""))
    tp = dict(mesh.shape).get("model", 1)
    from .mesh import check_shardable, param_pspec

    def stack_suffix(s: str) -> np.ndarray:
        # host-side np.stack, then ONE sharded transfer: device_put of a
        # host array against P("pipe", ...) ships each rank only its L/P
        # slab.  NOT models.common.stack_layer_params: its jnp.stack would
        # materialize the full depth on a single device first, breaking the
        # 1/P init-memory model pp exists for.
        return np.stack([np.asarray(params[f"{prefix}.{i}.{s}"])
                         for i in range(n_layers)])

    rest_items = [(k, v) for k, v in params.items()
                  if not k.startswith(f"{prefix}.")]
    if tp > 1:
        # layer axis over "pipe", hidden dims over "model" per the Megatron
        # specs — each device holds a (L/P, .../T) brick; the non-encoder
        # weights (embeddings, explainer_attn, heads) get the same specs
        # under plain GSPMD (replicated when no rule matches).  Fail closed
        # on every non-dividing dim at once (mesh.check_shardable), from
        # shapes alone — stacks are materialized one at a time afterwards
        # so host staging stays one suffix deep.
        stacked_specs = {}
        stacked_shapes = {}
        for s in suffixes:
            leaf = params[f"{prefix}.0.{s}"]
            stacked_shapes[s] = (n_layers, *np.shape(leaf))
            stacked_specs[s] = P("pipe", *param_pspec(s, np.ndim(leaf)))
        rest_specs = {k: param_pspec(k, np.ndim(v)) for k, v in rest_items}
        check_shardable(
            [(f"{prefix}.*.{s}", stacked_shapes[s], stacked_specs[s])
             for s in suffixes]
            + [(k, np.shape(v), rest_specs[k]) for k, v in rest_items],
            mesh)
        stacked = {
            s: jax.device_put(stack_suffix(s),
                              NamedSharding(mesh, stacked_specs[s]))
            for s in suffixes
        }
        rest = {
            k: jax.device_put(v, NamedSharding(mesh, rest_specs[k]))
            for k, v in rest_items
        }
    else:
        stacked = {}
        for s in suffixes:
            v = stack_suffix(s)
            stacked[s] = jax.device_put(
                v, NamedSharding(mesh, P("pipe", *([None] * (v.ndim - 1)))))
        rest = {
            k: jax.device_put(v, NamedSharding(mesh, P()))
            for k, v in rest_items
        }
    return rest, stacked


def merge_encoder_params(
    rest: Params, stacked: Params, n_layers: int,
    prefix: str = "vit.encoder.layers",
) -> Params:
    """Inverse of split_encoder_params: unstack the stage-sharded slabs back
    into per-layer flat keys (host arrays).  Keeps pp checkpoints in the
    same flat-dict format every other consumer (resume, conversions,
    export, migration) reads — pp is invisible on disk."""
    out = dict(rest)
    for s, v in stacked.items():
        host = np.asarray(v)  # gathers the stack: ckpt writes are host-side
        for i in range(n_layers):
            out[f"{prefix}.{i}.{s}"] = host[i]
    return out


def pp_vit_classifier_fwd(
    rest: Params, stacked: Params, cfg, pixels: jax.Array,
    mask: Optional[jax.Array], mesh: Mesh, *, microbatches: int,
    deterministic: bool = True, rng: Optional[jax.Array] = None,
) -> jax.Array:
    """models/vit.vit_classifier_fwd with the encoder pipelined: embeddings
    and head run GSPMD-sharded on the same mesh; the 12-layer trunk runs
    stage-sharded.  -> <B, n_classes> softmax probabilities.

    Rng fold tags mirror vit_backbone (10 = embeddings, 11 = encoder);
    inside the pipeline the per-layer keys additionally fold the global
    microbatch id (pipelined_scan), so dropout draws are iid but NOT
    bit-identical to the sequential scan's."""
    from ..models.common import dense, layer_norm, subdict
    from ..models.vit import _rng, vit_embeddings

    vp = subdict(rest, "vit.")
    h = vit_embeddings(vp, cfg, pixels, deterministic=deterministic,
                       rng=_rng(rng, 10))
    h = pipelined_vit_encoder_stacked(stacked, cfg, h, mask, mesh,
                                      microbatches=microbatches,
                                      deterministic=deterministic,
                                      rng=_rng(rng, 11))
    h = layer_norm(h, vp["layernorm.weight"], vp["layernorm.bias"],
                   cfg.layer_norm_eps)
    logits = dense(h[:, 0, :], rest["classifier.weight"].astype(h.dtype),
                   rest["classifier.bias"].astype(h.dtype))
    return jax.nn.softmax(logits, axis=-1)


def pp_bert_classifier_fwd(
    rest: Params, stacked: Params, cfg, input_ids: jax.Array,
    attention_mask: jax.Array, token_type_ids: jax.Array, mesh: Mesh, *,
    microbatches: int,
    deterministic: bool = True, rng: Optional[jax.Array] = None,
) -> jax.Array:
    """models/bert.bert_classifier_fwd with the encoder pipelined (the text
    track's counterpart of pp_vit_classifier_fwd; split the flat params
    with prefix="bert.encoder.layers").  -> <B, n_classes> softmax.
    Rng fold tags mirror bert_backbone/_cls_head (10 / 11 / head-internal
    30); see pp_vit_classifier_fwd on per-layer key derivation."""
    from ..models.bert import _cls_head, _rng, bert_embeddings
    from ..models.common import additive_mask_bias, subdict

    bp = subdict(rest, "bert.")
    h = bert_embeddings(bp, cfg, input_ids, token_type_ids,
                        deterministic=deterministic, rng=_rng(rng, 10))
    bias = additive_mask_bias(attention_mask, h.dtype)
    h = pipelined_bert_encoder_stacked(stacked, cfg, h, bias, mesh,
                                       microbatches=microbatches,
                                       deterministic=deterministic,
                                       rng=_rng(rng, 11))
    return _cls_head(rest, h, cfg, deterministic=deterministic, rng=rng)


def pp_vit_explainer_fwd(
    rest: Params, stacked: Params, cfg, pixels: jax.Array,
    mask: jax.Array, surrogate_grand: jax.Array, surrogate_null: jax.Array,
    mesh: Mesh, *, microbatches: int,
    deterministic: bool = True, rng: Optional[jax.Array] = None,
) -> jax.Array:
    """models/vit.vit_explainer_fwd with the backbone encoder pipelined: the
    explainer is the one vanilla tower trained FULL-DEPTH from scratch
    (recipes: every param trainable), so its grads + Adam moments are
    depth-proportional — exactly the state pp stage-shards.  The
    explainer_attn + MLP head runs GSPMD-sharded on `rest` after the
    pipeline.  -> <B, n_classes, n_players> attributions.

    Rng fold tags mirror vit_backbone (10 = embeddings, 11 = encoder) and
    vit_explainer_head's internal 20+i folds (the head sees the raw key,
    exactly like the sequential path)."""
    from ..models.common import layer_norm, subdict
    from ..models.vit import _rng, vit_embeddings, vit_explainer_head

    vp = subdict(rest, "vit.")
    h = vit_embeddings(vp, cfg, pixels, deterministic=deterministic,
                       rng=_rng(rng, 10))
    h = pipelined_vit_encoder_stacked(stacked, cfg, h, mask, mesh,
                                      microbatches=microbatches,
                                      deterministic=deterministic,
                                      rng=_rng(rng, 11))
    h = layer_norm(h, vp["layernorm.weight"], vp["layernorm.bias"],
                   cfg.layer_norm_eps)
    return vit_explainer_head(rest, cfg, h, mask, surrogate_grand,
                              surrogate_null, deterministic=deterministic,
                              rng=rng)


def pp_bert_explainer_fwd(
    rest: Params, stacked: Params, cfg, input_ids: jax.Array,
    attention_mask: jax.Array, token_type_ids: jax.Array,
    surrogate_grand: jax.Array, surrogate_null: jax.Array, mesh: Mesh, *,
    microbatches: int,
    deterministic: bool = True, rng: Optional[jax.Array] = None,
) -> jax.Array:
    """models/bert.bert_explainer_fwd with the encoder pipelined (text-track
    counterpart of pp_vit_explainer_fwd; no final LN — bert_backbone ends at
    the encoder).  Fold tags mirror bert_backbone (10/11) and
    bert_explainer_head's 20+i / 29 internals."""
    from ..models.bert import _rng, bert_embeddings, bert_explainer_head
    from ..models.common import additive_mask_bias, subdict

    bp = subdict(rest, "bert.")
    h = bert_embeddings(bp, cfg, input_ids, token_type_ids,
                        deterministic=deterministic, rng=_rng(rng, 10))
    bias = additive_mask_bias(attention_mask, h.dtype)
    h = pipelined_bert_encoder_stacked(stacked, cfg, h, bias, mesh,
                                       microbatches=microbatches,
                                       deterministic=deterministic,
                                       rng=_rng(rng, 11))
    return bert_explainer_head(rest, cfg, h, attention_mask,
                               surrogate_grand, surrogate_null,
                               deterministic=deterministic, rng=rng)


def pipelined_bert_encoder_stacked(
    stacked: Params, cfg, h, mask_bias, mesh, *,
    microbatches: int, deterministic: bool = True, rng=None,
) -> jax.Array:
    from ..models.bert import _bert_layer_body

    def layer_body(layer, x, side, layer_rng):
        return _bert_layer_body(layer, x, side, cfg, ident_ln1=False,
                                deterministic=deterministic, rng=layer_rng)

    n_local = cfg.num_hidden_layers // mesh.shape["pipe"]
    return pipelined_scan(_stage_scanner(layer_body, n_local),
                          stacked, h, mask_bias, mesh,
                          microbatches=microbatches, rng=rng)


def make_pp_classifier_train_step(cfg, tx, mesh: Mesh, *, microbatches: int):
    """Jitted (rest, stacked, opt_state, pixels, mask, labels) ->
    (rest, stacked, opt_state, loss): cross-entropy step on the pp
    classifier with weights, grads and Adam moments stage-sharded along
    "pipe" and the batch sharded along "data" — the full-training-step pp
    contract the dryrun validates."""

    from ..ops.flash_attention import xla_attention

    def loss_fn(rest, stacked, pixels, mask, labels):
        # same discipline as every trainer loss (parallel/train_step.py):
        # traced model regions under a mesh keep to XLA
        with xla_attention(sharded=True):
            probs = pp_vit_classifier_fwd(rest, stacked, cfg, pixels, mask,
                                          mesh, microbatches=microbatches)
        logp = jnp.log(jnp.clip(probs, 1e-9, None))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    @jax.jit
    def step(rest, stacked, opt_state, pixels, mask, labels):
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            rest, stacked, pixels, mask, labels)
        updates, opt_state = tx.update(grads, opt_state, (rest, stacked))
        rest, stacked = optax.apply_updates((rest, stacked), updates)
        return rest, stacked, opt_state, loss

    return step
