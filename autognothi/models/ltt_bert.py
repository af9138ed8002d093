"""LTT BERT — ladder side tuning (parity: /root/reference/models/ltt_bert.py).

A frozen vanilla BERT backbone carries one or two narrow *side ladders*:
after each backbone layer i, branch b updates
    side_b <- SideLayer_{b,i}( side_b + gelu(Map_{b,i}(hidden_i)) )
(ltt_bert.py:481-497).  The surrogate/classifier stage reads branch 0 through
a side pooler + classifier head; the explainer reads its branch through extra
side attention layers + MLP; the Final carries branch 0 = surrogate and
branch 1 = explainer over ONE backbone traversal (ltt_bert.py:287-302).

Redesign: the fused backbone+ladder loop is a single `lax.scan` whose
carry is (hidden, side_0[, side_1]); the progressive-training depth knob
(`ltt_freeze_layers_until`, ltt_bert.py:463-466) becomes a *traced* integer
`ltt_active_layers` gating side updates with `jnp.where` — the same
executable serves every epoch of progressive training."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.shapley import normalize_shapley_explanation
from ..utils.records import Record
from .bert import (
    VanillaBertConfig,
    _bert_layer_body,
    bert_embeddings,
    init_bert_backbone,
    _init_bert_layer,
)
from .common import (
    maybe_remat,
    Params,
    additive_mask_bias,
    dense,
    dropout,
    gelu,
    init_linear,
    stack_branch_params,
    stack_layer_params,
    subdict,
)


@dataclasses.dataclass
class LttBertConfig(Record):
    attention_probs_dropout_prob: float
    explainer_s_attn_num_layers: int
    explainer_s_head_hidden_size: int
    explainer_normalize: bool
    hidden_dropout_prob: float
    hidden_size: int
    intermediate_size: int
    layer_norm_eps: float
    max_position_embeddings: int
    num_attention_heads: int
    num_hidden_layers: int
    num_labels: int
    pad_token_id: int
    s_attn_hidden_size: int
    s_attn_intermediate_size: int
    type_vocab_size: int
    vocab_size: int

    def into(self) -> VanillaBertConfig:
        return VanillaBertConfig(
            attention_probs_dropout_prob=self.attention_probs_dropout_prob,
            explainer_attn_num_layers=self.explainer_s_attn_num_layers,
            explainer_head_hidden_size=self.explainer_s_head_hidden_size,
            explainer_normalize=self.explainer_normalize,
            hidden_dropout_prob=self.hidden_dropout_prob,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            layer_norm_eps=self.layer_norm_eps,
            max_position_embeddings=self.max_position_embeddings,
            num_attention_heads=self.num_attention_heads,
            num_hidden_layers=self.num_hidden_layers,
            num_labels=self.num_labels,
            pad_token_id=self.pad_token_id,
            type_vocab_size=self.type_vocab_size,
            vocab_size=self.vocab_size,
        )

    def side(self) -> VanillaBertConfig:
        """A VanillaBertConfig view at the side-ladder width."""
        cfg = self.into()
        return dataclasses.replace(
            cfg, hidden_size=self.s_attn_hidden_size,
            intermediate_size=self.s_attn_intermediate_size,
        )


# ------------------------------------------------------------------ init


def _init_side_parts(key: jax.Array, cfg: LttBertConfig, branch: int) -> Params:
    """Per-branch ladder params: maps + side layers for every backbone layer."""
    side_cfg = cfg.side()
    p: Params = {}
    keys = jax.random.split(key, cfg.num_hidden_layers)
    for i, k in enumerate(keys):
        k_map, k_layer = jax.random.split(k)
        w, b = init_linear(k_map, cfg.s_attn_hidden_size, cfg.hidden_size)
        p[f"bert.encoder.s_attn_maps.{branch}_{i}.weight"] = w
        p[f"bert.encoder.s_attn_maps.{branch}_{i}.bias"] = b
        for name, v in _init_bert_layer(k_layer, side_cfg, ident_ln1=False).items():
            p[f"bert.encoder.s_attn_layers.{branch}_{i}.{name}"] = v
    return p


def init_ltt_bert_surrogate(key: jax.Array, cfg: LttBertConfig) -> Params:
    k_bb, k_side, k_pool, k_cls, k_spool, k_scls = jax.random.split(key, 6)
    p = init_bert_backbone(k_bb, cfg.into())
    p.update(_init_side_parts(k_side, cfg, branch=0))
    w, b = init_linear(k_pool, cfg.hidden_size, cfg.hidden_size)
    p["bert_pooler.dense.weight"], p["bert_pooler.dense.bias"] = w, b
    w, b = init_linear(k_cls, cfg.num_labels, cfg.hidden_size)
    p["classifier.weight"], p["classifier.bias"] = w, b
    w, b = init_linear(k_spool, cfg.s_attn_hidden_size, cfg.s_attn_hidden_size)
    p["bert_s_attn_pooler.dense.weight"] = w
    p["bert_s_attn_pooler.dense.bias"] = b
    w, b = init_linear(k_scls, cfg.num_labels, cfg.s_attn_hidden_size)
    p["s_attn_classifier.weight"], p["s_attn_classifier.bias"] = w, b
    return p


def init_ltt_bert_explainer(key: jax.Array, cfg: LttBertConfig) -> Params:
    k_bb, k_side, k_pool, k_cls, k_attn, k_mlp = jax.random.split(key, 6)
    p = init_bert_backbone(k_bb, cfg.into())
    p.update(_init_side_parts(k_side, cfg, branch=0))
    w, b = init_linear(k_pool, cfg.hidden_size, cfg.hidden_size)
    p["bert_pooler.dense.weight"], p["bert_pooler.dense.bias"] = w, b
    w, b = init_linear(k_cls, cfg.num_labels, cfg.hidden_size)
    p["classifier.weight"], p["classifier.bias"] = w, b
    side_cfg = cfg.side()
    for i, k in enumerate(
        jax.random.split(k_attn, cfg.explainer_s_attn_num_layers)
    ):
        for name, v in _init_bert_layer(k, side_cfg, ident_ln1=(i == 0)).items():
            p[f"s_attn_attention_layers.{i}.{name}"] = v
    w_hid = cfg.explainer_s_head_hidden_size
    k0, k2, k4 = jax.random.split(k_mlp, 3)
    p["s_attn_explainer.0.weight"], p["s_attn_explainer.0.bias"] = init_linear(
        k0, w_hid, cfg.s_attn_hidden_size
    )
    p["s_attn_explainer.2.weight"], p["s_attn_explainer.2.bias"] = init_linear(
        k2, w_hid, w_hid
    )
    p["s_attn_explainer.4.weight"], p["s_attn_explainer.4.bias"] = init_linear(
        k4, cfg.num_labels, w_hid
    )
    return p


def init_ltt_bert_final(key: jax.Array, cfg: LttBertConfig) -> Params:
    k_srg, k_side1, k_exp_heads = jax.random.split(key, 3)
    p = init_ltt_bert_surrogate(k_srg, cfg)
    p.update(_init_side_parts(k_side1, cfg, branch=1))
    exp = init_ltt_bert_explainer(k_exp_heads, cfg)
    for name, v in exp.items():
        if name.startswith(("s_attn_attention_layers.", "s_attn_explainer.")):
            p[name] = v
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    return p


# ----------------------------------------------------------------- apply


def ltt_bert_encoder(
    p: Params,  # under the `bert.` prefix
    cfg: LttBertConfig,
    emb: jax.Array,
    mask_bias: jax.Array,
    branches: Tuple[int, ...],
    *,
    ltt_active_layers: Optional[jax.Array] = None,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, List[jax.Array]]:
    """Fused backbone + side-ladder scan -> (hidden, [side_b for b in branches])."""
    L = cfg.num_hidden_layers
    dtype = emb.dtype
    main_stack = stack_layer_params(p, "encoder.layers", L, dtype=dtype)
    side_stacks = [stack_branch_params(p, b, L, dtype) for b in branches]
    active = (
        jnp.asarray(L, jnp.int32) if ltt_active_layers is None
        else jnp.asarray(ltt_active_layers, jnp.int32)
    )
    side_cfg = cfg.side()

    b_sz, t = emb.shape[0], emb.shape[1]
    sides0 = [
        jnp.zeros((b_sz, t, cfg.s_attn_hidden_size), dtype) for _ in branches
    ]

    def body(carry, xs):
        h, sides = carry
        layer_idx, main_layer, *side_parts = xs
        layer_rng = None if rng is None else jax.random.fold_in(rng, layer_idx)
        h = _bert_layer_body(
            main_layer, h, mask_bias, cfg.into(),
            ident_ln1=False, deterministic=deterministic, rng=layer_rng,
        )
        # both branch maps as ONE dense: h is read once, not once per
        # branch (mirrors ltt_vit)
        all_maps = side_parts[0::2]
        joint = None if not all_maps else gelu(dense(
            h,
            jnp.concatenate([m["weight"] for m in all_maps], axis=0),
            jnp.concatenate([m["bias"] for m in all_maps], axis=0),
        ))
        s_hidden = cfg.s_attn_hidden_size
        new_sides = []
        for slot, layers in enumerate(side_parts[1::2]):
            side = sides[slot]
            side_rng = (
                None if rng is None
                else jax.random.fold_in(rng, 1000 + slot * 100 + layer_idx)
            )
            upd = side + joint[..., slot * s_hidden:(slot + 1) * s_hidden]
            upd = _bert_layer_body(
                layers, upd, mask_bias, side_cfg,
                ident_ln1=False, deterministic=deterministic, rng=side_rng,
            )
            new_sides.append(jnp.where(layer_idx < active, upd, side))
        return (h, tuple(new_sides)), None

    xs = [jnp.arange(L)]
    xs.append(main_stack)
    for maps, layers in side_stacks:
        xs.extend([maps, layers])
    (h, sides), _ = jax.lax.scan(maybe_remat(body), (emb, tuple(sides0)), tuple(xs))
    return h, list(sides)


def ltt_bert_backbone(
    p: Params,
    cfg: LttBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    branches: Tuple[int, ...],
    *,
    ltt_active_layers: Optional[jax.Array] = None,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, List[jax.Array]]:
    bp = subdict(p, "bert.")
    emb = bert_embeddings(
        bp, cfg.into(), input_ids, token_type_ids,
        deterministic=deterministic,
        rng=None if rng is None else jax.random.fold_in(rng, 10),
    )
    bias = additive_mask_bias(attention_mask, emb.dtype)
    return ltt_bert_encoder(
        bp, cfg, emb, bias, branches,
        ltt_active_layers=ltt_active_layers,
        deterministic=deterministic,
        rng=None if rng is None else jax.random.fold_in(rng, 11),
    )


def _main_head(p: Params, h: jax.Array, cfg, *, deterministic, rng) -> jax.Array:
    pooled = jnp.tanh(dense(
        h[:, 0, :], p["bert_pooler.dense.weight"].astype(h.dtype),
        p["bert_pooler.dense.bias"].astype(h.dtype),
    ))
    pooled = dropout(
        None if rng is None else jax.random.fold_in(rng, 30),
        pooled, cfg.hidden_dropout_prob, deterministic,
    )
    logits = dense(pooled, p["classifier.weight"].astype(h.dtype),
                   p["classifier.bias"].astype(h.dtype))
    return jax.nn.softmax(logits, axis=-1)


def _side_cls_head(p: Params, side: jax.Array, cfg, *, deterministic, rng) -> jax.Array:
    pooled = jnp.tanh(dense(
        side[:, 0, :], p["bert_s_attn_pooler.dense.weight"].astype(side.dtype),
        p["bert_s_attn_pooler.dense.bias"].astype(side.dtype),
    ))
    pooled = dropout(
        None if rng is None else jax.random.fold_in(rng, 31),
        pooled, cfg.hidden_dropout_prob, deterministic,
    )
    logits = dense(pooled, p["s_attn_classifier.weight"].astype(side.dtype),
                   p["s_attn_classifier.bias"].astype(side.dtype))
    return jax.nn.softmax(logits, axis=-1)


def ltt_bert_surrogate_fwd(
    p: Params,
    cfg: LttBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    **kw,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """-> (side probs, backbone probs, observations)."""
    deterministic = kw.get("deterministic", True)
    rng = kw.get("rng")
    h, (side,) = ltt_bert_backbone(
        p, cfg, input_ids, attention_mask, token_type_ids, (0,), **kw
    )
    obs = {"repr_cls": h, "repr_srg": side}
    logits = _main_head(p, h, cfg, deterministic=deterministic, rng=rng)
    srg_logits = _side_cls_head(p, side, cfg, deterministic=deterministic, rng=rng)
    return srg_logits, logits, obs


def ltt_bert_explainer_head(
    p: Params,
    cfg: LttBertConfig,
    side: jax.Array,
    attention_mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
    layer_prefix: str = "s_attn_attention_layers",
    mlp_prefix: str = "s_attn_explainer",
) -> jax.Array:
    side_cfg = cfg.side()
    bias = additive_mask_bias(attention_mask, side.dtype)
    for i in range(cfg.explainer_s_attn_num_layers):
        layer = subdict(p, f"{layer_prefix}.{i}.")
        side = _bert_layer_body(
            layer, side, bias, side_cfg,
            ident_ln1=(i == 0), deterministic=deterministic,
            rng=None if rng is None else jax.random.fold_in(rng, 20 + i),
        )
    side = dropout(
        None if rng is None else jax.random.fold_in(rng, 29),
        side, cfg.hidden_dropout_prob, deterministic,
    )
    w = {i: (p[f"{mlp_prefix}.{i}.weight"], p[f"{mlp_prefix}.{i}.bias"])
         for i in (0, 2, 4)}
    side = gelu(dense(side, *w[0]))
    side = gelu(dense(side, *w[2]))
    out = dense(side, *w[4])
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, surrogate_grand, surrogate_null)
    return jnp.swapaxes(out[:, 1:, :], 1, 2)


def ltt_bert_explainer_fwd(
    p: Params,
    cfg: LttBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    **kw,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """-> (attributions, backbone probs, observations)."""
    deterministic = kw.get("deterministic", True)
    rng = kw.get("rng")
    h, (side,) = ltt_bert_backbone(
        p, cfg, input_ids, attention_mask, token_type_ids, (0,), **kw
    )
    obs = {"repr_cls": h, "repr_exp": side}
    logits = _main_head(p, h, cfg, deterministic=deterministic, rng=rng)
    attr = ltt_bert_explainer_head(
        p, cfg, side, attention_mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )
    return attr, logits, obs


def ltt_bert_final_fwd(
    p: Params,
    cfg: LttBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    **kw,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """ONE backbone traversal feeding both side ladders ->
    (backbone probs, attributions, observations)."""
    deterministic = kw.get("deterministic", True)
    rng = kw.get("rng")
    if cfg.explainer_normalize:
        h, (srg_side, exp_side) = ltt_bert_backbone(
            p, cfg, input_ids, attention_mask, token_type_ids, (0, 1), **kw
        )
        grand = _side_cls_head(p, srg_side, cfg, deterministic=deterministic,
                               rng=rng)
        obs = {"repr_cls": h, "repr_srg": srg_side, "repr_exp": exp_side}
    else:
        h, (exp_side,) = ltt_bert_backbone(
            p, cfg, input_ids, attention_mask, token_type_ids, (1,), **kw
        )
        grand = jnp.zeros((input_ids.shape[0], cfg.num_labels), h.dtype)
        obs = {"repr_cls": h, "repr_exp": exp_side}
    logits = _main_head(p, h, cfg, deterministic=deterministic, rng=rng)
    attr = ltt_bert_explainer_head(
        p, cfg, exp_side, attention_mask, grand, p["surrogate_null"],
        deterministic=deterministic, rng=rng,
    )
    return logits, attr, obs


# ------------------------------------------------- coalition fast path


def ltt_bert_surrogate_coalitions_fwd(
    p: Params,
    cfg: LttBertConfig,
    input_ids: jax.Array,  # <B, T>
    masks: jax.Array,  # <B, M, T> (CLS column included)
    token_type_ids: jax.Array,
    *,
    deterministic: bool = True,
) -> jax.Array:
    """Side-branch surrogate over B*M coalitions, embedding computed once
    per sentence.  Returns <B, M, n_classes> side probabilities."""
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only (the reference evaluates its surrogate teacher "
            "under model.eval()); dropout rngs are not threaded here"
        )
    b, m, t = masks.shape
    bp = subdict(p, "bert.")
    emb = bert_embeddings(bp, cfg.into(), input_ids, token_type_ids)
    emb = jnp.broadcast_to(emb[:, None], (b, m, t, emb.shape[-1]))
    emb = emb.reshape(b * m, t, emb.shape[-1])
    bias = additive_mask_bias(masks.reshape(b * m, t), emb.dtype)
    _, (side,) = ltt_bert_encoder(
        bp, cfg, emb, bias, (0,), deterministic=deterministic
    )
    probs = _side_cls_head(p, side, cfg, deterministic=deterministic, rng=None)
    return probs.reshape(b, m, -1)


# -------------------------------------------------------------- policies


def ltt_bert_trainable(cfg: LttBertConfig, section: str):
    """Backbone always frozen (ltt_bert.py:86-92,161-167,341-347)."""
    frozen_prefixes = (
        "bert.embeddings.", "bert.encoder.layers.", "bert_pooler.",
        "classifier.",
    )

    def trainable(name: str) -> bool:
        return not name.startswith(frozen_prefixes)

    return trainable


def ltt_bert_progressive(cfg: LttBertConfig, section: str, unfrozen: int):
    """Grad filter matching the truncated ladder: side parts of layers >=
    `unfrozen` receive no updates (their forward contribution is gated off
    by `ltt_active_layers`)."""

    def keep(name: str) -> bool:
        for marker in ("s_attn_maps.", "s_attn_layers."):
            if marker in name:
                tail = name.split(marker, 1)[1]
                layer_idx = int(tail.split(".")[0].split("_")[1])
                return layer_idx < unfrozen
        return True

    return keep
