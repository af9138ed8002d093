"""LTT ViT — ladder side tuning (parity: /root/reference/models/ltt_vit.py).

Same fused backbone + side-ladder scan as ltt_bert, with the ViT specifics:
pre-norm layers with multiplicative score masking, per-branch final
LayerNorms (`vit.s_attn_layernorm.{b}`, ltt_vit.py:316-321), CLS-indexed
classifier heads without poolers, and the explainer side head carrying a
leading LayerNorm in its MLP (`s_explainer_mlp.0`)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.shapley import normalize_shapley_explanation
from ..utils.records import Record
from .common import (
    maybe_remat,
    Params,
    dense,
    gelu,
    init_layer_norm,
    init_linear,
    layer_norm,
    stack_branch_params,
    stack_layer_params,
    subdict,
)
from .vit import (
    VanillaViTConfig,
    _init_vit_layer,
    _vit_layer_body,
    init_vit_backbone,
    vit_embeddings,
)


@dataclasses.dataclass
class LttViTConfig(Record):
    attention_probs_dropout_prob: float
    explainer_s_attn_num_layers: int
    explainer_s_head_hidden_size: int
    explainer_normalize: bool
    hidden_dropout_prob: float
    hidden_size: int
    intermediate_size: int
    layer_norm_eps: float
    num_attention_heads: int
    num_hidden_layers: int
    num_labels: int
    s_attn_hidden_size: int
    s_attn_intermediate_size: int
    img_channels: int
    img_px_size: int
    img_patch_size: int

    def into(self) -> VanillaViTConfig:
        return VanillaViTConfig(
            attention_probs_dropout_prob=self.attention_probs_dropout_prob,
            explainer_attn_num_layers=self.explainer_s_attn_num_layers,
            explainer_head_hidden_size=self.explainer_s_head_hidden_size,
            explainer_normalize=self.explainer_normalize,
            hidden_dropout_prob=self.hidden_dropout_prob,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            layer_norm_eps=self.layer_norm_eps,
            num_attention_heads=self.num_attention_heads,
            num_hidden_layers=self.num_hidden_layers,
            num_labels=self.num_labels,
            img_channels=self.img_channels,
            img_px_size=self.img_px_size,
            img_patch_size=self.img_patch_size,
        )

    def side(self) -> VanillaViTConfig:
        cfg = self.into()
        return dataclasses.replace(
            cfg, hidden_size=self.s_attn_hidden_size,
            intermediate_size=self.s_attn_intermediate_size,
        )


# ------------------------------------------------------------------ init


def _init_side_parts(key: jax.Array, cfg: LttViTConfig, branch: int) -> Params:
    side_cfg = cfg.side()
    p: Params = {}
    keys = jax.random.split(key, cfg.num_hidden_layers)
    for i, k in enumerate(keys):
        k_map, k_layer = jax.random.split(k)
        w, b = init_linear(k_map, cfg.s_attn_hidden_size, cfg.hidden_size)
        p[f"vit.encoder.s_attn_maps.{branch}_{i}.weight"] = w
        p[f"vit.encoder.s_attn_maps.{branch}_{i}.bias"] = b
        for name, v in _init_vit_layer(k_layer, side_cfg, skip_ln1=False).items():
            p[f"vit.encoder.s_attn_layers.{branch}_{i}.{name}"] = v
    (p[f"vit.s_attn_layernorm.{branch}.weight"],
     p[f"vit.s_attn_layernorm.{branch}.bias"]) = init_layer_norm(
        cfg.s_attn_hidden_size
    )
    return p


def init_ltt_vit_surrogate(key: jax.Array, cfg: LttViTConfig) -> Params:
    k_bb, k_side, k_cls, k_scls = jax.random.split(key, 4)
    p = init_vit_backbone(k_bb, cfg.into())
    p.update(_init_side_parts(k_side, cfg, branch=0))
    w, b = init_linear(k_cls, cfg.num_labels, cfg.hidden_size)
    p["classifier.weight"], p["classifier.bias"] = w, b
    w, b = init_linear(k_scls, cfg.num_labels, cfg.s_attn_hidden_size)
    p["s_attn_classifier.weight"], p["s_attn_classifier.bias"] = w, b
    return p


def init_ltt_vit_explainer(key: jax.Array, cfg: LttViTConfig) -> Params:
    k_bb, k_side, k_cls, k_attn, k_mlp = jax.random.split(key, 5)
    p = init_vit_backbone(k_bb, cfg.into())
    p.update(_init_side_parts(k_side, cfg, branch=0))
    w, b = init_linear(k_cls, cfg.num_labels, cfg.hidden_size)
    p["classifier.weight"], p["classifier.bias"] = w, b
    side_cfg = cfg.side()
    for i, k in enumerate(
        jax.random.split(k_attn, cfg.explainer_s_attn_num_layers)
    ):
        for name, v in _init_vit_layer(k, side_cfg, skip_ln1=(i == 0)).items():
            p[f"s_explainer_attn.{i}.{name}"] = v
    w_hid = cfg.explainer_s_head_hidden_size
    k1, k3, k5 = jax.random.split(k_mlp, 3)
    (p["s_explainer_mlp.0.weight"],
     p["s_explainer_mlp.0.bias"]) = init_layer_norm(cfg.s_attn_hidden_size)
    p["s_explainer_mlp.1.weight"], p["s_explainer_mlp.1.bias"] = init_linear(
        k1, w_hid, cfg.s_attn_hidden_size
    )
    p["s_explainer_mlp.3.weight"], p["s_explainer_mlp.3.bias"] = init_linear(
        k3, w_hid, w_hid
    )
    p["s_explainer_mlp.5.weight"], p["s_explainer_mlp.5.bias"] = init_linear(
        k5, cfg.num_labels, w_hid
    )
    return p


def init_ltt_vit_final(key: jax.Array, cfg: LttViTConfig) -> Params:
    k_srg, k_side1, k_exp = jax.random.split(key, 3)
    p = init_ltt_vit_surrogate(k_srg, cfg)
    p.update(_init_side_parts(k_side1, cfg, branch=1))
    exp = init_ltt_vit_explainer(k_exp, cfg)
    for name, v in exp.items():
        if name.startswith(("s_explainer_attn.", "s_explainer_mlp.")):
            p[name] = v
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    return p


# ----------------------------------------------------------------- apply


def ltt_vit_backbone(
    p: Params,
    cfg: LttViTConfig,
    pixels: jax.Array,
    attention_mask: jax.Array,
    branches: Tuple[int, ...],
    *,
    ltt_active_layers: Optional[jax.Array] = None,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, List[jax.Array]]:
    """Fused embeddings + backbone/ladder scan + final LayerNorms."""
    vp = subdict(p, "vit.")
    emb = vit_embeddings(
        vp, cfg.into(), pixels,
        deterministic=deterministic,
        rng=None if rng is None else jax.random.fold_in(rng, 10),
    )
    L = cfg.num_hidden_layers
    dtype = emb.dtype
    main_stack = stack_layer_params(vp, "encoder.layers", L, dtype=dtype)
    side_stacks = [stack_branch_params(vp, b, L, dtype) for b in branches]
    active = (
        jnp.asarray(L, jnp.int32) if ltt_active_layers is None
        else jnp.asarray(ltt_active_layers, jnp.int32)
    )
    side_cfg = cfg.side()
    enc_rng = None if rng is None else jax.random.fold_in(rng, 11)

    b_sz, t = emb.shape[0], emb.shape[1]
    sides0 = [
        jnp.zeros((b_sz, t, cfg.s_attn_hidden_size), dtype) for _ in branches
    ]

    def body(carry, xs):
        h, sides = carry
        layer_idx, main_layer, *side_parts = xs
        layer_rng = (
            None if enc_rng is None else jax.random.fold_in(enc_rng, layer_idx)
        )
        h = _vit_layer_body(
            main_layer, h, attention_mask, cfg.into(),
            has_ln1=True, deterministic=deterministic, rng=layer_rng,
        )
        # both branch maps as ONE dense (out-features concatenated): h is
        # read once instead of once per branch
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
                None if enc_rng is None
                else jax.random.fold_in(enc_rng, 1000 + slot * 100 + layer_idx)
            )
            upd = side + joint[..., slot * s_hidden:(slot + 1) * s_hidden]
            upd = _vit_layer_body(
                layers, upd, attention_mask, side_cfg,
                has_ln1=True, deterministic=deterministic, rng=side_rng,
            )
            new_sides.append(jnp.where(layer_idx < active, upd, side))
        return (h, tuple(new_sides)), None

    xs = [jnp.arange(L), main_stack]
    for maps, layers in side_stacks:
        xs.extend([maps, layers])
    (h, sides), _ = jax.lax.scan(maybe_remat(body), (emb, tuple(sides0)), tuple(xs))

    h = layer_norm(h, vp["layernorm.weight"], vp["layernorm.bias"],
                   cfg.layer_norm_eps)
    out_sides = [
        layer_norm(
            side,
            vp[f"s_attn_layernorm.{b}.weight"],
            vp[f"s_attn_layernorm.{b}.bias"],
            cfg.layer_norm_eps,
        )
        for side, b in zip(sides, branches)
    ]
    return h, out_sides


def _cls_head(p, h, key_prefix="classifier"):
    return jax.nn.softmax(
        dense(h[:, 0, :], p[f"{key_prefix}.weight"].astype(h.dtype),
              p[f"{key_prefix}.bias"].astype(h.dtype)),
        axis=-1,
    )


def ltt_vit_surrogate_fwd(
    p: Params, cfg: LttViTConfig, pixels, attention_mask, **kw
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    h, (side,) = ltt_vit_backbone(p, cfg, pixels, attention_mask, (0,), **kw)
    obs = {"repr_cls": h, "repr_srg": side}
    return _cls_head(p, side, "s_attn_classifier"), _cls_head(p, h), obs


def ltt_vit_explainer_head(
    p: Params,
    cfg: LttViTConfig,
    side: jax.Array,
    attention_mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    side_cfg = cfg.side()
    for i in range(cfg.explainer_s_attn_num_layers):
        layer = subdict(p, f"s_explainer_attn.{i}.")
        side = _vit_layer_body(
            layer, side, attention_mask, side_cfg,
            has_ln1=(i != 0), deterministic=deterministic,
            rng=None if rng is None else jax.random.fold_in(rng, 20 + i),
        )
    from .vit import explainer_mlp_head

    out = explainer_mlp_head(p, side, prefix="s_explainer_mlp")
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, surrogate_grand, surrogate_null)
    return jnp.swapaxes(out[:, 1:, :], 1, 2)


def ltt_vit_explainer_fwd(
    p: Params, cfg: LttViTConfig, pixels, attention_mask,
    surrogate_grand, surrogate_null, **kw,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    deterministic = kw.get("deterministic", True)
    rng = kw.get("rng")
    h, (side,) = ltt_vit_backbone(p, cfg, pixels, attention_mask, (0,), **kw)
    obs = {"repr_cls": h, "repr_exp": side}
    logits = _cls_head(p, h)
    attr = ltt_vit_explainer_head(
        p, cfg, side, attention_mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )
    return attr, logits, obs


def ltt_vit_final_fwd(
    p: Params, cfg: LttViTConfig, pixels, attention_mask, **kw
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    deterministic = kw.get("deterministic", True)
    rng = kw.get("rng")
    if cfg.explainer_normalize:
        h, (srg_side, exp_side) = ltt_vit_backbone(
            p, cfg, pixels, attention_mask, (0, 1), **kw
        )
        grand = _cls_head(p, srg_side, "s_attn_classifier")
        obs = {"repr_cls": h, "repr_srg": srg_side, "repr_exp": exp_side}
    else:
        h, (exp_side,) = ltt_vit_backbone(
            p, cfg, pixels, attention_mask, (1,), **kw
        )
        grand = jnp.zeros((pixels.shape[0], cfg.num_labels), h.dtype)
        obs = {"repr_cls": h, "repr_exp": exp_side}
    logits = _cls_head(p, h)
    attr = ltt_vit_explainer_head(
        p, cfg, exp_side, attention_mask, grand, p["surrogate_null"],
        deterministic=deterministic, rng=rng,
    )
    return logits, attr, obs


def ltt_vit_surrogate_coalitions_fwd(
    p: Params,
    cfg: LttViTConfig,
    pixels: jax.Array,  # <B, C, H, W>
    masks: jax.Array,  # <B, M, 1 + n_players>
    *,
    deterministic: bool = True,
) -> jax.Array:
    """Side-branch surrogate over B*M coalitions with the patch embedding
    computed once per image.  Returns <B, M, n_classes>."""
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only (the reference evaluates its surrogate teacher "
            "under model.eval()); dropout rngs are not threaded here"
        )
    b, m, t = masks.shape
    vp = subdict(p, "vit.")
    emb = vit_embeddings(vp, cfg.into(), pixels)
    emb = jnp.broadcast_to(emb[:, None], (b, m, t, emb.shape[-1]))
    emb = emb.reshape(b * m, t, emb.shape[-1])
    flat_masks = masks.reshape(b * m, t)

    # re-run the ladder scan on the broadcast embeddings
    L = cfg.num_hidden_layers
    dtype = emb.dtype
    main_stack = stack_layer_params(vp, "encoder.layers", L, dtype=dtype)
    maps, layers = stack_branch_params(vp, 0, L, dtype)
    side_cfg = cfg.side()
    side0 = jnp.zeros((b * m, t, cfg.s_attn_hidden_size), dtype)

    def body(carry, xs):
        h, side = carry
        main_layer, s_maps, s_layers = xs
        h = _vit_layer_body(
            main_layer, h, flat_masks, cfg.into(),
            has_ln1=True, deterministic=deterministic, rng=None,
        )
        side = side + gelu(dense(h, s_maps["weight"], s_maps["bias"]))
        side = _vit_layer_body(
            s_layers, side, flat_masks, side_cfg,
            has_ln1=True, deterministic=deterministic, rng=None,
        )
        return (h, side), None

    (_, side), _ = jax.lax.scan(maybe_remat(body), (emb, side0), (main_stack, maps, layers))
    side = layer_norm(
        side, vp["s_attn_layernorm.0.weight"], vp["s_attn_layernorm.0.bias"],
        cfg.layer_norm_eps,
    )
    return _cls_head(p, side, "s_attn_classifier").reshape(b, m, -1)


def ltt_vit_trainable(cfg: LttViTConfig, section: str):
    frozen_prefixes = (
        "vit.embeddings.", "vit.encoder.layers.", "vit.layernorm.",
        "classifier.",
    )

    def trainable(name: str) -> bool:
        return not name.startswith(frozen_prefixes)

    return trainable


def ltt_vit_progressive(cfg: LttViTConfig, section: str, unfrozen: int):
    def keep(name: str) -> bool:
        for marker in ("s_attn_maps.", "s_attn_layers."):
            if marker in name:
                tail = name.split(marker, 1)[1]
                layer_idx = int(tail.split(".")[0].split("_")[1])
                return layer_idx < unfrozen
        return True

    return keep
