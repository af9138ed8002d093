"""Vanilla ViT family: classifier / surrogate / explainer / final.

Functional re-design of the reference family (/root/reference/models/
vanilla_vit.py): params are flat dicts, the encoder is a `lax.scan` over
stacked layer weights, and the coalition mask is applied *multiplicatively*
to raw attention scores — the reference's deliberate quirk
(vanilla_vit.py:448-451) that must be reproduced exactly for eval parity.

Behavioral contract:
- Classifier/Surrogate: backbone -> CLS hidden -> linear head -> softmax
  (probabilities, not raw logits — vanilla_vit.py:51-56).
- Explainer: backbone -> `explainer_attn` extra pre-norm layers (first
  layer's layernorm_before replaced by identity) -> LayerNorm+MLP head ->
  optional efficiency normalization over the *token* axis (CLS included) ->
  drop CLS, permute to <B, n_classes, n_players> (vanilla_vit.py:102-130).
- Final: classifier + surrogate(grand) + explainer with a stored
  `surrogate_null` buffer; one forward -> (probs, attributions).

Additions over the reference:
- `embed_once_coalitions`: the patch projection + position embedding is
  computed once per image and broadcast across the coalition axis, instead
  of replicating full pixel tensors B*M times on host
  (/root/reference/scripts/train_explainer.py:159-171).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.shapley import normalize_shapley_explanation
from ..utils.records import Record
from .common import (
    maybe_remat,
    Params,
    dense,
    dropout,
    gelu,
    init_embedding,
    init_layer_norm,
    init_linear,
    layer_norm,
    self_attention,
    stack_layer_params,
    subdict,
)


@dataclasses.dataclass
class VanillaViTConfig(Record):
    attention_probs_dropout_prob: float
    explainer_attn_num_layers: int
    explainer_head_hidden_size: int
    explainer_normalize: bool
    hidden_dropout_prob: float
    hidden_size: int
    intermediate_size: int
    layer_norm_eps: float
    num_attention_heads: int
    num_hidden_layers: int
    num_labels: int
    img_channels: int
    img_px_size: int
    img_patch_size: int

    @property
    def n_patches(self) -> int:
        return (self.img_px_size // self.img_patch_size) ** 2


# ------------------------------------------------------------------ init


def _init_vit_layer(key: jax.Array, cfg: VanillaViTConfig, skip_ln1: bool) -> Params:
    ks = jax.random.split(key, 6)
    p: Params = {}
    for name, k in zip(["query", "key", "value"], ks[:3]):
        w, b = init_linear(k, cfg.hidden_size, cfg.hidden_size)
        p[f"attention.self.{name}.weight"] = w
        p[f"attention.self.{name}.bias"] = b
    w, b = init_linear(ks[3], cfg.hidden_size, cfg.hidden_size)
    p["attention.output.dense.weight"] = w
    p["attention.output.dense.bias"] = b
    w, b = init_linear(ks[4], cfg.intermediate_size, cfg.hidden_size)
    p["intermediate.dense.weight"] = w
    p["intermediate.dense.bias"] = b
    w, b = init_linear(ks[5], cfg.hidden_size, cfg.intermediate_size)
    p["output.dense.weight"] = w
    p["output.dense.bias"] = b
    if not skip_ln1:
        p["layernorm_before.weight"], p["layernorm_before.bias"] = init_layer_norm(
            cfg.hidden_size
        )
    p["layernorm_after.weight"], p["layernorm_after.bias"] = init_layer_norm(
        cfg.hidden_size
    )
    return p


def init_vit_backbone(key: jax.Array, cfg: VanillaViTConfig) -> Params:
    """Params under the `vit.` prefix (embeddings + encoder + final LN)."""
    k_cls, k_pos, k_proj, k_enc = jax.random.split(key, 4)
    p: Params = {}
    p["vit.embeddings.cls_token"] = jax.random.normal(
        k_cls, (1, 1, cfg.hidden_size)
    )
    p["vit.embeddings.position_embeddings"] = jax.random.normal(
        k_pos, (1, cfg.n_patches + 1, cfg.hidden_size)
    )
    # conv2d default init: kaiming_uniform over fan_in = C*P*P
    fan_in = cfg.img_channels * cfg.img_patch_size**2
    w, b = init_linear(k_proj, cfg.hidden_size, fan_in)
    p["vit.embeddings.patch_embeddings.projection.weight"] = w.reshape(
        cfg.hidden_size, cfg.img_channels, cfg.img_patch_size, cfg.img_patch_size
    )
    p["vit.embeddings.patch_embeddings.projection.bias"] = b
    for i, k in enumerate(jax.random.split(k_enc, cfg.num_hidden_layers)):
        layer = _init_vit_layer(k, cfg, skip_ln1=False)
        for name, v in layer.items():
            p[f"vit.encoder.layers.{i}.{name}"] = v
    p["vit.layernorm.weight"], p["vit.layernorm.bias"] = init_layer_norm(
        cfg.hidden_size
    )
    return p


def init_vit_classifier(key: jax.Array, cfg: VanillaViTConfig) -> Params:
    k_bb, k_head = jax.random.split(key)
    p = init_vit_backbone(k_bb, cfg)
    w, b = init_linear(k_head, cfg.num_labels, cfg.hidden_size)
    p["classifier.weight"] = w
    p["classifier.bias"] = b
    return p


def init_vit_explainer(key: jax.Array, cfg: VanillaViTConfig) -> Params:
    k_bb, k_attn, k_mlp = jax.random.split(key, 3)
    p = init_vit_backbone(k_bb, cfg)
    for i, k in enumerate(jax.random.split(k_attn, cfg.explainer_attn_num_layers)):
        layer = _init_vit_layer(k, cfg, skip_ln1=(i == 0))
        for name, v in layer.items():
            p[f"explainer_attn.{i}.{name}"] = v
    w_hid = cfg.explainer_head_hidden_size
    k0, k1, k3, k5 = jax.random.split(k_mlp, 4)
    p["explainer_mlp.0.weight"], p["explainer_mlp.0.bias"] = init_layer_norm(
        cfg.hidden_size
    )
    p["explainer_mlp.1.weight"], p["explainer_mlp.1.bias"] = init_linear(
        k1, w_hid, cfg.hidden_size
    )
    p["explainer_mlp.3.weight"], p["explainer_mlp.3.bias"] = init_linear(
        k3, w_hid, w_hid
    )
    p["explainer_mlp.5.weight"], p["explainer_mlp.5.bias"] = init_linear(
        k5, cfg.num_labels, w_hid
    )
    return p


def init_vit_final(key: jax.Array, cfg: VanillaViTConfig) -> Params:
    k_c, k_s, k_e = jax.random.split(key, 3)
    p: Params = {}
    for name, v in init_vit_classifier(k_c, cfg).items():
        p[f"classifier.{name}"] = v
    for name, v in init_vit_classifier(k_s, cfg).items():
        p[f"surrogate.{name}"] = v
    for name, v in init_vit_explainer(k_e, cfg).items():
        p[f"explainer.{name}"] = v
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    return p


# ----------------------------------------------------------------- apply


def _rng(key: Optional[jax.Array], tag: int) -> Optional[jax.Array]:
    return None if key is None else jax.random.fold_in(key, tag)


def vit_patch_extract(cfg: VanillaViTConfig, pixels: jax.Array) -> jax.Array:
    """<B, C, H, W> -> <B, n_patches, C*ps*ps> pure rearrange (no weights).

    Split out so `vit_final_fwd` can run it ONCE and share the result
    across its three towers (classifier/surrogate/explainer embed the
    identical pixels)."""
    b, c, hh, ww = pixels.shape
    ps = cfg.img_patch_size
    gh, gw = hh // ps, ww // ps
    x = pixels.reshape(b, c, gh, ps, gw, ps)
    return x.transpose(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * ps * ps)


def vit_patch_embed(p: Params, cfg: VanillaViTConfig, pixels: jax.Array) -> jax.Array:
    """<B, C, H, W> (or pre-extracted <B, n_patches, C*ps*ps>) ->
    <B, n_patches, hidden> via reshape+matmul (the GEMM equivalent of the
    stride==kernel conv)."""
    x = pixels if pixels.ndim == 3 else vit_patch_extract(cfg, pixels)
    w = p["embeddings.patch_embeddings.projection.weight"].reshape(
        cfg.hidden_size, -1
    )
    return dense(x, w.astype(x.dtype), p["embeddings.patch_embeddings.projection.bias"].astype(x.dtype))


def vit_embeddings(
    p: Params,
    cfg: VanillaViTConfig,
    pixels: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    emb = vit_patch_embed(p, cfg, pixels)
    cls = jnp.broadcast_to(
        p["embeddings.cls_token"].astype(emb.dtype),
        (emb.shape[0], 1, cfg.hidden_size),
    )
    emb = jnp.concatenate([cls, emb], axis=1)
    emb = emb + p["embeddings.position_embeddings"].astype(emb.dtype)
    return dropout(_rng(rng, 0), emb, cfg.hidden_dropout_prob, deterministic)


def _vit_layer_body(
    layer: Params,
    h: jax.Array,
    mask: Optional[jax.Array],
    cfg: VanillaViTConfig,
    *,
    has_ln1: bool,
    deterministic: bool,
    rng: Optional[jax.Array],
) -> jax.Array:
    """Pre-norm ViT layer (vanilla_vit.py:364-377)."""
    if has_ln1:
        normed = layer_norm(
            h, layer["layernorm_before.weight"], layer["layernorm_before.bias"],
            cfg.layer_norm_eps,
        )
    else:
        normed = h
    ctx = self_attention(
        normed,
        layer["attention.self.query.weight"], layer["attention.self.query.bias"],
        layer["attention.self.key.weight"], layer["attention.self.key.bias"],
        layer["attention.self.value.weight"], layer["attention.self.value.bias"],
        cfg.num_attention_heads,
        mask,
        "multiplicative",
        attn_dropout=cfg.attention_probs_dropout_prob,
        dropout_key=_rng(rng, 1),
        deterministic=deterministic,
    )
    attn_out = dense(
        ctx, layer["attention.output.dense.weight"], layer["attention.output.dense.bias"]
    )
    attn_out = dropout(_rng(rng, 2), attn_out, cfg.hidden_dropout_prob, deterministic)
    h = h + attn_out
    normed2 = layer_norm(
        h, layer["layernorm_after.weight"], layer["layernorm_after.bias"],
        cfg.layer_norm_eps,
    )
    inter = gelu(dense(
        normed2, layer["intermediate.dense.weight"], layer["intermediate.dense.bias"]
    ))
    out = dense(inter, layer["output.dense.weight"], layer["output.dense.bias"])
    out = dropout(_rng(rng, 3), out, cfg.hidden_dropout_prob, deterministic)
    return h + out


def vit_encoder(
    p: Params,
    cfg: VanillaViTConfig,
    h: jax.Array,
    mask: Optional[jax.Array],
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    """lax.scan over the stacked encoder layers."""
    stacked = stack_layer_params(p, "encoder.layers", cfg.num_hidden_layers,
                                 dtype=h.dtype)

    def body(carry, xs):
        layer, layer_idx = xs
        layer_rng = None if rng is None else jax.random.fold_in(rng, layer_idx)
        out = _vit_layer_body(
            layer, carry, mask, cfg,
            has_ln1=True, deterministic=deterministic, rng=layer_rng,
        )
        return out, None

    idxs = jnp.arange(cfg.num_hidden_layers)
    h, _ = jax.lax.scan(maybe_remat(body), h, (stacked, idxs))
    return h


def vit_backbone(
    p: Params,
    cfg: VanillaViTConfig,
    pixels: jax.Array,
    mask: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    """Full `vit.` tower: embeddings -> encoder -> final LayerNorm."""
    vp = subdict(p, "vit.")
    h = vit_embeddings(vp, cfg, pixels, deterministic=deterministic, rng=_rng(rng, 10))
    h = vit_encoder(vp, cfg, h, mask, deterministic=deterministic, rng=_rng(rng, 11))
    return layer_norm(h, vp["layernorm.weight"], vp["layernorm.bias"],
                      cfg.layer_norm_eps)


def vit_classifier_fwd(
    p: Params,
    cfg: VanillaViTConfig,
    pixels: jax.Array,
    mask: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """-> (<B, n_classes> softmax probabilities, observations)."""
    h = vit_backbone(p, cfg, pixels, mask, deterministic=deterministic, rng=rng)
    logits = dense(h[:, 0, :], p["classifier.weight"].astype(h.dtype),
                   p["classifier.bias"].astype(h.dtype))
    return jax.nn.softmax(logits, axis=-1), {"repr_cls": h}


# surrogate shares the classifier architecture verbatim
vit_surrogate_fwd = vit_classifier_fwd


def explainer_mlp_head(p: Params, h: jax.Array,
                       prefix: str = "explainer_mlp") -> jax.Array:
    """The explainer MLP head: LN (torch default eps 1e-5) -> d1 -> gelu ->
    d2 -> gelu -> d3.  Shared by the ViT families and the LTT ViT side
    head."""
    h = layer_norm(h, p[f"{prefix}.0.weight"], p[f"{prefix}.0.bias"], 1e-5)
    h = gelu(dense(h, p[f"{prefix}.1.weight"], p[f"{prefix}.1.bias"]))
    h = gelu(dense(h, p[f"{prefix}.3.weight"], p[f"{prefix}.3.bias"]))
    return dense(h, p[f"{prefix}.5.weight"], p[f"{prefix}.5.bias"])


def vit_explainer_head(
    p: Params,
    cfg: VanillaViTConfig,
    h: jax.Array,
    mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    """explainer_attn layers + MLP head on backbone output `h`."""
    for i in range(cfg.explainer_attn_num_layers):
        layer = subdict(p, f"explainer_attn.{i}.")
        h = _vit_layer_body(
            layer, h, mask, cfg,
            has_ln1=(i != 0), deterministic=deterministic, rng=_rng(rng, 20 + i),
        )
    out = explainer_mlp_head(p, h)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, surrogate_grand, surrogate_null)
    # drop CLS, -> <B, n_classes, n_players>
    return jnp.swapaxes(out[:, 1:, :], 1, 2)


def vit_explainer_fwd(
    p: Params,
    cfg: VanillaViTConfig,
    pixels: jax.Array,
    mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    h = vit_backbone(p, cfg, pixels, mask, deterministic=deterministic, rng=rng)
    obs = {"repr_exp": h}
    attr = vit_explainer_head(
        p, cfg, h, mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )
    return attr, obs


def vit_final_fwd(
    p: Params,
    cfg: VanillaViTConfig,
    pixels: jax.Array,
    mask: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """-> (probs, attributions, observations).

    The pixel->patch rearrange is computed ONCE and shared by the three
    towers (identical input; only the projection weights differ)."""
    patches = vit_patch_extract(cfg, pixels) if pixels.ndim == 4 else pixels
    # per-tower rng folds: one shared key would draw perfectly correlated
    # dropout masks across the three towers (the reference's merged module
    # draws independently per submodule)
    probs, obs_c = vit_classifier_fwd(
        subdict(p, "classifier."), cfg, patches, mask,
        deterministic=deterministic, rng=_rng(rng, 21),
    )
    obs = {"repr_cls": obs_c["repr_cls"]}
    if cfg.explainer_normalize:
        grand, obs_s = vit_surrogate_fwd(
            subdict(p, "surrogate."), cfg, patches, mask,
            deterministic=deterministic, rng=_rng(rng, 22),
        )
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = jnp.zeros_like(probs)
    attr, obs_e = vit_explainer_fwd(
        subdict(p, "explainer."), cfg, patches, mask,
        grand, p["surrogate_null"],
        deterministic=deterministic, rng=_rng(rng, 23),
    )
    obs["repr_exp"] = obs_e["repr_exp"]
    return probs, attr, obs


# ------------------------------------------------- coalition fast path


def vit_surrogate_coalitions_fwd(
    p: Params,
    cfg: VanillaViTConfig,
    pixels: jax.Array,  # <B, C, H, W>
    masks: jax.Array,  # <B, M, 1 + n_players>  (CLS column included)
    *,
    deterministic: bool = True,
) -> jax.Array:
    """Evaluate the surrogate on B*M coalition-masked copies of each image,
    computing the patch projection + position embedding ONCE per image.

    Returns <B, M, n_classes> probabilities.  This replaces the reference's
    host-side replication of full pixel tensors (train_explainer.py:159-171):
    only the <B, T, hidden> embedding is broadcast across the coalition axis.
    """
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only (the reference evaluates its surrogate teacher "
            "under model.eval()); dropout rngs are not threaded here"
        )
    b, m = masks.shape[:2]
    vp = subdict(p, "vit.")
    emb = vit_embeddings(vp, cfg, pixels, deterministic=True)  # <B, T, H>
    t = emb.shape[1]
    emb = jnp.broadcast_to(emb[:, None], (b, m, t, emb.shape[-1]))
    emb = emb.reshape(b * m, t, emb.shape[-1])
    flat_masks = masks.reshape(b * m, t)
    h = vit_encoder(vp, cfg, emb, flat_masks, deterministic=deterministic)
    h = layer_norm(h, vp["layernorm.weight"], vp["layernorm.bias"],
                   cfg.layer_norm_eps)
    logits = dense(h[:, 0, :], p["classifier.weight"].astype(h.dtype),
                   p["classifier.bias"].astype(h.dtype))
    return jax.nn.softmax(logits, axis=-1).reshape(b, m, -1)
