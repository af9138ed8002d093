"""Duo vanilla ViT (parity: /root/reference/models/duo_vanilla_vit.py).

Unlike the duo BERT quirk, the duo ViT explainer's classification head DOES
apply softmax (duo_vanilla_vit.py:121-122); its raw forward returns
(attr, logits) which the recipe re-orders."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.records import project
from .common import Params, dense, layer_norm, subdict
from .vit import (
    VanillaViTConfig,
    init_vit_classifier,
    init_vit_explainer,
    vit_embeddings,
    vit_encoder,
    vit_explainer_head,
    vit_patch_extract,
    vit_surrogate_fwd,
)


@dataclasses.dataclass
class DuoVanillaViTConfig(VanillaViTConfig):
    def into(self) -> VanillaViTConfig:
        return project(self, VanillaViTConfig)


init_duo_vit_classifier = init_vit_classifier


def init_duo_vit_explainer(key: jax.Array, cfg: DuoVanillaViTConfig) -> Params:
    k_cls, k_exp = jax.random.split(key)
    p = init_vit_classifier(k_cls, cfg)
    exp = init_vit_explainer(k_exp, cfg)
    for name, v in exp.items():
        if name.startswith(("explainer_attn.", "explainer_mlp.")):
            p[name] = v
    return p


def init_duo_vit_final(key: jax.Array, cfg: DuoVanillaViTConfig) -> Params:
    k_s, k_e = jax.random.split(key)
    p: Params = {}
    for name, v in init_vit_classifier(k_s, cfg).items():
        p[f"surrogate.{name}"] = v
    for name, v in init_duo_vit_explainer(k_e, cfg).items():
        p[f"explainer.{name}"] = v
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    return p


def duo_vit_explainer_from_emb(
    p: Params,
    cfg: DuoVanillaViTConfig,
    emb: jax.Array,
    attention_mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    vp = subdict(p, "vit.")
    # encoder folds raw layer_idx 0..L-1 off its key: fold tag 11 first
    # (vanilla convention, vit.py:357) so deep backbones (L > 20) cannot
    # collide with the explainer head's 20+i folds below
    h = vit_encoder(vp, cfg, emb, attention_mask,
                    deterministic=deterministic,
                    rng=None if rng is None else jax.random.fold_in(rng, 11))
    h = layer_norm(h, vp["layernorm.weight"], vp["layernorm.bias"],
                   cfg.layer_norm_eps)
    obs = {"repr_cls": h, "repr_exp": h}
    logits = jax.nn.softmax(
        dense(h[:, 0, :], p["classifier.weight"].astype(h.dtype),
              p["classifier.bias"].astype(h.dtype)),
        axis=-1,
    )
    attr = vit_explainer_head(
        p, cfg, h, attention_mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )
    return logits, attr, obs


def duo_vit_explainer_fwd(
    p: Params,
    cfg: DuoVanillaViTConfig,
    pixels: jax.Array,
    attention_mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    emb = vit_embeddings(
        subdict(p, "vit."), cfg, pixels,
        deterministic=deterministic,
        rng=None if rng is None else jax.random.fold_in(rng, 10),
    )
    return duo_vit_explainer_from_emb(
        p, cfg, emb, attention_mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )


def duo_vit_final_fwd(
    p: Params,
    cfg: DuoVanillaViTConfig,
    pixels: jax.Array,
    attention_mask: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    obs: Dict[str, jax.Array] = {}
    # pixel->patch rearrange shared by the two towers (see vit_patch_extract)
    patches = (vit_patch_extract(cfg, pixels) if pixels.ndim == 4
               else pixels)
    if cfg.explainer_normalize:
        # per-tower rng folds (vanilla convention, vit.py:477-491): the
        # same key in both towers draws perfectly correlated dropout masks
        grand, obs_s = vit_surrogate_fwd(
            subdict(p, "surrogate."), cfg, patches, attention_mask,
            deterministic=deterministic,
            rng=None if rng is None else jax.random.fold_in(rng, 22),
        )
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = jnp.zeros((pixels.shape[0], cfg.num_labels))
    logits, attr, obs_e = duo_vit_explainer_fwd(
        subdict(p, "explainer."), cfg, patches, attention_mask,
        grand, p["surrogate_null"],
        deterministic=deterministic,
        rng=None if rng is None else jax.random.fold_in(rng, 23),
    )
    obs["repr_cls"] = obs_e["repr_cls"]
    obs["repr_exp"] = obs_e["repr_exp"]
    return logits, attr, obs
