"""Froyo ViT: frozen-backbone variant with a single-trunk Final (parity:
/root/reference/models/froyo_vit.py).  Stage models reuse the vanilla ViT
apply fns; the variant changes only the trainable sets and the Final."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.records import project
from .common import Params, dense, init_linear
from .vit import (
    VanillaViTConfig,
    init_vit_classifier,
    init_vit_explainer,
    vit_explainer_head,
    vit_backbone,
)


@dataclasses.dataclass
class FroyoViTConfig(VanillaViTConfig):
    def into(self) -> VanillaViTConfig:
        return project(self, VanillaViTConfig)


init_froyo_vit_classifier = init_vit_classifier
init_froyo_vit_explainer = init_vit_explainer


def init_froyo_vit_final(key: jax.Array, cfg: FroyoViTConfig) -> Params:
    k_cls, k_srg, k_exp = jax.random.split(key, 3)
    p = init_vit_classifier(k_cls, cfg)
    w, b = init_linear(k_srg, cfg.num_labels, cfg.hidden_size)
    p["srg_classifier.weight"] = w
    p["srg_classifier.bias"] = b
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    exp = init_vit_explainer(k_exp, cfg)
    for name, v in exp.items():
        if name.startswith(("explainer_attn.", "explainer_mlp.")):
            p[name] = v
    return p


def froyo_vit_final_fwd(
    p: Params,
    cfg: FroyoViTConfig,
    pixels: jax.Array,
    attention_mask: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    h = vit_backbone(p, cfg, pixels, attention_mask,
                     deterministic=deterministic, rng=rng)
    obs = {"repr_cls": h, "repr_srg": h, "repr_exp": h}

    cls_probs = jax.nn.softmax(
        dense(h[:, 0, :], p["classifier.weight"].astype(h.dtype),
              p["classifier.bias"].astype(h.dtype)),
        axis=-1,
    )
    if cfg.explainer_normalize:
        grand = jax.nn.softmax(
            dense(h[:, 0, :], p["srg_classifier.weight"].astype(h.dtype),
                  p["srg_classifier.bias"].astype(h.dtype)),
            axis=-1,
        )
    else:
        grand = jnp.zeros_like(cls_probs)

    attr = vit_explainer_head(
        p, cfg, h, attention_mask, grand, p["surrogate_null"],
        deterministic=deterministic, rng=rng,
    )
    return cls_probs, attr, obs


def froyo_vit_trainable(cfg: FroyoViTConfig, section: str):
    if section == "classifier":
        return lambda name: False
    if section in ("surrogate", "explainer"):
        return lambda name: not name.startswith("vit.")
    if section == "final":
        return lambda name: not name.startswith(("vit.", "classifier."))
    return lambda name: True
