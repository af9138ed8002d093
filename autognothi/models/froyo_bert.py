"""Froyo BERT ("frozen yoghurt"): vanilla architecture with everything in the
backbone frozen except the task heads, and a Final model that runs ONE shared
trunk feeding three heads (parity: /root/reference/models/froyo_bert.py).

Functionally, the classifier/surrogate/explainer stages reuse the vanilla
BERT apply fns — the variant differs only in its *trainable sets* (the
backbone stays frozen in every stage, which is exactly what makes the shared
trunk of the Final numerically coherent) and in the Final's fused forward."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from .bert import (
    VanillaBertConfig,
    _cls_head,
    bert_backbone,
    bert_explainer_head,
    init_bert_classifier,
    init_bert_explainer,
)
from ..utils.records import project
from .common import Params, dense, init_linear


@dataclasses.dataclass
class FroyoBertConfig(VanillaBertConfig):
    """Same hyperparameter surface as VanillaBertConfig."""

    def into(self) -> VanillaBertConfig:
        return project(self, VanillaBertConfig)


# the three stages share the vanilla param layouts
init_froyo_bert_classifier = init_bert_classifier
init_froyo_bert_explainer = init_bert_explainer


def init_froyo_bert_final(key: jax.Array, cfg: FroyoBertConfig) -> Params:
    """Single trunk + classifier head + srg_* head + explainer head."""
    k_cls, k_srg, k_exp = jax.random.split(key, 3)
    p = init_bert_classifier(k_cls, cfg)
    k_pool, k_head = jax.random.split(k_srg)
    w, b = init_linear(k_pool, cfg.hidden_size, cfg.hidden_size)
    p["srg_bert_pooler.dense.weight"] = w
    p["srg_bert_pooler.dense.bias"] = b
    w, b = init_linear(k_head, cfg.num_labels, cfg.hidden_size)
    p["srg_classifier.weight"] = w
    p["srg_classifier.bias"] = b
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    exp = init_bert_explainer(k_exp, cfg)
    for name, v in exp.items():
        if name.startswith(("explainer_attn.", "explainer_mlp.")):
            p[name] = v
    return p


def froyo_bert_final_fwd(
    p: Params,
    cfg: FroyoBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
    dtype=None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """One backbone traversal -> (cls probs, attributions, observations)."""
    h = bert_backbone(
        p, cfg, input_ids, attention_mask, token_type_ids,
        deterministic=deterministic, rng=rng, dtype=dtype,
    )
    obs = {"repr_cls": h, "repr_srg": h, "repr_exp": h}

    cls_probs = _cls_head(p, h, cfg, deterministic=deterministic, rng=rng)

    if cfg.explainer_normalize:
        from .common import dropout as _dropout

        pooled = jnp.tanh(dense(
            h[:, 0, :],
            p["srg_bert_pooler.dense.weight"].astype(h.dtype),
            p["srg_bert_pooler.dense.bias"].astype(h.dtype),
        ))
        pooled = _dropout(
            None if rng is None else jax.random.fold_in(rng, 31),
            pooled, cfg.hidden_dropout_prob, deterministic,
        )
        srg_logits = dense(pooled, p["srg_classifier.weight"].astype(h.dtype),
                           p["srg_classifier.bias"].astype(h.dtype))
        grand = jax.nn.softmax(srg_logits, axis=-1)
    else:
        grand = jnp.zeros_like(cls_probs)

    attr = bert_explainer_head(
        p, cfg, h, attention_mask, grand, p["surrogate_null"],
        deterministic=deterministic, rng=rng,
    )
    return cls_probs, attr, obs


def froyo_bert_trainable(cfg: FroyoBertConfig, section: str):
    """The froyo freeze policy (froyo_bert.py:72-103, 206-211)."""
    if section == "classifier":
        return lambda name: False
    if section in ("surrogate", "explainer"):
        return lambda name: not name.startswith("bert.")
    if section == "final":
        return lambda name: not name.startswith(
            ("bert.", "bert_pooler.", "classifier.")
        )
    return lambda name: True
