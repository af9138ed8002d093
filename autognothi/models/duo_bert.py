"""Duo vanilla BERT: one network trained on classification AND explanation
simultaneously (parity: /root/reference/models/duo_vanilla_bert.py).

Quirks preserved:
- the duo explainer's classification head emits RAW logits, no softmax
  (duo_vanilla_bert.py:142-144) — unlike every other classifier head;
- the Final has no separate classifier branch: (logits, shap) both come from
  the explainer (duo_vanilla_bert.py:166-205), so `verify_final_coherency`
  is off for this family.

The dual-task gradient probe exposes the shared input embedding as an
explicit function boundary so `jax.grad` can differentiate both losses with
respect to it — the functional replacement for backward hooks."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from .bert import (
    VanillaBertConfig,
    bert_embeddings,
    bert_encoder,
    bert_explainer_head,
    init_bert_classifier,
    init_bert_explainer,
)
from ..utils.records import project
from .common import Params, additive_mask_bias, dense, dropout, subdict


@dataclasses.dataclass
class DuoVanillaBertConfig(VanillaBertConfig):
    def into(self) -> VanillaBertConfig:
        return project(self, VanillaBertConfig)


init_duo_bert_classifier = init_bert_classifier


def init_duo_bert_explainer(key: jax.Array, cfg: DuoVanillaBertConfig) -> Params:
    """bert + pooler + raw-logit classifier head + explainer head."""
    k_cls, k_exp = jax.random.split(key)
    p = init_bert_classifier(k_cls, cfg)
    exp = init_bert_explainer(k_exp, cfg)
    for name, v in exp.items():
        if name.startswith(("explainer_attn.", "explainer_mlp.")):
            p[name] = v
    return p


def init_duo_bert_final(key: jax.Array, cfg: DuoVanillaBertConfig) -> Params:
    k_s, k_e = jax.random.split(key)
    p: Params = {}
    for name, v in init_bert_classifier(k_s, cfg).items():
        p[f"surrogate.{name}"] = v
    for name, v in init_duo_bert_explainer(k_e, cfg).items():
        p[f"explainer.{name}"] = v
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    return p


def duo_bert_explainer_from_emb(
    p: Params,
    cfg: DuoVanillaBertConfig,
    emb: jax.Array,  # <B, T, H> embedding output (the grad-probe boundary)
    attention_mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """-> (raw logits, attributions, observations)."""
    bias = additive_mask_bias(attention_mask, emb.dtype)
    # encoder folds raw layer_idx 0..L-1 off its key: fold tag 11 first
    # (vanilla convention, bert.py:332) so deep backbones (L > 20) cannot
    # collide with the explainer head's 20+i folds below
    h = bert_encoder(subdict(p, "bert."), cfg, emb, bias,
                     deterministic=deterministic,
                     rng=None if rng is None else jax.random.fold_in(rng, 11))
    obs = {"repr_cls": h, "repr_exp": h}
    pooled = jnp.tanh(dense(
        h[:, 0, :], p["bert_pooler.dense.weight"].astype(h.dtype),
        p["bert_pooler.dense.bias"].astype(h.dtype),
    ))
    pooled = dropout(
        None if rng is None else jax.random.fold_in(rng, 30),
        pooled, cfg.hidden_dropout_prob, deterministic,
    )
    logits = dense(pooled, p["classifier.weight"].astype(h.dtype),
                   p["classifier.bias"].astype(h.dtype))  # RAW, no softmax
    attr = bert_explainer_head(
        p, cfg, h, attention_mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )
    return logits, attr, obs


def duo_bert_explainer_fwd(
    p: Params,
    cfg: DuoVanillaBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    emb = bert_embeddings(
        subdict(p, "bert."), cfg, input_ids, token_type_ids,
        deterministic=deterministic,
        rng=None if rng is None else jax.random.fold_in(rng, 10),
    )
    return duo_bert_explainer_from_emb(
        p, cfg, emb, attention_mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )


def duo_bert_final_fwd(
    p: Params,
    cfg: DuoVanillaBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    from .bert import bert_surrogate_fwd

    obs: Dict[str, jax.Array] = {}
    if cfg.explainer_normalize:
        # per-tower rng folds (vanilla convention, bert.py:461-475): the
        # same key in both towers draws perfectly correlated dropout masks
        grand, obs_s = bert_surrogate_fwd(
            subdict(p, "surrogate."), cfg, input_ids, attention_mask,
            token_type_ids, deterministic=deterministic,
            rng=None if rng is None else jax.random.fold_in(rng, 22),
        )
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = jnp.zeros((input_ids.shape[0], cfg.num_labels))
    logits, attr, obs_e = duo_bert_explainer_fwd(
        subdict(p, "explainer."), cfg, input_ids, attention_mask,
        token_type_ids, grand, p["surrogate_null"],
        deterministic=deterministic,
        rng=None if rng is None else jax.random.fold_in(rng, 23),
    )
    # quirk preserved: the duo final reports repr_cls from the explainer's
    # observations (duo_vanilla_bert.py:200-204)
    obs["repr_cls"] = obs_e["repr_cls"]
    obs["repr_exp"] = obs_e["repr_exp"]
    return logits, attr, obs
