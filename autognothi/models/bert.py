"""Vanilla BERT family: classifier / surrogate / explainer / final.

Functional re-design of /root/reference/models/vanilla_bert.py: post-norm
encoder as a `lax.scan` over stacked layer params; the coalition mask enters
as the HF-style *additive* extended attention mask ((1-mask)*finfo.min added
to raw scores, vanilla_bert.py:521-523).  The classifier applies softmax
inside the model — downstream losses deliberately consume probabilities
(vanilla_bert.py:52,77).

Addition over the reference: `bert_surrogate_coalitions_fwd` computes the
(embedding lookup + LayerNorm) once per sentence and broadcasts the <B, T, H> tensor
across the coalition axis instead of replicating token ids host-side
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
    additive_mask_bias,
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
class VanillaBertConfig(Record):
    attention_probs_dropout_prob: float
    explainer_attn_num_layers: int
    explainer_head_hidden_size: int
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
    type_vocab_size: int
    vocab_size: int


# ------------------------------------------------------------------ init


def _init_bert_layer(key: jax.Array, cfg: VanillaBertConfig, ident_ln1: bool) -> Params:
    ks = jax.random.split(key, 6)
    p: Params = {}
    for name, k in zip(["query", "key", "value"], ks[:3]):
        w, b = init_linear(k, cfg.hidden_size, cfg.hidden_size)
        p[f"attention.self.{name}.weight"] = w
        p[f"attention.self.{name}.bias"] = b
    w, b = init_linear(ks[3], cfg.hidden_size, cfg.hidden_size)
    p["attention.output.dense.weight"] = w
    p["attention.output.dense.bias"] = b
    if not ident_ln1:
        (p["attention.output.LayerNorm.weight"],
         p["attention.output.LayerNorm.bias"]) = init_layer_norm(cfg.hidden_size)
    w, b = init_linear(ks[4], cfg.intermediate_size, cfg.hidden_size)
    p["intermediate.dense.weight"] = w
    p["intermediate.dense.bias"] = b
    w, b = init_linear(ks[5], cfg.hidden_size, cfg.intermediate_size)
    p["output.dense.weight"] = w
    p["output.dense.bias"] = b
    (p["output.LayerNorm.weight"],
     p["output.LayerNorm.bias"]) = init_layer_norm(cfg.hidden_size)
    return p


def init_bert_backbone(key: jax.Array, cfg: VanillaBertConfig) -> Params:
    k_w, k_p, k_t, k_enc = jax.random.split(key, 4)
    p: Params = {}
    word = init_embedding(k_w, cfg.vocab_size, cfg.hidden_size)
    word = word.at[cfg.pad_token_id].set(0.0)  # torch padding_idx init
    p["bert.embeddings.word_embeddings.weight"] = word
    p["bert.embeddings.position_embeddings.weight"] = init_embedding(
        k_p, cfg.max_position_embeddings, cfg.hidden_size
    )
    p["bert.embeddings.token_type_embeddings.weight"] = init_embedding(
        k_t, cfg.type_vocab_size, cfg.hidden_size
    )
    (p["bert.embeddings.LayerNorm.weight"],
     p["bert.embeddings.LayerNorm.bias"]) = init_layer_norm(cfg.hidden_size)
    for i, k in enumerate(jax.random.split(k_enc, cfg.num_hidden_layers)):
        for name, v in _init_bert_layer(k, cfg, ident_ln1=False).items():
            p[f"bert.encoder.layers.{i}.{name}"] = v
    return p


def init_bert_classifier(key: jax.Array, cfg: VanillaBertConfig) -> Params:
    k_bb, k_pool, k_head = jax.random.split(key, 3)
    p = init_bert_backbone(k_bb, cfg)
    w, b = init_linear(k_pool, cfg.hidden_size, cfg.hidden_size)
    p["bert_pooler.dense.weight"] = w
    p["bert_pooler.dense.bias"] = b
    w, b = init_linear(k_head, cfg.num_labels, cfg.hidden_size)
    p["classifier.weight"] = w
    p["classifier.bias"] = b
    return p


def init_bert_explainer(key: jax.Array, cfg: VanillaBertConfig) -> Params:
    k_bb, k_attn, k_mlp = jax.random.split(key, 3)
    p = init_bert_backbone(k_bb, cfg)
    for i, k in enumerate(jax.random.split(k_attn, cfg.explainer_attn_num_layers)):
        for name, v in _init_bert_layer(k, cfg, ident_ln1=(i == 0)).items():
            p[f"explainer_attn.{i}.{name}"] = v
    w_hid = cfg.explainer_head_hidden_size
    k0, k2, k4 = jax.random.split(k_mlp, 3)
    p["explainer_mlp.0.weight"], p["explainer_mlp.0.bias"] = init_linear(
        k0, w_hid, cfg.hidden_size
    )
    p["explainer_mlp.2.weight"], p["explainer_mlp.2.bias"] = init_linear(
        k2, w_hid, w_hid
    )
    p["explainer_mlp.4.weight"], p["explainer_mlp.4.bias"] = init_linear(
        k4, cfg.num_labels, w_hid
    )
    return p


def init_bert_final(key: jax.Array, cfg: VanillaBertConfig) -> Params:
    k_c, k_s, k_e = jax.random.split(key, 3)
    p: Params = {}
    for name, v in init_bert_classifier(k_c, cfg).items():
        p[f"classifier.{name}"] = v
    for name, v in init_bert_classifier(k_s, cfg).items():
        p[f"surrogate.{name}"] = v
    for name, v in init_bert_explainer(k_e, cfg).items():
        p[f"explainer.{name}"] = v
    p["surrogate_null"] = jnp.zeros((1, cfg.num_labels))
    return p


# ----------------------------------------------------------------- apply


def _rng(key: Optional[jax.Array], tag: int) -> Optional[jax.Array]:
    return None if key is None else jax.random.fold_in(key, tag)


def bert_embeddings(
    p: Params,
    cfg: VanillaBertConfig,
    input_ids: jax.Array,
    token_type_ids: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
    dtype=None,
) -> jax.Array:
    if dtype is None:
        # follow the parameter dtype: bf16-cast params compute in bf16
        # (an fp32 default silently upcast every bf16 serving path back
        # to fp32 — the BERT benches measured fp32 score math)
        dtype = p["embeddings.word_embeddings.weight"].dtype
    seq_len = input_ids.shape[-1]
    word = jnp.take(p["embeddings.word_embeddings.weight"], input_ids, axis=0)
    ttype = jnp.take(
        p["embeddings.token_type_embeddings.weight"], token_type_ids, axis=0
    )
    pos = p["embeddings.position_embeddings.weight"][:seq_len]
    emb = (word + ttype + pos).astype(dtype)
    emb = layer_norm(
        emb,
        p["embeddings.LayerNorm.weight"].astype(dtype),
        p["embeddings.LayerNorm.bias"].astype(dtype),
        cfg.layer_norm_eps,
    )
    return dropout(_rng(rng, 0), emb, cfg.hidden_dropout_prob, deterministic)


def _bert_layer_body(
    layer: Params,
    h: jax.Array,
    mask_bias: Optional[jax.Array],
    cfg: VanillaBertConfig,
    *,
    ident_ln1: bool,
    deterministic: bool,
    rng: Optional[jax.Array],
) -> jax.Array:
    """Post-norm BERT layer (vanilla_bert.py:410-427)."""
    ctx = self_attention(
        h,
        layer["attention.self.query.weight"], layer["attention.self.query.bias"],
        layer["attention.self.key.weight"], layer["attention.self.key.bias"],
        layer["attention.self.value.weight"], layer["attention.self.value.bias"],
        cfg.num_attention_heads,
        mask_bias,
        "additive",
        attn_dropout=cfg.attention_probs_dropout_prob,
        dropout_key=_rng(rng, 1),
        deterministic=deterministic,
    )
    attn_out = dense(
        ctx, layer["attention.output.dense.weight"],
        layer["attention.output.dense.bias"],
    )
    attn_out = dropout(
        _rng(rng, 2), attn_out, cfg.hidden_dropout_prob, deterministic
    )
    attn_out = attn_out + h
    if not ident_ln1:
        attn_out = layer_norm(
            attn_out,
            layer["attention.output.LayerNorm.weight"],
            layer["attention.output.LayerNorm.bias"],
            cfg.layer_norm_eps,
        )
    inter = gelu(dense(
        attn_out, layer["intermediate.dense.weight"],
        layer["intermediate.dense.bias"],
    ))
    out = dense(inter, layer["output.dense.weight"],
                layer["output.dense.bias"])
    out = dropout(_rng(rng, 3), out, cfg.hidden_dropout_prob, deterministic)
    pre_ln = out + attn_out
    return layer_norm(
        pre_ln,
        layer["output.LayerNorm.weight"],
        layer["output.LayerNorm.bias"],
        cfg.layer_norm_eps,
    )


def bert_encoder(
    p: Params,
    cfg: VanillaBertConfig,
    h: jax.Array,
    mask_bias: Optional[jax.Array],
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    stacked = stack_layer_params(p, "encoder.layers", cfg.num_hidden_layers,
                                 dtype=h.dtype)

    def body(carry, xs):
        layer, layer_idx = xs
        layer_rng = None if rng is None else jax.random.fold_in(rng, layer_idx)
        out = _bert_layer_body(
            layer, carry, mask_bias, cfg,
            ident_ln1=False, deterministic=deterministic, rng=layer_rng,
        )
        return out, None

    idxs = jnp.arange(cfg.num_hidden_layers)
    h, _ = jax.lax.scan(maybe_remat(body), h, (stacked, idxs))
    return h


def bert_backbone(
    p: Params,
    cfg: VanillaBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
    dtype=None,
) -> jax.Array:
    bp = subdict(p, "bert.")
    emb = bert_embeddings(
        bp, cfg, input_ids, token_type_ids,
        deterministic=deterministic, rng=_rng(rng, 10), dtype=dtype,
    )
    bias = additive_mask_bias(attention_mask, emb.dtype)
    return bert_encoder(
        bp, cfg, emb, bias, deterministic=deterministic, rng=_rng(rng, 11)
    )


def _cls_head(
    p: Params,
    h: jax.Array,
    cfg: VanillaBertConfig,
    *,
    deterministic: bool,
    rng: Optional[jax.Array],
) -> jax.Array:
    pooled = jnp.tanh(dense(
        h[:, 0, :],
        p["bert_pooler.dense.weight"].astype(h.dtype),
        p["bert_pooler.dense.bias"].astype(h.dtype),
    ))
    pooled = dropout(_rng(rng, 30), pooled, cfg.hidden_dropout_prob, deterministic)
    logits = dense(pooled, p["classifier.weight"].astype(h.dtype),
                   p["classifier.bias"].astype(h.dtype))
    return jax.nn.softmax(logits, axis=-1)


def bert_classifier_fwd(
    p: Params,
    cfg: VanillaBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
    dtype=None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    h = bert_backbone(
        p, cfg, input_ids, attention_mask, token_type_ids,
        deterministic=deterministic, rng=rng, dtype=dtype,
    )
    probs = _cls_head(p, h, cfg, deterministic=deterministic, rng=rng)
    return probs, {"repr_cls": h}


bert_surrogate_fwd = bert_classifier_fwd


def bert_explainer_head(
    p: Params,
    cfg: VanillaBertConfig,
    h: jax.Array,
    attention_mask: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
) -> jax.Array:
    bias = additive_mask_bias(attention_mask, h.dtype)
    for i in range(cfg.explainer_attn_num_layers):
        layer = subdict(p, f"explainer_attn.{i}.")
        h = _bert_layer_body(
            layer, h, bias, cfg,
            ident_ln1=(i == 0), deterministic=deterministic, rng=_rng(rng, 20 + i),
        )
    h = dropout(_rng(rng, 29), h, cfg.hidden_dropout_prob, deterministic)
    h = gelu(dense(h, p["explainer_mlp.0.weight"], p["explainer_mlp.0.bias"]))
    h = gelu(dense(h, p["explainer_mlp.2.weight"], p["explainer_mlp.2.bias"]))
    out = dense(h, p["explainer_mlp.4.weight"], p["explainer_mlp.4.bias"])
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, surrogate_grand, surrogate_null)
    return jnp.swapaxes(out[:, 1:, :], 1, 2)


def bert_explainer_fwd(
    p: Params,
    cfg: VanillaBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    surrogate_grand: jax.Array,
    surrogate_null: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
    dtype=None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    h = bert_backbone(
        p, cfg, input_ids, attention_mask, token_type_ids,
        deterministic=deterministic, rng=rng, dtype=dtype,
    )
    obs = {"repr_exp": h}
    attr = bert_explainer_head(
        p, cfg, h, attention_mask, surrogate_grand, surrogate_null,
        deterministic=deterministic, rng=rng,
    )
    return attr, obs


def bert_final_fwd(
    p: Params,
    cfg: VanillaBertConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    token_type_ids: jax.Array,
    *,
    deterministic: bool = True,
    rng: Optional[jax.Array] = None,
    dtype=None,
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    # per-tower rng folds: the same key in all three towers would draw
    # perfectly correlated dropout masks across them (the reference's
    # merged module draws independently per submodule)
    probs, obs_c = bert_classifier_fwd(
        subdict(p, "classifier."), cfg, input_ids, attention_mask, token_type_ids,
        deterministic=deterministic, rng=_rng(rng, 21), dtype=dtype,
    )
    obs = {"repr_cls": obs_c["repr_cls"]}
    if cfg.explainer_normalize:
        grand, obs_s = bert_surrogate_fwd(
            subdict(p, "surrogate."), cfg, input_ids, attention_mask, token_type_ids,
            deterministic=deterministic, rng=_rng(rng, 22), dtype=dtype,
        )
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = jnp.zeros_like(probs)
    attr, obs_e = bert_explainer_fwd(
        subdict(p, "explainer."), cfg, input_ids, attention_mask, token_type_ids,
        grand, p["surrogate_null"],
        deterministic=deterministic, rng=_rng(rng, 23), dtype=dtype,
    )
    obs["repr_exp"] = obs_e["repr_exp"]
    return probs, attr, obs


# ------------------------------------------------- coalition fast path


def bert_surrogate_coalitions_fwd(
    p: Params,
    cfg: VanillaBertConfig,
    input_ids: jax.Array,  # <B, T>
    masks: jax.Array,  # <B, M, T> (CLS column included)
    token_type_ids: jax.Array,  # <B, T>
    *,
    deterministic: bool = True,
    dtype=None,
) -> jax.Array:
    """Surrogate over B*M coalitions with the embedding computed once per
    sentence.  Returns <B, M, n_classes> probabilities."""
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only (the reference evaluates its surrogate teacher "
            "under model.eval()); dropout rngs are not threaded here"
        )
    b, m, t = masks.shape
    bp = subdict(p, "bert.")
    emb = bert_embeddings(bp, cfg, input_ids, token_type_ids, dtype=dtype)
    emb = jnp.broadcast_to(emb[:, None], (b, m, t, emb.shape[-1]))
    emb = emb.reshape(b * m, t, emb.shape[-1])
    bias = additive_mask_bias(masks.reshape(b * m, t), emb.dtype)
    h = bert_encoder(bp, cfg, emb, bias, deterministic=deterministic)
    probs = _cls_head(p, h, cfg, deterministic=deterministic, rng=None)
    return probs.reshape(b, m, -1)
