"""Recipe: KernelSHAP BERT baseline (parity: /root/reference/recipes/
kernel_shap_bert.py).  `fw_final` runs the full WLS estimation per call —
attributions cover ALL token columns with the CLS column dropped at the end
(kernel_shap_bert.py:183-186)."""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import RECIPE_VERSION
from ..data.tokenizer import load_tokenizer
from ..models.kernel_shap_bert import (
    KernelShapBertConfig,
    init_kernel_shap_classifier,
    init_kernel_shap_explainer,
    init_kernel_shap_final,
)
from ..ops.kernel_shap import kernel_shap
from ..utils.surgery import New, merge_param_dicts
from . import vanilla_bert as vb
from .types import ModelRecipe, ModelRecipe_Measurements, ModelRecipe_Training


@dataclasses.dataclass
class KernelShapBertMisc:
    tokenizer: Any


def _load_misc(m_path: pathlib.Path, cfg) -> KernelShapBertMisc:
    return KernelShapBertMisc(tokenizer=load_tokenizer(m_path / "tokenizer"))


def conv_surrogate_explainer(cfg, _misc, surrogate, key):
    dst = init_kernel_shap_explainer(key, cfg)
    return merge_param_dicts(
        ({"{_}": None, New(): "Xs_train"}, surrogate), into=dst
    )


def conv_explainer_final(cfg, misc, classifier, _surrogate, explainer, key):
    dst = init_kernel_shap_final(key, cfg)
    return merge_param_dicts(
        ({"{_}": "classifier.{_}"}, classifier),
        ({"Xs_train": "explainer.Xs_train"}, explainer),
        into=dst,
    )


def fw_explainer(cfg, params, xs, mask, grand, null, **kw):
    raise NotImplementedError("explainer model not available for KernelSHAP")


@functools.lru_cache(maxsize=8)
def _make_cls_fwd(cfg_json: str):
    """One compiled classifier per config — params are traced ARGUMENTS, so
    per-sample fw_final calls reuse the executable instead of re-tracing
    and compiling a fresh closure every call."""
    cfg = KernelShapBertConfig(**json.loads(cfg_json))

    @jax.jit
    def fwd(cls_params, rows):
        mask = jnp.ones_like(rows)
        ttype = jnp.zeros_like(rows)
        from ..models.bert import bert_classifier_fwd

        probs, _ = bert_classifier_fwd(cls_params, cfg, rows, mask, ttype)
        return probs

    return fwd


def _classifier_on_rows(cfg, cls_params):
    """Batched classifier over raw token rows (mask all-ones); the jitted
    forward is cached per-config with params as traced arguments."""
    fwd = _make_cls_fwd(json.dumps(cfg.to_dict()))

    def fn(rows_np: np.ndarray) -> np.ndarray:
        from ..utils.functional import iter_fixed_batches

        rows_np = np.asarray(rows_np, dtype=np.int64)
        outs = [
            np.asarray(fwd(cls_params, jnp.asarray(part)))[:real]
            for (part,), real in iter_fixed_batches([rows_np], 64)
        ]
        return np.concatenate(outs, axis=0)

    return fn


def fw_final(cfg, params, xs, **kw):
    """HOST-side final (recipe sets fw_final_host=True — consumers must not
    jit this): the WLS Shapley estimation is numpy; only the classifier
    forwards run on device through one cached executable."""
    from ..models.common import subdict

    cls_params = subdict(params, "classifier.")
    fn = _classifier_on_rows(cfg, cls_params)
    probs = jnp.asarray(fn(np.asarray(xs, dtype=np.int64)))
    background = np.asarray(params["explainer.Xs_train"], dtype=np.int64)
    bg_weights = np.ones(background.shape[0])
    attrs = []
    for row in np.asarray(xs, dtype=np.int64):
        phi = kernel_shap(
            fn, background, bg_weights, row,
            n_samples=cfg.kernel_shap_n_samples,
        )  # <C, T>
        attrs.append(phi[:, 1:])  # drop the CLS column
    return probs, jnp.asarray(np.stack(attrs), dtype=jnp.float32)


def kernel_shap_bert_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="kernel_shap_bert",
        version=RECIPE_VERSION,
        t_config=KernelShapBertConfig,
        init_classifier=init_kernel_shap_classifier,
        init_surrogate=init_kernel_shap_classifier,
        init_explainer=init_kernel_shap_explainer,
        init_final=init_kernel_shap_final,
        load_misc=_load_misc,
        conv_pretrained_classifier=vb.conv_pretrained_classifier,
        conv_classifier_surrogate=vb.conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        n_players=lambda cfg: cfg.max_position_embeddings - 1,
        gen_input=vb._gen_input,
        gen_null=lambda cfg, misc: vb._null_ids(cfg, misc),
        training=ModelRecipe_Training(
            support_classifier=False,
            support_surrogate=False,
            support_explainer=True,
            exp_variant_duo=False,
            exp_variant_kernel_shap=True,
        ),
        fw_classifier=vb.fw_classifier,
        fw_surrogate=vb.fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_final_host=True,
        fw_surrogate_coalitions=vb.fw_surrogate_coalitions,
        measurements=ModelRecipe_Measurements(
            verify_final_coherency=False,
            allow_accuracy=False,
            allow_faithfulness=True,
            allow_cls_acc=False,
            allow_performance_cls=False,
            allow_performance_srg_exp=False,
            allow_performance_fin=False,
            allow_train_resources=False,
            allow_dual_task_similarity=False,
            allow_branches_cka=False,
        ),
        trainable=lambda cfg, section: (lambda name: False),
    )
