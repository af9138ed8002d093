"""KernelSHAP BERT baseline (parity: /root/reference/models/
kernel_shap_bert.py): the "explainer" is just a stored, k-means-compressed
background token matrix `Xs_train`; the Final runs the frozen classifier and
estimates attributions per call via the WLS KernelSHAP solver in
ops.kernel_shap."""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from .bert import VanillaBertConfig, init_bert_classifier
from ..utils.records import project
from .common import Params


@dataclasses.dataclass
class KernelShapBertConfig(VanillaBertConfig):
    kernel_shap_n_samples: int
    kernel_shap_data_size: int

    def into(self) -> VanillaBertConfig:
        return project(self, VanillaBertConfig)


init_kernel_shap_classifier = init_bert_classifier


def init_kernel_shap_explainer(key: jax.Array, cfg: KernelShapBertConfig) -> Params:
    """Only the stored background token rows (kernel_shap_bert.py:81-102)."""
    del key
    return {
        "Xs_train": jnp.zeros(
            (cfg.kernel_shap_data_size, cfg.max_position_embeddings),
            dtype=jnp.int32,
        )
    }


def init_kernel_shap_final(key: jax.Array, cfg: KernelShapBertConfig) -> Params:
    p: Params = {}
    for name, v in init_bert_classifier(key, cfg).items():
        p[f"classifier.{name}"] = v
    for name, v in init_kernel_shap_explainer(key, cfg).items():
        p[f"explainer.{name}"] = v
    return p
