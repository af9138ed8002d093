"""The per-architecture recipe contract — the only interface the pipeline
layer uses to touch models.

A functional re-design of the reference's ModelRecipe (/root/reference/
recipes/types.py:96-162): constructors become `(key, cfg) -> Params` init
fns, conversion chains operate on flat param dicts through the surgery DSL,
and the forward adapters are *pure* jittable functions.  The four-stage
contract (classifier -> surrogate -> explainer -> final) and the uniform
`(params, Xs, mask)` adapter shapes are preserved so nine architectures share
one pipeline.

Extension: `fw_surrogate_coalitions` — a batched adapter over the
<B, M, P> coalition axis letting trainers and faithfulness sweeps avoid input
replication (the primary vmapped/sharded hot path).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Callable, Dict, Optional, Tuple, Type

import jax
import numpy as np

Params = Dict[str, jax.Array]

# (params, Xs, mask) -> (Ys, Ys_aux)
FwClassifier = Callable[..., Tuple[jax.Array, jax.Array]]
# (params, Xs, mask) -> (Ys, extra?)
FwSurrogate = Callable[..., Tuple[jax.Array, Optional[jax.Array]]]
# (params, Xs, mask, grand, null) -> (shap, extra?)
FwExplainer = Callable[..., Tuple[jax.Array, Optional[jax.Array]]]
# (params, Xs) -> (Ys, shap)
FwFinal = Callable[..., Tuple[jax.Array, jax.Array]]
# (params, Xs, masks <B, M, P>) -> <B, M, n_classes>
FwSurrogateCoalitions = Callable[..., jax.Array]


@dataclasses.dataclass
class ModelRecipe_Training:
    support_classifier: bool
    support_surrogate: bool
    support_explainer: bool
    exp_variant_duo: bool
    exp_variant_kernel_shap: bool


@dataclasses.dataclass
class ModelRecipe_Measurements_DualTaskSimilarity:
    allow: bool
    # (cfg, params, xs, mask, grand, null, zs, masks_bmp, v_0, v_s, v_1)
    #   -> per-loss gradients wrt the input embeddings — the actual
    # contract implemented by recipes/duo_vanilla_{bert,vit}.py and
    # consumed by pipeline/measure_dual_task_similarity.py
    grad_probe: Callable[..., Any]


@dataclasses.dataclass
class ModelRecipe_Measurements:
    verify_final_coherency: bool
    allow_accuracy: bool
    allow_faithfulness: bool
    allow_cls_acc: bool
    allow_performance_cls: bool
    allow_performance_srg_exp: bool
    allow_performance_fin: bool
    allow_train_resources: bool
    allow_dual_task_similarity: Any  # False | ModelRecipe_Measurements_DualTaskSimilarity
    allow_branches_cka: bool


@dataclasses.dataclass
class ModelRecipe:
    id: str
    version: str
    t_config: Type[Any]  # config record (utils.records.Record)

    # fresh param layouts  :: (key, cfg) -> Params
    init_classifier: Callable[[jax.Array, Any], Params]
    init_surrogate: Callable[[jax.Array, Any], Params]
    init_explainer: Callable[[jax.Array, Any], Params]
    init_final: Callable[[jax.Array, Any], Params]

    # misc (tokenizer etc.)  :: (model_path, cfg) -> Misc
    load_misc: Callable[[pathlib.Path, Any], Any]

    # weight conversion chain over flat param dicts; `key` seeds New() inits
    #   (cfg, pretrained_bundle, key) -> Params
    conv_pretrained_classifier: Callable[..., Params]
    #   (cfg, misc, classifier_params, key) -> Params
    conv_classifier_surrogate: Callable[..., Params]
    #   (cfg, misc, surrogate_params, key) -> Params
    conv_surrogate_explainer: Callable[..., Params]
    #   (cfg, misc, cls_params, srg_params, exp_params, key) -> Params
    conv_explainer_final: Callable[..., Params]

    # geometry & data adapters
    n_players: Callable[[Any], int]
    #   (cfg, misc) -> callable(raw_xs, raw_ys) -> (np Xs, np Ys)
    gen_input: Callable[[Any, Any], Callable[[Any, Any], Tuple[np.ndarray, np.ndarray]]]
    #   (cfg, misc) -> np Xs <1, ...>
    gen_null: Callable[[Any, Any], np.ndarray]

    training: ModelRecipe_Training

    # forward adapters (pure; first arg cfg, then params)
    fw_classifier: FwClassifier
    fw_surrogate: FwSurrogate
    fw_explainer: FwExplainer
    fw_final: FwFinal
    # fast path over the coalition axis (None -> fall back to replication)
    fw_surrogate_coalitions: Optional[FwSurrogateCoalitions]

    measurements: ModelRecipe_Measurements

    # optimizer partitioning: which params receive gradient updates in a
    # given training section (the JAX analogue of `.requires_grad` freezing,
    # /root/reference/utils/nnmodel.py:48-60). (cfg, section) -> name -> bool
    trainable: Callable[[Any, str], Callable[[str], bool]] = (
        lambda cfg, section: (lambda name: True)
    )

    # True when fw_final runs HOST-side (e.g. KernelSHAP's numpy WLS
    # solver): consumers must NOT wrap it in jax.jit — tracing its
    # np.asarray calls raises TracerArrayConversionError
    fw_final_host: bool = False

    # LTT progressive training support: (cfg, section, epoch) -> extra
    # name-filter applied on top of `trainable`, or None when unsupported
    progressive_trainable: Optional[
        Callable[[Any, str, int], Callable[[str], bool]]
    ] = None

    # representation observers (the functional analogue of the reference's
    # ObservableModuleMixin, utils/nnmodel.py:194-239) — used by the CKA
    # report.  (cfg, params, Xs, mask[, grand, null]) -> (out, hidden <B,T,H>)
    fw_classifier_repr: Optional[Callable[..., Tuple[jax.Array, jax.Array]]] = None
    fw_explainer_repr: Optional[Callable[..., Tuple[jax.Array, jax.Array]]] = None


def surrogate_coalition_values(
    recipe: "ModelRecipe", m_config: Any, srg_params: Params, xs, masks_bmp
):
    """<B, M, P> coalition masks -> <B*M, C> masked surrogate values.

    The one teacher-sweep primitive shared by the explainer trainers, the
    fused sharded train step, and the faithfulness sweep: dispatches to the
    recipe's embed-once `fw_surrogate_coalitions` fast path when present,
    else replicates inputs along the coalition axis (reference semantics,
    /root/reference/scripts/train_explainer.py:129-141)."""
    import jax.numpy as jnp

    b, m, p = masks_bmp.shape
    if recipe.fw_surrogate_coalitions is not None:
        v_s = recipe.fw_surrogate_coalitions(m_config, srg_params, xs, masks_bmp)
        return v_s.reshape(b * m, -1)
    xs_ext = jnp.repeat(xs, m, axis=0)
    v_s, _ = recipe.fw_surrogate(
        m_config, srg_params, xs_ext, masks_bmp.reshape(b * m, p)
    )
    return v_s
