"""The experiment configuration tree (`.hparams.json`).

Byte-compatible with the reference schema (scripts/types.py:256-296 of the
reference): same field names, same tagged unions over datasets and the nine
net kinds, same `$schema` alias, same `flatten_dump` used by loggers.  One
additive extension: the fully-offline `cv_samples` synthetic dataset.  The
classes are `utils.records.Record` dataclasses.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import ClassVar, Dict, Literal, Optional, Union

from ..data.loader import CvTransforms
from ..models.bert import VanillaBertConfig
from ..models.duo_bert import DuoVanillaBertConfig
from ..models.duo_vit import DuoVanillaViTConfig
from ..models.froyo_bert import FroyoBertConfig
from ..models.froyo_vit import FroyoViTConfig
from ..models.kernel_shap_bert import KernelShapBertConfig
from ..models.ltt_bert import LttBertConfig
from ..models.ltt_vit import LttViTConfig
from ..models.vit import VanillaViTConfig
from ..utils.records import Record
from ..utils.strings import flatten_dict

ConfigRelPath = str


def resolve_config_rel_path(
    rel_path: ConfigRelPath, root_dir_at: pathlib.Path
) -> pathlib.Path:
    parts = rel_path.replace("\\", "/").split("/")
    if parts and parts[0] in (".", ".."):
        return root_dir_at.joinpath(rel_path).resolve()
    return pathlib.Path(rel_path).resolve()


# ------------------------------------------------------------- datasets


@dataclasses.dataclass(kw_only=True)
class Config_Dataset_NlpSamples(Record):
    kind: Literal["nlp_samples"] = "nlp_samples"


@dataclasses.dataclass(kw_only=True)
class Config_Dataset_YelpPolarityMini(Record):
    kind: Literal["yelp_polarity_mini"] = "yelp_polarity_mini"


@dataclasses.dataclass(kw_only=True)
class Config_Dataset_YelpPolarity(Record):
    kind: Literal["yelp_polarity"] = "yelp_polarity"
    train_size: int
    test_size: int
    test_seed: int


@dataclasses.dataclass(kw_only=True)
class Config_Dataset_ImageNette(Record):
    kind: Literal["imagenette"] = "imagenette"
    train_size: int
    test_size: int
    test_seed: int
    transforms: CvTransforms


@dataclasses.dataclass(kw_only=True)
class Config_Dataset_CvSamples(Record):
    """Extension: offline synthetic image set for tests and smoke runs."""

    kind: Literal["cv_samples"] = "cv_samples"
    train_size: int
    test_size: int
    img_px_size: int
    num_classes: int
    seed: int = 1234


Config_Dataset = Union[
    Config_Dataset_NlpSamples,
    Config_Dataset_YelpPolarityMini,
    Config_Dataset_YelpPolarity,
    Config_Dataset_ImageNette,
    Config_Dataset_CvSamples,
]

Config_Dataset_Kind = Literal[
    "nlp_samples",
    "yelp_polarity_mini",
    "yelp_polarity",
    "imagenette",
    "cv_samples",
]


# ------------------------------------------------------------ base models


Config_Net_BaseModel_BertClassifier = Literal[
    "bert_tayp",
    "prj_bert_mini",
    "prj_bert_small",
    "prj_bert_medium",
    "gg_bert_base",
    "gg_bert_large",
    "ft_bert_base_yelp",
    "ft_bert_large_yelp",
    "ft_bert_medium_yelp",
    "ft_bert_mini_yelp",
    "ft_bert_small_yelp",
    # extension: fully offline deterministic random init
    "random_init",
]

Config_Net_BaseModel_ViTClassifier = Literal[
    "gg_vit_tiny",
    "gg_vit_small",
    "gg_vit_base",
    "gg_vit_large",
    "ft_vit_tiny_imagenette",
    "ft_vit_small_imagenette",
    "ft_vit_base_imagenette",
    "ft_vit_large_imagenette",
    "random_init",
]


# ----------------------------------------------------------------- nets


@dataclasses.dataclass(kw_only=True)
class Config_Net_VanillaBert(Record):
    kind: Literal["vanilla_bert"] = "vanilla_bert"
    version: str
    base_model: Config_Net_BaseModel_BertClassifier
    params: VanillaBertConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_VanillaViT(Record):
    kind: Literal["vanilla_vit"] = "vanilla_vit"
    version: str
    base_model: Config_Net_BaseModel_ViTClassifier
    params: VanillaViTConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_LttBert(Record):
    kind: Literal["ltt_bert"] = "ltt_bert"
    version: str
    base_model: Config_Net_BaseModel_BertClassifier
    params: LttBertConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_LttViT(Record):
    kind: Literal["ltt_vit"] = "ltt_vit"
    version: str
    base_model: Config_Net_BaseModel_ViTClassifier
    params: LttViTConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_FroyoBert(Record):
    kind: Literal["froyo_bert"] = "froyo_bert"
    version: str
    base_model: Config_Net_BaseModel_BertClassifier
    params: FroyoBertConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_FroyoViT(Record):
    kind: Literal["froyo_vit"] = "froyo_vit"
    version: str
    base_model: Config_Net_BaseModel_ViTClassifier
    params: FroyoViTConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_DuoVanillaBert(Record):
    kind: Literal["duo_vanilla_bert"] = "duo_vanilla_bert"
    version: str
    base_model: Config_Net_BaseModel_BertClassifier
    params: DuoVanillaBertConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_DuoVanillaViT(Record):
    kind: Literal["duo_vanilla_vit"] = "duo_vanilla_vit"
    version: str
    base_model: Config_Net_BaseModel_ViTClassifier
    params: DuoVanillaViTConfig


@dataclasses.dataclass(kw_only=True)
class Config_Net_KernelShapBert(Record):
    kind: Literal["kernel_shap_bert"] = "kernel_shap_bert"
    version: str
    base_model: Config_Net_BaseModel_BertClassifier
    params: KernelShapBertConfig


Config_Net = Union[
    Config_Net_DuoVanillaBert,
    Config_Net_DuoVanillaViT,
    Config_Net_FroyoBert,
    Config_Net_FroyoViT,
    Config_Net_KernelShapBert,
    Config_Net_LttBert,
    Config_Net_LttViT,
    Config_Net_VanillaBert,
    Config_Net_VanillaViT,
]


# ------------------------------------------------------------- training


@dataclasses.dataclass(kw_only=True)
class Config_Train(Record):
    epochs: int  # always resume from last known checkpoint
    ckpt_when: str  # cadence DSL, e.g. `<=5:%2==0; <=10:%3==0`
    lr: float
    batch_size: int
    EXPERIMENTAL_progressive_training: Optional[bool] = None


@dataclasses.dataclass(kw_only=True)
class Config_Train_Explainer(Config_Train):
    n_mask_samples: int
    lambda_efficiency: float
    lambda_norm: float


# ----------------------------------------------------------------- eval


@dataclasses.dataclass(kw_only=True)
class Config_Eval_Accuracy(Record):
    dataset: Optional[Config_Dataset]
    batch_size: int
    resolution: int


@dataclasses.dataclass(kw_only=True)
class Config_Eval_Faithfulness(Record):
    dataset: Optional[Config_Dataset]
    batch_size: int
    resolution: int


@dataclasses.dataclass(kw_only=True)
class Config_Eval_ClsAcc(Record):
    dataset: Optional[Config_Dataset]
    on_exp_epochs: Optional[str]
    batch_size: int


@dataclasses.dataclass(kw_only=True)
class Config_Eval_Performance(Record):
    dataset: Optional[Config_Dataset]
    loops: int


@dataclasses.dataclass(kw_only=True)
class Config_Eval_TrainResources(Record):
    dataset: Optional[Config_Dataset]
    batch_size: int
    max_samples: int


@dataclasses.dataclass(kw_only=True)
class Config_Eval_BranchesCka(Record):
    dataset: Optional[Config_Dataset]
    batch_size: int


@dataclasses.dataclass(kw_only=True)
class Config_Eval_DualTaskSimilarity(Record):
    dataset: Optional[Config_Dataset]
    batch_size: int


@dataclasses.dataclass(kw_only=True)
class Config_Logger(Record):
    wandb_enabled: bool
    wandb_project: str
    wandb_name: str
    # set automatically upon update
    wandb_run_id: Optional[str] = None
    wandb_global_step: Optional[int] = None


@dataclasses.dataclass(kw_only=True)
class ExpConfig(Record):
    _aliases: ClassVar[Dict[str, str]] = {"schema_version": "$schema"}

    schema_version: Optional[str] = None

    seed: int
    dataset: Config_Dataset
    net: Config_Net
    train_classifier: Config_Train
    train_surrogate: Config_Train
    train_explainer: Config_Train_Explainer
    logger_classifier: Optional[Config_Logger] = None
    logger_surrogate: Optional[Config_Logger] = None
    logger_explainer: Optional[Config_Logger] = None
    eval_accuracy: Config_Eval_Accuracy
    eval_faithfulness: Config_Eval_Faithfulness
    eval_cls_acc: Config_Eval_ClsAcc
    eval_performance: Config_Eval_Performance
    eval_train_resources: Config_Eval_TrainResources
    eval_branches_cka: Optional[Config_Eval_BranchesCka] = None
    eval_dual_task_similarity: Optional[Config_Eval_DualTaskSimilarity] = None

    def flatten_dump(self) -> dict:
        ret = self.to_dict()
        for k in ("logger_classifier", "logger_surrogate", "logger_explainer"):
            ret.pop(k, None)
        return flatten_dict(ret)

