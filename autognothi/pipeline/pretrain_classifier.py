"""Base-model fine-tuner: fully unfreezes the classifier, trains it on the
experiment dataset, and exports it into the zoo store as an `ft_*` base
model (parity: /root/reference/scripts/pretrain_classifier.py; also
subsumes the unregistered text variant scripts/pretrain_text_cls.py:13-40
— its tokenizer-artifact export is the `tokenizer` branch below, and this
module accepts both vanilla_bert and vanilla_vit)."""

from __future__ import annotations

import json

from ..zoo.loader import save_local_ft
from .env import ExpEnv
from .resources import get_recipe, latest_epoch, load_epoch_model
from .train_all import conv_pretrained_classifier
from .train_classifier import train_classifier


def pretrain_classifier(env: ExpEnv) -> None:
    env.log("[[[ fine-tune pretrained model ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_classifier:
        raise ValueError("cannot fine-tune model: classification not supported")
    if config.net.kind not in ("vanilla_bert", "vanilla_vit"):
        raise ValueError(f"unsupported model kind: {config.net.kind}")

    # existence probe only — never load a (potentially GB-scale) payload
    # just to detect the stage (same rationale as train_all.detect_stage)
    epoch_cls = latest_epoch(
        env.model_path, "classifier", config.train_classifier.epochs
    )
    if epoch_cls is None:
        env.log(":: initializing ft model")
        conv_pretrained_classifier(env)
        epoch_cls = 0
    if epoch_cls < config.train_classifier.epochs:
        env.log(f":: training ft model from epoch {epoch_cls}")
        train_classifier(env, unfreeze_all=True)

    m_misc = recipe.load_misc(env.model_path, m_config)
    epoch_cls, cls_params = load_epoch_model(env, recipe, "classifier")
    if epoch_cls < config.train_classifier.epochs:
        raise ValueError("classifier not fully trained")

    tokenizer = getattr(m_misc, "tokenizer", None)
    dest = save_local_ft(env.model_path.name, cls_params, tokenizer)
    with open(dest / "model.json", "w", encoding="utf-8") as f:
        f.write(json.dumps(m_config.to_dict(), indent=2))
    env.log(f"[[[ fine-tuning complete -> {dest} ]]]")
