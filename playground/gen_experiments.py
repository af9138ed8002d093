"""Generate the shipped experiment configurations.

Produces the reference's 15 experiment directories (SURVEY §2 row 51) with
`.hparams.json` files valid against `experiments/hparams_schema.json`:
vanilla/froyo/duo/ltt/kernel-shap BERT on yelp, vanilla ViT tiny/small/base/
large on imagenette, and the ft_* fine-tuning configs.

Run: python playground/gen_experiments.py
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

EXP_DIR = pathlib.Path(__file__).parent.parent / "experiments"

VIT_SIZES = {
    "tiny": dict(hidden_size=192, intermediate_size=768, num_attention_heads=3,
                 num_hidden_layers=12),
    "small": dict(hidden_size=384, intermediate_size=1536,
                  num_attention_heads=6, num_hidden_layers=12),
    "base": dict(hidden_size=768, intermediate_size=3072,
                 num_attention_heads=12, num_hidden_layers=12),
    "large": dict(hidden_size=1024, intermediate_size=4096,
                  num_attention_heads=16, num_hidden_layers=24),
}

BERT_BASE = dict(hidden_size=768, intermediate_size=3072,
                 num_attention_heads=12, num_hidden_layers=12)


def _loggers():
    return {
        f"logger_{stage}": {
            "wandb_enabled": False,
            "wandb_project": "<project>",
            "wandb_name": "<name>",
        }
        for stage in ("classifier", "surrogate", "explainer")
    }


def _evals(batch_size=8):
    return {
        "eval_accuracy": {"dataset": None, "batch_size": batch_size,
                          "resolution": 8},
        "eval_faithfulness": {"dataset": None, "batch_size": batch_size,
                              "resolution": 4},
        "eval_cls_acc": {"dataset": None, "on_exp_epochs": None,
                         "batch_size": batch_size},
        "eval_performance": {"dataset": None, "loops": 2},
        "eval_train_resources": {"dataset": None, "batch_size": 2,
                                 "max_samples": 32},
    }


def _train(epochs, lr=5e-5, batch_size=8, ckpt="<=20:%2==0; _:%5==0"):
    return {"epochs": epochs, "ckpt_when": ckpt, "lr": lr,
            "batch_size": batch_size}


def _train_exp(epochs, lr=5e-5, batch_size=4):
    out = _train(epochs, lr, batch_size,
                 ckpt="<=20:%2==0; <=50:%5==0; _:%10==0")
    out.update({"n_mask_samples": 2, "lambda_efficiency": 0.0,
                "lambda_norm": 0.0})
    return out


def vit_params(size: str, explainer=True, ltt=False):
    dims = VIT_SIZES[size]
    p = {
        "attention_probs_dropout_prob": 0.1,
        "explainer_normalize": True,
        "hidden_dropout_prob": 0.1,
        "layer_norm_eps": 1e-12,
        "num_labels": 10,
        "img_channels": 3,
        "img_px_size": 224,
        "img_patch_size": 16,
        **dims,
    }
    if ltt:
        p["explainer_s_attn_num_layers"] = 1
        p["explainer_s_head_hidden_size"] = dims["intermediate_size"]
        p["s_attn_hidden_size"] = dims["hidden_size"] // 8
        p["s_attn_intermediate_size"] = dims["intermediate_size"] // 8
    else:
        p["explainer_attn_num_layers"] = 1
        p["explainer_head_hidden_size"] = dims["intermediate_size"]
    return p


def bert_params(explainer=True, ltt=False, kernel_shap=False):
    p = {
        "attention_probs_dropout_prob": 0.1,
        "explainer_normalize": True,
        "hidden_dropout_prob": 0.1,
        "layer_norm_eps": 1e-12,
        "max_position_embeddings": 512,
        "num_labels": 2,
        "pad_token_id": 0,
        "type_vocab_size": 2,
        "vocab_size": 30522,
        **BERT_BASE,
    }
    if ltt:
        p["explainer_s_attn_num_layers"] = 1
        p["explainer_s_head_hidden_size"] = 3072
        p["s_attn_hidden_size"] = 96
        p["s_attn_intermediate_size"] = 384
    else:
        p["explainer_attn_num_layers"] = 1
        p["explainer_head_hidden_size"] = 3072
    if kernel_shap:
        p["kernel_shap_n_samples"] = 2048
        p["kernel_shap_data_size"] = 16
    return p


def yelp_dataset():
    return {"kind": "yelp_polarity", "train_size": 8, "test_size": 4,
            "test_seed": 42}


def imagenette_dataset():
    return {
        "kind": "imagenette", "train_size": 8, "test_size": 4,
        "test_seed": 10086,
        "transforms": {"resize": {"height": 224, "width": 224}},
    }


def make_config(dataset, net, cls_epochs=0, srg_epochs=5, exp_epochs=5):
    return {
        "$schema": "../hparams_schema.json",
        "seed": 3407,
        "dataset": dataset,
        "net": net,
        "train_classifier": _train(cls_epochs),
        "train_surrogate": _train(srg_epochs),
        "train_explainer": _train_exp(exp_epochs),
        **_loggers(),
        **_evals(),
    }


def main() -> None:
    configs = {}

    # BERT track on yelp (bert_tayp base)
    for name, kind, params in [
        ("bert_base_tayp_vanilla", "vanilla_bert", bert_params()),
        ("bert_base_tayp_froyo", "froyo_bert", bert_params()),
        ("bert_base_tayp_duo_vanilla", "duo_vanilla_bert", bert_params()),
        ("bert_base_tayp_ltt", "ltt_bert", bert_params(ltt=True)),
        ("bert_base_tayp_kernel_shap", "kernel_shap_bert",
         bert_params(kernel_shap=True)),
    ]:
        configs[name] = make_config(
            yelp_dataset(),
            {"kind": kind, "version": "beta.1.01", "base_model": "bert_tayp",
             "params": params},
        )

    # ViT track on imagenette (locally fine-tuned bases)
    for size in ("tiny", "small", "base", "large"):
        configs[f"vit_{size}_imagenette_vanilla"] = make_config(
            imagenette_dataset(),
            {"kind": "vanilla_vit", "version": "beta.1.01",
             "base_model": f"ft_vit_{size}_imagenette",
             "params": vit_params(size)},
        )

    # fine-tuning configs: train the classifier itself
    for size in ("tiny", "small", "base", "large"):
        cfg = make_config(
            imagenette_dataset(),
            {"kind": "vanilla_vit", "version": "beta.1.01",
             "base_model": f"gg_vit_{size}", "params": vit_params(size)},
            cls_epochs=5, srg_epochs=0, exp_epochs=0,
        )
        cfg["train_classifier"]["lr"] = 1e-4
        configs[f"ft_vit_{size}_imagenette"] = cfg
    cfg = make_config(
        yelp_dataset(),
        {"kind": "vanilla_bert", "version": "beta.1.01",
         "base_model": "gg_bert_base", "params": bert_params()},
        cls_epochs=3, srg_epochs=0, exp_epochs=0,
    )
    cfg["train_classifier"]["lr"] = 2e-5
    configs["ft_bert_base_yelp"] = cfg

    from autognothi.pipeline.config import ExpConfig

    # experiments/hparams_schema.json (the `$schema` every config names) is
    # kept as committed: the config records validate, they emit no schema
    EXP_DIR.mkdir(exist_ok=True)

    for name, cfg in configs.items():
        ExpConfig.from_dict(cfg)  # fail fast on schema drift
        exp = EXP_DIR / name
        exp.mkdir(exist_ok=True)
        with open(exp / ".hparams.json", "w", encoding="utf-8") as f:
            f.write(json.dumps(cfg, indent=2) + "\n")
        print(f"config --> {exp / '.hparams.json'}")


if __name__ == "__main__":
    main()
