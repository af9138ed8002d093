"""Run the torch reference pipeline OFFLINE (train_all + measure_all).

The reference (/root/reference, read-only) normally needs the HF hub for
its pretrained base (`params/loader.py:61-99`) and wandb/shap/torchvision at
import time.  This driver makes it run hermetically:

- wandb / shap / torchvision are stubbed via sys.modules (never exercised on
  the vanilla BERT mini track);
- stage 0 (pretrained download + conversion) is skipped by pre-seeding the
  experiment with `classifier-epoch-0.ckpt` (a seeded random
  `VanillaBertClassifier` state dict) and a shared `tokenizer/` dir, which is
  exactly what `conv_pretrained_classifier` would have produced
  (reference scripts/train_all.py:68-98);
- the dataset is the reference's own bundled `nlp_samples`
  (reference datasets/loader.py:179-196) — no network.

The resulting experiment dir is the input to the cross-framework migration
E2E (tests/test_migration_e2e.py): the torch-trained stage checkpoints are
imported into autognothi and the measure_all reports are diffed.

Usage:
    python playground/reference_run.py [--exp DIR] [--perf-dims base|mini]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import types

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, "/root")  # the `reference` package


def install_stubs() -> None:
    """Satisfy the reference's module-level imports that the offline image
    lacks.  None of the stubbed surfaces run on the vanilla BERT track:
    wandb is gated by `wandb_enabled: false`, shap only backs the
    kernel_shap variant, torchvision only the CV datasets."""

    import importlib.machinery

    def mod(name: str, **attrs) -> types.ModuleType:
        m = types.ModuleType(name)
        # a real ModuleSpec so importlib.util.find_spec-based probes
        # (e.g. transformers.utils.import_utils) see a regular module
        m.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
        m.__version__ = "0.0.0"
        for k, v in attrs.items():
            setattr(m, k, v)
        sys.modules[name] = m
        return m

    if "wandb" not in sys.modules:
        mod(
            "wandb",
            log=lambda *a, **k: None,
            init=lambda *a, **k: None,
            run=None,
            Image=object,
        )
    if "shap" not in sys.modules:
        mod("shap", KernelExplainer=object, kmeans=lambda *a, **k: None)
    if "torchvision" not in sys.modules:
        tv = mod("torchvision")
        names = (
            "CenterCrop ColorJitter Normalize RandomHorizontalFlip "
            "RandomResizedCrop RandomVerticalFlip Resize ToTensor"
        ).split()
        tr = mod("torchvision.transforms", **{n: type(n, (), {}) for n in names})
        fn = mod("torchvision.transforms.functional", resize=lambda *a, **k: None)
        tv.transforms = tr
        tr.functional = fn


MINI_NET_PARAMS = {
    "attention_probs_dropout_prob": 0.0,
    "explainer_attn_num_layers": 1,
    "explainer_head_hidden_size": 16,
    "explainer_normalize": True,
    "hidden_dropout_prob": 0.0,
    "hidden_size": 32,
    "intermediate_size": 64,
    "layer_norm_eps": 1e-12,
    "max_position_embeddings": 32,
    "num_attention_heads": 4,
    "num_hidden_layers": 2,
    "num_labels": 2,
    "pad_token_id": 0,
    "type_vocab_size": 2,
    # vocab_size filled in from the built vocab
}

BASE_NET_PARAMS = {
    # bert-base dims (reference experiments/bert_base_tayp_vanilla)
    "attention_probs_dropout_prob": 0.0,
    "explainer_attn_num_layers": 1,
    "explainer_head_hidden_size": 3072,
    "explainer_normalize": True,
    "hidden_dropout_prob": 0.0,
    "hidden_size": 768,
    "intermediate_size": 3072,
    "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512,
    "num_attention_heads": 12,
    "num_hidden_layers": 12,
    "num_labels": 2,
    "pad_token_id": 0,
    "type_vocab_size": 2,
}


MINI_VIT_NET_PARAMS = {
    # mini ViT dims (mirrors tests/test_train_all_e2e.py's MINI_VIT_HPARAMS)
    "attention_probs_dropout_prob": 0.0,
    "explainer_attn_num_layers": 1,
    "explainer_head_hidden_size": 16,
    "explainer_normalize": True,
    "hidden_dropout_prob": 0.0,
    "hidden_size": 32,
    "intermediate_size": 64,
    "layer_norm_eps": 1e-12,
    "num_attention_heads": 4,
    "num_hidden_layers": 2,
    "num_labels": 3,
    "img_channels": 3,
    "img_px_size": 16,
    "img_patch_size": 8,
}


MINI_LTT_VIT_NET_PARAMS = {
    # mini LTT ViT (the flagship architecture at test dims; ladder fields
    # mirror tests/test_ltt_e2e.py)
    "attention_probs_dropout_prob": 0.0,
    "explainer_s_attn_num_layers": 1,
    "explainer_s_head_hidden_size": 16,
    "explainer_normalize": True,
    "hidden_dropout_prob": 0.0,
    "hidden_size": 32,
    "intermediate_size": 64,
    "layer_norm_eps": 1e-12,
    "num_attention_heads": 4,
    "num_hidden_layers": 2,
    "num_labels": 3,
    "s_attn_hidden_size": 16,
    "s_attn_intermediate_size": 32,
    "img_channels": 3,
    "img_px_size": 16,
    "img_patch_size": 8,
}


VIT_BASE_NET_PARAMS = {
    # the reference's shipped vit_base_imagenette_vanilla net params
    # (/root/reference/experiments/vit_base_imagenette_vanilla/.hparams.json)
    "attention_probs_dropout_prob": 0.0,
    "explainer_attn_num_layers": 1,
    "explainer_head_hidden_size": 3072,
    "explainer_normalize": True,
    "hidden_dropout_prob": 0.0,
    "hidden_size": 768,
    "intermediate_size": 3072,
    "layer_norm_eps": 1e-12,
    "num_attention_heads": 12,
    "num_hidden_layers": 12,
    "num_labels": 10,
    "img_channels": 3,
    "img_px_size": 224,
    "img_patch_size": 16,
}


LTT_VIT_NET_PARAMS = {
    # flagship LTT ViT: ViT-Base backbone + the reference's shipped LTT
    # ladder dims (experiments/bert_base_tayp_ltt: s_attn 96/384, 1
    # s_explainer_attn layer, 3072 head) — the bench.py headline config
    "attention_probs_dropout_prob": 0.0,
    "explainer_s_attn_num_layers": 1,
    "explainer_s_head_hidden_size": 3072,
    "explainer_normalize": True,
    "hidden_dropout_prob": 0.0,
    "hidden_size": 768,
    "intermediate_size": 3072,
    "layer_norm_eps": 1e-12,
    "num_attention_heads": 12,
    "num_hidden_layers": 12,
    "num_labels": 10,
    "s_attn_hidden_size": 96,
    "s_attn_intermediate_size": 384,
    "img_channels": 3,
    "img_px_size": 224,
    "img_patch_size": 16,
}

LTT_BERT_NET_PARAMS = {
    # the reference's shipped bert_base_tayp_ltt net params (dropouts zeroed
    # for deterministic cross-framework comparison, like BASE_NET_PARAMS)
    "attention_probs_dropout_prob": 0.0,
    "explainer_s_attn_num_layers": 1,
    "explainer_s_head_hidden_size": 3072,
    "explainer_normalize": True,
    "hidden_dropout_prob": 0.0,
    "hidden_size": 768,
    "intermediate_size": 3072,
    "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512,
    "num_attention_heads": 12,
    "num_hidden_layers": 12,
    "num_labels": 2,
    "pad_token_id": 0,
    "s_attn_hidden_size": 96,
    "s_attn_intermediate_size": 384,
    "type_vocab_size": 2,
}

# froyo shares the vanilla field set; only the net kind differs
FROYO_BERT_NET_PARAMS = dict(BASE_NET_PARAMS)


def _default_kind(net_params: dict) -> str:
    return "vanilla_vit" if "img_px_size" in net_params else "vanilla_bert"


def hparams(net_params: dict, epochs: tuple, n_mask_samples: int = 4,
            resolution: int = 8, kind: str = None) -> dict:
    e_cls, e_srg, e_exp = epochs
    logger = {
        "wandb_enabled": False,
        "wandb_project": "<project>",
        "wandb_name": "<name>",
    }
    return {
        "$schema": "../hparams_schema.json",
        "seed": 3407,
        "dataset": {"kind": "nlp_samples"},
        "net": {
            "kind": kind or _default_kind(net_params),
            "version": "beta.1.01",
            "base_model": (
                "ft_vit_base_imagenette" if "img_px_size" in net_params
                else "bert_tayp"
            ),
            "params": dict(net_params),
        },
        "train_classifier": {
            "epochs": e_cls, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
        },
        "train_surrogate": {
            "epochs": e_srg, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
        },
        "train_explainer": {
            "epochs": e_exp, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 2,
            "n_mask_samples": n_mask_samples,
            "lambda_efficiency": 0.0, "lambda_norm": 0.0,
        },
        "logger_classifier": dict(logger),
        "logger_surrogate": dict(logger),
        "logger_explainer": dict(logger),
        "eval_accuracy": {"dataset": None, "batch_size": 4,
                          "resolution": resolution},
        "eval_faithfulness": {"dataset": None, "batch_size": 4,
                              "resolution": resolution},
        "eval_cls_acc": {"dataset": None, "on_exp_epochs": None, "batch_size": 4},
        "eval_performance": {"dataset": None, "loops": 1},
        "eval_train_resources": {"dataset": None, "batch_size": 2, "max_samples": 4},
    }


def reference_corpus() -> list:
    with open("/root/reference/datasets/nlp_samples/test.json", encoding="utf-8") as f:
        return json.load(f)


def build_shared_tokenizer(exp: pathlib.Path, corpus_texts) -> int:
    """HF BertTokenizerFast over a corpus-derived WordPiece vocab, saved to
    `<exp>/tokenizer` — the single tokenizer both frameworks load (reference:
    recipes/vanilla_bert.py:93; ours: recipes/vanilla_bert.py load_misc).
    Returns the vocab size."""
    sys.path.insert(0, str(REPO))
    from autognothi.data.tokenizer import build_vocab

    from transformers import BertTokenizerFast

    vocab = build_vocab(corpus_texts, max_size=2000)
    tk_dir = exp / "tokenizer"
    tk_dir.mkdir(parents=True, exist_ok=True)
    vocab_file = tk_dir / "vocab.txt"
    vocab_file.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    tok = BertTokenizerFast(vocab_file=str(vocab_file), do_lower_case=True)
    tok.save_pretrained(tk_dir)
    return len(vocab)


def _bert_classifier_cls(kind: str):
    """The reference's classifier-stage (model, config) classes per net
    kind (what `classifier-epoch-0.ckpt` must be a state dict of)."""
    if kind == "ltt_bert":
        from reference.models.ltt_bert import LttBertConfig, LttBertSurrogate

        return LttBertSurrogate, LttBertConfig
    if kind == "froyo_bert":
        from reference.models.froyo_bert import (
            FroyoBertClassifier,
            FroyoBertConfig,
        )

        return FroyoBertClassifier, FroyoBertConfig
    from reference.models.vanilla_bert import (
        VanillaBertClassifier,
        VanillaBertConfig,
    )

    return VanillaBertClassifier, VanillaBertConfig


def _vit_classifier_cls(kind: str):
    if kind == "ltt_vit":
        from reference.models.ltt_vit import LttViTConfig, LttViTSurrogate

        return LttViTSurrogate, LttViTConfig
    if kind == "froyo_vit":
        from reference.models.froyo_vit import (
            FroyoViTClassifier,
            FroyoViTConfig,
        )

        return FroyoViTClassifier, FroyoViTConfig
    from reference.models.vanilla_vit import (
        VanillaViTClassifier,
        VanillaViTConfig,
    )

    return VanillaViTClassifier, VanillaViTConfig


def seed_experiment(exp: pathlib.Path, net_params: dict, epochs: tuple,
                    kind: str = "vanilla_bert") -> None:
    """Materialize the experiment dir at the post-stage-0 state (BERT)."""
    import torch

    model_cls, cfg_cls = _bert_classifier_cls(kind)
    exp.mkdir(parents=True, exist_ok=True)
    corpus = reference_corpus()
    vocab_size = build_shared_tokenizer(exp, [x["inputs"] for x in corpus])
    params = dict(net_params, vocab_size=vocab_size)
    (exp / ".hparams.json").write_text(
        json.dumps(hparams(params, epochs, kind=kind), indent=2),
        encoding="utf-8",
    )
    torch.manual_seed(0)
    model = model_cls(cfg_cls(**params))
    torch.save(model.state_dict(), exp / "classifier-epoch-0.ckpt")


def seed_vit_experiment(exp: pathlib.Path, net_params: dict, epochs: tuple,
                        resolution: int = 8,
                        kind: str = "vanilla_vit") -> None:
    """Materialize a ViT experiment dir at the post-stage-0 state.  The
    config's dataset section says nlp_samples; for CV runs the resolver is
    patched to serve the shared synthetic image set instead
    (install_cv_dataset)."""
    import torch

    model_cls, cfg_cls = _vit_classifier_cls(kind)
    exp.mkdir(parents=True, exist_ok=True)
    (exp / ".hparams.json").write_text(
        json.dumps(hparams(dict(net_params), epochs, resolution=resolution,
                           kind=kind), indent=2),
        encoding="utf-8",
    )
    torch.manual_seed(0)
    model = model_cls(cfg_cls(**net_params))
    torch.save(model.state_dict(), exp / "classifier-epoch-0.ckpt")


def install_ltt_vit_conv_fix() -> None:
    """UPSTREAM BUG WORKAROUND: the reference's ltt_vit
    `_conv_surrogate_explainer` (/root/reference/recipes/ltt_vit.py:120-136)
    omits the `New()` rules for the `s_explainer_attn` layers, so its own
    merge fails ("ignored key from into_model") whenever
    `explainer_s_attn_num_layers > 0` — its ltt_bert sibling has the
    analogous rules (ltt_bert.py:145-152).  Patch in the missing rules so
    the shipped ViT-LTT conversion chain actually runs; everything else is
    stock reference code."""
    from reference.recipes import ltt_vit as r
    from reference.utils.nnmodel import New, merge_state_dicts

    def fixed(cfg, _misc, surrogate):
        rules = {
            "vit.{_}": ...,
            "classifier.{_}": ...,
            "s_attn_classifier.{wb}": None,
            New(): "s_explainer_attn.{_}",
            New(): "s_explainer_mlp.0.{wb}",
            New(): "s_explainer_mlp.1.{wb}",
            New(): "s_explainer_mlp.3.{wb}",
            New(): "s_explainer_mlp.5.{wb}",
        }
        explainer = r.LttViTExplainer(cfg)
        merge_state_dicts((rules, surrogate), into=explainer)
        return explainer

    r._conv_surrogate_explainer = fixed


def install_froyo_vit_final_fix() -> None:
    """UPSTREAM BUG WORKAROUND: the reference's `FroyoViTFinal.forward`
    (/root/reference/models/froyo_vit.py:140-146) declares
    `surrogate_grand`/`surrogate_null` positional parameters it never uses
    (it recomputes both internally from `srg_logits`/`self.surrogate_null`,
    froyo_vit.py:163-169), while its own recipe `_fw_final`
    (/root/reference/recipes/froyo_vit.py:215-224) calls `model(xs, mask)`
    without them — a TypeError on every invocation, so the shipped froyo_vit
    Final cannot run at all.  Its froyo_bert sibling's forward correctly
    takes 3 args (froyo_bert.py:152-157).  Default the two dead parameters
    to None (they are never read); everything else is stock reference
    code."""
    from reference.models.froyo_vit import FroyoViTFinal

    orig = FroyoViTFinal.forward

    def fixed(self, x, attention_mask, surrogate_grand=None,
              surrogate_null=None):
        return orig(self, x, attention_mask, surrogate_grand, surrogate_null)

    FroyoViTFinal.forward = fixed


CV_SAMPLES_SPEC = dict(train_size=8, test_size=4, img_px_size=16,
                       num_classes=3, seed=7)


def shared_cv_loader():
    """The deterministic synthetic image set BOTH frameworks evaluate on
    (ours: autognothi.data.loader.load_cv_samples, seeded)."""
    from autognothi.data.loader import load_cv_samples

    return load_cv_samples(**CV_SAMPLES_SPEC)


def install_cv_dataset() -> None:
    """Point the reference's dataset resolver at the shared synthetic CV
    set: every `load_cfg_dataset(kind="nlp_samples")` call dispatches
    through `reference.scripts.resources.load_nlp_samples`
    (/root/reference/scripts/resources.py:99,122), so one rebinding covers
    all trainers and reports."""
    import torch

    from reference.datasets.loader import DatasetLoader
    from reference.scripts import resources

    ours = shared_cv_loader()

    def as_torch(raw_iter):
        def loader(batch_size: int):
            for xs, ys, xr, yr in raw_iter(batch_size):
                tx = [torch.from_numpy(x) for x in xs]
                yield tx, list(ys), [t.clone() for t in tx], list(yr)

        return loader

    ref_loader = DatasetLoader(
        train_raw=as_torch(ours.train_raw),
        test_raw=as_torch(ours.test_raw),
    )
    resources.load_nlp_samples = lambda: ref_loader


def run_pipeline(exp: pathlib.Path, perf_reports: bool = True) -> dict:
    """train_all + measure_all on CPU; returns {report_name: dict}."""
    import torch

    from reference.scripts.env import ExpEnv
    from reference.scripts.measure_all import measure_all
    from reference.scripts.train_all import train_all
    from reference.utils.tools import set_iterative_seed

    device = torch.device("cpu")
    if not torch.cuda.is_available():
        # reference measure_performance.py:275 calls cuda.synchronize()
        # unconditionally; harmless no-op on a CPU-only build
        torch.cuda.synchronize = lambda *a, **k: None
    set_iterative_seed(42, "scripts.shell.main")  # same as reference shell.py:369
    env = ExpEnv(exp, lambda c: None)
    t0 = time.time()
    train_all(env, device)
    t1 = time.time()
    measure_all(
        env,
        device,
        run_accuracy=True,
        run_faithfulness=True,
        run_cls_acc=True,
        run_performance=perf_reports,
        run_train_resources=perf_reports,
        run_branches_cka=False,
        run_dual_task_similarity=False,
    )
    t2 = time.time()
    reports = {}
    for f in sorted((exp / ".reports").glob("*.json")):
        reports[f.stem] = json.loads(f.read_text(encoding="utf-8"))
    print(f"[reference_run] train_all {t1 - t0:.1f}s  measure_all {t2 - t1:.1f}s")
    return reports


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default="/tmp/refmini")
    ap.add_argument("--dims", choices=["mini", "base"], default="mini")
    ap.add_argument(
        "--epochs", default=None,
        help="cls,srg,exp epoch counts (default mini: 2,2,2; base: 0,0,0)",
    )
    args = ap.parse_args()

    install_stubs()
    exp = pathlib.Path(args.exp)
    net = MINI_NET_PARAMS if args.dims == "mini" else BASE_NET_PARAMS
    # vanilla classifiers are fully frozen (reference models/vanilla_bert.py:54-59)
    # and trained 0 epochs in the shipped configs; only surrogate/explainer train.
    default_epochs = (0, 2, 2) if args.dims == "mini" else (0, 0, 0)
    epochs = (
        tuple(int(x) for x in args.epochs.split(",")) if args.epochs
        else default_epochs
    )
    if not (exp / ".hparams.json").exists():
        seed_experiment(exp, net, epochs)
    reports = run_pipeline(exp)
    for name, body in reports.items():
        print(f"=== {name} ===")
        print(json.dumps(body, indent=2)[:2000])


if __name__ == "__main__":
    main()
