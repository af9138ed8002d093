"""GPU serving quality gate: faithfulness-AUC drift between the CPU fp32 XLA
reference pipeline and the GPU path (attention kernel, TF32 matmuls).

Protocol (the reference's own faithfulness mechanism, measure_faithfulness
— /root/reference/scripts/measure_faithfulness.py:143-146):
  1. train the 7-stage mini ViT experiment on CPU (fp32 XLA) and record
     its faithfulness report — the numerical reference;
  2. re-run ONLY the faithfulness measurement on the GPU, same
     checkpoints;
  3. diff every AUC cell; fail if any drifts beyond --atol (default 5e-3).

Usage:  python playground/quality_gate.py [--exp <dir>]   (on a GPU host)
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

MINI_VIT_HPARAMS = {
    "seed": 42,
    "dataset": {
        "kind": "cv_samples",
        "train_size": 8,
        "test_size": 4,
        "img_px_size": 16,
        "num_classes": 3,
        "seed": 7,
    },
    "net": {
        "kind": "vanilla_vit",
        "version": "beta.1.01",
        "base_model": "random_init",
        "params": {
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
        },
    },
    "train_classifier": {
        "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
    },
    "train_surrogate": {
        "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
    },
    "train_explainer": {
        "epochs": 2, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 4,
        "n_mask_samples": 2, "lambda_efficiency": 0.0, "lambda_norm": 0.0,
    },
    "eval_accuracy": {"dataset": None, "batch_size": 4, "resolution": 3},
    "eval_faithfulness": {"dataset": None, "batch_size": 4, "resolution": 3},
    "eval_cls_acc": {"dataset": None, "on_exp_epochs": "_:%1==0",
                     "batch_size": 4},
    "eval_performance": {"dataset": None, "loops": 1},
    "eval_train_resources": {"dataset": None, "batch_size": 4,
                             "max_samples": 4},
    "eval_branches_cka": {"dataset": None, "batch_size": 4},
}


def ltt_hparams() -> dict:
    """MINI_VIT_HPARAMS with the net swapped to ltt_vit (mini ladder dims,
    mirroring tests/test_ltt_e2e.py) — gates the flagship bench
    architecture's int8/kernel path the same way as vanilla."""
    hp = json.loads(json.dumps(MINI_VIT_HPARAMS))
    hp["net"]["kind"] = "ltt_vit"
    p = hp["net"]["params"]
    p.pop("explainer_attn_num_layers")
    p["explainer_s_attn_num_layers"] = 1
    p["explainer_s_head_hidden_size"] = p.pop("explainer_head_hidden_size")
    p["s_attn_hidden_size"] = 16
    p["s_attn_intermediate_size"] = 32
    return hp


def bert_hparams(vocab_size: int) -> dict:
    """Mini vanilla-BERT on the bundled nlp_samples (mirrors
    tests/test_bert_e2e.py) — gates the text track's int8/kernel serving
    path; the tokenizer is built offline into the experiment dir."""
    return {
        "seed": 11,
        "dataset": {"kind": "nlp_samples"},
        "net": {
            "kind": "vanilla_bert",
            "version": "beta.1.01",
            "base_model": "random_init",
            "params": {
                "attention_probs_dropout_prob": 0.0,
                "explainer_attn_num_layers": 1,
                "explainer_head_hidden_size": 16,
                "explainer_normalize": True,
                "hidden_dropout_prob": 0.0,
                "hidden_size": 32,
                "intermediate_size": 64,
                "layer_norm_eps": 1e-12,
                "max_position_embeddings": 16,
                "num_attention_heads": 4,
                "num_hidden_layers": 2,
                "num_labels": 2,
                "pad_token_id": 0,
                "type_vocab_size": 2,
                "vocab_size": vocab_size,
            },
        },
        "train_classifier": {
            "epochs": 0, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 8,
        },
        "train_surrogate": {
            "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 8,
        },
        "train_explainer": {
            "epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-3, "batch_size": 8,
            "n_mask_samples": 2, "lambda_efficiency": 0.0, "lambda_norm": 0.0,
        },
        "eval_accuracy": {"dataset": None, "batch_size": 8, "resolution": 3},
        "eval_faithfulness": {"dataset": None, "batch_size": 8,
                              "resolution": 3},
        "eval_cls_acc": {"dataset": None, "on_exp_epochs": None,
                         "batch_size": 8},
        "eval_performance": {"dataset": None, "loops": 1},
        "eval_train_resources": {"dataset": None, "batch_size": 8,
                                 "max_samples": 8},
    }


def prepare_bert_exp(exp: pathlib.Path) -> dict:
    sys.path.insert(0, str(REPO))
    import autognothi.data.loader as dl
    from autognothi.data.tokenizer import WordPieceTokenizer, build_vocab

    samples = json.loads(
        (pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text()
    )
    vocab = build_vocab([s["inputs"] for s in samples], max_size=400)
    WordPieceTokenizer(vocab).save(exp / "tokenizer")
    return bert_hparams(len(vocab))


def sh(args, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    print("+", " ".join(args), {k: v for k, v in (env_extra or {}).items()},
          flush=True)
    subprocess.run(args, check=True, env=env, cwd=str(REPO))


def auc_cells(report: dict, prefix=""):
    """Flatten every numeric 'auc'-keyed cell (incl. nested per-class)."""
    out = {}
    for k, v in report.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(auc_cells(v, path))
        elif isinstance(v, (int, float)) and "auc" in k.lower():
            out[path] = float(v)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default=None)
    ap.add_argument("--net", choices=["vanilla_vit", "ltt_vit", "froyo_vit",
                                      "vanilla_bert", "ltt_bert",
                                      "froyo_bert", "duo_vanilla_vit",
                                      "duo_vanilla_bert",
                                      "kernel_shap_bert"],
                    default="vanilla_vit")
    ap.add_argument("--atol", type=float, default=5e-3)
    ap.add_argument("--pp", type=int, default=0,
                    help="train the CPU reference stage with pipeline "
                         "parallelism (AUTOGNOTHI_PP=<P> over an 8-virtual-"
                         "device mesh) — proves PP-trained checkpoints are "
                         "production-indistinguishable through the full "
                         "hardware faithfulness gate (vanilla tracks only)")
    ap.add_argument("--tp", type=int, default=0,
                    help="with --pp: compose Megatron tensor parallelism "
                         "inside each pipeline stage (AUTOGNOTHI_PP_TP=<T> "
                         "— the full dp x pp x tp training composition)")
    args = ap.parse_args()

    if args.pp and args.net not in ("vanilla_vit", "vanilla_bert"):
        raise SystemExit("--pp gates the vanilla tracks (pipeline "
                         "parallelism covers full-tower training only)")
    if args.tp and not args.pp:
        raise SystemExit("--tp composes inside pipeline stages: use with "
                         "--pp")
    tag = (f"_pp{args.pp}" if args.pp else "") + \
        (f"_tp{args.tp}" if args.tp else "")
    exp = pathlib.Path(args.exp
                       or REPO / ".smoke" / f"quality_gate_{args.net}{tag}")
    faith = exp / ".reports" / "faithfulness.json"
    cpu_ref = exp / ".reports" / "faithfulness_cpu_fp32.json"

    if not cpu_ref.exists():
        if exp.exists():
            shutil.rmtree(exp)
        exp.mkdir(parents=True)
        if args.net == "ltt_vit":
            hp = ltt_hparams()
        elif args.net == "vanilla_bert":
            hp = prepare_bert_exp(exp)
        elif args.net == "ltt_bert":
            # the LTT-BERT final is a benched metric (playground/bench_ltt.py
            # --model ltt_bert); mini ladder dims mirror tests/test_ltt_e2e.py
            hp = prepare_bert_exp(exp)
            hp["net"]["kind"] = "ltt_bert"
            p = hp["net"]["params"]
            p.pop("explainer_attn_num_layers")
            p["explainer_s_attn_num_layers"] = 1
            p["explainer_s_head_hidden_size"] = p.pop(
                "explainer_head_hidden_size")
            p["s_attn_hidden_size"] = 16
            p["s_attn_intermediate_size"] = 32
        elif args.net == "froyo_bert":
            # froyo-BERT (single-trunk final) — also a benched metric
            hp = prepare_bert_exp(exp)
            hp["net"]["kind"] = "froyo_bert"
        elif args.net == "duo_vanilla_bert":
            # duo: dual-objective explainer, no classifier branch in the
            # final — its faithfulness sweep still rides the fused kernels
            hp = prepare_bert_exp(exp)
            hp["net"]["kind"] = "duo_vanilla_bert"
        elif args.net == "kernel_shap_bert":
            # classical-baseline family: the final explanation is host-side
            # WLS, but the classifier probes + surrogate evaluations inside
            # measure_faithfulness run on device through the kernels
            hp = prepare_bert_exp(exp)
            hp["net"]["kind"] = "kernel_shap_bert"
            hp["net"]["params"]["kernel_shap_n_samples"] = 32
            hp["net"]["params"]["kernel_shap_data_size"] = 3
            # kernel_shap has no trainable surrogate (the recipe skips the
            # stage, so the orchestrator must not expect its checkpoints —
            # mirrors tests/test_variants_e2e.py)
            hp["train_surrogate"]["epochs"] = 0
        elif args.net == "duo_vanilla_vit":
            hp = json.loads(json.dumps(MINI_VIT_HPARAMS))
            hp["net"]["kind"] = "duo_vanilla_vit"
        elif args.net == "froyo_vit":
            # froyo (single-trunk final — the family's fastest member and a
            # bench.py secondary metric) takes the vanilla params verbatim
            hp = json.loads(json.dumps(MINI_VIT_HPARAMS))
            hp["net"]["kind"] = "froyo_vit"
        else:
            hp = MINI_VIT_HPARAMS
        train_env = {"JAX_PLATFORMS": "cpu"}
        if args.pp:
            # stage-sharded training needs a mesh: 8 virtual CPU devices,
            # and batches divisible by (data x microbatches)
            for k in ("train_classifier", "train_surrogate",
                      "train_explainer"):
                if k in hp:
                    hp[k]["batch_size"] = 8
            train_env.update({
                "AUTOGNOTHI_PP": str(args.pp),
                # raised collective-rendezvous timeout + no persistent
                # cache: the pp steps' ppermute + all-reduce executables
                # can otherwise SIGABRT on this oversubscribed 8-virtual-
                # device host (tests/conftest.py rationale)
                "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                             "--xla_cpu_collective_timeout_seconds=1200",
            })
            if args.tp:
                train_env["AUTOGNOTHI_PP_TP"] = str(args.tp)
        (exp / ".hparams.json").write_text(
            json.dumps(hp, indent=1), encoding="utf-8"
        )
        # stage 1: CPU fp32 reference (trains + measures everything)
        sh([sys.executable, "main.py", "run_all", str(exp), "--device",
            "cpu"], train_env)
        shutil.copy(faith, cpu_ref)

    # stage 2: the GPU path, same checkpoints
    faith.unlink(missing_ok=True)
    sh([sys.executable, "main.py", "measure_all", str(exp),
        "--run-faithfulness", "--no-run-accuracy", "--no-run-cls-acc",
        "--no-run-performance", "--no-run-train-resources",
        "--no-run-branches-cka", "--no-run-dual-task-similarity",
        "--device", "gpu"], {})

    ref = auc_cells(json.loads(cpu_ref.read_text()))
    gpu = auc_cells(json.loads(faith.read_text()))
    assert ref and set(ref) == set(gpu), (sorted(ref), sorted(gpu))
    worst_key = max(ref, key=lambda k: abs(ref[k] - gpu[k]))
    worst = abs(ref[worst_key] - gpu[worst_key])
    for k in sorted(ref):
        d = abs(ref[k] - gpu[k])
        flag = "  <-- DRIFT" if d > args.atol else ""
        print(f"{k:45s} cpu_fp32={ref[k]:.6f} gpu={gpu[k]:.6f} "
              f"d={d:.2e}{flag}")
    print(f"\n[quality_gate] {len(ref)} AUC cells, worst |d|={worst:.3e} "
          f"at {worst_key} (atol {args.atol})")
    if worst > args.atol:
        raise SystemExit(1)
    print("[quality_gate] PASS")


if __name__ == "__main__":
    main()
