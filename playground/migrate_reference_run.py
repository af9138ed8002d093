"""Cross-framework trained-weight migration E2E.

Takes an experiment directory trained by the TORCH REFERENCE pipeline
(produced by playground/reference_run.py — real reference code, real
training), imports every stage checkpoint into autognothi (the torch
`state_dict` files load through our generic params reader and torch-style
names; reference round-trip semantics: /root/reference/params/loader.py:135-182),
re-runs our measurement suite on the IDENTICAL dataset + tokenizer, and
diffs the reports.

This is the strongest parity evidence available offline: two independent
implementations, one trained artifact, matching faithfulness/accuracy
numbers.

Usage:
    env JAX_PLATFORMS=cpu \
        python playground/migrate_reference_run.py [--ref-exp /tmp/refmini]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REFERENCE_SAMPLES = pathlib.Path("/root/reference/datasets/nlp_samples/test.json")


def clone_experiment(ref_exp: pathlib.Path, dst: pathlib.Path) -> pathlib.Path:
    """Copy config + tokenizer + every torch stage ckpt; drop reports/logs so
    our measure_all actually recomputes."""
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copy(ref_exp / ".hparams.json", dst / ".hparams.json")
    if (ref_exp / "tokenizer").exists():  # ViT experiments carry none
        shutil.copytree(ref_exp / "tokenizer", dst / "tokenizer")
    for ckpt in ref_exp.glob("*.ckpt"):
        shutil.copy(ckpt, dst / ckpt.name)
    return dst


def measure_ours(exp: pathlib.Path) -> dict:
    from autognothi.data.loader import _json_nlp_loader
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.measure_accuracy import measure_accuracy
    from autognothi.pipeline.measure_cls_acc import measure_cls_acc
    from autognothi.pipeline.measure_faithfulness import measure_faithfulness

    d_loader = _json_nlp_loader(REFERENCE_SAMPLES)
    env = ExpEnv(exp)
    return {
        "faithfulness": measure_faithfulness(env, d_loader=d_loader).to_dict(),
        "cls_acc": measure_cls_acc(env, d_loader=d_loader).to_dict(),
        "accuracy": measure_accuracy(env, d_loader=d_loader).to_dict(),
    }


def measure_ours_cv(exp: pathlib.Path) -> dict:
    """CV-track variant: identical synthetic image set both sides
    (reference_run.shared_cv_loader)."""
    import reference_run as ref

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.measure_accuracy import measure_accuracy
    from autognothi.pipeline.measure_cls_acc import measure_cls_acc
    from autognothi.pipeline.measure_faithfulness import measure_faithfulness

    d_loader = ref.shared_cv_loader()
    env = ExpEnv(exp)
    return {
        "faithfulness": measure_faithfulness(env, d_loader=d_loader).to_dict(),
        "cls_acc": measure_cls_acc(env, d_loader=d_loader).to_dict(),
        "accuracy": measure_accuracy(env, d_loader=d_loader).to_dict(),
    }


def load_reference_reports(ref_exp: pathlib.Path) -> dict:
    out = {}
    for name in ("faithfulness", "cls_acc", "accuracy"):
        with open(ref_exp / ".reports" / f"{name}.json", encoding="utf-8") as f:
            out[name] = json.load(f)
    return out


def diff_reports(theirs: dict, ours: dict) -> list:
    """-> list of (path, ref_value, our_value, abs_diff) rows for the
    deterministic metrics.  Faithfulness curves are deterministic given the
    weights (argsort ranking + linspace stops, no RNG); cls_acc is argmax
    counting; masked-accuracy uses framework RNG for masks so only its
    deterministic endpoints (0 masked / all masked) are compared.
    Tolerance filtering is the CALLER's job (rows carry abs_diff)."""
    rows = []

    def rec(path, a, b):
        if isinstance(a, dict):
            # JSON round-trips dict keys to str; to_dict keeps them int
            bk = {str(k): v for k, v in b.items()} if isinstance(b, dict) else {}
            for k in a:
                rec(f"{path}.{k}", a[k], bk.get(str(k)))
        elif isinstance(a, list):
            for i, x in enumerate(a):
                rec(f"{path}[{i}]", x, b[i] if b is not None else None)
        elif isinstance(a, (int, float)) and isinstance(b, (int, float)):
            rows.append((path, float(a), float(b), abs(float(a) - float(b))))

    for direction in ("insertion", "deletion", "insertion_non_ok", "deletion_non_ok"):
        if direction in theirs["faithfulness"]:
            rec(f"faithfulness.{direction}", theirs["faithfulness"][direction],
                ours["faithfulness"].get(direction))
    rec("cls_acc", theirs["cls_acc"], ours["cls_acc"])
    # masked-accuracy deterministic endpoints
    t_acc, o_acc = theirs["accuracy"], ours["accuracy"]
    rows.append(("accuracy[first]", t_acc["accuracy"][0], o_acc["accuracy"][0],
                 abs(t_acc["accuracy"][0] - o_acc["accuracy"][0])))
    rows.append(("accuracy[last]", t_acc["accuracy"][-1], o_acc["accuracy"][-1],
                 abs(t_acc["accuracy"][-1] - o_acc["accuracy"][-1])))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-exp", default="/tmp/refmini")
    ap.add_argument("--jax-exp", default="/tmp/refmini_jax")
    ap.add_argument("--atol", type=float, default=5e-4)
    args = ap.parse_args()

    ref_exp = pathlib.Path(args.ref_exp)
    if not (ref_exp / ".reports" / "faithfulness.json").exists():
        raise SystemExit(
            f"{ref_exp} has no reference reports — run "
            "playground/reference_run.py first"
        )

    exp = clone_experiment(ref_exp, pathlib.Path(args.jax_exp))
    ours = measure_ours(exp)
    theirs = load_reference_reports(ref_exp)
    rows = diff_reports(theirs, ours)
    worst = max(rows, key=lambda r: r[3])
    n_bad = sum(1 for r in rows if r[3] > args.atol)
    for path, a, b, d in rows:
        flag = "  <-- DIVERGES" if d > args.atol else ""
        print(f"{path:55s} ref={a:.6f} jax={b:.6f} d={d:.2e}{flag}")
    print(
        f"\n[migrate] {len(rows)} metrics compared; worst |d|={worst[3]:.3e} "
        f"at {worst[0]}; {n_bad} beyond atol={args.atol}"
    )
    if n_bad:
        raise SystemExit(1)
    print("[migrate] PARITY OK")


if __name__ == "__main__":
    main()
