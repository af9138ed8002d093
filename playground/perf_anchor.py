"""Same-host measured performance anchor: torch reference vs autognothi
on this machine's CPU, at the reference's own shipped model dims
(bert_base_tayp_vanilla @ seq 512; vit_base_imagenette_vanilla @ 224/16),
identical inputs, identical per-sample batch-1 protocol
(reference scripts/measure_performance.py:259-283 vs our
pipeline/measure_performance.py).

The reference publishes no benchmark numbers (SURVEY §6); this produces the
measured reference-side CPU anchors (bench.py's TORCH_CPU_MEASURED) so
vs_baseline claims have a real anchor.  Weights are conv-chain outputs of a seeded random classifier —
irrelevant for latency.

Usage (CPU; ~10-20 min, runs both frameworks):
    env JAX_PLATFORMS=cpu \
        python playground/perf_anchor.py [--track bert|vit|both]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, "/root")

import reference_run as ref  # noqa: E402  (playground sibling)
from migrate_reference_run import clone_experiment  # noqa: E402

N_IMAGES = 4

# track -> (net params, reference net kind).  The ltt/froyo tracks anchor
# the flagship architectures bench.py now headlines (VERDICT r2 items 1-2):
# ltt computes (logits, phi) in ONE backbone traversal + 96-dim ladders.
TRACKS = {
    "bert": (ref.BASE_NET_PARAMS, "vanilla_bert"),
    "vit": (ref.VIT_BASE_NET_PARAMS, "vanilla_vit"),
    "ltt_vit": (ref.LTT_VIT_NET_PARAMS, "ltt_vit"),
    "ltt_bert": (ref.LTT_BERT_NET_PARAMS, "ltt_bert"),
    "froyo_bert": (ref.FROYO_BERT_NET_PARAMS, "froyo_bert"),
    # froyo ViT = vanilla ViT dims with the frozen-backbone single-trunk
    # final (the bench.py secondary family closest to the 10x bar) — its
    # anchor makes vs_baseline_matched possible for every benched family
    "froyo_vit": (ref.VIT_BASE_NET_PARAMS, "froyo_vit"),
}


def _is_vit(track: str) -> bool:
    return "vit" in track


def _images() -> list:
    rng = np.random.RandomState(0)
    return [rng.randn(3, 224, 224).astype(np.float32) for _ in range(N_IMAGES)]


def _torch_image_loader():
    import torch

    from reference.datasets.loader import DatasetLoader

    xs = [torch.tensor(x) for x in _images()]
    ys = list(range(N_IMAGES))

    def it(batch_size: int):
        for i in range(0, len(xs), batch_size):
            c_xs, c_ys = xs[i : i + batch_size], ys[i : i + batch_size]
            yield c_xs, c_ys, list(c_xs), list(c_ys)

    return DatasetLoader(train_raw=it, test_raw=it)


def _jax_image_loader():
    from autognothi.data.loader import DatasetLoader

    xs, ys = _images(), list(range(N_IMAGES))

    def it(batch_size: int):
        for i in range(0, len(xs), batch_size):
            c_xs, c_ys = xs[i : i + batch_size], ys[i : i + batch_size]
            yield c_xs, c_ys, list(c_xs), list(c_ys)

    return DatasetLoader(train_raw=it, test_raw=it)


def run_reference(track: str, exp: pathlib.Path) -> dict:
    import torch

    from reference.scripts.env import ExpEnv
    from reference.scripts.measure_performance import measure_performance
    from reference.scripts.train_all import train_all
    from reference.utils.tools import set_iterative_seed

    device = torch.device("cpu")
    if not torch.cuda.is_available():
        torch.cuda.synchronize = lambda *a, **k: None
    if track == "ltt_vit":
        # the reference's ltt_vit conv chain has a missing-rule bug
        # (reference_run.install_ltt_vit_conv_fix docstring)
        ref.install_ltt_vit_conv_fix()
    if track == "froyo_vit":
        # the reference's FroyoViTFinal.forward signature does not match its
        # own recipe call — unrunnable as shipped
        # (reference_run.install_froyo_vit_final_fix docstring)
        ref.install_froyo_vit_final_fix()
    if not (exp / ".hparams.json").exists():
        params, kind = TRACKS[track]
        if _is_vit(track):
            ref.seed_vit_experiment(exp, params, (0, 0, 0), kind=kind)
        else:
            ref.seed_experiment(exp, params, (0, 0, 0), kind=kind)
    set_iterative_seed(42, "scripts.shell.main")
    env = ExpEnv(exp, lambda c: None)
    train_all(env, device)  # conv chain only: 0 train epochs everywhere
    d_loader = _torch_image_loader() if _is_vit(track) else None
    report = measure_performance(env, device, d_loader=d_loader)
    (exp / ".reports").mkdir(exist_ok=True)
    (exp / ".reports" / "performance.json").write_text(
        json.dumps(report.to_dict(), indent=2), encoding="utf-8"
    )
    return report.to_dict()


def run_ours(track: str, ref_exp: pathlib.Path, exp: pathlib.Path) -> dict:
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.measure_performance import measure_performance

    clone_experiment(ref_exp, exp)
    env = ExpEnv(exp)
    d_loader = _jax_image_loader() if _is_vit(track) else None
    report = measure_performance(env, d_loader=d_loader)
    (exp / ".reports").mkdir(exist_ok=True)
    (exp / ".reports" / "performance.json").write_text(
        json.dumps(report.to_dict(), indent=2), encoding="utf-8"
    )
    return report.to_dict()


def summarize(track: str, theirs: dict, ours: dict) -> dict:
    out = {"track": track}
    for stage in ("classifier", "surrogate", "explainer", "final"):
        t, o = theirs.get(stage), ours.get(stage)
        if not (t and o):
            continue
        out[stage] = {
            "torch_cpu_ms": round(t["time_avg"] * 1e3, 2),
            "jax_cpu_ms": round(o["time_avg"] * 1e3, 2),
            "speedup": round(t["time_avg"] / o["time_avg"], 3),
        }
    if "final" in out:
        out["torch_cpu_expl_per_s"] = round(1.0 / theirs["final"]["time_avg"], 3)
        out["jax_cpu_expl_per_s"] = round(1.0 / ours["final"]["time_avg"], 3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--track", choices=[*TRACKS, "both"], default="both")
    ap.add_argument("--workdir", default="/tmp/perf_anchor")
    args = ap.parse_args()

    ref.install_stubs()
    work = pathlib.Path(args.workdir)
    tracks = ["bert", "vit"] if args.track == "both" else [args.track]
    results = []
    for track in tracks:
        ref_exp = work / f"{track}_torch"
        our_exp = work / f"{track}_jax"
        theirs = run_reference(track, ref_exp)
        ours = run_ours(track, ref_exp, our_exp)
        row = summarize(track, theirs, ours)
        results.append(row)
        print(json.dumps(row, indent=2))
    (work / "anchor.json").write_text(json.dumps(results, indent=2))
    print(f"[perf_anchor] wrote {work / 'anchor.json'}")


if __name__ == "__main__":
    main()
