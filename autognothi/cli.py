"""Command shell: the public CLI (parity: the reference's scripts/shell.py
typer app, rebuilt on argparse since typer isn't vendored).

Usage:  python ./main.py <command> <experiment_dir> [--device gpu|cpu] ...

`--device` maps onto JAX platform selection (the analogue of the reference's
`--device cuda:0`).  The CLI runs on the GPU ("gpu", "cuda" or "cuda:N"; the
default) and exits with an error when there is none.  It runs on the host
only when asked: `--device cpu`, or no `--device` with `JAX_PLATFORMS=cpu`.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
from typing import List, Optional

from .utils.seeding import set_iterative_seed


def _apply_device(device: str) -> None:
    import jax

    from .parallel.distributed import maybe_initialize_distributed
    from .utils.devices import enable_compile_cache

    on_cpu = device == "cpu" or (
        not device and os.environ.get("JAX_PLATFORMS") == "cpu")
    if not on_cpu and device not in ("", "gpu", "cuda") \
            and not device.startswith("cuda:"):
        raise SystemExit(f"unknown --device {device!r}: use gpu, cuda[:N] "
                         "or cpu")
    # the host CPU backend stays available beside the GPU for weight
    # surgery (utils.devices.on_host)
    jax.config.update("jax_platforms", "cpu" if on_cpu else "cuda,cpu")
    enable_compile_cache()
    # multi-host: AUTOGNOTHI_DIST_COORD/NPROCS/PROC_ID engage
    # jax.distributed (no-op when unset).  Ordering matters: after the
    # platform pin (gloo detection reads it), before any backend init.
    maybe_initialize_distributed()
    if on_cpu:
        return
    try:
        platform = jax.devices()[0].platform
    except RuntimeError:  # the CUDA backend failed to initialise
        platform = None
    if platform != "gpu":
        raise SystemExit("no GPU found: pass --device cpu to run on the host")


def _env(model_path: pathlib.Path):
    from .pipeline.env import ExpEnv

    return ExpEnv(model_path)


def _override_loader(args, config):
    """--dataset override -> DatasetLoader or None (use config)."""
    if not getattr(args, "dataset", None):
        return None
    from .pipeline.resources import load_id_dataset

    img_px_size = getattr(config.net.params, "img_px_size", None)
    return load_id_dataset(args.dataset, img_px_size)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="autognothi",
        description="AutoGnothi in JAX: self-interpretability pipelines",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def cmd(name: str, model_path: bool = True, device: bool = True,
            dataset: bool = False):
        p = sub.add_parser(name)
        if model_path:
            p.add_argument("model_path", type=pathlib.Path)
        if device:
            p.add_argument("--device", default="", type=str)
        if dataset:
            p.add_argument("--dataset", default=None, type=str)
        return p

    cmd("preload_all", model_path=False, device=False)
    cmd("pretrain_classifier")
    cmd("estimate_train_time")
    cmd("conv_pretrained_classifier", device=False)
    cmd("train_classifier")
    cmd("conv_classifier_surrogate", device=False)
    cmd("train_surrogate")
    cmd("conv_surrogate_explainer", device=False)
    cmd("train_explainer")
    cmd("conv_explainer_final", device=False)
    cmd("train_all")

    cmd("measure_accuracy", dataset=True)
    p = cmd("measure_faithfulness", dataset=True)
    p.add_argument("--resolution", default=None, type=int)
    cmd("measure_cls_acc", dataset=True)
    cmd("measure_performance", dataset=True)
    cmd("measure_train_resources", dataset=True)
    cmd("measure_branches_cka", dataset=True)
    cmd("measure_dual_task_similarity", dataset=True)

    p = cmd("measure_all")
    for flag in (
        "accuracy", "faithfulness", "cls_acc", "performance",
        "train_resources", "branches_cka", "dual_task_similarity",
    ):
        p.add_argument(
            f"--run-{flag.replace('_', '-')}", dest=f"run_{flag}",
            default=True, action=argparse.BooleanOptionalAction,
        )

    cmd("run_all")

    for name in ("run_image_explanation", "run_text_explanation"):
        p = cmd(name, dataset=True)
        p.add_argument("--into", type=pathlib.Path, required=True)
        p.add_argument("--limit", default=None, type=int)

    p = cmd("serve")
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8321, type=int)
    p.add_argument("--batch-size", dest="batch_size", default=8, type=int)
    p.add_argument("--window", dest="window_s", default=0.0, type=float,
                   help="max seconds a partial slab waits to coalesce "
                        "concurrent requests (0 = only natural "
                        "backpressure batching)")
    p.add_argument("--u8-scale", dest="u8_scale", default=1.0 / 255.0,
                   type=float, help="device-side dequant scale for "
                                    "images_u8 payloads")
    p.add_argument("--u8-offset", dest="u8_offset", default=0.0,
                   type=float, help="device-side dequant offset for "
                                    "images_u8 payloads")
    p.add_argument("--artifact", default=None, type=pathlib.Path,
                   help="serve an export_final artifact (program+weights) "
                        "instead of the experiment's checkpoints; a fixed-"
                        "batch artifact dictates the slab size")

    p = cmd("export_final")
    p.add_argument("--into", type=pathlib.Path, required=True)
    p.add_argument("--batch-size", dest="batch_size", default=8, type=int,
                   help="0 = batch-polymorphic artifact (one lowering "
                        "serves any batch; XLA path only)")
    p.add_argument("--platforms", default="cuda,cpu", type=str,
                   help="comma list of lowering targets embedded in the "
                        "artifact (default: one file serves cuda AND cpu)")
    def _positive(v: str) -> int:
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError(
                f"--data-parallel must be >= 1, got {n}")
        return n

    p.add_argument("--data-parallel", dest="data_parallel", default=1,
                   type=_positive,
                   help="export a mesh-sharded artifact for N devices "
                        "(weights replicated, slab rows split; serve "
                        "--artifact then shards over the first N local "
                        "devices); needs no devices at export time")

    cmd("__show_fridge__", device=False)
    p = cmd("__preview_text_shapley__", dataset=True)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    try:
        _main(argv)
    except RuntimeError as e:  # TrainingInterrupted is lazily importable
        from .pipeline.training import INTERRUPT_EXIT_CODE, TrainingInterrupted

        if not isinstance(e, TrainingInterrupted):
            raise
        print(f"[[[ interrupted: {e} ]]]", file=sys.stderr)
        raise SystemExit(INTERRUPT_EXIT_CODE)


def _main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    set_iterative_seed(42, "scripts.shell.main")
    _apply_device(getattr(args, "device", ""))
    from .parallel.distributed import distributed_env_configured

    if distributed_env_configured():
        from .parallel.distributed import process_info

        print(f"[distributed] {process_info()}", file=sys.stderr)
    command = args.command

    if command == "preload_all":
        from .data.loader import preload_all_datasets
        from .zoo.loader import preload_all_params

        preload_all_datasets()
        preload_all_params()
        return

    env = _env(args.model_path)

    if command == "pretrain_classifier":
        from .pipeline.pretrain_classifier import pretrain_classifier

        with env.fork(lambda ec: ec.logger_classifier) as e:
            pretrain_classifier(e)
    elif command == "estimate_train_time":
        from .pipeline.estimate_train_time import estimate_train_time

        estimate_train_time(env)
    elif command == "conv_pretrained_classifier":
        from .pipeline.train_all import conv_pretrained_classifier

        conv_pretrained_classifier(env)
    elif command == "train_classifier":
        from .pipeline.train_classifier import train_classifier

        with env.fork(lambda ec: ec.logger_classifier) as e:
            train_classifier(e)
    elif command == "conv_classifier_surrogate":
        from .pipeline.train_all import conv_classifier_surrogate

        conv_classifier_surrogate(env)
    elif command == "train_surrogate":
        from .pipeline.train_surrogate import train_surrogate

        with env.fork(lambda ec: ec.logger_surrogate) as e:
            train_surrogate(e)
    elif command == "conv_surrogate_explainer":
        from .pipeline.train_all import conv_surrogate_explainer

        conv_surrogate_explainer(env)
    elif command == "train_explainer":
        from .pipeline.train_explainer import train_explainer

        with env.fork(lambda ec: ec.logger_explainer) as e:
            train_explainer(e)
    elif command == "conv_explainer_final":
        from .pipeline.train_all import conv_explainer_final

        conv_explainer_final(env)
    elif command == "train_all":
        from .pipeline.train_all import train_all

        train_all(env)
    elif command == "measure_accuracy":
        from .pipeline.measure_accuracy import MeasureAccuracyReport, measure_accuracy
        from .pipeline.measure_all import load_or_run_report

        loader = _override_loader(args, env.config)
        if loader is not None:
            measure_accuracy(env, loader)
        else:
            load_or_run_report(env, MeasureAccuracyReport, "accuracy.json",
                               lambda: measure_accuracy(env))
    elif command == "measure_faithfulness":
        from .pipeline.measure_all import load_or_run_report
        from .pipeline.measure_faithfulness import (
            MeasureFaithfulnessReport,
            measure_faithfulness,
        )

        loader = _override_loader(args, env.config)
        if loader is not None or args.resolution is not None:
            measure_faithfulness(env, loader, args.resolution)
        else:
            load_or_run_report(env, MeasureFaithfulnessReport,
                               "faithfulness.json",
                               lambda: measure_faithfulness(env))
    elif command == "measure_cls_acc":
        from .pipeline.measure_all import load_or_run_report
        from .pipeline.measure_cls_acc import MeasureClsAccReport, measure_cls_acc

        loader = _override_loader(args, env.config)
        if loader is not None:
            measure_cls_acc(env, loader)
        else:
            load_or_run_report(env, MeasureClsAccReport, "cls_acc.json",
                               lambda: measure_cls_acc(env))
    elif command == "measure_performance":
        from .pipeline.measure_all import load_or_run_report
        from .pipeline.measure_performance import (
            MeasurePerformanceReport,
            measure_performance,
        )

        loader = _override_loader(args, env.config)
        if loader is not None:
            measure_performance(env, loader)
        else:
            load_or_run_report(env, MeasurePerformanceReport,
                               "performance.json",
                               lambda: measure_performance(env))
    elif command == "measure_train_resources":
        from .pipeline.measure_all import load_or_run_report
        from .pipeline.measure_train_resources import (
            MeasureTrainResourcesReport,
            measure_train_resources,
        )

        loader = _override_loader(args, env.config)
        if loader is not None:
            measure_train_resources(env, loader)
        else:
            load_or_run_report(env, MeasureTrainResourcesReport,
                               "train_resources.json",
                               lambda: measure_train_resources(env))
    elif command == "measure_branches_cka":
        from .pipeline.measure_all import load_or_run_report
        from .pipeline.measure_branches_cka import (
            MeasureBranchesCkaReport,
            measure_branches_cka,
        )

        loader = _override_loader(args, env.config)
        if loader is not None:
            measure_branches_cka(env, loader)
        else:
            load_or_run_report(env, MeasureBranchesCkaReport,
                               "branches_cka.json",
                               lambda: measure_branches_cka(env))
    elif command == "measure_dual_task_similarity":
        from .pipeline.measure_all import load_or_run_report
        from .pipeline.measure_dual_task_similarity import (
            MeasureDualTaskSimilarityReport,
            measure_dual_task_similarity,
        )

        loader = _override_loader(args, env.config)
        if loader is not None:
            measure_dual_task_similarity(env, loader)
        else:
            load_or_run_report(env, MeasureDualTaskSimilarityReport,
                               "dual_task_similarity.json",
                               lambda: measure_dual_task_similarity(env))
    elif command == "measure_all":
        from .pipeline.measure_all import measure_all

        measure_all(
            env,
            run_accuracy=args.run_accuracy,
            run_faithfulness=args.run_faithfulness,
            run_cls_acc=args.run_cls_acc,
            run_performance=args.run_performance,
            run_train_resources=args.run_train_resources,
            run_branches_cka=args.run_branches_cka,
            run_dual_task_similarity=args.run_dual_task_similarity,
        )
    elif command == "run_all":
        from .pipeline.measure_all import measure_all
        from .pipeline.train_all import train_all

        train_all(env)
        measure_all(env)
    elif command == "run_image_explanation":
        from .pipeline.run_image_explanation import run_image_explanation

        run_image_explanation(env, _override_loader(args, env.config),
                              args.into, args.limit)
    elif command == "run_text_explanation":
        from .pipeline.run_text_explanation import run_text_explanation

        run_text_explanation(env, _override_loader(args, env.config),
                             args.into, args.limit)
    elif command == "serve":
        from .pipeline.serve import serve

        serve(env, args.host, args.port, args.batch_size,
              window_s=args.window_s,
              u8_dequant=(args.u8_scale, args.u8_offset),
              artifact=args.artifact)
    elif command == "export_final":
        from .pipeline.export import export_final

        export_final(env, args.into, args.batch_size,
                     platforms=[s for s in args.platforms.split(",") if s],
                     data_parallel=args.data_parallel)
    elif command == "__show_fridge__":
        from .pipeline.show_fridge import show_fridge

        show_fridge(env)
    elif command == "__preview_text_shapley__":
        from .pipeline.preview_text_shapley import preview_text_shapley

        preview_text_shapley(env, _override_loader(args, env.config))
    else:  # pragma: no cover
        raise SystemExit(f"unknown command: {command}")


if __name__ == "__main__":
    main(sys.argv[1:])
