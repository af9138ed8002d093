"""Measurement runner with JSON report caching (parity: /root/reference/
scripts/measure_all.py).  Reports cached at `<exp>/.reports/<name>.json` are
loaded, never recomputed."""

from __future__ import annotations

import json
from typing import Callable, Optional, Type, TypeVar

from ..utils.records import Record
from .env import ExpEnv
from .measure_accuracy import MeasureAccuracyReport, measure_accuracy
from .measure_branches_cka import MeasureBranchesCkaReport, measure_branches_cka
from .measure_cls_acc import MeasureClsAccReport, measure_cls_acc
from .measure_dual_task_similarity import (
    MeasureDualTaskSimilarityReport,
    measure_dual_task_similarity,
)
from .measure_faithfulness import MeasureFaithfulnessReport, measure_faithfulness
from .measure_performance import MeasurePerformanceReport, measure_performance
from .measure_train_resources import (
    MeasureTrainResourcesReport,
    measure_train_resources,
)
from .resources import get_recipe

TReport = TypeVar("TReport", bound=Record)


def load_or_run_report(
    env: ExpEnv,
    t_report: Type[TReport],
    filename: str,
    run: Callable[[], TReport],
) -> TReport:
    f_path = env.model_path / ".reports" / filename
    if f_path.exists():
        with open(f_path, "r", encoding="utf-8") as f:
            return t_report.from_dict(json.load(f))
    report = run()
    f_path.parent.mkdir(parents=True, exist_ok=True)
    with open(f_path, "w", encoding="utf-8") as f:
        raw = report.to_dict(exclude_unset=True)
        f.write(json.dumps(raw, indent=2) + "\n")
    return report


def measure_all(
    env: ExpEnv,
    run_accuracy: bool = True,
    run_faithfulness: bool = True,
    run_cls_acc: bool = True,
    run_performance: bool = True,
    run_train_resources: bool = True,
    run_branches_cka: bool = True,
    run_dual_task_similarity: bool = True,
) -> None:
    recipe, _ = get_recipe(env.config)

    def run_report(
        t_report: Type[TReport],
        filename: str,
        run: Callable[[], TReport],
        recipe_allow: bool,
        cli_allow: bool,
    ) -> Optional[TReport]:
        name = filename.split(".")[0]
        if recipe_allow:
            if cli_allow:
                env.log(f"[[[ Measuring: {name} ]]]")
                return load_or_run_report(env, t_report, filename, run)
            env.log(f"[[[ skip: {name} ]]]")
        return None

    run_report(
        MeasureAccuracyReport, "accuracy.json",
        lambda: measure_accuracy(env),
        recipe.measurements.allow_accuracy, run_accuracy,
    )
    run_report(
        MeasureFaithfulnessReport, "faithfulness.json",
        lambda: measure_faithfulness(env),
        recipe.measurements.allow_faithfulness, run_faithfulness,
    )
    run_report(
        MeasureClsAccReport, "cls_acc.json",
        lambda: measure_cls_acc(env),
        recipe.measurements.allow_cls_acc, run_cls_acc,
    )
    run_report(
        MeasurePerformanceReport, "performance.json",
        lambda: measure_performance(env),
        (
            recipe.measurements.allow_performance_cls
            or recipe.measurements.allow_performance_srg_exp
            or recipe.measurements.allow_performance_fin
        ),
        run_performance,
    )
    run_report(
        MeasureTrainResourcesReport, "train_resources.json",
        lambda: measure_train_resources(env),
        recipe.measurements.allow_train_resources, run_train_resources,
    )
    run_report(
        MeasureBranchesCkaReport, "branches_cka.json",
        lambda: measure_branches_cka(env),
        recipe.measurements.allow_branches_cka, run_branches_cka,
    )
    run_report(
        MeasureDualTaskSimilarityReport, "dual_task_similarity.json",
        lambda: measure_dual_task_similarity(env),
        recipe.measurements.allow_dual_task_similarity is not False,
        run_dual_task_similarity,
    )
    env.log("[[[ done all measurements ]]]")
