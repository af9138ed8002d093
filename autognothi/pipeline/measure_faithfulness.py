"""Faithfulness report: insertion / deletion AUC of the final model's
explanations (parity: /root/reference/scripts/measure_faithfulness.py).

Identical metric semantics — rank players by attribution, build masks at
`linspace(0, n_players, steps)` stops, surrogate evaluates each perturbed
state, trapezoidal AUC over the per-stop averages — but a device-side
evaluation plan: per sample, the masks for ALL classes x ALL stops are built
on-device from one argsort (replacing the numpy xor loop,
measure_faithfulness.py:225-251) and evaluated as a single coalition batch
through the surrogate's embed-once fast path (replacing the per-class
per-chunk replication loop, :195-218)."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from ..parallel.mesh import setup_data_parallel
from ..recipes.types import surrogate_coalition_values
from ..utils.records import Record
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset, load_epoch_model


@dataclasses.dataclass(kw_only=True)
class FaithfulnessCurve(Record):
    auc: float
    avg: Dict[int, float]
    std: Dict[int, float]


CurvePoint = Dict[int, Dict[int, float]]  # cls -> stop -> metric


@dataclasses.dataclass(kw_only=True)
class MeasureFaithfulnessReport(Record):
    """Requires: surrogate [-1], final [-1]."""

    insertion: FaithfulnessCurve
    deletion: FaithfulnessCurve
    insertion_non_ok: FaithfulnessCurve
    deletion_non_ok: FaithfulnessCurve
    data_cls: List[int]
    data_ins: List[CurvePoint]
    data_del: List[CurvePoint]


def _auc(curve: Dict[int, float]) -> float:
    vals = np.array(list(curve.values()))
    if len(vals) < 2:  # single-stop curve (resolution/n_players == 1):
        return 0.0     # trapezoid over an empty slice would be NaN
    return float(((vals[1:] + vals[:-1]) / 2).mean())


def _paint_curve(curves: List[Dict[int, float]]) -> FaithfulnessCurve:
    items: Dict[int, List[float]] = {}
    for curve in curves:
        for stop, point in curve.items():
            items.setdefault(stop, []).append(point)
    avg = {stop: float(np.mean(vals)) for stop, vals in items.items()}
    std = {stop: float(np.std(vals)) for stop, vals in items.items()}
    return FaithfulnessCurve(auc=_auc(avg), avg=avg, std=std)


def perturbation_masks(
    attr: jax.Array, stops: jax.Array, mask_base: int
) -> jax.Array:
    """<C, P> attributions + <S> stops -> <C, S, P> masks.

    For each class: rank players by attribution (descending); at stop s, the
    top-s players are flipped from `mask_base` (0=insertion from empty,
    1=deletion from full)."""
    order = jnp.argsort(-attr, axis=-1)  # <C, P> ranking
    position = jnp.argsort(order, axis=-1)  # player -> rank index
    flipped = (position[:, None, :] < stops[None, :, None]).astype(jnp.int32)
    return jnp.bitwise_xor(jnp.int32(mask_base), flipped)


def measure_faithfulness(
    env: ExpEnv,
    d_loader: Optional[DatasetLoader] = None,
    resolution: Optional[int] = None,
) -> MeasureFaithfulnessReport:
    env.log("loading final model...")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.allow_faithfulness:
        raise ValueError("unsupported recipe action")

    _, srg_params = load_epoch_model(env, recipe, "surrogate")
    _, final_params = load_epoch_model(env, recipe, "final")

    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    if d_loader is None:
        env.log("loading dataset...")
        d_config = config.eval_faithfulness.dataset or config.dataset
        d_loader = load_cfg_dataset(d_config, env.model_path)
    if resolution is None:
        resolution = config.eval_faithfulness.resolution

    steps = min(n_players, resolution)
    stops_np = np.linspace(0, n_players, steps, dtype=np.int64)
    stops = jnp.asarray(stops_np)

    # the classes x stops coalition batch is embarrassingly parallel
    # (SURVEY §2.9): shard it along the "data" mesh axis, replicating the
    # params — the same placement the trainers use
    mesh, place_params, _ = setup_data_parallel()
    srg_params = place_params(srg_params)
    final_params = place_params(final_params)
    n_shards = mesh.shape["data"] if mesh is not None else 1

    _explain = lambda p, xs: recipe.fw_final(m_config, p, xs)  # noqa: E731
    # host-side finals (KernelSHAP's numpy WLS) must not be traced
    explain = _explain if recipe.fw_final_host else jax.jit(_explain)

    @partial(jax.jit, static_argnums=3)
    def eval_perturbed(srg_p, xs, attr, mask_base):
        """xs <1, ...>, attr <C, P> -> <C, S> surrogate value of class c at
        stop s (one coalition batch through the embed-once fast path,
        sharded over the data mesh)."""
        n_classes = attr.shape[0]
        masks0 = perturbation_masks(attr, stops, mask_base)  # <C, S, P>
        total = n_classes * steps
        padded = ((total + n_shards - 1) // n_shards) * n_shards
        flat = masks0.reshape(1, total, n_players)
        if padded != total:
            # edge-pad so the coalition axis divides the mesh; extra rows are
            # recomputed copies, sliced off below
            flat = jnp.concatenate(
                [flat, jnp.broadcast_to(flat[:, -1:], (1, padded - total,
                                                       n_players))], axis=1)
        if mesh is not None:
            # shard_map over the coalition axis: xs/params replicated,
            # masks split — the fused kernels run per-shard (plain GSPMD
            # jit would replicate a pallas_call behind all-gathers)
            from ..parallel.mesh import sharded_call

            probs = sharded_call(
                lambda p, x, f: surrogate_coalition_values(
                    recipe, m_config, p, x, f),
                mesh, in_axes=(None, None, 1), out_axes=0,
            )(srg_p, xs, flat)
        else:
            probs = surrogate_coalition_values(recipe, m_config, srg_p, xs,
                                               flat)
        probs = probs.reshape(padded, -1)[:total]
        probs = probs.reshape(n_classes, steps, -1)
        cls_idx = jnp.arange(n_classes)
        return probs[cls_idx, :, cls_idx]  # <C, S>

    env.log("[[[ running measurement... ]]]")
    ok_cls_l: List[int] = []
    ins_curves: List[CurvePoint] = []
    del_curves: List[CurvePoint] = []
    for i, (_inputs, _targets) in enumerate(d_loader.test(1)):
        xs, zs = gen_input(_inputs, _targets)
        xs = jnp.asarray(xs[:1])
        ok_cls = int(np.asarray(zs)[0])
        _logits, explanation = explain(final_params, xs)
        attr = explanation[0]  # <C, P>

        curves = {}
        for direction, mask_base in (("ins", 0), ("del", 1)):
            vals = np.asarray(eval_perturbed(srg_params, xs, attr,
                                             int(mask_base)))
            curves[direction] = {
                c: {int(stops_np[s]): float(vals[c, s]) for s in range(steps)}
                for c in range(attr.shape[0])
            }
        ok_cls_l.append(ok_cls)
        ins_curves.append(curves["ins"])
        del_curves.append(curves["del"])
        ins_val = [_auc(c) for c in curves["ins"].values()]
        del_val = [_auc(c) for c in curves["del"].values()]
        env.log(
            f"> sample {i}: ok_cls {ok_cls}, ins^ {ins_val[ok_cls]:.6f}, "
            f"del^ {del_val[ok_cls]:.6f}"
        )

    cv_ins_ok, cv_del_ok, cv_ins_nok, cv_del_nok = [], [], [], []
    for ok_cls, ins_curve, del_curve in zip(ok_cls_l, ins_curves, del_curves):
        for cl in ins_curve:
            if cl == ok_cls:
                cv_ins_ok.append(ins_curve[cl])
                cv_del_ok.append(del_curve[cl])
            else:
                cv_ins_nok.append(ins_curve[cl])
                cv_del_nok.append(del_curve[cl])

    st_ins_ok = _paint_curve(cv_ins_ok)
    st_del_ok = _paint_curve(cv_del_ok)
    st_ins_nok = _paint_curve(cv_ins_nok)
    st_del_nok = _paint_curve(cv_del_nok)
    env.log(
        "FINAL RESULTS:\n"
        f"  > insertion: target {st_ins_ok.auc:.6f}, "
        f"non-target {st_ins_nok.auc:.6f}\n"
        f"  > deletion: target {st_del_ok.auc:.6f}, "
        f"non-target {st_del_nok.auc:.6f}"
    )
    return MeasureFaithfulnessReport(
        insertion=st_ins_ok,
        deletion=st_del_ok,
        insertion_non_ok=st_ins_nok,
        deletion_non_ok=st_del_nok,
        data_cls=ok_cls_l,
        data_ins=ins_curves,
        data_del=del_curves,
    )
