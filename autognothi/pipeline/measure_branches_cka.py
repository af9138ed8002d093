"""Branch-CKA report: per-explainer-epoch CKA (linear & RBF) between the
classifier's and explainer's hidden representations (parity:
/root/reference/scripts/measure_branches_cka.py).  Observations flow through
the recipes' functional `fw_*_repr` adapters instead of a stateful mixin."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from ..ops.cka import kernel_cka, linear_cka
from ..utils.records import Record
from .env import ExpEnv
from .resources import (
    get_epoch_ckpts,
    get_recipe,
    load_cfg_dataset,
    load_epoch_ckpt,
    load_epoch_model,
)


@dataclasses.dataclass(kw_only=True)
class CkaStats(Record):
    linear_cka_all: List[List[float]]
    linear_cka_avg: List[float]
    linear_cka_std: List[float]
    kernel_cka_all: List[List[float]]
    kernel_cka_avg: List[float]
    kernel_cka_std: List[float]


@dataclasses.dataclass(kw_only=True)
class MeasureBranchesCkaReport(Record):
    """Requires: classifier [-1], surrogate [-1], explainer [ep]."""

    epochs: List[int]
    classes: List[List[int]]
    all: CkaStats
    by_cls: Dict[str, CkaStats]


def _stat(lin_all: List[List[float]], krn_all: List[List[float]]) -> CkaStats:
    def per_epoch(values, fn):
        return [float(fn(np.asarray(v))) for v in values]

    def std1(v):
        return v.std(ddof=1) if len(v) > 1 else 0.0

    return CkaStats(
        linear_cka_all=lin_all,
        linear_cka_avg=per_epoch(lin_all, np.mean),
        linear_cka_std=per_epoch(lin_all, std1),
        kernel_cka_all=krn_all,
        kernel_cka_avg=per_epoch(krn_all, np.mean),
        kernel_cka_std=per_epoch(krn_all, std1),
    )


def measure_branches_cka(
    env: ExpEnv, d_loader: Optional[DatasetLoader] = None
) -> MeasureBranchesCkaReport:
    env.log("loading models...")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.allow_branches_cka:
        raise ValueError("unsupported recipe action")
    if recipe.fw_classifier_repr is None or recipe.fw_explainer_repr is None:
        raise ValueError("recipe lacks representation observers")

    if d_loader is None:
        env.log("loading dataset...")
        d_config = (
            config.eval_branches_cka.dataset
            if config.eval_branches_cka is not None
            and config.eval_branches_cka.dataset is not None
            else config.dataset
        )
        d_loader = load_cfg_dataset(d_config, env.model_path)

    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)
    batch_size = (
        config.eval_branches_cka.batch_size
        if config.eval_branches_cka is not None
        else config.train_explainer.batch_size
    )

    _, cls_params = load_epoch_model(env, recipe, "classifier")
    _, srg_params = load_epoch_model(env, recipe, "surrogate")
    nil_xs = jnp.asarray(recipe.gen_null(m_config, m_misc))
    nil_mask = jnp.ones((1, n_players), jnp.int32)
    surrogate_null, _ = recipe.fw_surrogate(m_config, srg_params, nil_xs, nil_mask)

    fw_srg = jax.jit(
        lambda p, xs, mask: recipe.fw_surrogate(m_config, p, xs, mask)[0]
    )

    @jax.jit
    def cka_pair(cls_p, exp_p, xs, mask, grand):
        _, repr_cls = recipe.fw_classifier_repr(m_config, cls_p, xs, mask)
        _, repr_exp = recipe.fw_explainer_repr(
            m_config, exp_p, xs, mask, grand, surrogate_null
        )
        return linear_cka(repr_cls, repr_exp), kernel_cka(repr_cls, repr_exp)

    env.log("[[[ running measurement... ]]]")
    all_epochs: List[int] = []
    all_cls: List[List[int]] = []
    all_lin: List[List[float]] = []
    all_krn: List[List[float]] = []
    for loading_epoch in get_epoch_ckpts(
        env.model_path, "explainer", config.train_explainer.epochs
    ):
        epoch_exp, arrays = load_epoch_ckpt(
            env.model_path, "explainer", loading_epoch, required=True
        )
        exp_params = {k: jnp.asarray(v) for k, v in arrays.items()}

        ts_begin = time.time()
        ep_cls: List[int] = []
        ep_lin: List[float] = []
        ep_krn: List[float] = []
        for batch_idx, (_inputs, _targets) in enumerate(d_loader.test(batch_size)):
            xs, zs = gen_input(_inputs, _targets)
            mask_1 = jnp.ones((xs.shape[0], n_players), jnp.int32)
            grand = fw_srg(srg_params, jnp.asarray(xs), mask_1)
            lin, krn = cka_pair(cls_params, exp_params, jnp.asarray(xs),
                                mask_1, grand)
            lin, krn = np.asarray(lin), np.asarray(krn)
            ep_cls.extend(int(z) for z in np.asarray(zs))
            ep_lin.extend(float(v) for v in lin)
            ep_krn.extend(float(v) for v in krn)
            env.log(
                f"  > epoch {epoch_exp} :{batch_idx}:test // "
                f"cka: lin {lin.mean():.6f}, krn {krn.mean():.6f} // "
                f"fin {len(ep_lin)}"
            )
        all_epochs.append(epoch_exp)
        all_cls.append(ep_cls)
        all_lin.append(ep_lin)
        all_krn.append(ep_krn)
        env.log(
            f"  > epoch {epoch_exp} done in {time.time() - ts_begin:.2f}s // "
            f"cka: lin avg {np.mean(ep_lin):.6f}, krn avg {np.mean(ep_krn):.6f}"
        )

    stat_all = _stat(all_lin, all_krn)
    stat_by_cls: Dict[str, CkaStats] = {}
    for cl in sorted({c for ep in all_cls for c in ep}):
        cl_lin = [
            [v for c, v in zip(ep_cls, ep_lin) if c == cl]
            for ep_cls, ep_lin in zip(all_cls, all_lin)
        ]
        cl_krn = [
            [v for c, v in zip(ep_cls, ep_krn) if c == cl]
            for ep_cls, ep_krn in zip(all_cls, all_krn)
        ]
        stat_by_cls[f"{cl}"] = _stat(cl_lin, cl_krn)

    return MeasureBranchesCkaReport(
        epochs=all_epochs, classes=all_cls, all=stat_all, by_cls=stat_by_cls
    )
