"""Dual-task gradient-similarity report (parity: /root/reference/scripts/
measure_dual_task_similarity.py): cosine similarity between the input-
embedding gradients of the classification loss and the Shapley loss, for
models trained on both tasks at once (the duo family).

JAX redesign: instead of backward hooks on a mutated module
(TorchGradientHook, :243-280), the recipe supplies a pure `grad_probe`
(cfg, params, xs, mask, grand, null, zs, masks, v_0, v_s, v_1) ->
(grad_cls <B, T, H>, grad_exp <B, T, H>) built from two `jax.grad` calls
with respect to the shared input embedding."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from ..ops.shapley import mask_shapley
from ..utils.records import Record
from ..utils.seeding import iterative_key
from .env import ExpEnv
from .resources import (
    get_epoch_ckpts,
    get_recipe,
    load_cfg_dataset,
    load_epoch_ckpt,
    load_epoch_model,
)


@dataclasses.dataclass(kw_only=True)
class MeasureDualTaskSimilarityReport(Record):
    """Requires: surrogate [-1], explainer [ep], `duo_vanilla` family."""

    epochs: List[int]
    cos_sim_avg: List[float]
    cos_sim_std: List[float]


def measure_dual_task_similarity(
    env: ExpEnv, d_loader: Optional[DatasetLoader] = None
) -> MeasureDualTaskSimilarityReport:
    env.log("loading models...")
    config = env.config
    recipe, m_config = get_recipe(config)
    inspector = recipe.measurements.allow_dual_task_similarity
    if inspector is False or inspector is None:
        raise ValueError("unsupported recipe action")

    if d_loader is None:
        env.log("loading dataset...")
        d_config = (
            config.eval_dual_task_similarity.dataset
            if config.eval_dual_task_similarity is not None
            and config.eval_dual_task_similarity.dataset is not None
            else config.dataset
        )
        d_loader = load_cfg_dataset(d_config, env.model_path)

    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    n_mask_samples = config.train_explainer.n_mask_samples
    gen_input = recipe.gen_input(m_config, m_misc)
    batch_size = (
        config.eval_dual_task_similarity.batch_size
        if config.eval_dual_task_similarity is not None
        else config.train_explainer.batch_size
    )

    _, srg_params = load_epoch_model(env, recipe, "surrogate")
    nil_xs = jnp.asarray(recipe.gen_null(m_config, m_misc))
    nil_mask = jnp.ones((1, n_players), jnp.int32)
    surrogate_null, _ = recipe.fw_surrogate(m_config, srg_params, nil_xs, nil_mask)

    @jax.jit
    def teacher(p, xs, masks_bmp):
        b = masks_bmp.shape[0]
        mask_1 = jnp.ones((b, n_players), jnp.int32)
        if recipe.fw_surrogate_coalitions is not None:
            v_s = recipe.fw_surrogate_coalitions(m_config, p, xs, masks_bmp)
            v_s = v_s.reshape(b * n_mask_samples, -1)
        else:
            xs_ext = jnp.repeat(xs, n_mask_samples, axis=0)
            v_s, _ = recipe.fw_surrogate(
                m_config, p, xs_ext, masks_bmp.reshape(-1, n_players)
            )
        v_1, _ = recipe.fw_surrogate(m_config, p, xs, mask_1)
        return v_s, v_1

    probe = jax.jit(
        lambda p, xs, zs, masks, v_s, v_1: inspector.grad_probe(
            m_config, p, xs, jnp.ones((xs.shape[0], n_players), jnp.int32),
            v_1, surrogate_null, zs, masks, surrogate_null, v_s, v_1,
        )
    )

    env.log("[[[ running measurement... ]]]")
    all_epochs: List[int] = []
    all_avg: List[float] = []
    all_std: List[float] = []
    for loading_epoch in get_epoch_ckpts(
        env.model_path, "explainer", config.train_explainer.epochs
    ):
        epoch_exp, arrays = load_epoch_ckpt(
            env.model_path, "explainer", loading_epoch, required=True
        )
        exp_params = {k: jnp.asarray(v) for k, v in arrays.items()}

        ts_begin = time.time()
        cos_sims: List[float] = []
        for batch_idx, (_inputs, _targets) in enumerate(d_loader.test(batch_size)):
            xs, zs = gen_input(_inputs, _targets)
            xs, zs = jnp.asarray(xs), jnp.asarray(zs)
            batch = xs.shape[0]
            key = iterative_key(
                config.seed,
                f"dual_task[epoch={epoch_exp},batch={batch_idx}]",
            )
            masks = mask_shapley(key, batch * n_mask_samples, n_players)
            masks = masks.reshape(batch, n_mask_samples, n_players)
            v_s, v_1 = teacher(srg_params, xs, masks)
            g_cls, g_exp = probe(exp_params, xs, zs, masks, v_s, v_1)
            g_cls = np.asarray(g_cls).reshape(batch, -1)
            g_exp = np.asarray(g_exp).reshape(batch, -1)
            denom = (
                np.linalg.norm(g_cls, axis=1) * np.linalg.norm(g_exp, axis=1)
            )
            cos = (g_cls * g_exp).sum(axis=1) / np.maximum(denom, 1e-12)
            cos_sims.extend(float(c) for c in cos)
            env.log(
                f"  > epoch {epoch_exp} :{batch_idx}:sim // "
                f"{np.mean(cos):.6f}, fin {len(cos_sims)}"
            )
        arr = np.asarray(cos_sims)
        std = float(arr.std(ddof=1)) if len(arr) > 1 else 0.0
        all_epochs.append(epoch_exp)
        all_avg.append(float(arr.mean()))
        all_std.append(std)
        env.log(
            f"  > epoch {epoch_exp} done in {time.time() - ts_begin:.2f}s // "
            f"cos_sim: avg {all_avg[-1]:.6f} std {all_std[-1]:.6f}"
        )

    return MeasureDualTaskSimilarityReport(
        epochs=all_epochs, cos_sim_avg=all_avg, cos_sim_std=all_std
    )
