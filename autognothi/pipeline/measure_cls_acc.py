"""Classifier-accuracy-over-explainer-epochs report (parity:
/root/reference/scripts/measure_cls_acc.py): for each retained explainer
checkpoint (filtered by the `on_exp_epochs` cadence DSL), rebuild the Final
model and measure argmax accuracy through it on the test set."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from ..utils.records import Record
from ..utils.seeding import iterative_key
from ..utils.strings import ranged_modulo_test
from .env import ExpEnv
from .resources import (
    get_epoch_ckpts,
    get_recipe,
    load_cfg_dataset,
    load_epoch_ckpt,
    load_epoch_model,
)


@dataclasses.dataclass(kw_only=True)
class MeasureClsAccReport(Record):
    """Requires: classifier [ep], surrogate [ep], explainer [ep] | final [-1]."""

    epochs: List[int]
    accuracy: List[float]


def measure_cls_acc(
    env: ExpEnv, d_loader: Optional[DatasetLoader] = None
) -> MeasureClsAccReport:
    env.log("[[[ measuring classifier accuracy ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.allow_cls_acc:
        raise ValueError("unsupported recipe action")

    if d_loader is None:
        env.log("loading dataset...")
        d_config = config.eval_cls_acc.dataset or config.dataset
        d_loader = load_cfg_dataset(d_config, env.model_path)

    m_misc = recipe.load_misc(env.model_path, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)
    _, cls_params = load_epoch_model(env, recipe, "classifier")
    _, srg_params = load_epoch_model(env, recipe, "surrogate")

    def measure_on(ep: int) -> bool:
        if config.eval_cls_acc.on_exp_epochs is None:
            return ep == config.train_explainer.epochs
        return ranged_modulo_test(config.eval_cls_acc.on_exp_epochs)(ep)

    # embarrassingly parallel over the batch (SURVEY §2.9): params
    # replicated, batch sharded along the data mesh — identical math.
    # shard_map (not plain GSPMD jit) so the fused kernels run per-shard
    from ..parallel.mesh import setup_data_parallel, sharded_eval_fn

    mesh, place_params, place_batch = setup_data_parallel()

    def _fw_final(p, xs):
        return recipe.fw_final(m_config, p, xs)[0]

    fw_final = sharded_eval_fn(_fw_final, mesh, in_axes=(None, 0))

    env.log("[[[ measuring explainers... ]]]")
    all_epochs: List[int] = []
    all_acc: List[float] = []
    for loading_epoch in get_epoch_ckpts(
        env.model_path, "explainer", config.train_explainer.epochs
    ):
        if not measure_on(loading_epoch):
            continue
        epoch_exp, arrays = load_epoch_ckpt(
            env.model_path, "explainer", loading_epoch, required=True
        )
        exp_params = {k: jnp.asarray(v) for k, v in arrays.items()}
        key = iterative_key(config.seed, f"measure_cls_acc[epoch={epoch_exp}]")
        final_params = place_params(recipe.conv_explainer_final(
            m_config, m_misc, cls_params, srg_params, exp_params, key
        ))

        ts_begin = time.time()
        correct, total = 0, 0
        for batch_idx, (_inputs, _targets) in enumerate(
            d_loader.test(config.train_classifier.batch_size)
        ):
            xs, zs = gen_input(_inputs, _targets)
            probs = fw_final(final_params, place_batch(jnp.asarray(xs)))
            correct += int(np.sum(np.argmax(np.asarray(probs), axis=1) == zs))
            total += xs.shape[0]
            env.log(
                f"  > epoch {epoch_exp} :{batch_idx}:test // "
                f"acc: {100.0 * correct / total:.3f}%, {correct}/{total}"
            )
        acc = correct / max(total, 1)
        all_epochs.append(epoch_exp)
        all_acc.append(acc)
        env.log(
            f"  > epoch {epoch_exp} done in {time.time() - ts_begin:.2f}s // "
            f"test_acc: {acc:.3f}"
        )

    return MeasureClsAccReport(epochs=all_epochs, accuracy=all_acc)
