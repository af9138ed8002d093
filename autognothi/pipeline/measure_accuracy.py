"""Masked-accuracy report: surrogate accuracy vs number of masked players
(parity: /root/reference/scripts/measure_accuracy.py)."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from ..ops.shapley import mask_uniform_selective
from ..utils.records import Record
from ..utils.seeding import iterative_key
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset, load_epoch_model


@dataclasses.dataclass(kw_only=True)
class MeasureAccuracyReport(Record):
    """Surrogate accuracy at `resolution` masked-player counts spread over
    [0, n_players].  Requires: surrogate [ep]."""

    masked_players: List[int]
    accuracy: List[float]


def measure_accuracy(
    env: ExpEnv, d_loader: Optional[DatasetLoader] = None
) -> MeasureAccuracyReport:
    env.log("[[[ measuring model accuracy ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.allow_accuracy:
        raise ValueError("unsupported recipe action")

    if d_loader is None:
        env.log("loading dataset...")
        d_config = config.eval_accuracy.dataset or config.dataset
        d_loader = load_cfg_dataset(d_config, env.model_path)

    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)
    epoch_srg, srg_params = load_epoch_model(env, recipe, "surrogate")

    # embarrassingly parallel over the batch (SURVEY §2.9): params
    # replicated, batch sharded along the data mesh — identical math.
    # shard_map (not plain GSPMD jit) so the fused kernels run per-shard
    from ..parallel.mesh import setup_data_parallel, sharded_eval_fn

    mesh, place_params, place_batch = setup_data_parallel()
    srg_params = place_params(srg_params)

    def _fwd(p, xs, mask):
        return recipe.fw_surrogate(m_config, p, xs, mask)[0]

    fwd = sharded_eval_fn(_fwd, mesh, in_axes=(None, 0, 0))

    env.log("[[[ measuring surrogate... ]]]")
    all_masked = np.linspace(0, n_players, config.eval_accuracy.resolution,
                             dtype=np.int64).tolist()
    all_acc: List[float] = []
    for n_masked in all_masked:
        ts_begin = time.time()
        correct, total = 0, 0
        for batch_idx, (_inputs, _targets) in enumerate(
            d_loader.test(config.train_surrogate.batch_size)
        ):
            xs, zs = gen_input(_inputs, _targets)
            batch = xs.shape[0]
            key = iterative_key(
                config.seed, f"measure_accuracy[mask={n_masked},batch={batch_idx}]"
            )
            mask = mask_uniform_selective(key, batch, n_players, int(n_masked))
            probs = fwd(srg_params, place_batch(jnp.asarray(xs)),
                        place_batch(mask))
            correct += int(np.sum(np.argmax(np.asarray(probs), axis=1) == zs))
            total += batch
            env.log(
                f"  > mask {n_masked} :{batch_idx}:test // "
                f"acc: {100.0 * correct / total:.3f}%, {correct}/{total}"
            )
        acc = correct / max(total, 1)
        all_acc.append(acc)
        env.log(
            f"  > mask {n_masked} done in {time.time() - ts_begin:.2f}s // "
            f"test_acc: {acc:.3f}"
        )

    return MeasureAccuracyReport(masked_players=all_masked, accuracy=all_acc)
