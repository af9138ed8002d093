"""Train-resource report: seconds & device-MiB per training step for the
surrogate and explainer stages, plus setup cost (parity: /root/reference/
scripts/measure_train_resources.py).

Instrumentation: per-step wall time ends at `jax.block_until_ready`;
memory is the device allocator's `peak_bytes_in_use` delta where the
backend exposes `memory_stats()` (the GPU does).  Backends without
allocator stats (the CPU) fall back to XLA's static
`compiled.memory_analysis()` of the step executables (argument + temp +
output bytes — the program's device working set, constant across steps);
`mem_estimator` in the report labels which estimator produced the MiB
cells so they are never silently-meaningless zeros.  The reference always
has allocator stats (torch.cuda, measure_train_resources.py:285-301).
Known reference quirk (measure_train_resources.py:154): the explainer step
reuses `optim_srg` — we use the explainer's own optimizer and document the
deviation here."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from ..ops.shapley import (
    loss_logits_kl_divergence,
    mask_purely_uniform,
    mask_shapley,
)
from ..utils.records import Record
from ..utils.seeding import iterative_key
from ..utils.units import MiBytes, Seconds
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset
from .training import make_optimizer, make_train_step, ones_mask


@dataclasses.dataclass(kw_only=True)
class SecondsStats(Record):
    all: List[Seconds]
    avg: Seconds
    std: Seconds

    @staticmethod
    def from_list(values: List[Seconds]) -> "SecondsStats":
        arr = np.asarray(values) if values else np.zeros(1)
        std = float(arr.std(ddof=1)) if len(arr) > 1 else 0.0
        return SecondsStats(all=values, avg=float(arr.mean()), std=std)


@dataclasses.dataclass(kw_only=True)
class MiBytesStats(Record):
    all: List[MiBytes]
    avg: MiBytes
    std: MiBytes

    @staticmethod
    def from_list(values: List[MiBytes]) -> "MiBytesStats":
        arr = np.asarray(values) if values else np.zeros(1)
        std = float(arr.std(ddof=1)) if len(arr) > 1 else 0.0
        return MiBytesStats(all=values, avg=float(arr.mean()), std=std)


@dataclasses.dataclass(kw_only=True)
class MeasureTrainResourcesReport(Record):
    init_tm: Seconds
    init_mem: MiBytes
    srg_tm: SecondsStats
    srg_mem: MiBytesStats
    exp_tm: SecondsStats
    exp_mem: MiBytesStats
    # which estimator filled the MiB cells: "device_allocator"
    # (peak_bytes_in_use deltas) or "compiled_memory_analysis" (XLA static
    # program analysis — backends without memory_stats)
    mem_estimator: str = "device_allocator"


def _allocator_available() -> bool:
    try:
        stats = jax.local_devices()[0].memory_stats()
        return bool(stats) and "peak_bytes_in_use" in stats
    except Exception:
        return False


def _device_peak_mib() -> float:
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats and "peak_bytes_in_use" in stats:
            return stats["peak_bytes_in_use"] / (1024 * 1024)
    except Exception:
        pass
    return 0.0


def _compiled_mib(jitted, *args) -> float:
    """Static device working set of one executable (0.0 when unavailable);
    the shared estimator lives in measure_performance.compiled_mem_mib."""
    from .measure_performance import compiled_mem_mib

    mib = compiled_mem_mib(jitted, *args)
    return 0.0 if mib is None else mib


def _tree_mib(*trees) -> float:
    """Byte size of pytrees of arrays (init-region fallback: the setup
    phase allocates exactly the params + optimizer states)."""
    total = 0
    for tree in trees:
        for leaf in jax.tree.leaves(tree):
            total += getattr(leaf, "size", 1) * getattr(
                getattr(leaf, "dtype", np.dtype(np.float32)), "itemsize", 4)
    return total / (1024 * 1024)


def measure_train_resources(
    env: ExpEnv, d_loader: Optional[DatasetLoader] = None
) -> MeasureTrainResourcesReport:
    env.log("loading models...")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.allow_train_resources:
        raise ValueError("unsupported recipe action")

    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    n_mask_samples = config.train_explainer.n_mask_samples
    gen_input = recipe.gen_input(m_config, m_misc)

    if d_loader is None:
        env.log("loading dataset...")
        d_config = config.eval_performance.dataset or config.dataset
        d_loader = load_cfg_dataset(d_config, env.model_path)

    # ---- setup resources: fresh params + optimizers
    use_allocator = _allocator_available()
    mem_before = _device_peak_mib()
    t0 = time.perf_counter()
    key = iterative_key(config.seed, "measure_train_resources")
    k_cls, k_srg, k_exp = jax.random.split(key, 3)
    cls_params = recipe.init_classifier(k_cls, m_config)
    srg_params = recipe.init_surrogate(k_srg, m_config)
    exp_params = recipe.init_explainer(k_exp, m_config)
    tx_srg, opt_srg = make_optimizer(
        srg_params, recipe.trainable(m_config, "surrogate")
    )
    tx_exp, opt_exp = make_optimizer(
        exp_params, recipe.trainable(m_config, "explainer")
    )
    jax.block_until_ready(exp_params)
    init_tm = time.perf_counter() - t0
    if use_allocator:
        init_mem = max(0.0, _device_peak_mib() - mem_before)
    else:  # static estimate: setup allocates the params + optimizer states
        init_mem = _tree_mib(cls_params, srg_params, exp_params,
                             opt_srg, opt_exp)
    env.log(f"init: {init_tm:.6f} s, {init_mem:.2f} MB")

    batch_size = config.eval_train_resources.batch_size
    max_samples = config.eval_train_resources.max_samples
    lr_srg = jnp.asarray(config.train_surrogate.lr)
    lr_exp = jnp.asarray(config.train_explainer.lr)

    nil_xs = jnp.asarray(recipe.gen_null(m_config, m_misc))
    nil_mask = jnp.ones((1, n_players), jnp.int32)
    surrogate_null, _ = recipe.fw_surrogate(m_config, srg_params, nil_xs, nil_mask)

    # ---- surrogate step
    def srg_loss(p, xs, mask, orig, rng):
        adapt, _ = recipe.fw_surrogate(
            m_config, p, xs, mask, deterministic=False, rng=rng
        )
        return loss_logits_kl_divergence(orig, adapt), None

    srg_step = make_train_step(tx_srg, srg_loss)
    # measurement teachers run UNQUANTIZED (unlike the production
    # trainer's int8-teacher default): report numerics stay
    # reference-parity; deliberately NOT parallel.train_step._make_teacher
    teacher = jax.jit(
        lambda p, xs, mask: recipe.fw_classifier(m_config, p, xs, mask)[1]
    )
    srg_mask = ones_mask(srg_params)

    srg_tms: List[float] = []
    srg_mems: List[float] = []
    seen = 0
    for batch_idx, (_inputs, _targets) in enumerate(d_loader.train(batch_size)):
        if seen >= max_samples:
            break
        xs, _zs = gen_input(_inputs, _targets)
        xs = jnp.asarray(xs)
        size = xs.shape[0]
        rng = jax.random.fold_in(key, 100 + batch_idx)
        mask_rand = mask_purely_uniform(rng, size, n_players)
        mask_1 = jnp.ones((size, n_players), jnp.int32)
        if batch_idx == 0:  # warm both executables outside timing
            orig = teacher(cls_params, xs, mask_1)
            jax.block_until_ready(orig)
            srg_step(srg_params, opt_srg, lr_srg, srg_mask, xs, mask_rand,
                     orig, rng)
            if not use_allocator:
                # static fallback: the timed region runs two executables in
                # sequence — its working set is the larger of the two
                srg_mem_static = max(
                    _compiled_mib(teacher, cls_params, xs, mask_1),
                    _compiled_mib(srg_step, srg_params, opt_srg, lr_srg,
                                  srg_mask, xs, mask_rand, orig, rng),
                )
        mem_a = _device_peak_mib()
        # the teacher forward is INSIDE the timed region: the reference
        # computes orig_Ys within its timed _step (scripts/
        # measure_train_resources.py:178-259), and the production trainer's
        # fused step includes the teacher sweep (~80% of step time)
        t0 = time.perf_counter()
        orig = teacher(cls_params, xs, mask_1)
        srg_params, opt_srg, _loss, _aux = srg_step(
            srg_params, opt_srg, lr_srg, srg_mask, xs, mask_rand, orig, rng
        )
        jax.block_until_ready(srg_params)
        srg_tms.append((time.perf_counter() - t0) / size)
        srg_mems.append(max(0.0, _device_peak_mib() - mem_a)
                        if use_allocator else srg_mem_static)
        seen += size
    env.log(f"surrogate: {np.mean(srg_tms):.6f} s/sample over {seen} samples")

    # ---- explainer step (own optimizer; see module docstring re: reference
    # quirk using optim_srg here)
    def exp_loss(p, xs, masks_bmp, v_0, v_s, v_1, rng):
        b = masks_bmp.shape[0]
        mask_1 = jnp.ones((b, n_players), jnp.int32)
        phi, _ = recipe.fw_explainer(
            m_config, p, xs, mask_1, v_1, v_0, deterministic=False, rng=rng
        )
        from ..ops.shapley import loss_shapley

        return loss_shapley(masks_bmp, v_0, v_s, v_1, phi), None

    exp_step = make_train_step(tx_exp, exp_loss)
    exp_mask = ones_mask(exp_params)

    @jax.jit
    def exp_teacher(p, xs, masks_bmp):
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

    exp_tms: List[float] = []
    exp_mems: List[float] = []
    seen = 0
    for batch_idx, (_inputs, _targets) in enumerate(d_loader.train(batch_size)):
        if seen >= max_samples:
            break
        xs, _zs = gen_input(_inputs, _targets)
        xs = jnp.asarray(xs)
        size = xs.shape[0]
        rng = jax.random.fold_in(key, 200 + batch_idx)
        masks = mask_shapley(rng, size * n_mask_samples, n_players).reshape(
            size, n_mask_samples, n_players
        )
        if batch_idx == 0:  # warm both executables outside timing
            v_s, v_1 = exp_teacher(srg_params, xs, masks)
            jax.block_until_ready(v_s)
            exp_step(exp_params, opt_exp, lr_exp, exp_mask, xs, masks,
                     surrogate_null, v_s, v_1, rng)
            if not use_allocator:
                exp_mem_static = max(
                    _compiled_mib(exp_teacher, srg_params, xs, masks),
                    _compiled_mib(exp_step, exp_params, opt_exp, lr_exp,
                                  exp_mask, xs, masks, surrogate_null,
                                  v_s, v_1, rng),
                )
        mem_a = _device_peak_mib()
        # teacher coalition sweep timed with the step (reference parity —
        # surrogate_values are computed inside its timed _step)
        t0 = time.perf_counter()
        v_s, v_1 = exp_teacher(srg_params, xs, masks)
        exp_params, opt_exp, _loss, _aux = exp_step(
            exp_params, opt_exp, lr_exp, exp_mask, xs, masks,
            surrogate_null, v_s, v_1, rng,
        )
        jax.block_until_ready(exp_params)
        exp_tms.append((time.perf_counter() - t0) / size)
        exp_mems.append(max(0.0, _device_peak_mib() - mem_a)
                        if use_allocator else exp_mem_static)
        seen += size
    env.log(f"explainer: {np.mean(exp_tms):.6f} s/sample over {seen} samples")

    return MeasureTrainResourcesReport(
        init_tm=init_tm,
        init_mem=init_mem,
        srg_tm=SecondsStats.from_list(srg_tms),
        srg_mem=MiBytesStats.from_list(srg_mems),
        exp_tm=SecondsStats.from_list(exp_tms),
        exp_mem=MiBytesStats.from_list(exp_mems),
        mem_estimator=("device_allocator" if use_allocator
                       else "compiled_memory_analysis"),
    )
