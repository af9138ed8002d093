"""Duo explainer trainer: joint classification + Shapley objective
(parity: /root/reference/scripts/train_duo_explainer.py, loss = cls + shap
at :195).  Shares the structure of train_explainer: on-device
masks, coalition fast path, one fused step."""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.shapley import loss_shapley, mask_shapley
from ..utils.seeding import iterative_key, set_iterative_seed
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        maybe_restore_opt_state, save_epoch_ckpt)
from .training import (
    LossDrain,
    graceful_training,
    cast_input,
    maybe_enable_debug_nans,
    cosine_lr,
    cross_entropy_on_probs,
    make_optimizer,
    make_train_step,
    ones_mask,
    pad_batch,
)


@graceful_training
def train_duo_explainer(env: ExpEnv) -> None:
    env.log("[[[ train duo explainer ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)

    d_loader = load_cfg_dataset(config.dataset, env.model_path)
    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    n_mask_samples = config.train_explainer.n_mask_samples
    gen_input = recipe.gen_input(m_config, m_misc)

    _, srg_params = load_epoch_model(env, recipe, "surrogate")
    epoch_start, params = load_epoch_model(env, recipe, "explainer")
    if epoch_start >= config.train_explainer.epochs:
        env.log("[[[ explainer already trained ]]]")
        return

    # multi-device: replicate params, shard the batch/coalition axis
    # (same data-parallel placement as train_explainer.py)
    from ..parallel.mesh import setup_data_parallel

    mesh, place_params, place_batch = setup_data_parallel()
    if mesh is not None:
        env.log(f"[[[ data-parallel over {mesh.devices.size} devices ]]]")
        params = place_params(params)
        srg_params = place_params(srg_params)

    tx, opt_state = make_optimizer(params, recipe.trainable(m_config, "explainer"))
    # exact resume (AUTOGNOTHI_CKPT_OPT=1): reload Adam moments saved at
    # the resume epoch; no-op otherwise (reference rebuilds from zero)
    opt_state = maybe_restore_opt_state(
        env.model_path, "explainer", epoch_start, opt_state)

    nil_xs = jnp.asarray(recipe.gen_null(m_config, m_misc))
    nil_mask = jnp.ones((1, n_players), dtype=jnp.int32)
    surrogate_null, _ = jax.jit(
        lambda p, xs, mask: recipe.fw_surrogate(m_config, p, xs, mask)
    )(srg_params, nil_xs, nil_mask)

    # the shared teacher helper: routed through shard_map under a mesh
    # exactly like the single-explainer step (parallel.train_step)
    from ..ops.flash_attention import xla_attention
    from ..parallel.train_step import _make_teacher

    teacher = jax.jit(_make_teacher(recipe, m_config, n_players, mesh))

    def joint_loss(p, xs, zs, masks_bmp, v_0, v_s, v_1, rng, weights):
        b = masks_bmp.shape[0]
        mask_1 = jnp.ones((b, n_players), jnp.int32)
        with xla_attention(sharded=True):
            phi, base_ys = recipe.fw_explainer(
                m_config, p, xs, mask_1, v_1, v_0,
                deterministic=rng is None, rng=rng,
            )
        loss_cls = cross_entropy_on_probs(base_ys, zs, weights)
        loss_shap = loss_shapley(masks_bmp, v_0, v_s, v_1, phi, weights)
        return loss_cls + loss_shap, (loss_cls, loss_shap, base_ys)

    step = make_train_step(tx, joint_loss)
    eval_loss = jax.jit(
        lambda p, xs, zs, masks, v_0, v_s, v_1, weights: joint_loss(
            p, xs, zs, masks, v_0, v_s, v_1, None, weights
        )
    )

    def run_epoch(epoch: int, rng, lr, train: bool):
        nonlocal params, opt_state
        state = {"cls": 0.0, "reg": 0.0, "tot": 0.0, "correct": 0, "total": 0}
        tag = "train" if train else "test"

        def emit(batch_idx, vals, host):
            cls_v, reg_v, tot_v, base_np = (
                float(vals[0]), float(vals[1]), float(vals[2]),
                np.asarray(vals[3]))
            zs_np, batch = host
            state["cls"] += cls_v
            state["reg"] += reg_v
            state["tot"] += tot_v
            state["correct"] += int(
                np.sum(np.argmax(base_np[:batch], axis=1) == zs_np))
            state["total"] += batch
            env.log(
                f"  > epoch {epoch} :{batch_idx}:{tag} // "
                f"loss: cls {cls_v / batch:.6f} shap {reg_v / batch:.6f} "
                f"tot {tot_v / batch:.6f} // "
                f"acc: {100.0 * state['correct'] / state['total']:.3f}%, "
                f"{state['correct']}/{state['total']}"
            )

        drain = LossDrain(emit)
        items = (
            d_loader.train(config.train_explainer.batch_size) if train
            else d_loader.test(config.train_explainer.batch_size)
        )
        update_mask = ones_mask(params)
        for batch_idx, (_inputs, _targets) in enumerate(items):
            xs, zs = gen_input(_inputs, _targets)
            batch = xs.shape[0]
            zs_np = np.asarray(zs)
            xs, zs_p, weights = pad_batch(
                xs, zs, config.train_explainer.batch_size)
            xs = place_batch(cast_input(jnp.asarray(xs)))
            zs_j = place_batch(jnp.asarray(zs_p))
            w = place_batch(jnp.asarray(weights))
            padded = xs.shape[0]
            mask_key = jax.random.fold_in(rng, 2 * batch_idx)
            step_rng = jax.random.fold_in(rng, 2 * batch_idx + 1)
            masks = mask_shapley(mask_key, padded * n_mask_samples, n_players)
            masks = place_batch(masks.reshape(padded, n_mask_samples, n_players))
            v_s, v_1 = teacher(srg_params, xs, masks)
            if train:
                params, opt_state, loss, aux = step(
                    params, opt_state, lr, update_mask,
                    xs, zs_j, masks, surrogate_null, v_s, v_1, step_rng, w,
                )
            else:
                loss, aux = eval_loss(params, xs, zs_j, masks, surrogate_null,
                                      v_s, v_1, w)
            loss_cls, loss_shap, base_ys = aux
            drain.push((loss_cls, loss_shap, loss, base_ys),
                       (zs_np, batch))
        drain.flush()
        total = max(state["total"], 1)
        return (state["cls"] / total, state["reg"] / total,
                state["tot"] / total, state["correct"] / total)

    for epoch in range(epoch_start + 1, config.train_explainer.epochs + 1):
        set_iterative_seed(config.seed, f"train_explainer[epoch={epoch}]")
        rng = iterative_key(config.seed, f"train_explainer[epoch={epoch}]")
        env.log(f"### epoch {epoch}")
        lr = cosine_lr(config.train_explainer.lr, epoch,
                       config.train_explainer.epochs)
        ts_begin = time.time()
        tr_cls, tr_reg, tr_tot, tr_acc = run_epoch(
            epoch, jax.random.fold_in(rng, 0), lr, train=True
        )
        te_cls, te_reg, te_tot, te_acc = run_epoch(
            epoch, jax.random.fold_in(rng, 1), lr, train=False
        )
        ts_delta = time.time() - ts_begin

        env.metrics({
            "epoch": epoch,
            "train_cls_loss": tr_cls,
            "train_reg_loss": tr_reg,
            "train_loss": tr_tot,
            "train_cls_acc": tr_acc,
            "test_cls_loss": te_cls,
            "test_reg_loss": te_reg,
            "test_loss": te_tot,
            "test_cls_acc": te_acc,
            "test_plots": [],
        })
        env.log(
            f"  > epoch {epoch} done in {ts_delta:.2f}s // "
            f"train_loss: shap {tr_reg:.6f} // test_loss: shap {te_reg:.6f}"
        )
        if save_epoch_ckpt(env.model_path, "explainer",
                           config.train_explainer, epoch, params,
                           opt_state=opt_state):
            env.flush_cfg()
