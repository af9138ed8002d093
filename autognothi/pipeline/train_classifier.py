"""Classifier training stage (parity: /root/reference/scripts/
train_classifier.py).  For vanilla recipes the black-box classifier is fully
frozen so this stage is usually epochs=0; for LTT it trains side branches
(progressively when EXPERIMENTAL_progressive_training is set); for
`pretrain_classifier` the caller passes `unfreeze_all=True`."""

from __future__ import annotations

import math
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.shapley import mask_purely_uniform  # noqa: F401  (parity import)
from ..utils.seeding import iterative_key, set_iterative_seed
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        maybe_restore_opt_state, save_epoch_ckpt)
from ..ops.flash_attention import xla_attention
from .training import (
    LossDrain,
    graceful_training,
    maybe_enable_debug_nans,
    cast_input,
    cosine_lr,
    cross_entropy_on_probs,
    filter_mask,
    make_optimizer,
    make_train_step,
    ones_mask,
    pad_batch,
)


@graceful_training
def train_classifier(env: ExpEnv, unfreeze_all: bool = False) -> None:
    env.log("[[[ train classifier ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_classifier:
        env.log("[[[ skip: classifier cannot be trained ]]]")
        return

    d_loader = load_cfg_dataset(config.dataset, env.model_path)
    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    epoch_start, params = load_epoch_model(env, recipe, "classifier")
    if epoch_start >= config.train_classifier.epochs:
        env.log("[[[ classifier already trained ]]]")
        return

    trainable = (
        (lambda name: True) if unfreeze_all
        else recipe.trainable(m_config, "classifier")
    )

    # LTT recipes take a *traced* ladder-depth knob (progressive training
    # truncates the side ladder in the forward, ltt_bert.py:463-497)
    is_ltt = recipe.progressive_trainable is not None
    full_depth = getattr(m_config, "num_hidden_layers", 0)

    from ..parallel.pipeline import pp_config_from_env

    pp_cfg = pp_config_from_env()
    if pp_cfg is not None:
        from .pp_trainer import setup_pp_classifier

        (params, tx, opt_state, step, eval_fwd, place_batch,
         to_flat) = setup_pp_classifier(env, config, m_config, params,
                                        trainable, *pp_cfg)
    else:
        from ..parallel.mesh import setup_data_parallel

        mesh, place_params, place_batch = setup_data_parallel()
        if mesh is not None:
            env.log(f"[[[ data-parallel over {mesh.devices.size} devices ]]]")
            params = place_params(params)
        tx, opt_state = make_optimizer(params, trainable)

        def loss_fn(p, xs, mask, labels, rng, ltt_active, weights):
            kw = {"ltt_active_layers": ltt_active} if is_ltt else {}
            # XLA path under a mesh (GSPMD would replicate a pallas_call
            # behind all-gathers — ops.flash_attention.xla_attention)
            with xla_attention(sharded=True):
                probs, _ = recipe.fw_classifier(
                    m_config, p, xs, mask, deterministic=False, rng=rng, **kw
                )
            loss = cross_entropy_on_probs(probs, labels, weights)
            return loss, probs

        step = make_train_step(tx, loss_fn)

        def _eval(p, xs, mask, labels, weights, ltt_active):
            # one executable per eval batch: probs AND the loss (eager
            # cross-entropy costs ~6 dispatches per batch)
            with xla_attention(sharded=True):
                probs = recipe.fw_classifier(
                    m_config, p, xs, mask,
                    **({"ltt_active_layers": ltt_active} if is_ltt else {}),
                )[0]
            return probs, cross_entropy_on_probs(probs, labels, weights)

        eval_fwd = jax.jit(_eval)
        to_flat = lambda p: p  # noqa: E731

    # exact resume (AUTOGNOTHI_CKPT_OPT=1): reload Adam moments saved at
    # the resume epoch; no-op otherwise (reference rebuilds from zero)
    opt_state = maybe_restore_opt_state(
        env.model_path, "classifier", epoch_start, opt_state)

    for epoch in range(epoch_start + 1, config.train_classifier.epochs + 1):
        set_iterative_seed(config.seed, f"train_classifier[epoch={epoch}]")
        rng = iterative_key(config.seed, f"train_classifier[epoch={epoch}]")
        env.log(f"### epoch {epoch}")

        update_mask = ones_mask(params)
        ltt_active = jnp.asarray(full_depth, jnp.int32)
        if config.train_classifier.EXPERIMENTAL_progressive_training and \
                recipe.progressive_trainable is not None:
            unfrozen = min(math.ceil(epoch / 1), m_config.num_hidden_layers)
            env.log(f"  > freeze side branches exc. first {unfrozen} layers")
            update_mask = filter_mask(
                params, recipe.progressive_trainable(m_config, "classifier", unfrozen)
            )
            ltt_active = jnp.asarray(unfrozen, jnp.int32)

        lr = cosine_lr(config.train_classifier.lr, epoch,
                       config.train_classifier.epochs)
        ts_begin = time.time()

        def run_epoch(tag: str) -> tuple:
            nonlocal params, opt_state
            state = {"loss": 0.0, "correct": 0, "total": 0}

            def emit(batch_idx, vals, host):
                loss_val, probs_np = float(vals[0]), np.asarray(vals[1])
                zs_np, batch = host
                state["loss"] += loss_val
                state["correct"] += int(
                    np.sum(np.argmax(probs_np[:batch], axis=1) == zs_np))
                state["total"] += batch
                env.log(
                    f"  > epoch {epoch} :{batch_idx}:{tag} // "
                    f"loss: cls {loss_val / batch:.6f} // "
                    f"acc: {100.0 * state['correct'] / state['total']:.3f}%, "
                    f"{state['correct']}/{state['total']}"
                )

            drain = LossDrain(emit)
            items = (
                d_loader.train(config.train_classifier.batch_size)
                if tag == "train"
                else d_loader.test(config.train_classifier.batch_size)
            )
            for batch_idx, (_inputs, _targets) in enumerate(items):
                xs, zs = gen_input(_inputs, _targets)
                batch = xs.shape[0]
                xs, zs_p, weights = pad_batch(
                    xs, zs, config.train_classifier.batch_size)
                xs = place_batch(cast_input(jnp.asarray(xs)))
                w = jnp.asarray(weights)
                mask_1 = jnp.ones((xs.shape[0], n_players), dtype=jnp.int32)
                if tag == "train":
                    step_rng = jax.random.fold_in(rng, batch_idx)
                    params, opt_state, loss, probs = step(
                        params, opt_state, lr, update_mask,
                        xs, mask_1, jnp.asarray(zs_p), step_rng, ltt_active, w,
                    )
                else:
                    probs, loss = eval_fwd(params, xs, mask_1,
                                           jnp.asarray(zs_p), w, ltt_active)
                drain.push((loss, probs), (np.asarray(zs), batch))
            drain.flush()
            total = max(state["total"], 1)
            return state["loss"] / total, state["correct"] / total

        train_loss, train_acc = run_epoch("train")
        test_loss, test_acc = run_epoch("test")

        ts_delta = time.time() - ts_begin
        env.metrics({
            "epoch": epoch,
            "train_cls_loss": train_loss,
            "train_cls_acc": train_acc,
            "test_cls_loss": test_loss,
            "test_cls_acc": test_acc,
        })
        env.log(
            f"  > epoch {epoch} done in {ts_delta:.2f}s // "
            f"train_loss: cls {train_loss:.6f} // "
            f"test_loss: cls {test_loss:.6f} // test_acc: {test_acc:.3f}"
        )
        if save_epoch_ckpt(env.model_path, "classifier",
                           config.train_classifier, epoch, to_flat(params),
                           opt_state=opt_state):
            env.flush_cfg()

