"""Surrogate training stage: KL-distillation of the frozen classifier under
random coalition masks (parity: /root/reference/scripts/train_surrogate.py).

Notes: masks are drawn on-device from the epoch key; the student
forward, BOTH losses (KL + the cls metric) and the optimizer update compile
into one XLA program per batch shape, with the frozen teacher forward as
one more (its output feeds the step as data — two dispatches per batch
total, all device values fetched through LossDrain)."""

from __future__ import annotations

import math
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.shapley import loss_logits_kl_divergence, mask_purely_uniform
from ..utils.seeding import iterative_key, set_iterative_seed
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        maybe_restore_opt_state, save_epoch_ckpt)
from ..ops.flash_attention import xla_attention
from .training import (
    LossDrain,
    graceful_training,
    cast_input,
    maybe_enable_debug_nans,
    cosine_lr,
    cross_entropy_on_probs,
    filter_mask,
    make_optimizer,
    make_train_step,
    ones_mask,
    pad_batch,
)


@graceful_training
def train_surrogate(env: ExpEnv) -> None:
    env.log("[[[ train surrogate ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_surrogate:
        env.log("[[[ skip: surrogate cannot be trained ]]]")
        return

    d_loader = load_cfg_dataset(config.dataset, env.model_path)
    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    _, cls_params = load_epoch_model(env, recipe, "classifier")
    epoch_start, params = load_epoch_model(env, recipe, "surrogate")
    if epoch_start >= config.train_surrogate.epochs:
        env.log("[[[ surrogate already trained ]]]")
        return

    is_ltt = recipe.progressive_trainable is not None
    full_depth = getattr(m_config, "num_hidden_layers", 0)

    def _ltt_kw(ltt_active):
        return {"ltt_active_layers": ltt_active} if is_ltt else {}

    from ..parallel.pipeline import pp_config_from_env

    pp_cfg = pp_config_from_env()
    if pp_cfg is not None:
        from .pp_trainer import setup_pp_surrogate

        (params, cls_params, tx, opt_state, step, eval_fwd, place_batch,
         to_flat) = setup_pp_surrogate(
            env, config, m_config, params, cls_params,
            recipe.trainable(m_config, "surrogate"), *pp_cfg)
    else:
        from ..parallel.mesh import setup_data_parallel

        mesh, place_params, place_batch = setup_data_parallel()
        if mesh is not None:
            env.log(f"[[[ data-parallel over {mesh.devices.size} devices ]]]")
            params = place_params(params)
            cls_params = place_params(cls_params)

        tx, opt_state = make_optimizer(
            params, recipe.trainable(m_config, "surrogate"))

        def loss_fn(p, xs, mask, orig_ys, labels, rng, ltt_active, weights):
            # XLA path under a mesh (ops.flash_attention.xla_attention)
            with xla_attention(sharded=True):
                adapt_ys, _ = recipe.fw_surrogate(
                    m_config, p, xs, mask, deterministic=False, rng=rng,
                    **_ltt_kw(ltt_active),
                )
            kld = loss_logits_kl_divergence(orig_ys, adapt_ys, weights)
            # the cls metric rides the SAME executable (eagerly it costs ~6
            # dispatches per batch)
            cls = cross_entropy_on_probs(adapt_ys, labels, weights)
            return kld, (cls, adapt_ys)

        step = make_train_step(tx, loss_fn)

        def _eval(p, xs, mask, orig_ys, labels, weights, ltt_active):
            with xla_attention(sharded=True):
                adapt_ys = recipe.fw_surrogate(
                    m_config, p, xs, mask, **_ltt_kw(ltt_active)
                )[0]
            return (adapt_ys,
                    loss_logits_kl_divergence(orig_ys, adapt_ys, weights),
                    cross_entropy_on_probs(adapt_ys, labels, weights))

        eval_fwd = jax.jit(_eval)
        to_flat = lambda p: p  # noqa: E731

    # exact resume (AUTOGNOTHI_CKPT_OPT=1): reload Adam moments saved at
    # the resume epoch; no-op otherwise (reference rebuilds from zero)
    opt_state = maybe_restore_opt_state(
        env.model_path, "surrogate", epoch_start, opt_state)

    def _teacher(p, xs, mask):
        # frozen no-grad teacher: XLA-path under a mesh (GSPMD replicates
        # pallas_calls behind all-gathers — ops.flash_attention);
        # under pp the teacher is NOT pipelined — it is grad-free, so there
        # is no optimizer state to shard, and GSPMD data-shards it fine
        with xla_attention(sharded=True):
            return recipe.fw_classifier(m_config, p, xs, mask)[1]

    teacher_fwd = jax.jit(_teacher)

    def run_epoch(epoch: int, rng, lr, update_mask, ltt_active, train: bool):
        nonlocal params, opt_state
        state = {"kld": 0.0, "cls": 0.0, "correct": 0, "total": 0}
        tag = "train" if train else "test"

        def emit(batch_idx, vals, host):
            kld_val, cls_val, adapt_np = (
                float(vals[0]), float(vals[1]), np.asarray(vals[2]))
            zs_np, batch = host
            state["kld"] += kld_val
            state["cls"] += cls_val
            state["correct"] += int(
                np.sum(np.argmax(adapt_np[:batch], axis=1) == zs_np))
            state["total"] += batch
            env.log(
                f"  > epoch {epoch} :{batch_idx}:{tag} // "
                f"loss: kld {kld_val / batch:.6f} cls {cls_val / batch:.6f} // "
                f"acc: {100.0 * state['correct'] / state['total']:.3f}%, "
                f"{state['correct']}/{state['total']}"
            )

        drain = LossDrain(emit)
        items = (
            d_loader.train(config.train_surrogate.batch_size) if train
            else d_loader.test(config.train_surrogate.batch_size)
        )
        for batch_idx, (_inputs, _targets) in enumerate(items):
            xs, zs = gen_input(_inputs, _targets)
            batch = xs.shape[0]
            xs, zs_p, weights = pad_batch(
                xs, zs, config.train_surrogate.batch_size)
            xs = place_batch(cast_input(jnp.asarray(xs)))
            w = jnp.asarray(weights)
            padded = xs.shape[0]
            mask_key = jax.random.fold_in(rng, 2 * batch_idx)
            step_rng = jax.random.fold_in(rng, 2 * batch_idx + 1)
            mask_1 = jnp.ones((padded, n_players), dtype=jnp.int32)
            mask_rand = mask_purely_uniform(mask_key, padded, n_players)
            orig_ys = teacher_fwd(cls_params, jnp.asarray(xs), mask_1)
            if train:
                params, opt_state, loss_kld, (loss_cls, adapt_ys) = step(
                    params, opt_state, lr, update_mask,
                    jnp.asarray(xs), mask_rand, orig_ys, jnp.asarray(zs_p),
                    step_rng, ltt_active, w,
                )
            else:
                adapt_ys, loss_kld, loss_cls = eval_fwd(
                    params, jnp.asarray(xs), mask_rand, orig_ys,
                    jnp.asarray(zs_p), w, ltt_active)
            drain.push((loss_kld, loss_cls, adapt_ys), (np.asarray(zs), batch))
        drain.flush()
        total = max(state["total"], 1)
        return state["kld"] / total, state["cls"] / total, state["correct"] / total

    for epoch in range(epoch_start + 1, config.train_surrogate.epochs + 1):
        set_iterative_seed(config.seed, f"train_surrogate[epoch={epoch}]")
        rng = iterative_key(config.seed, f"train_surrogate[epoch={epoch}]")
        env.log(f"### epoch {epoch}")

        update_mask = ones_mask(params)
        ltt_active = jnp.asarray(full_depth, jnp.int32)
        if config.train_surrogate.EXPERIMENTAL_progressive_training and \
                recipe.progressive_trainable is not None:
            unfrozen = min(math.ceil(epoch / 3), m_config.num_hidden_layers)
            env.log(f"  > freeze side branches exc. first {unfrozen} layers")
            update_mask = filter_mask(
                params, recipe.progressive_trainable(m_config, "surrogate", unfrozen)
            )
            ltt_active = jnp.asarray(unfrozen, jnp.int32)

        lr = cosine_lr(config.train_surrogate.lr, epoch,
                       config.train_surrogate.epochs)
        ts_begin = time.time()
        train_kld, train_cls, train_acc = run_epoch(
            epoch, jax.random.fold_in(rng, 0), lr, update_mask, ltt_active,
            train=True,
        )
        test_kld, test_cls, test_acc = run_epoch(
            epoch, jax.random.fold_in(rng, 1), lr, update_mask, ltt_active,
            train=False,
        )
        ts_delta = time.time() - ts_begin

        env.metrics({
            "epoch": epoch,
            "train_kld_loss": train_kld,
            "train_cls_loss": train_cls,
            "train_cls_acc": train_acc,
            "test_kld_loss": test_kld,
            "test_cls_loss": test_cls,
            "test_cls_acc": test_acc,
        })
        env.log(
            f"  > epoch {epoch} done in {ts_delta:.2f}s // "
            f"train_loss: kld {train_kld:.6f} cls {train_cls:.6f} // "
            f"test_loss: kld {test_kld:.6f} cls {test_cls:.6f} // "
            f"test_acc: {test_acc:.3f}"
        )
        if save_epoch_ckpt(env.model_path, "surrogate",
                           config.train_surrogate, epoch, to_flat(params),
                           opt_state=opt_state):
            env.flush_cfg()
