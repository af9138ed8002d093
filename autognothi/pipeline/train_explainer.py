"""Explainer training stage: Shapley-regression against masked surrogate
values (parity: /root/reference/scripts/train_explainer.py).

This is THE hot loop.  A compiled redesign of the reference's per-batch flow
(train_explainer.py:148-206):
- coalition masks are sampled on-device (no host rng / transfer);
- the B*M masked surrogate forwards go through the recipe's coalition fast
  path (embeddings computed once per input, hidden states batched across the
  coalition axis) instead of replicating inputs in a Python loop;
- coalition sampling + surrogate teacher + explainer fwd/bwd + AdamW compile
  into ONE XLA program: parallel.train_step.make_explainer_train_step — the
  same fused, mesh-shardable step the multichip dryrun and the benches run.
"""

from __future__ import annotations

import math
import time

import jax
import jax.numpy as jnp

from ..parallel.train_step import (
    make_explainer_eval_step,
    make_explainer_train_step,
)
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
    filter_mask,
    make_optimizer,
    ones_mask,
    pad_batch,
)


@graceful_training
def train_explainer(env: ExpEnv) -> None:
    env.log("[[[ train explainer ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_explainer:
        env.log("[[[ skip: explainer cannot be trained ]]]")
        return
    if recipe.training.exp_variant_duo:
        from .train_duo_explainer import train_duo_explainer

        return train_duo_explainer(env)
    if recipe.training.exp_variant_kernel_shap:
        from .train_kernel_shap_explainer import train_kernel_shap_explainer

        return train_kernel_shap_explainer(env)

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

    from ..parallel.pipeline import pp_config_from_env

    pp_cfg = pp_config_from_env()
    if pp_cfg is not None:
        # AUTOGNOTHI_PP: backbone stage-sharded over ("data", "pipe") — the
        # explainer is the one tower trained full-depth from scratch, so its
        # grads + Adam moments are the most depth-proportional state there is
        from .pp_trainer import setup_pp_explainer

        (params, srg_params, tx, opt_state, step, eval_step, place_batch,
         to_flat) = setup_pp_explainer(
            env, config, m_config, params, srg_params, recipe, *pp_cfg)
    else:
        # multi-device: replicate params, shard the batch/coalition axis
        from ..parallel.mesh import setup_data_parallel

        mesh, place_params, place_batch = setup_data_parallel()
        if mesh is not None:
            env.log(f"[[[ data-parallel over {mesh.devices.size} devices ]]]")
            params = place_params(params)
            srg_params = place_params(srg_params)

        tx, opt_state = make_optimizer(
            params, recipe.trainable(m_config, "explainer"))
        # ONE step implementation: the fused, mesh-shardable XLA program from
        # parallel/train_step.py (sampler + teacher + fwd/bwd + AdamW).
        step = make_explainer_train_step(recipe, m_config, n_players,
                                         n_mask_samples, tx, mesh=mesh)
        eval_step = make_explainer_eval_step(recipe, m_config, n_players,
                                             n_mask_samples, mesh=mesh)
        to_flat = lambda p: p  # noqa: E731

    # exact resume (AUTOGNOTHI_CKPT_OPT=1): reload Adam moments saved at
    # the resume epoch; no-op otherwise (reference rebuilds from zero)
    opt_state = maybe_restore_opt_state(
        env.model_path, "explainer", epoch_start, opt_state)

    # surrogate_null: surrogate on the all-on null input, computed once
    nil_xs = jnp.asarray(recipe.gen_null(m_config, m_misc))
    nil_mask = jnp.ones((1, n_players), dtype=jnp.int32)
    surrogate_null, _ = jax.jit(
        lambda p, xs, mask: recipe.fw_surrogate(m_config, p, xs, mask)
    )(srg_params, nil_xs, nil_mask)

    full_depth = getattr(m_config, "num_hidden_layers", 0)

    def run_epoch(epoch: int, rng, lr, update_mask, ltt_active, train: bool):
        nonlocal params, opt_state
        state = {"sum": 0.0, "total": 0}
        tag = "train" if train else "test"

        def emit(batch_idx, vals, host):
            loss_val, (batch,) = float(vals[0]), host
            state["sum"] += loss_val
            state["total"] += batch
            env.log(
                f"  > epoch {epoch} :{batch_idx}:{tag} // "
                f"loss: shap {loss_val / batch:.6f}, fin {state['total']}"
            )

        drain = LossDrain(emit)
        items = (
            d_loader.train(config.train_explainer.batch_size) if train
            else d_loader.test(config.train_explainer.batch_size)
        )
        for batch_idx, (_inputs, _targets) in enumerate(items):
            xs, _zs = gen_input(_inputs, _targets)
            batch = xs.shape[0]
            xs, _, weights = pad_batch(
                xs, None, config.train_explainer.batch_size)
            xs = place_batch(cast_input(jnp.asarray(xs)))
            w = jnp.asarray(weights)
            step_key = jax.random.fold_in(rng, batch_idx)
            if train:
                params, opt_state, loss = step(
                    params, opt_state, srg_params, surrogate_null, xs,
                    step_key, lr, update_mask, ltt_active, w,
                )
            else:
                loss = eval_step(params, srg_params, surrogate_null, xs,
                                 step_key, ltt_active, w)
            drain.push((loss,), (batch,))
        drain.flush()
        return state["sum"] / max(state["total"], 1)

    for epoch in range(epoch_start + 1, config.train_explainer.epochs + 1):
        set_iterative_seed(config.seed, f"train_explainer[epoch={epoch}]")
        rng = iterative_key(config.seed, f"train_explainer[epoch={epoch}]")
        env.log(f"### epoch {epoch}")

        update_mask = ones_mask(params)
        ltt_active = jnp.asarray(full_depth, jnp.int32)
        if config.train_explainer.EXPERIMENTAL_progressive_training and \
                recipe.progressive_trainable is not None:
            unfrozen = min(math.ceil(epoch / 2), m_config.num_hidden_layers)
            env.log(f"  > freeze side branches exc. first {unfrozen} layers")
            update_mask = filter_mask(
                params, recipe.progressive_trainable(m_config, "explainer", unfrozen)
            )
            ltt_active = jnp.asarray(unfrozen, jnp.int32)

        lr = cosine_lr(config.train_explainer.lr, epoch,
                       config.train_explainer.epochs)
        ts_begin = time.time()
        train_loss = run_epoch(
            epoch, jax.random.fold_in(rng, 0), lr, update_mask, ltt_active,
            train=True,
        )
        test_loss = run_epoch(
            epoch, jax.random.fold_in(rng, 1), lr, update_mask, ltt_active,
            train=False,
        )
        ts_delta = time.time() - ts_begin

        env.metrics({
            "epoch": epoch,
            "train_reg_loss": train_loss,
            "test_reg_loss": test_loss,
            "test_plots": [],
        })
        env.log(
            f"  > epoch {epoch} done in {ts_delta:.2f}s // "
            f"train_loss: shap {train_loss:.6f} // "
            f"test_loss: shap {test_loss:.6f}"
        )
        if save_epoch_ckpt(env.model_path, "explainer",
                           config.train_explainer, epoch, to_flat(params),
                           opt_state=opt_state):
            env.flush_cfg()
