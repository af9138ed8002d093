"""The fused, shardable explainer step — the framework's hot path.

One XLA program per step: on-device paired-complement coalition sampling,
the B*M masked surrogate teacher forwards (embeddings amortized via the
recipe's coalition fast path), the explainer forward/backward, and the AdamW
update.  Under a Mesh, the batch/coalition axes shard along "data" and the
Megatron param specs (parallel.mesh.param_pspec) shard attention/MLP blocks
along "model"; GSPMD inserts the psum/all-reduce collectives.

This module is consumed by BOTH the production trainer
(pipeline/train_explainer.py) and the multichip dryrun / benches, so the
benchmarked step is exactly what training runs.  The step carries two
dynamic-freeze controls so LTT progressive training reuses the same
compiled executable across epochs:

- `update_mask`: per-param 0/1 scalars multiplied into gradients and
  updates (frozen side branches keep zero Adam moments — torch semantics);
- `ltt_active`: traced active-depth scalar forwarded to the recipe as
  `ltt_active_layers` when the recipe supports progressive training.

Replaces the reference's five-kernel-launch + host-rng + input-replication
loop (/root/reference/scripts/train_explainer.py:148-206).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from ..ops.flash_attention import xla_attention
from ..ops.shapley import loss_shapley, mask_shapley
from ..recipes.types import ModelRecipe, Params, surrogate_coalition_values


def _ltt_kwargs(recipe: ModelRecipe, ltt_active):
    if recipe.progressive_trainable is not None:
        return {"ltt_active_layers": ltt_active}
    return {}


def _make_teacher(
    recipe: ModelRecipe, m_config: Any, n_players: int, mesh=None
) -> Callable:
    """The no-grad teacher sweep (the B*M masked surrogate forwards).  With
    a mesh it runs under shard_map over the batch axis so the attention
    kernel executes per-shard on several devices (the GSPMD fallback would
    replicate a pallas_call behind all-gathers; parallel.mesh.sharded_call).

    On the pp trainer's ("data", "pipe") mesh the batch still splits over
    "data" ONLY, leaving each pipe pair computing identical teacher
    forwards.  A joint ("data", "pipe") split (2x teacher compute at P=2)
    was built and REVERTED in r5: the pipe->data reshard collective it
    induces overlaps the pipeline's collective-permutes, and the XLA:CPU
    thunk runtime DEADLOCKS on that program when the executable is loaded
    from the persistent compile cache (rendezvous termination timeout —
    freshly compiled it runs fine).  Revisit on several GPUs / a newer
    XLA."""

    def inner(srg_params: Params, xs, masks_bmp):
        b = masks_bmp.shape[0]
        mask_1 = jnp.ones((b, n_players), dtype=jnp.int32)
        v_s = surrogate_coalition_values(
            recipe, m_config, srg_params, xs, masks_bmp
        )
        v_1, _ = recipe.fw_surrogate(m_config, srg_params, xs, mask_1)
        return v_s, v_1

    def teacher(srg_params: Params, xs, masks_bmp):
        # pure-DP meshes only: under Megatron TP the teacher params are
        # model-sharded and GSPMD must keep partitioning them (shard_map
        # with replicated param specs would all-gather the whole model)
        dp_only = mesh is not None and dict(mesh.shape).get("model", 1) == 1
        if dp_only and xs.shape[0] % mesh.shape["data"] == 0 \
                and xs.shape[0] >= mesh.shape["data"]:
            from .mesh import sharded_call

            return sharded_call(inner, mesh, in_axes=(None, 0, 0),
                                out_axes=0)(srg_params, xs, masks_bmp)
        with xla_attention(sharded=True):
            return inner(srg_params, xs, masks_bmp)

    return teacher


def make_explainer_train_step(
    recipe: ModelRecipe,
    m_config: Any,
    n_players: int,
    n_mask_samples: int,
    tx: optax.GradientTransformation,
    mesh=None,
) -> Callable:
    """-> step(params, opt_state, srg_params, surrogate_null, xs, key, lr,
               update_mask, ltt_active) -> (params, opt_state, loss)

    `update_mask` is a per-param 0/1 scalar dict (pipeline.training.ones_mask
    / filter_mask); `ltt_active` an int32 scalar (ignored by non-LTT
    recipes).  `key` seeds both the coalition sampler and dropout.  `mesh`
    (optional): the trainer's data mesh — the teacher sweep then keeps the
    attention kernel per-shard via shard_map instead of pinning to XLA.
    """
    teacher = _make_teacher(recipe, m_config, n_players, mesh)

    def loss_fn(params, xs, masks_bmp, v_0, v_s, v_1, rng, ltt_active,
                weights):
        b = masks_bmp.shape[0]
        mask_1 = jnp.ones((b, n_players), dtype=jnp.int32)
        with xla_attention(sharded=True):
            phi, _ = recipe.fw_explainer(
                m_config, params, xs, mask_1, v_1, v_0,
                deterministic=False, rng=rng,
                **_ltt_kwargs(recipe, ltt_active),
            )
        return loss_shapley(masks_bmp, v_0, v_s, v_1, phi, weights)

    @jax.jit
    def step(
        params, opt_state, srg_params, surrogate_null, xs, key, lr,
        update_mask, ltt_active, weights=None,
    ):
        b = xs.shape[0]
        mask_key, drop_key = jax.random.split(key)
        masks = mask_shapley(mask_key, b * n_mask_samples, n_players)
        masks = masks.reshape(b, n_mask_samples, n_players)
        v_s, v_1 = teacher(srg_params, xs, masks)
        loss, grads = jax.value_and_grad(loss_fn)(
            params, xs, masks, surrogate_null, v_s, v_1, drop_key, ltt_active,
            weights,
        )
        grads = jax.tree.map(lambda g, m: g * m, grads, update_mask)
        opt_state = optax.tree_utils.tree_set(opt_state, learning_rate=lr)
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = jax.tree.map(lambda u, m: u * m, updates, update_mask)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_explainer_eval_step(
    recipe: ModelRecipe,
    m_config: Any,
    n_players: int,
    n_mask_samples: int,
    mesh=None,
) -> Callable:
    """-> eval(params, srg_params, surrogate_null, xs, key, ltt_active)
            -> loss   (deterministic forward, same fused teacher sweep)"""
    teacher = _make_teacher(recipe, m_config, n_players, mesh)

    @jax.jit
    def eval_step(params, srg_params, surrogate_null, xs, key, ltt_active,
                  weights=None):
        b = xs.shape[0]
        mask_key, _ = jax.random.split(key)
        masks = mask_shapley(mask_key, b * n_mask_samples, n_players)
        masks = masks.reshape(b, n_mask_samples, n_players)
        v_s, v_1 = teacher(srg_params, xs, masks)
        mask_1 = jnp.ones((b, n_players), dtype=jnp.int32)
        with xla_attention(sharded=True):
            phi, _ = recipe.fw_explainer(
                m_config, params, xs, mask_1, v_1, surrogate_null,
                **_ltt_kwargs(recipe, ltt_active),
            )
        return loss_shapley(masks, surrogate_null, v_s, v_1, phi, weights)

    return eval_step
