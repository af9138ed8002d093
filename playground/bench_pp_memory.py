"""Measure the pipeline-parallel memory model (VERDICT r4 #4).

Two claims, both MEASURED here instead of asserted structurally:

1. Per-rank weight + Adam-moment bytes scale 1/P with pipe depth
   (split_encoder_params keeps the encoder stack, its grads and its
   moments P("pipe")-sharded) — measured from the actual addressable
   shard buffers after one real train step, P in {1, 2, 3, 4}.
2. The GPipe-in-scan schedule stashes activations for all M+P-1 ticks
   for the backward; jax.checkpoint (AUTOGNOTHI_REMAT=1) trades
   recompute for that stash — measured from
   compiled.memory_analysis().temp_size_in_bytes over a microbatch
   sweep, with and without remat.  The 1F1B decision is made FROM this
   table, not speculatively.

Run on the 8-virtual-device CPU mesh:
  env JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python playground/bench_pp_memory.py
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax


def _cfg(layers=12):
    from autognothi.models.vit import VanillaViTConfig

    return VanillaViTConfig(
        attention_probs_dropout_prob=0.0,
        explainer_attn_num_layers=1,
        explainer_head_hidden_size=64,
        explainer_normalize=True,
        hidden_dropout_prob=0.0,
        hidden_size=64,
        intermediate_size=256,
        layer_norm_eps=1e-12,
        num_attention_heads=4,
        num_hidden_layers=layers,
        num_labels=3,
        img_channels=3,
        img_px_size=32,
        img_patch_size=8,
    )


def per_device_bytes(tree, device) -> int:
    total = 0
    for leaf in jax.tree.leaves(tree):
        if not hasattr(leaf, "addressable_shards"):
            continue
        for s in leaf.addressable_shards:
            if s.device == device:
                total += s.data.nbytes
    return total


def measure_param_scaling():
    from autognothi.models.vit import init_vit_classifier
    from autognothi.parallel.pipeline import (
        make_pipe_mesh,
        make_pp_classifier_train_step,
        split_encoder_params,
    )

    cfg = _cfg()
    params = init_vit_classifier(jax.random.PRNGKey(0), cfg)
    rows = []
    # (pipe, tp): pure depth splits P in {1..4}, plus the 3-D composition
    # (pipe x model bricks — per-rank stack bytes must drop 1/(P*T))
    for pipe, tp in ((1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (2, 4)):
        mesh = make_pipe_mesh(pipe * tp, pipe=pipe, model=tp)  # data=1
        rest, stacked = split_encoder_params(params, cfg.num_hidden_layers,
                                             mesh)
        tx = optax.adamw(1e-3)
        opt = tx.init((rest, stacked))
        step = make_pp_classifier_train_step(cfg, tx, mesh, microbatches=2)
        xs = jnp.zeros((2, 3, 32, 32), jnp.float32)
        ones = jnp.ones((2, cfg.n_patches + 1), jnp.float32)
        labels = jnp.zeros((2,), jnp.int32)
        rest, stacked, opt, _ = step(rest, stacked, opt, xs, ones, labels)
        dev = mesh.devices.flat[0]
        stacked_b = per_device_bytes(stacked, dev)
        opt_b = per_device_bytes(opt, dev)
        rest_b = per_device_bytes(rest, dev)
        rows.append((pipe, tp, stacked_b, opt_b, rest_b,
                     stacked_b + opt_b + rest_b))
    print("\n== per-rank weight + opt-state bytes (12-layer mini, post-step)")
    print(f"{'P':>2} {'T':>2} {'stack':>10} {'opt':>10} {'rest':>10} "
          f"{'total':>10} {'stack+opt vs P=T=1':>19}")
    base = rows[0][2] + rows[0][3]
    for pipe, tp, sb, ob, rb, tot in rows:
        print(f"{pipe:>2} {tp:>2} {sb:>10} {ob:>10} {rb:>10} {tot:>10} "
              f"{(sb + ob) / base:>18.4f}")
    return rows


def measure_microbatch_sweep(pipe=2, batch=8):
    """temp_size_in_bytes of the compiled pp step over the microbatch count
    M — the activation-stash vs bubble trade (bubble = (P-1)/(M+P-1))."""
    from autognothi.models.vit import init_vit_classifier
    from autognothi.parallel.pipeline import (
        make_pipe_mesh,
        make_pp_classifier_train_step,
        split_encoder_params,
    )

    cfg = _cfg()
    params = init_vit_classifier(jax.random.PRNGKey(0), cfg)
    mesh = make_pipe_mesh(pipe, pipe=pipe)
    rest, stacked = split_encoder_params(params, cfg.num_hidden_layers, mesh)
    tx = optax.adamw(1e-3)
    opt = tx.init((rest, stacked))
    xs = jnp.zeros((batch, 3, 32, 32), jnp.float32)
    ones = jnp.ones((batch, cfg.n_patches + 1), jnp.float32)
    labels = jnp.zeros((batch,), jnp.int32)

    rows = []
    for m in (1, 2, 4, 8):
        if batch % m:
            continue
        step = make_pp_classifier_train_step(cfg, tx, mesh, microbatches=m)
        exe = step.lower(rest, stacked, opt, xs, ones, labels).compile()
        ma = exe.memory_analysis()
        bubble = (pipe - 1) / (m + pipe - 1)
        rows.append((m, ma.temp_size_in_bytes, bubble))
    remat = os.environ.get("AUTOGNOTHI_REMAT") == "1"
    print(f"\n== compiled pp step temp bytes, P={pipe}, batch={batch}, "
          f"remat={'on' if remat else 'off'}")
    print(f"{'M':>2} {'temp_bytes':>12} {'bubble':>8}")
    for m, tb, bub in rows:
        print(f"{m:>2} {tb:>12} {bub:>8.3f}")
    return rows


if __name__ == "__main__":
    if os.environ.get("_PP_MEM_CHILD") != "1" and \
            os.environ.get("AUTOGNOTHI_REMAT") != "1":
        # parent: run the sweep again with remat in a child (the knob is
        # read at trace time; a fresh process keeps the comparison clean)
        measure_param_scaling()
        measure_microbatch_sweep()
        env = dict(os.environ, AUTOGNOTHI_REMAT="1", _PP_MEM_CHILD="1")
        subprocess.run([sys.executable, __file__], env=env, check=True)
    else:
        measure_microbatch_sweep()
