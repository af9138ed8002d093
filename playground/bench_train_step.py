"""Benchmark the fused explainer train step on the GPU.

Measures coalition-masked surrogate forwards/sec inside the full training
step (mask sampling + teacher sweep + explainer fwd/bwd + AdamW), comparing
the embed-once coalition fast path against reference-style input
replication.  python playground/bench_train_step.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

BATCH = 8
N_MASK_SAMPLES = 32
WARMUP = 3
ITERS = 5


def main() -> None:
    import jax
    import jax.numpy as jnp

    from autognothi.models.common import cast_tree
    from autognothi.models.vit import init_vit_classifier, init_vit_explainer
    from autognothi.parallel.train_step import make_explainer_train_step
    from autognothi.pipeline.training import make_optimizer, ones_mask
    from autognothi.recipes.vanilla_vit import fw_surrogate, vanilla_vit_recipe
    from __graft_entry__ import _flagship_cfg

    cfg = _flagship_cfg()
    recipe = vanilla_vit_recipe()
    n_players = recipe.n_players(cfg)

    key = jax.random.PRNGKey(0)
    exp_params = cast_tree(init_vit_explainer(key, cfg), jnp.bfloat16)
    srg_params = cast_tree(
        init_vit_classifier(jax.random.fold_in(key, 1), cfg), jnp.bfloat16
    )
    tx, opt_state = make_optimizer(exp_params, lambda name: True)

    nil_xs = jnp.zeros((1, 3, 224, 224), jnp.bfloat16)
    nil_mask = jnp.ones((1, n_players), jnp.int32)
    surrogate_null, _ = fw_surrogate(cfg, srg_params, nil_xs, nil_mask)

    xs = jax.random.normal(jax.random.PRNGKey(2), (BATCH, 3, 224, 224),
                           jnp.bfloat16)

    results = {}
    for label, fast_path in (("fast", True), ("replicated", False)):
        r = vanilla_vit_recipe()
        if not fast_path:
            r.fw_surrogate_coalitions = None
        step = make_explainer_train_step(r, cfg, n_players, N_MASK_SAMPLES, tx)
        p, s = exp_params, opt_state
        umask = ones_mask(p)
        depth = jnp.asarray(cfg.num_hidden_layers, jnp.int32)
        # the timed loop waits for each step, matching the production
        # trainer's default per-batch loss fetch
        for i in range(WARMUP):
            p, s, loss = step(p, s, srg_params, surrogate_null, xs,
                              jax.random.fold_in(jax.random.PRNGKey(3), i),
                              jnp.asarray(1e-4), umask, depth)
            jax.block_until_ready(loss)
        t0 = time.perf_counter()
        for i in range(ITERS):
            p, s, loss = step(p, s, srg_params, surrogate_null, xs,
                              jax.random.fold_in(jax.random.PRNGKey(4), i),
                              jnp.asarray(1e-4), umask, depth)
            jax.block_until_ready(loss)
        dt = (time.perf_counter() - t0) / ITERS
        coalitions_per_sec = BATCH * N_MASK_SAMPLES / dt
        results[label] = coalitions_per_sec
        print(f"{label}: {dt*1e3:.1f} ms/step -> "
              f"{coalitions_per_sec:.0f} masked fwds/s", flush=True)

    print(json.dumps({
        "metric": "vit_base_explainer_train_coalitions_per_sec",
        "value": round(results["fast"], 2),
        "unit": "masked fwds/s",
        "vs_baseline": round(results["fast"] / results["replicated"], 3),
    }))


if __name__ == "__main__":
    main()
