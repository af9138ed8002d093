"""Multi-GPU scaling bench for the sharded serving path.

For each mesh size m in a doubling sweep up to
the visible device count, it runs the deployment-layout sharded `fw_final`
(params replicated, request batch split along "data" via shard_map — the
same `parallel.mesh.sharded_serving_fn` that `pipeline/serve.py` and
`bench.py` use, so the attention kernel runs per-shard instead of
replicating behind all-gathers) with a FIXED per-device batch (weak
scaling), and reports expl/s plus parallel efficiency vs the 1-device run.
Without GPUs it still validates the whole path end-to-end: `--mini` runs
tiny dims on the virtual CPU mesh
(set JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8),
where timings are meaningless but sharding, kernels-per-shard and the
efficiency accounting are real.

    # functional check (any machine):
    env JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python playground/bench_scaling.py --mini
    # four GPUs:
    python playground/bench_scaling.py --model ltt --batch-per-chip 256

Timings end at `jax.block_until_ready`; ascending mesh sizes reuse one
process.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

WARMUP = 3
ITERS = 10


def build_model(model: str, mini: bool):
    import jax
    import jax.numpy as jnp

    from autognothi.models.common import cast_tree

    if model == "ltt":
        from autognothi.models.ltt_vit import (
            LttViTConfig,
            init_ltt_vit_final,
        )
        from autognothi.recipes.ltt_vit import fw_final

        if mini:
            cfg = LttViTConfig(
                attention_probs_dropout_prob=0.0,
                explainer_s_attn_num_layers=1,
                explainer_s_head_hidden_size=16,
                explainer_normalize=True,
                hidden_dropout_prob=0.0,
                hidden_size=32,
                intermediate_size=64,
                layer_norm_eps=1e-12,
                num_attention_heads=4,
                num_hidden_layers=2,
                num_labels=3,
                s_attn_hidden_size=16,
                s_attn_intermediate_size=32,
                img_channels=3,
                img_px_size=16,
                img_patch_size=8,
            )
        else:
            from __graft_entry__ import _flagship_ltt_cfg

            cfg = _flagship_ltt_cfg()
        params = init_ltt_vit_final(jax.random.PRNGKey(0), cfg)
    elif model == "froyo":
        from autognothi.models.froyo_vit import (
            FroyoViTConfig,
            init_froyo_vit_final,
        )
        from autognothi.recipes.froyo_vit import fw_final
        from autognothi.utils.records import project
        from __graft_entry__ import _flagship_cfg

        assert not mini, "--mini supports ltt/vanilla"
        cfg = project(_flagship_cfg(), FroyoViTConfig)
        params = init_froyo_vit_final(jax.random.PRNGKey(0), cfg)
    else:
        from autognothi.models.vit import (
            VanillaViTConfig,
            init_vit_final,
        )
        from autognothi.recipes.vanilla_vit import fw_final

        if mini:
            cfg = VanillaViTConfig(
                attention_probs_dropout_prob=0.0,
                explainer_attn_num_layers=1,
                explainer_head_hidden_size=16,
                explainer_normalize=True,
                hidden_dropout_prob=0.0,
                hidden_size=32,
                intermediate_size=64,
                layer_norm_eps=1e-12,
                num_attention_heads=4,
                num_hidden_layers=2,
                num_labels=3,
                img_channels=3,
                img_px_size=16,
                img_patch_size=8,
            )
        else:
            from __graft_entry__ import _flagship_cfg

            cfg = _flagship_cfg()
        params = init_vit_final(jax.random.PRNGKey(0), cfg)

    params = cast_tree(params, jnp.bfloat16)

    def fw(p, xs):
        probs, attr = fw_final(cfg, p, xs.astype(jnp.bfloat16))
        return probs.astype(jnp.float32), attr.astype(jnp.float32)

    return cfg, params, fw


def bench_mesh_size(m: int, per_chip: int, px: int, params, fw) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from autognothi.parallel.mesh import (
        make_mesh,
        replicate_params,
        sharded_serving_fn,
    )

    batch = per_chip * m
    mesh = make_mesh(m, model_parallel=1)
    placed = replicate_params(params, mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P

    xs = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(1), (batch, 3, px, px)),
        NamedSharding(mesh, P("data", None, None, None)),
    )
    run = sharded_serving_fn(fw, mesh)

    with mesh:
        for _ in range(WARMUP):
            probs, _ = run(placed, xs)
        jax.block_until_ready(probs)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            probs, _ = run(placed, xs)
        jax.block_until_ready(probs)
        dt = time.perf_counter() - t0
    return {
        "mesh": m,
        "batch": batch,
        "expl_per_sec": batch * ITERS / dt,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["ltt", "vanilla", "froyo"],
                    default="ltt")
    ap.add_argument("--batch-per-chip", type=int, default=None,
                    help="fixed per-device batch (weak scaling); defaults "
                         "to bench.py's batch (256)")
    ap.add_argument("--mesh-sizes", default=None,
                    help="comma list, default: doubling up to all devices")
    ap.add_argument("--mini", action="store_true",
                    help="tiny dims (functional check on the CPU mesh)")
    args = ap.parse_args()

    import jax

    n = len(jax.devices())
    if args.mesh_sizes:
        sizes = [int(s) for s in args.mesh_sizes.split(",")]
    else:
        sizes, m = [], 1
        while m <= n:
            sizes.append(m)
            m *= 2
    per_chip = args.batch_per_chip or (
        8 if args.mini else 256)

    cfg, params, fw = build_model(args.model, args.mini)
    px = cfg.img_px_size

    rows = []
    for m in sizes:
        row = bench_mesh_size(m, per_chip, px, params, fw)
        base = rows[0]["expl_per_sec"] if rows else row["expl_per_sec"]
        row["efficiency"] = round(row["expl_per_sec"] / (base * m), 4)
        rows.append(row)
        print(json.dumps({**row,
                          "expl_per_sec": round(row["expl_per_sec"], 2)}),
              flush=True)

    print(json.dumps({
        "metric": f"{args.model}_serving_weak_scaling",
        "devices": n,
        "per_chip_batch": per_chip,
        "rows": [{**r, "expl_per_sec": round(r["expl_per_sec"], 2)}
                 for r in rows],
    }))


if __name__ == "__main__":
    main()
