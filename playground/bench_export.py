"""Flagship-scale probe of the AOT export path (pipeline/export.py).

Exports the flagship LTT ViT-B final — the bench.py headline program —
through jax.export at serving dims for the GPU (the portable XLA trace,
ops.flash_attention.xla_attention), reloads the serialized artifact and
times it against the live jit path (attention kernel where it applies) in
the same process, on the GPU.

    python playground/bench_export.py [--batch 256]

Timings end at `jax.block_until_ready`.  Artifact weights ride as runtime
arguments (pipeline/export.py).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

WARMUP = 3
ITERS = 10


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _flagship_ltt_cfg
    from autognothi.models.common import cast_tree
    from autognothi.models.ltt_vit import init_ltt_vit_final
    from autognothi.ops.flash_attention import xla_attention
    from autognothi.pipeline.export import jax_export
    from autognothi.recipes.ltt_vit import fw_final

    jexport = jax_export()

    cfg = _flagship_ltt_cfg()
    params = cast_tree(init_ltt_vit_final(jax.random.PRNGKey(0), cfg),
                       jnp.bfloat16)

    def fw(p, xs):
        probs, attr = fw_final(cfg, p, xs.astype(jnp.bfloat16))
        return probs.astype(jnp.float32), attr.astype(jnp.float32)

    def fw_portable(p, xs):
        with xla_attention():
            return fw(p, xs)

    pspecs = jax.tree.map(
        lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), params)
    spec = jax.ShapeDtypeStruct((args.batch, 3, 224, 224), jnp.float32)

    t0 = time.perf_counter()
    exported = jexport.export(jax.jit(fw_portable), platforms=["cuda"])(
        pspecs, spec)
    blob = exported.serialize()
    t1 = time.perf_counter()
    art = pathlib.Path(tempfile.gettempdir()) / "flagship_ltt.jaxexp"
    art.write_bytes(blob)
    rt = jexport.deserialize(bytearray(art.read_bytes()))
    t2 = time.perf_counter()
    print(f"export+serialize {t1-t0:.1f}s, blob {len(blob)/1e6:.1f} MB, "
          f"deserialize {t2-t1:.1f}s", flush=True)

    xs = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(1), spec.shape, spec.dtype))
    dev_params = jax.device_put(params)

    def bench(run, label):
        out = None
        for _ in range(WARMUP):
            out = run(dev_params, xs)
        jax.block_until_ready(out)
        t = time.perf_counter()
        for _ in range(ITERS):
            out = run(dev_params, xs)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t
        rate = args.batch * ITERS / dt
        print(f"{label}: {rate:.1f} expl/s", flush=True)
        return rate, [np.asarray(o) for o in out]

    live_rate, live_out = bench(jax.jit(fw), "live jit")
    art_rate, art_out = bench(rt.call, "exported artifact")
    d = max(np.abs(a - b).max() for a, b in zip(live_out, art_out))
    print(json.dumps({
        "metric": "ltt_export_artifact_expl_per_sec",
        "value": round(art_rate, 1),
        "live_expl_per_sec": round(live_rate, 1),
        "max_abs_diff_vs_live": float(d),
        "blob_mb": round(len(blob) / 1e6, 1),
        "batch": args.batch,
    }))


if __name__ == "__main__":
    main()
