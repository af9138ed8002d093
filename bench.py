"""Serving benchmark: explanations/s on one GPU for the flagship serving
architecture — the LTT (ladder side-tuning) ViT-Base/16 @224 final — and
the other five finals.

One "explanation" = one fw_final pass (classifier probs + surrogate grand +
normalized per-patch Shapley attributions for all classes) — the deployment
path the reference measures in measure_performance.py:106-251.

LTT is the reference's flagship method (the AutoGnothi paper's architecture,
models/ltt_vit.py:407-440 of the reference): ONE frozen-backbone traversal
plus 96-dim side ladders yields logits AND attributions, ~37 GF/explanation
vs the vanilla 3-tower final's ~107 GF.  The vanilla final and the froyo
final (the reference's single-trunk variant, no ladders) are measured too
and reported under `{vanilla,froyo}_expl_per_sec`.  The TEXT track measures
the same three families at BERT-base @T=512:
`{bert,ltt_bert,froyo_bert}_expl_per_sec`.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}.  The device block names the card (`platform`, `device_kind`, device
count, and the power limit nvidia-smi reports).

BASELINE ACCOUNTING — two ratios, both always emitted:

- `vs_baseline` (per family: `<fam>_vs_baseline`): the CROSS-ARCHITECTURE
  ratio against the estimated torch *vanilla* 3-tower A100 throughput
  (~450 expl/s = 3 ViT-B fwds/expl at ~1350 img/s eager fp16).
- `vs_baseline_matched` (per family): the METHOD-MATCHED ratio — each
  family's throughput over the SAME family's estimated A100 torch
  throughput.  Per-family A100 estimates derive from the measured same-host
  torch-CPU anchors (playground/perf_anchor.py, batch-1 eager, 1 core)
  scaled by the same 483x CPU->A100 factor the vanilla estimate implies
  (450 / 0.932).
- `vs_ref_cpu_measured` (per family): throughput vs the measured same-arch
  torch-CPU anchor directly — the only ratio with no estimated factor.

The parent process never imports JAX: each model runs in a child of its
own, one child at a time, so exactly one process holds the card.  A child
that fails — a missing GPU included — fails the run.
"""

import json
import os
import subprocess
import sys
import time

A100_TORCH_EST_EXPL_PER_SEC = 450.0
# measured same-host torch-CPU anchors (perf_anchor.py, batch-1 eager,
# 1 core): ms/expl -> expl/s
TORCH_CPU_MEASURED = {
    "vanilla": 0.932,      # 1073 ms/expl (ViT-B/224)
    "ltt": 2.347,          # 426 ms/expl
    "froyo": 2.525,        # 396 ms/expl
    "bert": 0.225,         # 4452 ms/expl (BERT-base @T=512)
    "ltt_bert": 0.560,     # 1786 ms/expl
    "froyo_bert": 0.812,   # 1231 ms/expl
}
CPU_TO_A100_FACTOR = A100_TORCH_EST_EXPL_PER_SEC / TORCH_CPU_MEASURED["vanilla"]
A100_TORCH_EST = {  # method-matched per-family A100 estimates
    fam: cpu * CPU_TO_A100_FACTOR for fam, cpu in TORCH_CPU_MEASURED.items()
}
# cross-architecture denominator per TRACK: the vanilla family of the same
# track (ViT children anchor to the vanilla 3-tower ViT estimate; BERT
# children to the vanilla 3-tower BERT estimate — same 483x CPU->A100
# factor, module docstring)
A100_TRACK_BASELINE = {
    "vanilla": A100_TORCH_EST_EXPL_PER_SEC,
    "ltt": A100_TORCH_EST_EXPL_PER_SEC,
    "froyo": A100_TORCH_EST_EXPL_PER_SEC,
    "bert": A100_TORCH_EST["bert"],
    "ltt_bert": A100_TORCH_EST["bert"],
    "froyo_bert": A100_TORCH_EST["bert"],
}

MODELS = ("ltt", "vanilla", "froyo", "bert", "ltt_bert", "froyo_bert")
# one stated batch per family, from the batch sweep on the H100 (PERF.md):
# the ViT finals are flat from 128 to 512 but vanilla's (+5% at 512); the
# BERT@512 finals gain up to 4% from 32 to 64
BATCH = {"ltt": 256, "vanilla": 512, "froyo": 256,
         "bert": 64, "ltt_bert": 64, "froyo_bert": 64}

WARMUP = 3
ITERS = 10


def build_final(model: str):
    """-> (cfg, float32 params, fw_final(cfg, params, xs), is_text) for one
    of MODELS at its published widths, with weights drawn from seed 0."""
    import jax

    from __graft_entry__ import (_flagship_bert_kwargs, _flagship_cfg,
                                 _flagship_ltt_cfg)

    key = jax.random.PRNGKey(0)
    if model == "bert":
        from autognothi.models.bert import VanillaBertConfig, init_bert_final
        from autognothi.recipes.vanilla_bert import fw_final

        cfg = VanillaBertConfig(explainer_attn_num_layers=1,
                                explainer_head_hidden_size=3072,
                                **_flagship_bert_kwargs())
        return cfg, init_bert_final(key, cfg), fw_final, True
    if model == "ltt_bert":
        from autognothi.models.ltt_bert import (LttBertConfig,
                                                init_ltt_bert_final)
        from autognothi.recipes.ltt_bert import fw_final

        cfg = LttBertConfig(explainer_s_attn_num_layers=1,
                            explainer_s_head_hidden_size=3072,
                            s_attn_hidden_size=96,
                            s_attn_intermediate_size=384,
                            **_flagship_bert_kwargs())
        return cfg, init_ltt_bert_final(key, cfg), fw_final, True
    if model == "froyo_bert":
        from autognothi.models.froyo_bert import (FroyoBertConfig,
                                                  init_froyo_bert_final)
        from autognothi.recipes.froyo_bert import fw_final

        cfg = FroyoBertConfig(explainer_attn_num_layers=1,
                              explainer_head_hidden_size=3072,
                              **_flagship_bert_kwargs())
        return cfg, init_froyo_bert_final(key, cfg), fw_final, True
    if model == "ltt":
        from autognothi.models.ltt_vit import init_ltt_vit_final
        from autognothi.recipes.ltt_vit import fw_final

        cfg = _flagship_ltt_cfg()
        return cfg, init_ltt_vit_final(key, cfg), fw_final, False
    if model == "froyo":
        from autognothi.models.froyo_vit import (FroyoViTConfig,
                                                 init_froyo_vit_final)
        from autognothi.recipes.froyo_vit import fw_final
        from autognothi.utils.records import project

        cfg = project(_flagship_cfg(), FroyoViTConfig)
        return cfg, init_froyo_vit_final(key, cfg), fw_final, False
    if model == "vanilla":
        from autognothi.models.vit import init_vit_final
        from autognothi.recipes.vanilla_vit import fw_final

        cfg = _flagship_cfg()
        return cfg, init_vit_final(key, cfg), fw_final, False
    raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")


def make_serving_fn(model: str, batch: int):
    """-> (run(params, xs), bf16 params, xs, batch) on the visible devices,
    laid out as pipeline/serve.py lays them out."""
    import jax
    import jax.numpy as jnp

    from autognothi.models.common import cast_tree
    from autognothi.parallel.mesh import (setup_data_parallel,
                                          sharded_serving_fn)

    cfg, params, fw_final, is_text = build_final(model)
    # bf16 weights & activations; layernorm/softmax math runs fp32
    params = cast_tree(params, jnp.bfloat16)
    mesh, place_params, place_batch = setup_data_parallel()
    if mesh is not None:
        # shard_map splits the leading axis evenly over "data"
        n = mesh.devices.size
        batch = -(-batch // n) * n

    def fw(p, xs):
        if not is_text:
            xs = xs.astype(jnp.bfloat16)  # token ids stay integer
        probs, attr = fw_final(cfg, p, xs)
        return probs.astype(jnp.float32), attr.astype(jnp.float32)

    if mesh is not None:
        params = place_params(params)
        run = sharded_serving_fn(fw, mesh)
    else:
        run = jax.jit(fw)
    key = jax.random.PRNGKey(1)
    xs = place_batch(
        jax.random.randint(key, (batch, 512), 1, cfg.vocab_size) if is_text
        else jax.random.normal(key, (batch, 3, 224, 224)))
    return run, params, xs, batch


def time_serving(run, params, xs, iters: int = ITERS) -> float:
    """Seconds per call of `run(params, xs)` after WARMUP calls."""
    import jax

    for _ in range(WARMUP):
        out = run(params, xs)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(params, xs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def require_gpu():
    """-> jax.devices()[0]; exits non-zero when JAX finds no GPU."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {device.platform!r}")
    return device


def gpu_name_and_power_limit() -> str:
    """The card as `nvidia-smi` names it: "<name>, <power limit>"."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def _bench_model(model: str) -> None:
    """Child-process entry: build + warm + time one model, print one JSON."""
    import jax

    from autognothi.utils.devices import enable_compile_cache

    device = require_gpu()
    enable_compile_cache()
    run, params, xs, batch = make_serving_fn(model, BATCH[model])
    dt = time_serving(run, params, xs)
    print(json.dumps({"expl_per_sec": batch / dt, "batch": batch,
                      "platform": device.platform,
                      "device_kind": device.device_kind,
                      "count": len(jax.devices())}), flush=True)


def _run_child(model: str) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", model],
        capture_output=True, text=True, timeout=1800,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if proc.returncode != 0:
        raise SystemExit(f"bench child {model!r} failed "
                         f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    results = {model: _run_child(model) for model in MODELS}
    ltt = results["ltt"]
    extra = {}
    for name in MODELS[1:]:
        v = results[name]["expl_per_sec"]
        extra[f"{name}_expl_per_sec"] = round(v, 2)
        extra[f"{name}_batch"] = results[name]["batch"]
        extra[f"{name}_vs_baseline"] = round(v / A100_TRACK_BASELINE[name], 3)
        extra[f"{name}_vs_baseline_matched"] = round(
            v / A100_TORCH_EST[name], 3)
        extra[f"{name}_vs_ref_cpu_measured"] = round(
            v / TORCH_CPU_MEASURED[name], 1)

    value = ltt["expl_per_sec"]
    print(json.dumps({
        "metric": "ltt_vit_base_224_explanations_per_sec_per_gpu",
        "value": round(value, 2),
        "unit": "explanations/s",
        "batch": ltt["batch"],
        "device": {"platform": ltt["platform"], "kind": ltt["device_kind"],
                   "count": ltt["count"],
                   "nvidia_smi": gpu_name_and_power_limit()},
        # cross-architecture: LTT vs the vanilla-3-tower A100 estimate
        "vs_baseline": round(value / A100_TORCH_EST_EXPL_PER_SEC, 3),
        # method-matched: LTT vs the LTT A100 estimate
        "vs_baseline_matched": round(value / A100_TORCH_EST["ltt"], 3),
        "vs_ref_cpu_measured": round(value / TORCH_CPU_MEASURED["ltt"], 1),
        **extra,
    }))


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        _bench_model(sys.argv[2])
    else:
        main()
