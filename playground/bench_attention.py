"""The masked-attention kernel against XLA (and cuDNN) on the GPU.

Decides whether ops/flash_attention.py earns its place.  In one process:

  1. check: the kernel against the float32 "highest" reference at the real
     widths — ViT-B trunk (T=197, 12x64, multiplicative mask), the LTT
     ladder (T=197, 12x8, multiplicative) and BERT-base (T=512, 12x64,
     additive mask with padded tokens);
  2. op: the attention op alone at those shapes: kernel, XLA, and cuDNN's
     fused attention (`jax.nn.dot_product_attention(implementation=
     "cudnn")`) for the additive mask;
  3. fw_final: every bench.py family at its bench batch with
     `self_attention` on the kernel, on XLA and (BERT families) on cuDNN;
  4. sweep: fw_final throughput per family over a few batch sizes.

Prints one JSON line per measurement and appends it to
chiprun_out/bench_attention.jsonl.

    python playground/bench_attention.py [--skip-sweep] [--bert-only]
    python playground/bench_attention.py --train-step

`--bert-only` runs the additive-mask comparisons alone (op and fw_final of
the three BERT families: kernel, XLA and cuDNN, in one process).
`--train-step` times only the LTT ViT-B/16 explainer train step (the
coalition teacher sweep, then the explainer forward and backward and the
AdamW update, float32 weights as the trainer keeps them) with attention on
XLA, on the kernel (differentiated calls on the reference, as shipped) and
on the kernel with a recomputing backward (kernel forward everywhere, the
reference's forward and backward in the backward pass).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "chiprun_out" / "bench_attention.jsonl"
# batches beside bench.BATCH (256 for ViT, 32 for BERT@512)
SWEEP = {"ltt": (128, 512), "vanilla": (128, 512), "froyo": (128, 512),
         "bert": (8, 64), "ltt_bert": (8, 64), "froyo_bert": (8, 64)}


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a", encoding="utf-8") as f:
        f.write(line + "\n")


def _cudnn_attention(q, k, v, mask_row, mode):
    """cuDNN's fused attention with the additive mask as its bias; cuDNN
    takes a bias only at the full <N, 1, T, T> score shape.  It cannot
    express the multiplicative mask, which keeps to the kernel."""
    import jax
    import jax.numpy as jnp

    from autognothi.ops.flash_attention import masked_attention

    if mode == "mul":
        return masked_attention(q, k, v, mask_row, mode)
    n, t = mask_row.shape
    bias = jnp.broadcast_to(mask_row.astype(q.dtype)[:, None, None, :],
                            (n, 1, t, t))
    return jax.nn.dot_product_attention(q, k, v, bias=bias,
                                        implementation="cudnn")


@contextlib.contextmanager
def attention_impl(impl: str):
    """Route `models.common.self_attention` through one implementation."""
    from autognothi.ops import flash_attention as fa

    saved = fa.kernel_applies, fa.masked_attention
    fa.kernel_applies = lambda: impl != "xla"
    if impl == "cudnn":
        fa.masked_attention = _cudnn_attention
    try:
        yield
    finally:
        fa.kernel_applies, fa.masked_attention = saved


def _inputs(n, t, h, d, mode, dtype, seed=0):
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    q, k, v = (jax.random.normal(kk, (n, t, h, d), jnp.float32).astype(dtype)
               for kk in ks[:3])
    if mode == "mul":  # coalition 0/1 factors, CLS always kept
        row = jax.random.bernoulli(ks[3], 0.5, (n, t)).astype(jnp.float32)
        row = row.at[:, 0].set(1.0)
    else:  # BERT: padded tail of each sequence masked by a finfo.min bias
        lens = jax.random.randint(ks[3], (n,), t // 4, t + 1)
        keep = jnp.arange(t)[None, :] < lens[:, None]
        row = (1.0 - keep.astype(jnp.float32)) * jnp.finfo(jnp.float32).min
    return q, k, v, row


def _time(fn, *args, iters=20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


SHAPES = (  # name, N, T, heads, d, mode
    ("vit_trunk", 256, 197, 12, 64, "mul"),
    ("ltt_ladder", 256, 197, 12, 8, "mul"),
    ("bert", 32, 512, 12, 64, "add"),
)


def check_and_time_ops(shapes=None) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from autognothi.ops.flash_attention import masked_attention, reference

    shapes = shapes or SHAPES
    for name, n, t, h, d, mode in shapes:
        for dtype, tol in ((jnp.float32, 2e-3), (jnp.bfloat16, 2e-2)):
            q, k, v, row = _inputs(min(n, 16), t, h, d, mode, dtype)
            with jax.default_matmul_precision("highest"):
                ref = jax.jit(lambda *a: reference(*a, mode))(
                    *(x.astype(jnp.float32) for x in (q, k, v)), row)
            rec = {"phase": "check", "shape": name, "dtype": dtype.__name__,
                   "tol": tol, "ref_precision": "float32 highest"}
            try:
                out = jax.jit(lambda *a: masked_attention(*a, mode))(
                    q, k, v, row)
                err = float(np.max(np.abs(np.asarray(out, np.float32)
                                          - np.asarray(ref))))
                rec.update(max_abs_err=err, ok=err <= tol)
            except Exception as exc:  # record and go on to the XLA numbers
                rec.update(ok=False, error=repr(exc)[:400])
                traceback.print_exc()
            emit(rec)

    for name, n, t, h, d, mode in shapes:
        q, k, v, row = _inputs(n, t, h, d, mode, jnp.bfloat16)
        impls = {"xla": jax.jit(lambda *a: reference(*a, mode)),
                 "kernel": jax.jit(lambda *a: masked_attention(*a, mode))}
        if mode == "add":
            impls["cudnn"] = jax.jit(lambda *a: _cudnn_attention(*a, mode))
        for impl, fn in impls.items():
            rec = {"phase": "op", "shape": name, "impl": impl, "n": n,
                   "dtype": "bfloat16"}
            try:
                rec["ms"] = _time(fn, q, k, v, row) * 1e3
            except Exception as exc:
                rec["error"] = repr(exc)[:400]
            emit(rec)


def time_fw_final(model: str, batch: int, impl: str) -> dict:
    import bench

    rec = {"phase": "fw_final", "model": model, "impl": impl}
    try:
        with attention_impl(impl):
            run, params, xs, batch = bench.make_serving_fn(model, batch)
            t0 = time.perf_counter()
            import jax

            jax.block_until_ready(run(params, xs))
            rec["compile_s"] = time.perf_counter() - t0
            dt = bench.time_serving(run, params, xs)
        rec.update(batch=batch, ms=dt * 1e3, expl_per_sec=batch / dt)
    except Exception as exc:
        rec["error"] = repr(exc)[:400]
        traceback.print_exc()
    return rec


def _recomputing_kernel(q, k, v, mask_row, mode):
    """The kernel in every forward, differentiated calls included; the
    backward recomputes the reference's forward to differentiate it."""
    import functools

    import jax

    from autognothi.ops import flash_attention as fa

    @jax.custom_vjp
    def attn(q, k, v, mask_row):
        return fa._call(q, k, v, mask_row, mode=mode, interpret=False,
                        precision=None)

    def fwd(*args):
        return attn(*args), args

    def bwd(args, g):
        return jax.vjp(functools.partial(fa.reference, mode=mode), *args)[1](g)

    attn.defvjp(fwd, bwd)
    return attn(q, k, v, mask_row)


TRAIN_SIZES = ((8, 32), (4, 2))  # (batch, coalitions per image): a
# teacher-heavy step, and the shipped experiments' train_explainer sizes


def time_train_step(iters: int = 20) -> None:
    """Each variant is compiled once, then timed twice in the order A B C
    C B A, so drift of the card's clocks shows as a gap between the two
    readings of one variant."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _flagship_ltt_cfg
    from autognothi.models.ltt_vit import (init_ltt_vit_explainer,
                                           init_ltt_vit_surrogate)
    from autognothi.ops import flash_attention as fa
    from autognothi.parallel.train_step import make_explainer_train_step
    from autognothi.pipeline.training import make_optimizer, ones_mask
    from autognothi.recipes.ltt_vit import ltt_vit_recipe

    cfg = _flagship_ltt_cfg()
    recipe = ltt_vit_recipe()
    n_players = recipe.n_players(cfg)
    exp0 = init_ltt_vit_explainer(jax.random.PRNGKey(0), cfg)
    srg = init_ltt_vit_surrogate(jax.random.PRNGKey(1), cfg)
    null = jnp.zeros((1, cfg.num_labels), jnp.float32)
    tx, opt0 = make_optimizer(exp0, recipe.trainable(cfg, "explainer"))
    tail = (jax.random.PRNGKey(3), jnp.asarray(1e-4), ones_mask(exp0),
            jnp.asarray(cfg.num_hidden_layers, jnp.int32))
    impls = ("xla", "kernel", "kernel_recompute")
    for batch, n_mask in TRAIN_SIZES:
        px = cfg.img_px_size
        xs = jax.random.normal(jax.random.PRNGKey(2), (batch, 3, px, px))
        args = (exp0, opt0, srg, null, xs) + tail
        steps, losses = {}, {}
        for impl in impls:  # trace and compile under each routing
            saved = fa.kernel_applies, fa.masked_attention
            fa.kernel_applies = lambda: impl != "xla"
            if impl == "kernel_recompute":
                fa.masked_attention = _recomputing_kernel
            try:
                step = make_explainer_train_step(recipe, cfg, n_players,
                                                 n_mask, tx)
                t0 = time.perf_counter()
                losses[impl] = float(step(*args)[2])
                steps[impl] = step
                emit({"phase": "train_step_compile", "impl": impl,
                      "batch": batch, "n_mask_samples": n_mask,
                      "compile_s": time.perf_counter() - t0,
                      "loss": losses[impl]})
            except Exception as exc:
                emit({"phase": "train_step_compile", "impl": impl,
                      "batch": batch, "error": repr(exc)[:400]})
                traceback.print_exc()
            finally:
                fa.kernel_applies, fa.masked_attention = saved
        order = [i for i in impls if i in steps]
        for rep, impl in enumerate(order + order[::-1]):
            jax.block_until_ready(steps[impl](*args))
            t0 = time.perf_counter()
            for _ in range(iters):
                out = steps[impl](*args)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / iters
            emit({"phase": "train_step", "model": "ltt_vit_b16",
                  "dtype": "float32", "batch": batch,
                  "n_mask_samples": n_mask, "impl": impl,
                  "reading": 1 + (rep >= len(order)), "ms": dt * 1e3,
                  "masked_fwds_per_sec": batch * n_mask / dt})
        if len(losses) == len(impls):
            emit({"phase": "train_step_loss_agreement", "batch": batch,
                  "max_rel": float(np.max([abs(v / losses["xla"] - 1)
                                           for v in losses.values()]))})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--bert-only", action="store_true")
    ap.add_argument("--train-step", action="store_true")
    args = ap.parse_args()
    OUT.parent.mkdir(exist_ok=True)

    import jax

    import bench

    device = bench.require_gpu()
    emit({"phase": "device", "nvidia_smi": bench.gpu_name_and_power_limit(),
          "device_kind": device.device_kind, "jax": jax.__version__})
    if args.train_step:
        time_train_step()
        return
    if args.bert_only:
        check_and_time_ops([s for s in SHAPES if s[5] == "add"])
        for model in ("bert", "ltt_bert", "froyo_bert"):
            for impl in ("kernel", "xla", "cudnn"):
                emit(time_fw_final(model, bench.BATCH[model], impl))
        return
    check_and_time_ops()
    for model in bench.MODELS:
        impls = ["kernel", "xla"] + (["cudnn"] if "bert" in model else [])
        for impl in impls:
            emit(time_fw_final(model, bench.BATCH[model], impl))
    if not args.skip_sweep:
        for model, batches in SWEEP.items():
            for batch in batches:
                for impl in ("kernel", "xla"):
                    emit({**time_fw_final(model, batch, impl),
                          "phase": "sweep"})


if __name__ == "__main__":
    main()
