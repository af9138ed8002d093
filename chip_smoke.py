"""Start-up proof on the GPU: the explanation pipeline's main path, driven
through the entry points a user calls, at the full width of the flagship
model — LTT ViT-B/16 @224 (hidden 768, 12 layers of 12 heads; 96-wide
ladders of 12 heads of 8; explainer head 3072), random weights from seeds.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the multi-device paths only

One GPU, in order:
  device   the card (nvidia-smi name and power limit), JAX's device kind;
  kernels  the `gpu`-marked tests: the compiled attention kernel against the
           float32 "highest" reference at the real widths;
  train    `main.py train_all --device gpu` on an offline `cv_samples`
           experiment at 224 px (classifier, surrogate, explainer, final,
           and the final-coherency check);
  serve    `main.py serve` answers `/explain` in the images_u8 wire format;
           the answers are checked against an in-process `fw_final` on the
           same pixels, then `export_final` is served with `--artifact` and
           its answers are checked against the live server's.
Four GPUs (`--four`): data-parallel serving, the data-parallel explainer
train step and the pipeline-parallel explainer step, each against the same
computation on one GPU.

The parent never imports JAX: every phase runs in a child process of its
own, one at a time, so exactly one process holds the cards.  Any failure
exits non-zero before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".smoke"  # listed in .gitignore
EXP = WORK / "ltt_vit_b16"
ARTIFACT = WORK / "final.jaxexp"
ANSWERS = WORK / "answers.npz"
DEVICE = "gpu"  # the CLI children's --device
SEED = 0
N_REQUESTS = 3
ROWS_PER_REQUEST = 2
SERVE_BATCH = 8

# the flagship LTT ViT-B/16 @224 (__graft_entry__._flagship_ltt_cfg) in a
# `.hparams.json`, with stage sizes that give two steps per stage
HPARAMS = {
    "seed": 42,
    "dataset": {"kind": "cv_samples", "train_size": 16, "test_size": 8,
                "img_px_size": 224, "num_classes": 10, "seed": 7},
    "net": {
        "kind": "ltt_vit", "version": "beta.1.01", "base_model": "random_init",
        "params": {
            "attention_probs_dropout_prob": 0.0,
            "explainer_s_attn_num_layers": 1,
            "explainer_s_head_hidden_size": 3072,
            "explainer_normalize": True,
            "hidden_dropout_prob": 0.0,
            "hidden_size": 768,
            "intermediate_size": 3072,
            "layer_norm_eps": 1e-12,
            "num_attention_heads": 12,
            "num_hidden_layers": 12,
            "num_labels": 10,
            "s_attn_hidden_size": 96,
            "s_attn_intermediate_size": 384,
            "img_channels": 3,
            "img_px_size": 224,
            "img_patch_size": 16,
        },
    },
    "train_classifier": {"epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-4,
                         "batch_size": 8},
    "train_surrogate": {"epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-4,
                        "batch_size": 8},
    "train_explainer": {"epochs": 1, "ckpt_when": "_:%1==0", "lr": 1e-4,
                        "batch_size": 8, "n_mask_samples": 16,
                        "lambda_efficiency": 1.0, "lambda_norm": 0.0},
    "eval_accuracy": {"dataset": None, "batch_size": 8, "resolution": 4},
    "eval_faithfulness": {"dataset": None, "batch_size": 8, "resolution": 4},
    "eval_cls_acc": {"dataset": None, "on_exp_epochs": None, "batch_size": 8},
    "eval_performance": {"dataset": None, "loops": 1},
    "eval_train_resources": {"dataset": None, "batch_size": 8,
                             "max_samples": 8},
}

# Tolerances, with the precision each comparison runs at.  Answers
# (probabilities and attributions, which sum to a difference of
# probabilities) are compared as max |a - b| <= rtol * max |b| over all of
# them.  Served vs in-process fw_final: the same model and slab shape on
# the same card, compiled in another process, whose autotuner may run a
# GEMM in TF32 (10-bit mantissa, 2^-11 ~ 4.9e-4 relative rounding) where
# the other ran it in fp32, or the reverse: seen up to 5.5e-4 of the
# largest value.
SERVE_VS_FW_FINAL = 2e-3
# the artifact (XLA attention) vs the live server (the attention kernel):
# the same TF32 rounding, compounded through 12 layers
ARTIFACT_VS_SERVE = 1e-2
# four GPUs against one, fp32 at "highest" precision: outputs and losses
# differ only by sums regrouped across shards (and, under the pipeline, by
# microbatch); one AdamW step is compared as the L1 distance between the
# two updates over the L1 size of the update (a gradient that is ~0 may
# flip the sign of its first Adam step without any fault)
FOUR_OUTPUT_TOL = 1e-4
FOUR_LOSS_RTOL = 1e-4
FOUR_UPDATE_RTOL = {"data": 1e-3, "pipe": 1e-2}


class SmokeError(RuntimeError):
    pass


def _say(msg: str) -> None:
    print(msg, flush=True)


def _child_env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the children run on the GPU
    env.update(extra)
    return env


def _run(argv, timeout: int, what: str, **env) -> str:
    """Run one child to its end -> its stdout; a failure raises with the
    end of its output on stderr."""
    proc = subprocess.run(argv, cwd=REPO, env=_child_env(**env), text=True,
                          capture_output=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-6000:])
        raise SmokeError(f"{what} failed (rc={proc.returncode})")
    return proc.stdout


def _phase_child(phase: str, timeout: int) -> str:
    return _run([sys.executable, str(REPO / "chip_smoke.py"), "--phase",
                 phase], timeout, f"phase {phase}")


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


# ------------------------------------------------------------ parent phases


def phase_device() -> dict:
    dev = _last_json(_phase_child("device", 300))
    if dev["platform"] != "gpu":
        raise SmokeError(f"no GPU: JAX runs on {dev['platform']!r}")
    for line in nvidia_smi().splitlines():
        _say(f"[device] nvidia-smi: {line}")
    _say(f"[device] jax {dev['jax']}: {dev['count']} x {dev['kind']}")
    return dev


def phase_kernels() -> None:
    out = _run([sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-s",
                "-p", "no:cacheprovider", "tests/test_flash_attention.py"],
               900, "the gpu-marked tests", JAX_PLATFORMS="cuda,cpu")
    for line in out.splitlines():
        if "[kernels]" in line:  # after pytest's progress dots
            _say(line[line.index("[kernels]"):])
        elif " passed" in line:
            _say(f"[kernels] {line}")
    if " passed" not in out or "skipped" in out:
        raise SmokeError("the gpu-marked tests did not all run")


def phase_train() -> None:
    shutil.rmtree(WORK, ignore_errors=True)
    EXP.mkdir(parents=True)
    (EXP / ".hparams.json").write_text(json.dumps(HPARAMS, indent=2) + "\n")
    _run([sys.executable, "main.py", "train_all", str(EXP), "--device",
          DEVICE], 900, "train_all")
    log = (EXP / ".log.txt").read_text()  # the console wraps long lines
    losses = [line.split("METRICS: ", 1)[1] for line in log.splitlines()
              if "METRICS: " in line]
    for loss in losses:
        _say(f"[train] {loss}")
    if not losses:
        raise SmokeError("train_all logged no losses")
    if "verified final model is coherent" not in log:
        raise SmokeError("train_all did not pass the final-coherency check")
    _say("[train] final-coherency check passed")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _net_params() -> dict:
    return json.loads((EXP / ".hparams.json").read_text())["net"]["params"]


def _request_pixels():
    import numpy as np

    px = _net_params()["img_px_size"]
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (ROWS_PER_REQUEST, 3, px, px),
                         dtype=np.uint8) for _ in range(N_REQUESTS)]


def _serve_and_ask(extra_args, what: str):
    """Start `main.py serve`, send the seeded requests, stop it; -> answers
    as [(logits, attributions)] numpy arrays."""
    import numpy as np

    port = _free_port()
    argv = [sys.executable, "main.py", "serve", str(EXP), "--device", DEVICE,
            "--port", str(port), "--batch-size", str(SERVE_BATCH),
            *extra_args]
    log = open(WORK / f"{what}.log", "w", encoding="utf-8")
    proc = subprocess.Popen(argv, cwd=REPO, env=_child_env(), stdout=log,
                            stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 600
        while True:
            if proc.poll() is not None:
                tail = (WORK / f"{what}.log").read_text()[-4000:]
                raise SmokeError(f"{what} exited early "
                                 f"(rc={proc.returncode}):\n{tail}")
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise SmokeError(f"{what} did not come up within 600 s")
            time.sleep(2)
        answers = []
        for pixels in _request_pixels():
            body = json.dumps({"images_u8": pixels.tolist()}).encode()
            req = urllib.request.Request(
                base + "/explain", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                ans = json.loads(r.read())
            logits = np.asarray(ans["logits"], np.float32)
            attr = np.asarray(ans["attributions"], np.float32)
            net = _net_params()
            n_labels = net["num_labels"]
            n_patches = (net["img_px_size"] // net["img_patch_size"]) ** 2
            want = ((ROWS_PER_REQUEST, n_labels),
                    (ROWS_PER_REQUEST, n_labels, n_patches))
            if (logits.shape, attr.shape) != want:
                raise SmokeError(f"{what}: answer shapes "
                                 f"{logits.shape, attr.shape}, want {want}")
            if not (np.isfinite(logits).all() and np.isfinite(attr).all()):
                raise SmokeError(f"{what}: non-finite answer")
            answers.append((logits, attr))
        return answers
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def _max_diff(a, b) -> float:
    import numpy as np

    return max(float(np.max(np.abs(x - y))) for pa, pb in zip(a, b)
               for x, y in zip(pa, pb))


def _scale(answers) -> float:
    return max(float(abs(x).max()) for pair in answers for x in pair)


def _close(a, b, rtol: float) -> bool:
    """max |a - b| <= rtol * max |b| over all answers."""
    return _max_diff(a, b) <= rtol * _scale(b)


def phase_serve() -> None:
    import numpy as np

    live = _serve_and_ask([], "serve")
    _say(f"[serve] {N_REQUESTS} /explain answers of {ROWS_PER_REQUEST} images"
         " each, shapes ok")
    np.savez(ANSWERS, **{f"{kind}{i}": arr for i, pair in enumerate(live)
                         for kind, arr in zip(("logits", "attr"), pair)})
    res = _last_json(_phase_child("fw_final", 600))
    _say(f"[serve] vs in-process fw_final: max |diff| "
         f"{res['max_abs_diff']:.3e} over values up to {res['scale']:.3e} "
         f"(tolerance {SERVE_VS_FW_FINAL:g} of the largest; fp32 weights, "
         "default matmul precision, same slab shape)")
    if not res["ok"]:
        raise SmokeError("served answers differ from fw_final")

    _run([sys.executable, "main.py", "export_final", str(EXP), "--into",
          str(ARTIFACT), "--batch-size", str(SERVE_BATCH), "--device", DEVICE],
         600, "export_final")
    exported = _serve_and_ask(["--artifact", str(ARTIFACT)], "serve_artifact")
    diff = _max_diff(live, exported)
    scale = _scale(live)
    _say(f"[serve] artifact vs live server: max |diff| {diff:.3e} over values "
         f"up to {scale:.3e} (tolerance {ARTIFACT_VS_SERVE:g} of the largest;"
         " fp32 weights, TF32 matmuls)")
    if not _close(exported, live, ARTIFACT_VS_SERVE):
        raise SmokeError("the exported artifact answers differently")


# ------------------------------------------------------------- child phases


def child_device() -> None:
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices()), "jax": jax.__version__}))


def child_fw_final() -> None:
    """The served answers against `fw_final` called in this process on the
    same pixels, dequantised as the server does, in slabs of its size."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.resources import get_recipe, load_epoch_model
    from autognothi.utils.devices import enable_compile_cache

    enable_compile_cache()
    env = ExpEnv(EXP)
    recipe, m_config = get_recipe(env.config)
    _, params = load_epoch_model(env, recipe, "final")
    fw = jax.jit(lambda p, xs: recipe.fw_final(
        m_config, p, xs.astype(jnp.float32) * (1.0 / 255.0) + 0.0))
    saved = np.load(ANSWERS)
    served, mine = [], []
    for i, pixels in enumerate(_request_pixels()):
        slab = np.zeros((SERVE_BATCH,) + pixels.shape[1:], np.uint8)
        slab[:len(pixels)] = pixels
        mine.append(tuple(np.asarray(x)[:len(pixels)]
                          for x in fw(params, jnp.asarray(slab))))
        served.append((saved[f"logits{i}"], saved[f"attr{i}"]))
    print(json.dumps({
        "max_abs_diff": _max_diff(served, mine),
        "scale": _scale(served),
        "ok": _close(mine, served, SERVE_VS_FW_FINAL)}))


def child_four() -> None:
    """Each multi-device path against the same computation on one GPU, at
    the flagship ViT-B width (vanilla family: the pipeline-parallel trainer
    covers full-tower training), depth cut to 4 layers, fp32 at "highest"
    precision."""
    import dataclasses

    import jax

    import __graft_entry__
    from autognothi.utils.devices import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    child_device()
    if len(devices) < 4 or devices[0].platform != "gpu":
        raise SystemExit(f"four GPUs needed, found {devices}")
    jax.config.update("jax_default_matmul_precision", "highest")
    four_paths(dataclasses.replace(__graft_entry__._flagship_cfg(),
                                   num_hidden_layers=4))


def four_paths(cfg) -> None:
    """Serving, the data-parallel and the pipeline-parallel explainer steps
    over the first four devices, each checked against the first device."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp
    import numpy as np

    from autognothi.models.vit import (init_vit_classifier,
                                       init_vit_explainer, init_vit_final)
    from autognothi.parallel.mesh import (make_mesh, replicate_params,
                                          shard_batch, shard_params,
                                          sharded_serving_fn)
    from autognothi.parallel.train_step import make_explainer_train_step
    from autognothi.pipeline.pp_trainer import setup_pp_explainer
    from autognothi.pipeline.training import make_optimizer
    from autognothi.recipes.vanilla_vit import fw_final, vanilla_vit_recipe

    recipe = vanilla_vit_recipe()
    n_players = recipe.n_players(cfg)
    px = cfg.img_px_size
    rng = np.random.RandomState(SEED)
    one = jax.devices()[0]

    def spans_four(tree, what):
        for leaf in jax.tree.leaves(tree):
            if len(leaf.sharding.device_set) != 4:
                raise SystemExit(f"{what}: an output lives on "
                                 f"{len(leaf.sharding.device_set)} device(s)")

    def fail_unless(ok, what):
        if not ok:
            raise SystemExit(f"{what} differs from one GPU")

    def compare_outputs(what, got, want):
        diff = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                   for a, b in zip(jax.tree.leaves(got),
                                   jax.tree.leaves(want)))
        print(f"[four] {what}: max |diff| vs one GPU {diff:.3e} (tolerance "
              f"{FOUR_OUTPUT_TOL:g}, fp32 highest)", flush=True)
        fail_unless(diff <= FOUR_OUTPUT_TOL, what)

    def compare_steps(what, axis, loss, params, want_loss, want_params):
        loss, want_loss = float(loss), float(want_loss)
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        moved = sum(float(np.sum(np.abs(np.asarray(want_params[k])
                                        - exp0[k]))) for k in exp0)
        apart = sum(float(np.sum(np.abs(np.asarray(params[k])
                                        - np.asarray(want_params[k]))))
                    for k in exp0)
        tol = FOUR_UPDATE_RTOL[axis]
        print(f"[four] {what}: loss {loss:.6f} vs {want_loss:.6f} on one GPU "
              f"(rel {loss_rel:.2e}, tolerance {FOUR_LOSS_RTOL:g}); AdamW "
              f"update L1 distance {apart / moved:.2e} of its size "
              f"(tolerance {tol:g}); fp32 highest", flush=True)
        fail_unless(loss_rel <= FOUR_LOSS_RTOL and apart <= tol * moved, what)

    # serving: the shard_map data-parallel forward against one GPU
    params = init_vit_final(jax.random.PRNGKey(1), cfg)
    xs = jnp.asarray(rng.randn(8, 3, px, px).astype(np.float32))
    fw = lambda p, x: fw_final(cfg, p, x)  # noqa: E731
    want = jax.jit(fw)(jax.device_put(params, one), jax.device_put(xs, one))
    mesh = make_mesh(4)
    got = sharded_serving_fn(fw, mesh)(replicate_params(params, mesh),
                                       shard_batch(xs, mesh))
    spans_four(got, "serving")
    compare_outputs("data-parallel serving", got, want)

    # training: the explainer step on a ("data",) mesh of 4 vs one GPU
    exp0 = {k: np.asarray(v) for k, v in init_vit_explainer(
        jax.random.PRNGKey(2), cfg).items()}
    srg0 = {k: np.asarray(v) for k, v in init_vit_classifier(
        jax.random.PRNGKey(3), cfg).items()}
    n_mask, batch = 4, 8
    xs = rng.randn(batch, 3, px, px).astype(np.float32)
    null = np.asarray(jax.jit(
        lambda p, x, m: recipe.fw_surrogate(cfg, p, x, m)[0])(
            srg0, jnp.zeros((1, 3, px, px)),
            jnp.ones((1, n_players), jnp.int32)))
    key, lr = jax.random.PRNGKey(4), jnp.asarray(1e-4)
    full = jnp.asarray(cfg.num_hidden_layers, jnp.int32)
    ones = jax.tree.map(lambda _: jnp.ones(()), exp0)
    tx, opt0 = make_optimizer(exp0, recipe.trainable(cfg, "explainer"))
    seq = make_explainer_train_step(recipe, cfg, n_players, n_mask, tx)
    seq_p, _, seq_loss = seq(*jax.device_put(
        (exp0, opt0, srg0, null, xs), one), key, lr, ones, full)

    mesh = make_mesh(4)
    dp = make_explainer_train_step(recipe, cfg, n_players, n_mask, tx,
                                   mesh=mesh)
    with mesh:
        dp_p, _, dp_loss = dp(shard_params(exp0, mesh), opt0,
                              shard_params(srg0, mesh), null,
                              shard_batch(jnp.asarray(xs), mesh), key, lr,
                              ones, full)
    spans_four(dp_p, "data-parallel step")
    compare_steps("data-parallel explainer step", "data", dp_loss, dp_p,
                  seq_loss, seq_p)

    # pipeline: the pp explainer step on a 2x2 ("data", "pipe") mesh
    fake_env = SimpleNamespace(log=lambda *_: None)
    fake_cfg = SimpleNamespace(
        net=SimpleNamespace(kind="vanilla_vit"),
        train_explainer=SimpleNamespace(batch_size=batch,
                                        n_mask_samples=n_mask))
    (ep, srg_p, _tx, eopt, estep, _eval, eplace, to_flat) = \
        setup_pp_explainer(fake_env, fake_cfg, cfg, exp0, srg0, recipe, 2, 2)
    ep2, _, pp_loss = estep(ep, eopt, srg_p, null, eplace(jnp.asarray(xs)),
                            key, lr, jax.tree.map(lambda _: jnp.ones(()), ep),
                            full)
    spans_four(ep2, "pipeline step")
    compare_steps("pipeline-parallel explainer step", "pipe", pp_loss,
                  to_flat(ep2), seq_loss, seq_p)


# ------------------------------------------------------------------- main


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU paths (and nothing else)")
    ap.add_argument("--phase", choices=["device", "fw_final", "four"],
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not (REPO / "autognothi").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        raise SystemExit(1)
    if args.phase:
        {"device": child_device, "fw_final": child_fw_final,
         "four": child_four}[args.phase]()
        return
    try:
        if args.four:
            out = _phase_child("four", 1100)
            for line in out.splitlines():
                if line.startswith("[four]"):
                    _say(line)
            dev = json.loads(out.splitlines()[0])
            for line in nvidia_smi().splitlines():
                _say(f"[device] nvidia-smi: {line}")
        else:
            dev = phase_device()
            phase_kernels()
            phase_train()
            phase_serve()
    except (SmokeError, subprocess.TimeoutExpired) as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"],
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}))


if __name__ == "__main__":
    main()
