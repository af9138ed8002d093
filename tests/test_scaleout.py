"""Scale-out stress past the 4x2 default (verdict r3 #3): bigger virtual
meshes (16/32 devices), TP=4, pinned collective counts in the compiled HLO,
fail-closed TP divisibility, and a 2-process shard_map *serving* smoke.

The perf argument says "scaling is the remaining dimension" — these tests
make that claim load-bearing: the serving path must compile to ZERO
cross-device collectives at every mesh shape (pure DP over replicated
weights; the known failure mode is GSPMD replicating a pallas_call behind
all-gathers, tests/test_pallas_gspmd.py), the TP forward must all-reduce
exactly once per row-parallel matmul region and never all-gather, and the
fused train step must reduce (grad psums) but never all-gather.
"""

import json
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_parallel import _mini_cfg, _run_step, _step_inputs


# the production dryrun's counter — importing it keeps these pins and the
# driver-run assertions counting the same ops the same way
from __graft_entry__ import _collective_counts  # noqa: E402


# ------------------------------------------------------ in-process: TP=4


def test_tp4_step_equals_single_device_step():
    """The fused explainer step under a (2 data x 4 model) mesh matches the
    unsharded step — TP past the 4x2 shape everything else exercises."""
    from autognothi.parallel.mesh import make_mesh

    cfg = _mini_cfg()
    recipe, n_players, exp_p, srg_p, null, xs = _step_inputs(cfg, batch=8)
    ref_params, ref_loss = _run_step(
        recipe, cfg, n_players, exp_p, srg_p, null, xs, mesh=None
    )
    mesh = make_mesh(8, model_parallel=4)
    tp_params, tp_loss = _run_step(
        recipe, cfg, n_players, exp_p, srg_p, null, xs,
        mesh=mesh, model_parallel=4,
    )
    assert np.isfinite(ref_loss) and abs(ref_loss - tp_loss) < 1e-5
    for k in ref_params:
        np.testing.assert_allclose(
            tp_params[k], ref_params[k], atol=2e-4, rtol=0, err_msg=k
        )


def _mini_ltt_cfg():
    from autognothi.models.ltt_vit import LttViTConfig

    return LttViTConfig(
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
        s_attn_hidden_size=8,
        s_attn_intermediate_size=16,
        img_channels=3,
        img_px_size=16,
        img_patch_size=8,
    )


def test_ltt_param_pspec_covers_side_ladders():
    """The flagship family's side-ladder weights must ride the Megatron
    specs, not silently replicate: every s_attn_layers / s_explainer_attn
    attention+MLP block weight ends with a param_pspec suffix and shards
    over "model" (flagship dims: s_attn 96 divides TP in {2,3,4,6,12}).
    The s_attn_maps trunk->ladder denses and the s_explainer_mlp head
    stay replicated BY DESIGN: the maps are skinny (hidden x 96), and the
    head is a small share of flagship serving — sharding it buys one more
    all-reduce pair for little compute."""
    from jax.sharding import PartitionSpec as P

    from autognothi.models.ltt_vit import init_ltt_vit_explainer
    from autognothi.parallel.mesh import param_pspec

    params = init_ltt_vit_explainer(jax.random.PRNGKey(0), _mini_ltt_cfg())
    ladder_w = [k for k in params
                if (".s_attn_layers." in k or ".s_explainer_attn." in k
                    or "s_explainer_attn." in k)
                and k.endswith((".query.weight", ".key.weight",
                                ".value.weight", "intermediate.dense.weight",
                                "attention.output.dense.weight",
                                ".output.dense.weight"))]
    assert ladder_w, "no ladder block weights found — naming drifted?"
    for k in ladder_w:
        spec = param_pspec(k, params[k].ndim)
        assert "model" in spec, f"{k} would replicate under TP: {spec}"
    # the trunk attention/MLP weights keep their specs too (regression pin)
    assert param_pspec(
        "vit.encoder.layers.0.attention.self.query.weight", 2
    ) == P("model", None)


def test_ltt_tp2_step_equals_single_device_step():
    """The fused explainer step for the FLAGSHIP family (LTT: frozen trunk +
    trainable side ladders, traced ltt_active depth) under a (4 data x
    2 model) Megatron mesh matches the unsharded step — the TP parity
    matrix was vanilla-only before (verdict r4 #8)."""
    from autognothi.models.ltt_vit import (
        init_ltt_vit_explainer,
        init_ltt_vit_surrogate,
    )
    from autognothi.parallel.mesh import make_mesh, shard_batch, shard_params
    from autognothi.parallel.train_step import make_explainer_train_step
    from autognothi.pipeline.training import make_optimizer, ones_mask
    from autognothi.recipes.ltt_vit import ltt_vit_recipe

    cfg = _mini_ltt_cfg()
    recipe = ltt_vit_recipe()
    n_players = recipe.n_players(cfg)
    key = jax.random.PRNGKey(0)
    exp_p = init_ltt_vit_explainer(key, cfg)
    srg_p = init_ltt_vit_surrogate(jax.random.fold_in(key, 1), cfg)
    nil_xs = jnp.zeros((1, 3, 16, 16))
    null, _ = recipe.fw_surrogate(
        cfg, srg_p, nil_xs, jnp.ones((1, n_players), jnp.int32))
    xs = jnp.asarray(np.random.RandomState(0).randn(8, 3, 16, 16)
                     .astype(np.float32))

    def run(mesh):
        ep, sp, x = exp_p, srg_p, xs
        if mesh is not None:
            ep, sp, x = (shard_params(ep, mesh), shard_params(sp, mesh),
                         shard_batch(x, mesh))
        tx, opt = make_optimizer(ep, recipe.trainable(cfg, "explainer"))
        step = make_explainer_train_step(recipe, cfg, n_players, 4, tx,
                                         mesh=mesh)
        args = (ep, opt, sp, null, x, jax.random.PRNGKey(7),
                jnp.asarray(1e-3), ones_mask(ep),
                jnp.asarray(cfg.num_hidden_layers, jnp.int32))
        if mesh is not None:
            with mesh:
                new_p, _, loss = step(*args)
        else:
            new_p, _, loss = step(*args)
        return jax.device_get(new_p), float(loss)

    ref_p, ref_loss = run(None)
    tp_p, tp_loss = run(make_mesh(8, model_parallel=2))
    assert np.isfinite(ref_loss) and abs(ref_loss - tp_loss) < 1e-5
    for k in ref_p:
        np.testing.assert_allclose(tp_p[k], ref_p[k], atol=2e-4, rtol=0,
                                   err_msg=k)


def test_shard_params_fails_closed_on_indivisible_tp():
    """A TP degree that does not divide the weight dims must raise a clear
    error naming the weights — never let GSPMD pad or device_put crash with
    an opaque message (mini hidden=32 does not divide model=3)."""
    from autognothi.models.vit import init_vit_explainer
    from autognothi.parallel.mesh import make_mesh, shard_params

    params = init_vit_explainer(jax.random.PRNGKey(0), _mini_cfg())
    mesh = make_mesh(6, model_parallel=3)
    with pytest.raises(ValueError, match=r"model_parallel.*divides"):
        shard_params(params, mesh)
    try:
        shard_params(params, mesh)
    except ValueError as e:
        assert "query.weight" in str(e)  # offenders are listed by name


# --------------------------------------------- pinned HLO collective counts


def _fw_surrogate_compiled(model_parallel: int):
    from autognothi.parallel.mesh import make_mesh, shard_batch, shard_params
    from autognothi.recipes.vanilla_vit import fw_surrogate

    cfg = _mini_cfg()
    _, n_players, _, srg_p, _, xs = _step_inputs(cfg, batch=8)
    mesh = make_mesh(8, model_parallel=model_parallel)
    sp = shard_params(srg_p, mesh)
    sx = shard_batch(xs, mesh)
    sm = shard_batch(jnp.ones((8, n_players), jnp.int32), mesh)
    with mesh:
        f = jax.jit(lambda p, x, m: fw_surrogate(cfg, p, x, m)[0])
        return f.lower(sp, sx, sm).compile()


def test_serving_shard_map_compiles_to_zero_collectives():
    """DP=8 shard_map serving: weights replicated, batch sharded — the
    compiled program must contain NO cross-device collective of any kind."""
    from autognothi.parallel.mesh import (
        make_mesh, replicate_params, shard_batch, sharded_serving_fn,
    )
    from autognothi.recipes.vanilla_vit import fw_final

    cfg = _mini_cfg()
    from autognothi.models.vit import init_vit_final

    mesh = make_mesh(8, model_parallel=1)
    fin = replicate_params(init_vit_final(jax.random.PRNGKey(2), cfg), mesh)
    xs = shard_batch(jnp.zeros((8, 3, 16, 16), jnp.float32), mesh)
    fw = sharded_serving_fn(lambda p, x: fw_final(cfg, p, x), mesh)
    with mesh:
        cc = _collective_counts(fw.lower(fin, xs).compile())
    assert cc == {k: 0 for k in cc}, cc


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_collectives_pinned(tp):
    """Megatron TP forward: exactly one all-reduce per row-parallel matmul
    region and ZERO all-gathers (an all-gather means a weight lost its
    sharding and got re-materialized).  Measured regions at these mini dims:
    encoder scan body 2 (attention output + MLP output, executed per layer)
    + the surrogate's explainer-side blocks = 6 in the HLO text; identical
    at TP=2 and TP=4 by construction (count is per-region, not per-shard)."""
    cc = _collective_counts(_fw_surrogate_compiled(tp))
    assert cc["all-gather"] == 0, cc
    assert cc["all-reduce"] == 6, cc
    assert cc["collective-permute"] == cc["all-to-all"] == 0, cc


def test_train_step_collectives_no_allgather():
    """The fused sharded train step on the 4x2 mesh: grad syncs and TP
    block reductions are all-reduces; all-gathers are forbidden (they mean
    an operand runs replicated and the mesh buys nothing)."""
    from autognothi.parallel.mesh import make_mesh, shard_batch, shard_params
    from autognothi.parallel.train_step import make_explainer_train_step
    from autognothi.pipeline.training import make_optimizer, ones_mask
    from autognothi.recipes.vanilla_vit import vanilla_vit_recipe

    cfg = _mini_cfg()
    recipe, n_players, exp_p, srg_p, null, xs = _step_inputs(cfg, batch=8)
    mesh = make_mesh(8, model_parallel=2)
    ep = shard_params(exp_p, mesh)
    sp = shard_params(srg_p, mesh)
    sx = shard_batch(xs, mesh)
    tx, opt = make_optimizer(ep, lambda n: True)
    step = make_explainer_train_step(recipe, cfg, n_players, 4, tx, mesh=mesh)
    args = (ep, opt, sp, null, sx, jax.random.PRNGKey(7), jnp.asarray(1e-3),
            ones_mask(ep), jnp.asarray(cfg.num_hidden_layers, jnp.int32))
    with mesh:
        cc = _collective_counts(step.lower(*args).compile())
    assert cc["all-gather"] == 0, cc
    assert cc["all-reduce"] > 0, cc  # grads DO sync across "data"


# ------------------------------------------- bigger meshes (subprocess)


@pytest.mark.slow
@pytest.mark.parametrize("devices,tp", [(16, 4), (32, 4), (16, 2)])
def test_dryrun_larger_meshes(devices, tp):
    """dryrun_multichip at 16/32 virtual devices and TP=4 — the full fused
    train step + eval + shard_map serving + faithfulness sweep, with the
    dryrun's built-in collective assertions (serving: zero collectives;
    train: zero all-gathers) at each shape."""
    import os
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import __graft_entry__ as g; g.dryrun_multichip({devices}, {tp})"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"mesh=({devices // tp}x{tp}) devices={devices}" in proc.stdout


# ------------------------- 2-process shard_map serving smoke (multi-host)


SERVE_CHILD = textwrap.dedent("""
    import json, os, sys
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "host_platform_device_count" not in f]
    flags.append("--xla_force_host_platform_device_count=2")
    os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))

    from autognothi.parallel.distributed import (
        maybe_initialize_distributed, process_info,
    )
    assert maybe_initialize_distributed(), "env did not engage distributed"
    info = process_info()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from autognothi.parallel.mesh import make_mesh, sharded_serving_fn
    from autognothi.models.vit import init_vit_final
    from autognothi.recipes.vanilla_vit import fw_final
    from test_parallel import _mini_cfg

    cfg = _mini_cfg()
    params = init_vit_final(jax.random.PRNGKey(2), cfg)  # same on every proc
    batch = np.random.RandomState(0).randn(4, 3, 16, 16).astype(np.float32)

    mesh = make_mesh()  # 2 procs x 2 local = 4 global devices, pure DP
    rep = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P("data", None, None, None))
    g_params = {k: jax.make_array_from_callback(v.shape, rep,
                                                lambda idx, v=v: v[idx])
                for k, v in params.items()}
    g_xs = jax.make_array_from_callback(batch.shape, dp,
                                        lambda idx: batch[idx])

    fw = sharded_serving_fn(lambda p, x: fw_final(cfg, p, x), mesh)
    with mesh:
        probs, attr = fw(g_params, g_xs)

    # single-device local reference over the FULL batch
    ref_p, ref_a = jax.jit(lambda p, x: fw_final(cfg, p, x))(params, batch)
    ok = True
    for got, ref in ((probs, np.asarray(ref_p)), (attr, np.asarray(ref_a))):
        for shard in got.addressable_shards:
            want = ref[tuple(shard.index)]
            ok &= bool(np.allclose(np.asarray(shard.data), want,
                                   rtol=2e-5, atol=2e-6))
    info["serve_ok"] = ok
    info["probs_shape"] = list(probs.shape)
    print(json.dumps(info), flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_shard_map_serving():
    """The deployment serving wrapper (sharded_serving_fn) across a process
    boundary: 2 OS processes x 2 virtual devices, params replicated via
    make_array_from_callback, request batch globally sharded along "data" —
    every process's local output shards must equal the single-device run."""
    import os

    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "AUTOGNOTHI_DIST_COORD": f"127.0.0.1:{port}",
            "AUTOGNOTHI_DIST_NPROCS": "2",
            "AUTOGNOTHI_DIST_PROC_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SERVE_CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    for pid, proc in enumerate(procs):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"proc {pid} failed:\n{err[-2000:]}"
        info = json.loads(out.strip().splitlines()[-1])
        assert info["global_devices"] == 4
        assert info["serve_ok"] is True
        assert info["probs_shape"] == [4, 3]


@pytest.mark.slow
def test_weak_scaling_harness_runs_mini():
    """The multi-chip weak-scaling measurement protocol
    (playground/bench_scaling.py --mini) stays runnable: doubling mesh
    sweep over the 8 virtual devices, shard_map serving layout, efficiency
    accounting — the harness a real pod run will use."""
    import os
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=8"])
    proc = subprocess.run(
        [sys.executable, "playground/bench_scaling.py", "--mini"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    meshes = [r["mesh"] for r in rows if "mesh" in r]
    assert meshes == [1, 2, 4, 8], meshes  # doubling sweep over the mesh
    one_chip = next(r for r in rows if r.get("mesh") == 1)
    assert abs(one_chip["efficiency"] - 1.0) < 1e-6
    summary = rows[-1]
    assert summary["metric"].endswith("serving_weak_scaling")
    assert len(summary["rows"]) == 4
