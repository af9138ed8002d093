"""Direct tests for the parallelism layer (autognothi/parallel/).

The reference is single-device, so this capability has no torch oracle; the
oracles here are *internal*: an 8-device data-parallel optimizer step must
equal the 1-device step bit-for-bit-ish, a TP=2 sharded forward must equal
the unsharded forward, and every attention/MLP weight name must hit the
Megatron pspec table (a typo'd suffix would silently replicate a weight).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P


def _mini_cfg():
    from autognothi.models.vit import VanillaViTConfig

    return VanillaViTConfig(
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


def _step_inputs(cfg, batch):
    from autognothi.models.vit import init_vit_classifier, init_vit_explainer
    from autognothi.recipes.vanilla_vit import fw_surrogate, vanilla_vit_recipe

    recipe = vanilla_vit_recipe()
    n_players = recipe.n_players(cfg)
    key = jax.random.PRNGKey(0)
    exp_params = init_vit_explainer(key, cfg)
    srg_params = init_vit_classifier(jax.random.fold_in(key, 1), cfg)
    nil_xs = jnp.zeros((1, 3, cfg.img_px_size, cfg.img_px_size))
    nil_mask = jnp.ones((1, n_players), jnp.int32)
    surrogate_null, _ = fw_surrogate(cfg, srg_params, nil_xs, nil_mask)
    xs = jnp.asarray(
        np.random.RandomState(0)
        .randn(batch, 3, cfg.img_px_size, cfg.img_px_size)
        .astype(np.float32)
    )
    return recipe, n_players, exp_params, srg_params, surrogate_null, xs


def _run_step(recipe, cfg, n_players, exp_params, srg_params, surrogate_null,
              xs, mesh=None, model_parallel=1):
    from autognothi.parallel.mesh import shard_batch, shard_params
    from autognothi.parallel.train_step import make_explainer_train_step
    from autognothi.pipeline.training import make_optimizer, ones_mask

    if mesh is not None:
        exp_params = shard_params(exp_params, mesh)
        srg_params = shard_params(srg_params, mesh)
        xs = shard_batch(xs, mesh)
    tx, opt_state = make_optimizer(exp_params, lambda name: True)
    step = make_explainer_train_step(recipe, cfg, n_players, 4, tx,
                                     mesh=mesh)
    args = (
        exp_params, opt_state, srg_params, surrogate_null, xs,
        jax.random.PRNGKey(7), jnp.asarray(1e-3),
        ones_mask(exp_params), jnp.asarray(cfg.num_hidden_layers, jnp.int32),
    )
    if mesh is not None:
        with mesh:
            new_params, _, loss = step(*args)
    else:
        new_params, _, loss = step(*args)
    return jax.device_get(new_params), float(loss)


def test_dp8_step_equals_single_device_step():
    """One fused optimizer step on the 8-device data mesh == 1 device."""
    from autognothi.parallel.mesh import make_mesh

    cfg = _mini_cfg()
    recipe, n_players, exp_p, srg_p, null, xs = _step_inputs(cfg, batch=8)
    ref_params, ref_loss = _run_step(
        recipe, cfg, n_players, exp_p, srg_p, null, xs, mesh=None
    )
    mesh = make_mesh(8, model_parallel=1)
    dp_params, dp_loss = _run_step(
        recipe, cfg, n_players, exp_p, srg_p, null, xs, mesh=mesh
    )
    assert np.isfinite(ref_loss) and abs(ref_loss - dp_loss) < 1e-5
    # AdamW's first step is ~lr*sign(grad), so cross-device reduction-order
    # noise on near-zero grads shows up at ~5e-5; a real sharding bug (wrong
    # mask/zeroed shard) shifts params by the full ~1e-3 update magnitude.
    for k in ref_params:
        np.testing.assert_allclose(
            dp_params[k], ref_params[k], atol=2e-4, rtol=0, err_msg=k
        )


def test_tp2_step_equals_single_device_step():
    """The full fused step under a (4 data x 2 model) Megatron mesh matches
    the unsharded step — this is the exact configuration whose dryrun broke
    in round 1."""
    from autognothi.parallel.mesh import make_mesh

    cfg = _mini_cfg()
    recipe, n_players, exp_p, srg_p, null, xs = _step_inputs(cfg, batch=8)
    ref_params, ref_loss = _run_step(
        recipe, cfg, n_players, exp_p, srg_p, null, xs, mesh=None
    )
    mesh = make_mesh(8, model_parallel=2)
    tp_params, tp_loss = _run_step(
        recipe, cfg, n_players, exp_p, srg_p, null, xs,
        mesh=mesh, model_parallel=2,
    )
    assert np.isfinite(ref_loss) and abs(ref_loss - tp_loss) < 1e-5
    for k in ref_params:
        np.testing.assert_allclose(
            tp_params[k], ref_params[k], atol=2e-4, rtol=0, err_msg=k
        )


def test_tp2_forward_equals_tp1_forward():
    """fw_surrogate on TP=2-sharded params == unsharded forward."""
    from autognothi.parallel.mesh import make_mesh, shard_batch, shard_params
    from autognothi.recipes.vanilla_vit import fw_surrogate

    cfg = _mini_cfg()
    _, n_players, _, srg_p, _, xs = _step_inputs(cfg, batch=4)
    mask = jnp.ones((4, n_players), jnp.int32)
    ref, _ = jax.jit(lambda p, x, m: fw_surrogate(cfg, p, x, m))(srg_p, xs, mask)

    mesh = make_mesh(8, model_parallel=2)
    sp = shard_params(srg_p, mesh)
    sx = shard_batch(xs, mesh)
    sm = shard_batch(mask, mesh)
    with mesh:
        out, _ = jax.jit(lambda p, x, m: fw_surrogate(cfg, p, x, m))(sp, sx, sm)
    np.testing.assert_allclose(
        jax.device_get(out), jax.device_get(ref), rtol=2e-5, atol=2e-6
    )


def test_param_pspec_covers_every_tp_weight():
    """Every attention/MLP block weight in both model families must map to a
    sharded spec; everything else must be replicated.  Catches a typo'd
    suffix in the Megatron table (which would silently replicate)."""
    from autognothi.models.bert import VanillaBertConfig, init_bert_explainer
    from autognothi.models.vit import init_vit_explainer
    from autognothi.parallel.mesh import param_pspec

    cfg = _mini_cfg()
    vit_params = init_vit_explainer(jax.random.PRNGKey(0), cfg)
    bert_cfg = VanillaBertConfig(
        attention_probs_dropout_prob=0.0,
        explainer_attn_num_layers=1,
        explainer_head_hidden_size=16,
        explainer_normalize=True,
        hidden_dropout_prob=0.0,
        hidden_size=32,
        intermediate_size=64,
        layer_norm_eps=1e-12,
        max_position_embeddings=32,
        num_attention_heads=4,
        num_hidden_layers=2,
        num_labels=3,
        pad_token_id=0,
        type_vocab_size=2,
        vocab_size=64,
    )
    bert_params = init_bert_explainer(jax.random.PRNGKey(1), bert_cfg)

    col = re.compile(
        r"\.(attention\.self\.(query|key|value)|intermediate\.dense)\.weight$"
    )
    col_bias = re.compile(
        r"\.(attention\.self\.(query|key|value)|intermediate\.dense)\.bias$"
    )
    row = re.compile(r"\.(attention\.output\.dense|(?<!e)output\.dense)\.weight$")

    for params in (vit_params, bert_params):
        for name, value in params.items():
            spec = param_pspec(name, value.ndim)
            if col.search(name):
                assert spec == P("model", None), name
            elif col_bias.search(name):
                assert spec == P("model"), name
            elif row.search(name):
                assert spec == P(None, "model"), name
            else:
                assert "model" not in jax.tree.leaves(tuple(spec)), (
                    f"unexpected TP sharding for {name}: {spec}"
                )


def test_param_pspec_divisibility_tp2():
    """Sharded dims must divide by model=2 on the flagship-sized blocks so
    device_put never pads silently."""
    from autognothi.models.vit import init_vit_explainer
    from autognothi.parallel.mesh import param_pspec

    params = init_vit_explainer(jax.random.PRNGKey(0), _mini_cfg())
    for name, value in params.items():
        spec = param_pspec(name, value.ndim)
        for dim, axis in zip(value.shape, spec):
            if axis == "model":
                assert dim % 2 == 0, (name, value.shape, spec)


def test_dryrun_multichip_self_bootstraps_from_one_device():
    """Regression for the round-1 driver failure: dryrun_multichip(8) must
    succeed even when the calling process sees a single device (it re-execs
    a CPU child with 8 virtual devices)."""
    import subprocess
    import sys
    import os
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the parent sees ONE device (no forced device count) — like the driver
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK" in proc.stdout


def test_pad_to_multiple():
    from autognothi.parallel.mesh import pad_to_multiple

    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    out = pad_to_multiple(a, 4, axis=0)
    assert out.shape == (8, 2)
    np.testing.assert_array_equal(out[:5], a)
    np.testing.assert_array_equal(out[5:], np.broadcast_to(a[-1], (3, 2)))
    assert pad_to_multiple(a, 5, axis=0) is a


def test_make_mesh_fails_closed_on_too_few_devices():
    """Requesting more devices than visible must name the real cause, not
    die in a cryptic numpy reshape."""
    import pytest

    from autognothi.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="only 8 device"):
        make_mesh(16, model_parallel=4)
