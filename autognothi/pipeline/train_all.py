"""7-stage training orchestrator with resumable stage detection and the
final-coherency invariant (parity: the reference's scripts/train_all.py).

Stages: 0) pretrained -> classifier ckpt, 1) train classifier, 2) ->
surrogate, 3) train surrogate, 4) -> explainer, 5) train explainer,
6) -> final (verified numerically coherent against the individual models)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.devices import on_host
from ..utils.seeding import iterative_key
from .config import Config_Train
from .env import ExpEnv
from .resources import (
    get_recipe,
    latest_epoch,
    load_epoch_model,
    save_epoch_ckpt,
)
from .train_classifier import train_classifier
from .train_explainer import train_explainer
from .train_surrogate import train_surrogate

_STAGE0_TRAIN_CFG = Config_Train(epochs=0, ckpt_when="_:%1==0", lr=0.0, batch_size=1)

COHERENCY_EPS = 1e-5


def train_all(env: ExpEnv) -> None:
    config = env.config

    def detect_stage() -> int:
        # existence probes only — never load payloads just to detect stages
        if latest_epoch(env.model_path, "final", 0) is not None:
            return 7
        epoch_exp = latest_epoch(
            env.model_path, "explainer", config.train_explainer.epochs
        )
        if epoch_exp is not None:
            return 6 if epoch_exp == config.train_explainer.epochs else 5
        epoch_srg = latest_epoch(
            env.model_path, "surrogate", config.train_surrogate.epochs
        )
        if epoch_srg is not None:
            return 4 if epoch_srg == config.train_surrogate.epochs else 3
        epoch_cls = latest_epoch(env.model_path, "classifier", 0)
        if epoch_cls is not None:
            return 2 if epoch_cls == config.train_classifier.epochs else 1
        return 0

    stage = detect_stage()
    env.log(f"[[[ current stage: {stage} / 7 ]]]")
    if stage < 1:
        conv_pretrained_classifier(env)
    if stage < 2:
        with env.fork(lambda ec: ec.logger_classifier) as cl_env:
            train_classifier(cl_env)
    if stage < 3:
        conv_classifier_surrogate(env)
    if stage < 4:
        with env.fork(lambda ec: ec.logger_surrogate) as sg_env:
            train_surrogate(sg_env)
    if stage < 5:
        conv_surrogate_explainer(env)
    if stage < 6:
        with env.fork(lambda ec: ec.logger_explainer) as ex_env:
            train_explainer(ex_env)
    if stage < 7:
        conv_explainer_final(env)
    env.log("[[[ all stages ok ]]]")


def conv_pretrained_classifier(env: ExpEnv) -> None:
    from ..zoo.loader import load_params

    with on_host():  # surgery on host (utils.devices)
        env.log("[[[ loading base params... ]]]")
        config = env.config
        recipe, m_config = get_recipe(config)
        bundle, tokenizer = load_params(
            config.net.base_model, num_labels=config.net.params.num_labels
        )

        env.log("[[[ converting base -> classifier {0}... ]]]")
        key = iterative_key(config.seed, "conv_pretrained_classifier")
        if bundle is None:  # random_init extension
            params = recipe.init_classifier(key, m_config)
        else:
            params = recipe.conv_pretrained_classifier(m_config, bundle, key)
        save_epoch_ckpt(env.model_path, "classifier", _STAGE0_TRAIN_CFG, 0, params)

        if tokenizer is not None:
            env.log("[[[ converting base tokenizer... ]]]")
            tk_path = env.model_path / "tokenizer"
            if hasattr(tokenizer, "save_pretrained"):
                tokenizer.save_pretrained(str(tk_path))
            else:
                tokenizer.save(tk_path)
        else:
            env.log("[[[ skipped base misc ]]]")
        env.log("[[[ convert base -> classifier {0} ok ]]]")


def conv_classifier_surrogate(env: ExpEnv) -> None:
    with on_host():  # surgery on host (utils.devices)
        env.log("[[[ loading classifier params... ]]]")
        config = env.config
        recipe, m_config = get_recipe(config)
        m_misc = recipe.load_misc(env.model_path, m_config)
        epoch_cls, cls_params = load_epoch_model(env, recipe, "classifier")
        if epoch_cls < config.train_classifier.epochs:
            raise ValueError("under-trained classifier")

        env.log(f"[[[ converting classifier {epoch_cls} -> surrogate 0... ]]]")
        key = iterative_key(config.seed, "conv_classifier_surrogate")
        params = recipe.conv_classifier_surrogate(m_config, m_misc, cls_params, key)
        save_epoch_ckpt(env.model_path, "surrogate", config.train_surrogate, 0, params)
        env.log(f"[[[ convert classifier {epoch_cls} -> surrogate 0 ok ]]]")


def conv_surrogate_explainer(env: ExpEnv) -> None:
    with on_host():  # surgery on host (utils.devices)
        env.log("[[[ loading surrogate params... ]]]")
        config = env.config
        recipe, m_config = get_recipe(config)
        m_misc = recipe.load_misc(env.model_path, m_config)
        epoch_srg, srg_params = load_epoch_model(env, recipe, "surrogate")
        if epoch_srg < config.train_surrogate.epochs:
            raise ValueError("under-trained surrogate")

        env.log(f"[[[ converting surrogate {epoch_srg} -> explainer 0... ]]]")
        key = iterative_key(config.seed, "conv_surrogate_explainer")
        params = recipe.conv_surrogate_explainer(m_config, m_misc, srg_params, key)
        save_epoch_ckpt(env.model_path, "explainer", config.train_explainer, 0, params)
        env.log(f"[[[ convert surrogate {epoch_srg} -> explainer 0 ok ]]]")


def conv_explainer_final(env: ExpEnv) -> None:
    with on_host():  # surgery on host (utils.devices)
        env.log("[[[ loading all params... ]]]")
        config = env.config
        recipe, m_config = get_recipe(config)
        m_misc = recipe.load_misc(env.model_path, m_config)
        epoch_cls, cls_params = load_epoch_model(env, recipe, "classifier")
        epoch_srg, srg_params = load_epoch_model(env, recipe, "surrogate")
        epoch_exp, exp_params = load_epoch_model(env, recipe, "explainer")
        if epoch_cls < config.train_classifier.epochs:
            raise ValueError("under-trained classifier")
        if epoch_srg < config.train_surrogate.epochs:
            raise ValueError("under-trained surrogate")
        if epoch_exp < config.train_explainer.epochs:
            raise ValueError("under-trained explainer")

        env.log("[[[ converting models -> final 0... ]]]")
        key = iterative_key(config.seed, "conv_explainer_final")
        final_params = recipe.conv_explainer_final(
            m_config, m_misc, cls_params, srg_params, exp_params, key
        )
        if not _verify_final_coherency(env, final_params, cls_params,
                                       srg_params, exp_params):
            raise ValueError("cannot save final model due to non-coherency")
        save_epoch_ckpt(env.model_path, "final", _STAGE0_TRAIN_CFG, 0, final_params)
        env.log("[[[ convert models -> final 0 ok ]]]")


def _verify_final_coherency(env: ExpEnv, final_params, cls_params,
                            srg_params, exp_params) -> bool:
    """Numeric invariant: the merged Final reproduces the individual
    classifier/explainer outputs on the null input to 1e-5
    (train_all.py:166-218) — the conversion regression test run on every
    pipeline pass.  The reference computes it in true float32 (torch keeps
    TF32 off for matmuls by default), so every matmul here runs at
    "highest" precision: TF32 alone can move the outputs past 1e-5."""
    env.log("[[[ verifying final model coherency... ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.verify_final_coherency:
        env.log("[[[ skipped: net recipe does not support this ]]]")
        return True

    env.log("judging...")  # stage params arrive from the caller — the
    # conversion just loaded them (re-reading was 2x the checkpoint I/O)
    m_misc = recipe.load_misc(env.model_path, m_config)
    n_players = recipe.n_players(m_config)
    nil_xs = jnp.asarray(recipe.gen_null(m_config, m_misc))
    nil_mask = jnp.ones((1, n_players), dtype=jnp.int32)

    with jax.default_matmul_precision("highest"):
        _, cls_ref = recipe.fw_classifier(m_config, cls_params, nil_xs,
                                          nil_mask)
        srg_ref, _ = recipe.fw_surrogate(m_config, srg_params, nil_xs,
                                         nil_mask)
        exp_ref, _ = recipe.fw_explainer(
            m_config, exp_params, nil_xs, nil_mask, srg_ref, srg_ref
        )
        cls_out, exp_out = recipe.fw_final(m_config, final_params, nil_xs)

    cls_diff = float(jnp.max(jnp.abs(cls_ref - cls_out)))
    exp_diff = float(jnp.max(jnp.abs(exp_ref - exp_out)))
    env.log(f"cls_diff: {cls_diff}, exp_diff: {exp_diff}")

    if cls_diff > COHERENCY_EPS or exp_diff > COHERENCY_EPS:
        env.log("[[[ !!! final is not coherent !!! ]]]")
        raise ValueError("final model is not coherent")
    env.log("[[[ verified final model is coherent ]]]")
    return True
