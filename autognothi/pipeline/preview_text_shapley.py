"""Monte-Carlo permutation-sampling Shapley preview against the surrogate
(parity: /root/reference/scripts/preview_text_shapley.py).

Redesign: instead of streaming <P+1, P> cumulative masks through a host
rebatcher, each repetition's full permutation sweep evaluates as ONE
coalition batch via the surrogate's embed-once fast path, vmapped over
repetitions; the marginal-contribution scatter happens on device."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset, load_epoch_model
from .run_text_explanation import print_label, print_text_attr, real_tokenize_text


def montecarlo_shapley(
    recipe,
    m_config,
    srg_params,
    xs: jnp.ndarray,  # <1, ...>
    n_players: int,
    key: jax.Array,
    reps: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (sv <n_classes, n_players>, v0 <n_classes>, vN <n_classes>)."""

    def one_rep(rep_key):
        perm = jax.random.permutation(rep_key, n_players)
        # cumulative masks: row i has perm[:i] enabled  -> <P+1, P>
        order_pos = jnp.argsort(perm)  # player -> position in perm
        steps = jnp.arange(n_players + 1)[:, None]  # <P+1, 1>
        masks = (order_pos[None, :] < steps).astype(jnp.int32)
        if recipe.fw_surrogate_coalitions is not None:
            probs = recipe.fw_surrogate_coalitions(
                m_config, srg_params, xs, masks[None]
            )[0]
        else:
            xs_ext = jnp.repeat(xs, n_players + 1, axis=0)
            probs, _ = recipe.fw_surrogate(m_config, srg_params, xs_ext, masks)
        # value-fn sharpening: logit link over (re-)softmaxed outputs
        p = jax.nn.softmax(probs, axis=1)
        v = jnp.log(p / (1 - p + 1e-6))  # <P+1, C>
        d_perm = v[1:] - v[:-1]  # marginal contribs in perm order <P, C>
        d = jnp.zeros_like(d_perm).at[perm].set(d_perm)  # scatter to players
        return d, v[0], v[-1]

    keys = jax.random.split(key, reps)
    d_all, v0_all, vn_all = jax.lax.map(one_rep, keys)
    sv = d_all.sum(axis=0) / reps  # <P, C>
    return (
        np.asarray(sv.T),  # <C, P>
        np.asarray(v0_all[-1]),
        np.asarray(vn_all[-1]),
    )


def preview_text_shapley(
    env: ExpEnv, d_loader: Optional[DatasetLoader] = None, reps: int = 8
) -> None:
    config = env.config
    recipe, m_config = get_recipe(config)
    if d_loader is None:
        d_loader = load_cfg_dataset(config.dataset, env.model_path)

    _, srg_params = load_epoch_model(env, recipe, "surrogate")
    m_misc = recipe.load_misc(env.model_path, m_config)
    tokenizer = m_misc.tokenizer
    gen_input = recipe.gen_input(m_config, m_misc)
    n_players = recipe.n_players(m_config)

    for i, (_inputs, _targets) in enumerate(d_loader.test(1)):
        xs, zs = gen_input(_inputs, _targets)
        key = jax.random.fold_in(jax.random.PRNGKey(config.seed), i)
        sv, _v0, _vn = montecarlo_shapley(
            recipe, m_config, srg_params, jnp.asarray(xs[:1]), n_players, key,
            reps=reps,
        )
        tokens = real_tokenize_text([int(t) for t in np.asarray(xs)[0]], tokenizer)
        label = int(np.asarray(zs)[0])
        for cls in range(min(2, sv.shape[0])):
            pairs = [
                (w, float(sv[cls, idx])) for idx, w in tokens
                if idx < sv.shape[1]
            ]
            print_label(cls, label)
            print_text_attr(pairs)
            print("")
        print("")
