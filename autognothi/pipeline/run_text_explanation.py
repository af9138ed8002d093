"""Terminal text-explanation demo: heat-colored per-token attributions from
the final model (parity: /root/reference/scripts/run_text_explanation.py)."""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader
from ..utils.records import Record
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset, load_epoch_model

try:
    import rich

    console = rich.get_console()

    def _print(text: str, style: str) -> None:
        console.print(text, style=style, end="", highlight=False)

except ImportError:  # pragma: no cover

    def _print(text: str, style: str) -> None:
        print(text, end="")


@dataclasses.dataclass(kw_only=True)
class RunTextExplanationResults(Record):
    items: Dict[int, List[Tuple[str, float]]]


def real_tokenize_text(token_ids: List[int], tokenizer) -> List[Tuple[int, str]]:
    """Reassemble display tokens, skipping specials; wordpiece continuations
    glue to the previous token, alphabetic tokens get a leading space."""
    special = set(getattr(tokenizer, "all_special_ids", []))
    out: List[Tuple[int, str]] = []
    for i, tk in enumerate(token_ids):
        if tk in special:
            continue
        s = str(tokenizer.decode(tk)).strip()
        if not s:
            s = " "
        if s.startswith("##"):
            s = s[2:]
        elif s[0].isalpha():
            s = " " + s
        out.append((i, s))
    if out:
        out[0] = (out[0][0], out[0][1].lstrip())
        out[-1] = (out[-1][0], out[-1][1].rstrip())
    return out


def _mix_color(cl, cr, r: float):
    return tuple(int(cl[i] * r + cr[i] * (1 - r)) for i in range(3))


def print_label(label: int, pred: int) -> None:
    style = "bold green" if label == pred else "white"
    _print(f"[{label}] ", style)


def print_text_attr(tks_scores: List[Tuple[str, float]]) -> None:
    attrs = [a for _, a in tks_scores]
    cl_lim = max(abs(min(attrs)), abs(max(attrs))) or 1.0
    cl_begin = (18, 132, 255)  # < 0
    cl_mid = (224, 224, 224)
    cl_end = (237, 127, 127)  # > 0
    for tk, at in tks_scores:
        if at < -cl_lim:
            color = cl_begin
        elif at < 0:
            color = _mix_color(cl_begin, cl_mid, -at / cl_lim)
        elif at < cl_lim:
            color = _mix_color(cl_mid, cl_end, 1.0 - at / cl_lim)
        else:
            color = cl_end
        _print(tk, f"rgb({color[0]},{color[1]},{color[2]})")


def run_text_explanation(
    env: ExpEnv,
    d_loader: Optional[DatasetLoader],
    into: pathlib.Path,
    limit: Optional[int],
) -> None:
    config = env.config
    recipe, m_config = get_recipe(config)
    if d_loader is None:
        d_loader = load_cfg_dataset(config.dataset, env.model_path)

    _, final_params = load_epoch_model(env, recipe, "final")
    m_misc = recipe.load_misc(env.model_path, m_config)
    tokenizer = m_misc.tokenizer
    gen_input = recipe.gen_input(m_config, m_misc)
    _fw = lambda p, xs: recipe.fw_final(m_config, p, xs)  # noqa: E731
    # host-side finals (KernelSHAP's numpy WLS) must not be traced
    fw_final = _fw if recipe.fw_final_host else jax.jit(_fw)

    result_buffer: List[List[Tuple[str, float]]] = []
    for i, (_inputs, _targets) in enumerate(d_loader.test(1)):
        if limit is not None and i >= limit:
            break
        xs, zs = gen_input(_inputs, _targets)
        logits, attr = fw_final(final_params, jnp.asarray(xs))
        label = int(np.asarray(zs)[0])
        pred = int(np.argmax(np.asarray(logits)[0]))
        if label != pred:
            continue

        attr = np.asarray(attr)
        tokens = real_tokenize_text([int(t) for t in np.asarray(xs)[0]], tokenizer)
        pairs = [
            (w, float(attr[0, label, idx]))
            for idx, w in tokens
            if idx < attr.shape[2]
        ]
        print(f"# {i}")
        print_label(label, label)
        print_text_attr(pairs)
        print("\n")
        result_buffer.append(pairs)

    env.log(f"saving into: {into}")
    results = RunTextExplanationResults(
        items={i: r for i, r in enumerate(result_buffer)}
    )
    with open(into, "w", encoding="utf-8") as f:
        f.write(json.dumps(results.to_dict(), indent=2) + "\n")
