"""Image-explanation demo: base64 JPEG + per-patch attribution JSON
(parity: /root/reference/scripts/run_image_explanation.py)."""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import pathlib
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.loader import DatasetLoader, _resize_chw
from ..utils.records import Record
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset, load_epoch_model


@dataclasses.dataclass(kw_only=True)
class ImageExplanation(Record):
    img_channels: int
    img_px_size: int
    img_patch_size: int
    image: str  # base64-encoded jpg
    explanation: List[List[float]]  # [label][h*w]


@dataclasses.dataclass(kw_only=True)
class RunImageExplanationResults(Record):
    items: Dict[int, ImageExplanation]


def _to_b64_jpeg(img_chw: np.ndarray, px: int) -> str:
    import PIL.Image

    img = _resize_chw(np.asarray(img_chw, dtype=np.float32), px, px)
    img = np.clip(img.transpose(1, 2, 0) * 255, 0, 255).astype("uint8")
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def run_image_explanation(
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
    num_labels = m_config.num_labels
    img_channels = m_config.img_channels
    img_px_size = m_config.img_px_size
    img_patch_size = m_config.img_patch_size

    gen_input = recipe.gen_input(m_config, m_misc)
    _fw = lambda p, xs: recipe.fw_final(m_config, p, xs)  # noqa: E731
    # host-side finals (KernelSHAP's numpy WLS) must not be traced
    fw_final = _fw if recipe.fw_final_host else jax.jit(_fw)

    result_buffer: List[ImageExplanation] = []
    for i, (_inputs, _targets, _inputs_raw, _targets_raw) in enumerate(
        d_loader.test_raw(1)
    ):
        if limit is not None and i >= limit:
            break
        xs, zs = gen_input(_inputs, _targets)
        logits, attr = fw_final(final_params, jnp.asarray(xs))
        label = int(np.asarray(zs)[0])
        pred = int(np.argmax(np.asarray(logits)[0]))
        if label != pred:
            continue

        attr = np.asarray(attr)
        assert attr.shape == (
            1, num_labels, (img_px_size // img_patch_size) ** 2
        )
        result_buffer.append(
            ImageExplanation(
                img_channels=img_channels,
                img_px_size=img_px_size,
                img_patch_size=img_patch_size,
                image=_to_b64_jpeg(_inputs_raw[0], img_px_size),
                explanation=attr[0].tolist(),
            )
        )
        print(f"    visualized #{i}...")

    env.log(f"saving into: {into}")
    results = RunImageExplanationResults(
        items={i: r for i, r in enumerate(result_buffer)}
    )
    with open(into, "w", encoding="utf-8") as f:
        raw = results.to_dict()
        f.write(json.dumps(raw, indent=None) + "\n")
