"""Dataset acquisition & batching.

Mirrors the reference loader surface (/root/reference/datasets/loader.py):
a `DatasetLoader` exposes `train/test/train_raw/test_raw(batch_size)`
iterables; HF-arrow datasets download on first use with deterministic seeded
test subsetting (loader.py:93-106); bundled JSON minisets serve as
CPU-feasible integration fixtures (loader.py:179-196); imagenette labels are
remapped to the model ordering (loader.py:339-366).

Notes: CV samples are produced as numpy `<3, H, W>` float arrays
(channel-first, normalized) ready for `jax.device_put`; nothing here touches
a device.  A fully offline synthetic CV miniset (`cv_samples`) is added so
image pipelines are testable with zero egress.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import random
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple,
                    TypedDict)

import numpy as np

from ..utils.records import Record

_HERE = pathlib.Path(__file__).parent

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


# ------------------------------------------------------------- transforms


class CvTransformResize(TypedDict):
    height: int
    width: int


class CvTransformRandomCrop(TypedDict):
    height: int
    width: int
    scale: Tuple[float, float]
    p: float


class CvTransformCenterCrop(TypedDict):
    height: int
    width: int


class CvTransformHorizontalFlip(TypedDict):
    p: float


class CvTransformVerticalFlip(TypedDict):
    p: float


class CvTransformColorJitter(TypedDict):
    brightness: float
    contrast: float
    saturation: float
    hue: float


@dataclasses.dataclass(kw_only=True)
class CvTransforms(Record):
    resize: Optional[CvTransformResize] = None
    random_crop: Optional[CvTransformRandomCrop] = None
    center_crop: Optional[CvTransformCenterCrop] = None
    horizontal_flip: Optional[CvTransformHorizontalFlip] = None
    vertical_flip: Optional[CvTransformVerticalFlip] = None
    color_jitter: Optional[CvTransformColorJitter] = None


_IMAGEPROC = None  # cached native lib handle (False when unavailable)


def _native_imageproc():
    """Lazily build/load the C++ image pre-processing core."""
    global _IMAGEPROC
    if _IMAGEPROC is None:
        import ctypes

        from ..native import build_and_load

        lib = build_and_load("imageproc")
        if lib is not None:
            fp = ctypes.POINTER(ctypes.c_float)
            lib.ip_resize_bilinear.restype = ctypes.c_int
            lib.ip_resize_bilinear.argtypes = [
                fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                fp, ctypes.c_int64, ctypes.c_int64,
            ]
        _IMAGEPROC = lib or False
    return _IMAGEPROC or None


def _resize_chw(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a <C, H, W> float array.  Native C++ core when the
    toolchain allows (same align-corners grid), numpy otherwise."""
    c, h, w = img.shape
    if (h, w) == (height, width):
        return img
    lib = _native_imageproc()
    if lib is not None:
        import ctypes

        src = np.ascontiguousarray(img, dtype=np.float32)
        dst = np.empty((c, height, width), dtype=np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        rc = lib.ip_resize_bilinear(
            src.ctypes.data_as(fp), c, h, w,
            dst.ctypes.data_as(fp), height, width,
        )
        if rc == 0:
            return dst
    ys = np.linspace(0, h - 1, height)
    xs = np.linspace(0, w - 1, width)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    top = img[:, y0][:, :, x0] * (1 - wx) + img[:, y0][:, :, x1] * wx
    bot = img[:, y1][:, :, x0] * (1 - wx) + img[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def apply_cv_transforms(
    img: np.ndarray, transforms: CvTransforms, rng: Optional[random.Random] = None
) -> np.ndarray:
    """Apply the configured transform chain to a normalized <C, H, W> image."""
    rng = rng or random
    if transforms.resize:
        opt = transforms.resize
        img = _resize_chw(img, opt["height"], opt["width"])
    if transforms.random_crop:
        opt = transforms.random_crop
        c, h, w = img.shape
        scale = rng.uniform(*opt["scale"])
        ch = max(1, int(round(h * np.sqrt(scale))))
        cw = max(1, int(round(w * np.sqrt(scale))))
        top = rng.randint(0, max(0, h - ch))
        left = rng.randint(0, max(0, w - cw))
        img = _resize_chw(img[:, top : top + ch, left : left + cw],
                          opt["height"], opt["width"])
    if transforms.center_crop:
        opt = transforms.center_crop
        c, h, w = img.shape
        ch, cw = opt["height"], opt["width"]
        if h < ch or w < cw:
            # torchvision CenterCrop zero-pads images smaller than the crop
            # (a bare slice would yield ragged batches -> np.stack crash)
            ph, pw = max(0, ch - h), max(0, cw - w)
            img = np.pad(img, ((0, 0), (ph // 2, ph - ph // 2),
                               (pw // 2, pw - pw // 2)))
            c, h, w = img.shape
        top = max(0, (h - ch) // 2)
        left = max(0, (w - cw) // 2)
        img = img[:, top : top + ch, left : left + cw]
    if transforms.horizontal_flip and rng.random() < transforms.horizontal_flip["p"]:
        img = img[:, :, ::-1].copy()
    if transforms.vertical_flip and rng.random() < transforms.vertical_flip["p"]:
        img = img[:, ::-1, :].copy()
    # color_jitter intentionally approximate: brightness/contrast only
    if transforms.color_jitter:
        opt = transforms.color_jitter
        if opt["brightness"]:
            img = img * rng.uniform(1 - opt["brightness"], 1 + opt["brightness"])
        if opt["contrast"]:
            mean = img.mean()
            img = (img - mean) * rng.uniform(
                1 - opt["contrast"], 1 + opt["contrast"]
            ) + mean
    return img.astype(np.float32)


# ----------------------------------------------------------------- loader


@dataclasses.dataclass
class DatasetLoader:
    # batch_size -> ...(Xs, Ys, Xs_raw, Ys_raw)
    #     nlp: Xs = Xs_raw := List[str], Ys = Ys_raw := List[int]
    #     cv:  Xs := List[np <3,H,W>] normalized+transformed, Ys := List[int]
    #          Xs_raw := List[np <3,h,w>] un-normalized, Ys_raw := List[int]
    train_raw: Callable[[int], Iterable[Tuple[Any, Any, Any, Any]]]
    test_raw: Callable[[int], Iterable[Tuple[Any, Any, Any, Any]]]

    def train(self, batch_size: int) -> Iterable[Tuple[Any, Any]]:
        for xs, ys, _xr, _yr in self.train_raw(batch_size):
            yield xs, ys

    def test(self, batch_size: int) -> Iterable[Tuple[Any, Any]]:
        for xs, ys, _xr, _yr in self.test_raw(batch_size):
            yield xs, ys


# ------------------------------------------------------------ nlp minisets


def _json_nlp_loader(path: pathlib.Path) -> DatasetLoader:
    with open(path, "r", encoding="utf-8") as f:
        samples = json.load(f)

    def it(batch_size: int) -> Iterable[Tuple[Any, Any, Any, Any]]:
        for i in range(0, len(samples), batch_size):
            chunk = samples[i : i + batch_size]
            xs = [s["inputs"] for s in chunk]
            ys = [s["targets"] for s in chunk]
            yield xs, ys, list(xs), list(ys)

    return DatasetLoader(train_raw=it, test_raw=it)


def load_nlp_samples() -> DatasetLoader:
    return _json_nlp_loader(_HERE / "nlp_samples.json")


def load_yelp_polarity_mini() -> DatasetLoader:
    """Mini yelp-polarity; falls back to the bundled sample set offline."""
    mini = _HERE / "yelp_polarity_mini.json"
    if mini.exists():
        return _json_nlp_loader(mini)
    return load_nlp_samples()


# --------------------------------------------------------- HF arrow sets


def _subset_ids(
    n: int, pick: int, *, seed: Optional[int]
) -> List[int]:
    """Deterministic (seeded) or run-random subset of range(n)."""
    ids = list(range(n))
    gen = random.Random(seed if seed is not None else random.randint(0, 2**32))
    gen.shuffle(ids)
    return ids[:pick]


def _hf_dataset(ds_id: str, subtype: Optional[str], cache_dir: pathlib.Path):
    from datasets import load_dataset, load_from_disk

    if cache_dir.exists():
        try:
            return load_from_disk(str(cache_dir))
        except Exception:
            pass
    ds = load_dataset(ds_id, name=subtype)
    cache_dir.parent.mkdir(parents=True, exist_ok=True)
    ds.save_to_disk(str(cache_dir))
    return ds


def load_yelp_polarity(
    train_size: int, test_size: int, test_seed: int
) -> DatasetLoader:
    cache = _HERE / "yelp_polarity"
    ds = _hf_dataset("fancyzhx/yelp_polarity", None, cache)

    def make_it(split: str, size: int, seed: Optional[int]):
        def it(batch_size: int):
            data = ds[split]
            ids = _subset_ids(len(data), size, seed=seed)
            sub = data.select(ids)
            for batch in sub.iter(batch_size):
                xs, ys = [], []
                for t, l in zip(batch["text"], batch["label"]):
                    if isinstance(t, str) and isinstance(l, int) and 0 <= l < 2 \
                            and len(t) >= 32:
                        xs.append(t)
                        ys.append(l)
                if xs:
                    yield xs, ys, list(xs), list(ys)

        return it

    return DatasetLoader(
        train_raw=make_it("train", train_size, None),
        test_raw=make_it("test", test_size, test_seed),
    )


IMAGENETTE_LABEL_ORDER: Dict[int, int] = {
    # position in frgfm/imagenette -> model label id
    # (tench, springer, cassette, chainsaw, church, horn, truck, pump,
    #  golf ball, parachute) -> reference ordering
    0: 2, 1: 3, 2: 0, 3: 7, 4: 4, 5: 6, 6: 1, 7: 9, 8: 8, 9: 5,
}


def load_imagenette(
    train_size: int, test_size: int, test_seed: int, transforms: CvTransforms
) -> DatasetLoader:
    cache = _HERE / "imagenette"
    ds = _hf_dataset("frgfm/imagenette", "full_size", cache)

    def make_it(split: str, size: int, seed: Optional[int]):
        def it(batch_size: int):
            data = ds[split]
            ids = _subset_ids(len(data), size, seed=seed)
            sub = data.select(ids)
            for batch in sub.iter(batch_size):
                xs, ys, xr = [], [], []
                for img, label in zip(batch["image"], batch["label"]):
                    mapped = IMAGENETTE_LABEL_ORDER.get(label)
                    if mapped is None:
                        continue
                    arr = np.asarray(img, dtype=np.float32) / 255.0
                    if arr.ndim == 2:
                        arr = np.stack([arr] * 3, axis=-1)
                    arr = arr.transpose(2, 0, 1)  # <3, H, W>
                    raw = arr.copy()
                    arr = (arr - IMAGENET_MEAN[:, None, None]) / (
                        IMAGENET_STD[:, None, None]
                    )
                    arr = apply_cv_transforms(arr, transforms)
                    xs.append(arr)
                    ys.append(mapped)
                    xr.append(raw)
                if xs:
                    yield xs, ys, xr, list(ys)

        return it

    return DatasetLoader(
        train_raw=make_it("train", train_size, None),
        test_raw=make_it("validation", test_size, test_seed),
    )


# --------------------------------------------------- synthetic cv miniset


def load_cv_samples(
    train_size: int = 32,
    test_size: int = 16,
    img_px_size: int = 32,
    num_classes: int = 4,
    seed: int = 1234,
) -> DatasetLoader:
    """Fully offline synthetic image classification set: each class is a
    distinct low-frequency pattern + noise.  Deterministic in `seed`."""

    def make(count: int, salt: int):
        rng = np.random.RandomState(seed + salt)
        xs, ys = [], []
        yy, xx = np.mgrid[0:img_px_size, 0:img_px_size].astype(np.float32)
        yy, xx = yy / img_px_size, xx / img_px_size
        for i in range(count):
            label = i % num_classes
            phase = 2 * np.pi * label / num_classes
            base = np.sin(2 * np.pi * (xx + yy) + phase)
            img = np.stack(
                [base, np.cos(2 * np.pi * xx + phase), np.sin(2 * np.pi * yy - phase)]
            )
            img = img + 0.25 * rng.randn(3, img_px_size, img_px_size)
            xs.append(img.astype(np.float32))
            ys.append(label)
        return xs, ys

    train_xs, train_ys = make(train_size, 0)
    test_xs, test_ys = make(test_size, 1)

    def it(xs, ys):
        def loader(batch_size: int):
            for i in range(0, len(xs), batch_size):
                bx = xs[i : i + batch_size]
                by = ys[i : i + batch_size]
                yield bx, by, [x.copy() for x in bx], list(by)

        return loader

    return DatasetLoader(train_raw=it(train_xs, train_ys),
                         test_raw=it(test_xs, test_ys))


def preload_all_datasets() -> None:
    load_yelp_polarity(560000, 38000, 0x3407)
    load_imagenette(9469, 3925, 0x3407, CvTransforms())
