"""Native (C++) image pre-processing core vs the numpy reference: identical
bilinear sampling grid (align-corners), fp32-tolerance outputs."""

import ctypes

import numpy as np
import pytest

import autognothi.data.loader as dl


def _numpy_resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    c, h, w = img.shape
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


@pytest.fixture(scope="module")
def lib():
    handle = dl._native_imageproc()
    if handle is None:
        pytest.skip("native toolchain unavailable")
    return handle


@pytest.mark.parametrize(
    "src_hw,dst_hw",
    [((32, 48), (16, 16)), ((7, 9), (224, 224)), ((5, 5), (1, 1)),
     ((1, 1), (4, 4)), ((16, 16), (16, 16))],
)
def test_resize_matches_numpy(lib, src_hw, dst_hw):
    rng = np.random.RandomState(0)
    img = rng.randn(3, *src_hw).astype(np.float32)
    got = dl._resize_chw(img, *dst_hw)
    want = _numpy_resize(img, *dst_hw)
    assert got.shape == want.shape == (3, *dst_hw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_loader_uses_some_resize_path():
    # the public loader path produces correctly-sized normalized images
    loader = dl.load_cv_samples(train_size=4, test_size=2, img_px_size=24)
    xs, _ = next(iter(loader.test(2)))
    assert np.asarray(xs).shape == (2, 3, 24, 24)


def test_normalize_batch(lib):
    fp = ctypes.POINTER(ctypes.c_float)
    lib.ip_normalize.restype = ctypes.c_int
    lib.ip_normalize.argtypes = [
        fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, fp, fp,
    ]
    rng = np.random.RandomState(1)
    img = rng.rand(2, 3, 8 * 8).astype(np.float32)
    mean = np.asarray([0.5, 0.4, 0.3], dtype=np.float32)
    std = np.asarray([0.2, 0.25, 0.3], dtype=np.float32)
    want = (img - mean[None, :, None]) / std[None, :, None]
    got = img.copy()
    rc = lib.ip_normalize(
        got.ctypes.data_as(fp), 2, 3, 64,
        mean.ctypes.data_as(fp), std.ctypes.data_as(fp),
    )
    assert rc == 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # zero std -> error code, buffer untouched semantics not required
    bad_std = np.asarray([0.2, 0.0, 0.3], dtype=np.float32)
    rc = lib.ip_normalize(
        got.ctypes.data_as(fp), 2, 3, 64,
        mean.ctypes.data_as(fp), bad_std.ctypes.data_as(fp),
    )
    assert rc == 2
