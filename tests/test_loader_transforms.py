"""CV transform semantics that parity with torchvision depends on."""

import numpy as np


def test_center_crop_pads_small_images():
    """torchvision CenterCrop zero-pads images smaller than the crop; a
    bare slice yields ragged batches that crash np.stack downstream."""
    from autognothi.data.loader import CvTransforms, apply_cv_transforms

    tf = CvTransforms(center_crop={"height": 8, "width": 8})
    rng = np.random.RandomState(0)
    small = rng.rand(3, 5, 6).astype(np.float32)
    out = apply_cv_transforms(small, tf)
    assert out.shape == (3, 8, 8)
    # the original content sits centered; the border is zero padding
    assert np.count_nonzero(out[:, 0, :]) == 0  # top pad row
    assert np.allclose(out[:, 1:6, 1:7], small)


def test_center_crop_crops_large_images():
    from autognothi.data.loader import CvTransforms, apply_cv_transforms

    tf = CvTransforms(center_crop={"height": 4, "width": 4})
    rng = np.random.RandomState(1)
    big = rng.rand(3, 10, 10).astype(np.float32)
    out = apply_cv_transforms(big, tf)
    assert out.shape == (3, 4, 4)
    assert np.allclose(out, big[:, 3:7, 3:7])
