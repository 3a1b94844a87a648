"""``RandomGaussianBlur`` at any radius (``cnsn_tpu_torch/segmentation/
data.py``) against JAX's, which is ``cv2.GaussianBlur(image, (r, r), 0)``
on the float32 image, on images smaller and larger than the kernel
(BORDER_REFLECT_101 reflects again where the kernel outgrows the image).

The taps equal ``cv2.getGaussianKernel(r, 0, CV_32F)`` bit for bit: its
fixed tables up to 9 taps, the sigma-derived kernel beyond.  The images:
bit for bit up to 3 taps; beyond, within 2 float32 ulps of the 0–255
scale (2^-16 each), and within 3 at 5 taps, whose order of operations
inside OpenCV's filter the port does not reproduce (the recipe's radius;
the 5-tap blur before this file was held within 1e-3).
"""
import cv2
import numpy as np
import pytest

import cnsn_tpu.segmentation.data as J
from cnsn_tpu_torch.segmentation import data as P
from test_torch_threads import one_thread  # noqa: F401 (autouse)

ULP = 2.0 ** -16  # a float32 ulp on [128, 256)
BOUND_ULPS = {1: 0, 3: 0, 5: 3}
SHAPES = ((1, 1), (2, 3), (5, 4), (23, 17), (70, 61))


def _images(seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.float32) for h, w in SHAPES]


@pytest.mark.parametrize("radius", [1, 3, 5, 7, 9, 15, 31])
def test_blur_matches_jax_cv2(radius):
    np.testing.assert_array_equal(
        P.gaussian_taps(radius),
        cv2.getGaussianKernel(radius, 0, cv2.CV_32F).ravel())
    bound = BOUND_ULPS.get(radius, 2) * ULP
    for i, image in enumerate(_images(radius)):
        want, _ = J.RandomGaussianBlur(radius, p=1.0)(
            np.random.RandomState(i), image.copy(), None)
        got, _ = P.RandomGaussianBlur(radius, p=1.0)(
            np.random.RandomState(i), image.copy(), None)
        assert got.dtype == np.float32 and got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err <= bound, (image.shape, err / ULP)


@pytest.mark.parametrize("radius", [0, 2, 8, -3])
def test_even_or_nonpositive_radius_raises(radius):
    with pytest.raises(ValueError, match="odd"):
        P.RandomGaussianBlur(radius)
    if radius > 0:
        with pytest.raises(cv2.error):
            cv2.GaussianBlur(np.zeros((8, 8, 3), np.float32),
                             (radius, radius), 0)
