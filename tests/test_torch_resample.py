"""The port's PIL-exact resampling (durf_tpu_torch/data/resample.py) against
PIL's `Image.resize` on random images.

Tolerance: bitwise on uint8 ("L", "RGB") and for NEAREST; within 1e-5 on
float32 ("F") LANCZOS, whose double sums may round to float32 apart.
"""

import numpy as np
import pytest
from PIL import Image

from durf_tpu_torch.data import resample as rs

F_TOL = 1e-5
METHODS = {"lanczos": (rs.LANCZOS, Image.LANCZOS), "nearest": (rs.NEAREST, Image.NEAREST)}
# (input height, width) -> output (width, height): factors 2, 4, 8 of the
# converters' pyramids, sizes that do not divide, an upscale and one axis.
SIZES = {
    "f2": ((64, 96), (48, 32)),
    "f4": ((64, 96), (24, 16)),
    "f8": ((64, 96), (12, 8)),
    "odd": ((37, 53), (17, 12)),
    "up": ((9, 13), (29, 20)),
    "one_axis": ((32, 40), (40, 9)),
}


def _image(mode, hw, seed):
    rng = np.random.default_rng(seed)
    if mode == "L":
        return rng.integers(0, 256, hw).astype(np.uint8)
    if mode == "RGB":
        return rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    return (rng.normal(size=hw) * 10).astype(np.float32)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("mode", ["L", "RGB", "F"])
def test_resample_matches_pil(mode, method, size):
    hw, out = SIZES[size]
    img = _image(mode, hw, seed=len(size) + 7 * len(mode))
    ours, pils = METHODS[method]
    ref = np.asarray(Image.fromarray(img).resize(out, pils))
    got = rs.resample(img, out, ours)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if mode == "F" and method == "lanczos":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F_TOL)
    else:
        assert np.array_equal(got, ref)


def test_resample_of_a_converter_pyramid_level():
    """A Waymo-sized frame to factor 4 and a mask's NEAREST level, as the
    converters call them."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (320, 480, 3)).astype(np.uint8)
    assert np.array_equal(rs.resample(rgb, (120, 80)),
                          np.asarray(Image.fromarray(rgb).resize((120, 80), Image.LANCZOS)))
    mask = (rng.uniform(size=(80, 120)) > 0.5).astype(np.float32)
    assert np.array_equal(rs.resample(mask, (15, 10), rs.NEAREST),
                          np.asarray(Image.fromarray(mask).resize((15, 10), Image.NEAREST)))


def test_same_size_is_a_copy_and_other_inputs_raise():
    img = _image("RGB", (5, 7), 0)
    out = rs.resample(img, (7, 5))
    assert np.array_equal(out, img) and out is not img
    for bad in (img.astype(np.float64), np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.int32)):
        with pytest.raises(ValueError, match="resample takes"):
            rs.resample(bad, (2, 2))
    with pytest.raises(ValueError, match="unknown method"):
        rs.resample(img, (3, 2), "bicubic")
