"""PIL's `Image.resize` in numpy, for the modes the converters use.

`resample(image, (width, height), LANCZOS | NEAREST)` returns what
`np.asarray(Image.fromarray(image).resize((width, height), filter))` returns:

  * LANCZOS follows libImaging/Resample.c: `precompute_coeffs` (support
    3 * scale, each output's taps over the input pixels its box bounds
    select, normalised to sum 1); the horizontal pass, then the vertical
    pass, each only where that size changes. Each pass is a sparse product
    that sums an output's taps in input order, as Resample.c's loops do.
    On uint8 [H, W] ("L") and [H, W, 3] ("RGB") the coefficients are in
    fixed point at PRECISION_BITS = 32 - 8 - 2 with its rounding, the sums
    start from 1 << (PRECISION_BITS - 1) and end in `clip8`; they are
    integers below 2^31, exact in float64. On float32 [H, W] ("F") the
    double sums of each pass are stored as float32, as PIL stores them.
  * NEAREST follows Geometry.c's `ImagingScaleAffine`: the source of output
    pixel x is floor(x0), x0 starting at scale / 2 and growing by scale =
    in / out per pixel in double precision.
"""

from __future__ import annotations

import functools
import math

import numpy as np

LANCZOS, NEAREST = "lanczos", "nearest"
PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int, fixed: bool):
    """Resample.c's precompute_coeffs as a sparse [out_size, in_size] matrix,
    cached per size pair: row xx holds output pixel xx's normalised taps
    over the input pixels its box bounds select, in input order; with
    `fixed`, normalize_coeffs_8bpc's fixed point (rounded half away from
    zero at PRECISION_BITS)."""
    import scipy.sparse

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale
    rows, cols, vals = [], [], []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        rows += [xx] * xmax
        cols += range(xmin, xmin + xmax)
        vals += k
    vals = np.asarray(vals, np.float64)
    if fixed:
        scaled = vals * (1 << PRECISION_BITS)
        vals = np.trunc(np.where(vals < 0, -0.5 + scaled, 0.5 + scaled))
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(out_size, in_size))


def _one_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """ImagingResample{Horizontal,Vertical}_{8bpc,32bpc} along `axis`, as a
    sparse product that sums each output's taps in input order: for uint8
    the fixed-point sums (integers, exact in float64) from the rounding
    half, then clip8; for float32 double sums stored as float32."""
    fixed = img.dtype == np.uint8
    mat = _coefficients(img.shape[axis], out_size, fixed)
    src = np.moveaxis(img, axis, 0)
    sums = mat @ src.astype(np.float64, order="C").reshape(src.shape[0], -1)
    sums = sums.reshape((out_size,) + src.shape[1:])
    if fixed:
        sums += 1 << (PRECISION_BITS - 1)
        out = np.clip(sums.astype(np.int64) >> PRECISION_BITS, 0, 255).astype(np.uint8)
    else:
        out = sums.astype(np.float32)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """ImagingScaleAffine's source index of each output pixel (-1: none)."""
    step = in_size / out_size
    pos = step * 0.5
    index = np.empty(out_size, np.int64)
    for x in range(out_size):
        i = -1 if pos < 0.0 else int(pos)
        index[x] = i if i < in_size else -1
        pos += step
    return index


def resample(image: np.ndarray, size, method: str = LANCZOS) -> np.ndarray:
    """PIL's `Image.resize(size, Image.LANCZOS | Image.NEAREST)` of the image
    `Image.fromarray(image)` makes, as an array. `size` is (width, height)."""
    image = np.asarray(image)
    gray_or_rgb = image.ndim == 2 or image.ndim == 3 and image.shape[2] == 3
    if not (image.dtype == np.uint8 and gray_or_rgb or image.dtype == np.float32
            and image.ndim == 2):
        raise ValueError(f"resample takes uint8 [H, W] or [H, W, 3] or float32 [H, W], "
                         f"got {image.dtype} {image.shape}")
    width, height = size
    if width <= 0 or height <= 0:
        raise ValueError(f"resample: size must be positive, got {size}")
    in_h, in_w = image.shape[:2]
    if (width, height) == (in_w, in_h):
        return image.copy()
    if method == NEAREST:
        rows, cols = _nearest_index(in_h, height), _nearest_index(in_w, width)
        out = image[np.clip(rows, 0, None)][:, np.clip(cols, 0, None)]
        out[rows < 0] = 0
        out[:, cols < 0] = 0
        return out
    if method != LANCZOS:
        raise ValueError(f"resample: unknown method {method!r} (LANCZOS or NEAREST)")
    out = image
    if width != in_w:
        out = _one_pass(out, 1, width)
    if height != in_h:
        out = _one_pass(out, 0, height)
    return out
