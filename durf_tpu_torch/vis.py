"""Visualization: depth colorization, fake normals and sample-weight bars
for eval logging (the port's copy of the JAX package's `vis.py`, numpy).

Behavioral parity with reference internal/vis.py (sinebow/turbo depth maps
with acc-weighted percentile auto-ranging, normals from depth gradients).
Implemented host-side in numpy — visualization is not a device workload.

Provenance: `visualize_depth`/`visualize_normals` follow the structure of
reference internal/vis.py:45-132, which is itself vendored from Google's
Apache-2.0 mip-NeRF (github.com/google/mipnerf, internal/vis.py) — the
sort/cumsum acc-weighted auto-ranging and curve_fn/modulus contract are
that upstream algorithm, re-expressed host-side in numpy with a polynomial
turbo approximation instead of matplotlib (as `compute_ssim` in mathx.py
notes its mip-NeRF lineage).
"""

from __future__ import annotations

import numpy as np


def sinebow(h: np.ndarray) -> np.ndarray:
    """Cyclic uniform colormap (reference vis.py:23-26)."""
    f = lambda x: np.sin(np.pi * x) ** 2
    return np.stack([f(3 / 6 - h), f(5 / 6 - h), f(7 / 6 - h)], -1)


def _turbo(x: np.ndarray) -> np.ndarray:
    """Polynomial approximation of the turbo colormap (no matplotlib needed)."""
    x = np.clip(x, 0, 1)
    r = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943])
    g = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604])
    b = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973])
    xs = np.stack([np.ones_like(x), x, x**2, x**3, x**4, x**5], -1)
    return np.clip(np.stack([xs @ r, xs @ g, xs @ b], -1), 0, 1)


def visualize_depth(
    depth: np.ndarray,
    acc: np.ndarray | None = None,
    near: float | None = None,
    far: float | None = None,
    ignore_frac: float = 0.0,
    curve_fn=lambda x: -np.log(x + np.finfo(np.float32).eps),
    modulus: float = 0.0,
) -> np.ndarray:
    """Colorized depth with acc-weighted percentile auto-ranging
    (reference vis.py:45-111)."""
    depth = np.asarray(depth, np.float64)
    acc = np.ones_like(depth) if acc is None else np.asarray(acc, np.float64)
    acc = np.where(np.isnan(depth), 0.0, acc)

    sortidx = np.argsort(depth.reshape(-1))
    depth_sorted = depth.reshape(-1)[sortidx]
    acc_sorted = acc.reshape(-1)[sortidx]
    cum = np.cumsum(acc_sorted)
    mask = (cum >= cum[-1] * ignore_frac) & (cum <= cum[-1] * (1 - ignore_frac))
    keep = depth_sorted[mask]

    eps = np.finfo(np.float32).eps
    near = near or (keep[0] - eps if keep.size else eps)
    far = far or (keep[-1] + eps if keep.size else 1.0)

    # Sky rays carry depth 0 (LIDAR no-return), so the -log curve hits
    # log(0) = -inf for them; the nan_to_num below maps those pixels to the
    # clip edge — silence the (expected) warning.
    with np.errstate(divide="ignore", invalid="ignore"):
        depth, near, far = [curve_fn(x) for x in (depth, near, far)]
    if modulus > 0:
        value = np.mod(depth, modulus) / modulus
        vis = sinebow(value)
    else:
        value = np.nan_to_num(np.clip((depth - min(near, far)) / abs(far - near), 0, 1))
        vis = _turbo(value)
    return vis * acc[..., None] + (1 - acc[..., None])


def depth_to_normals(depth: np.ndarray) -> np.ndarray:
    """Fake normals from depth gradients (reference vis.py:34-42)."""
    from scipy.signal import convolve2d

    f_blur = np.array([1, 2, 1]) / 4
    f_edge = np.array([-1, 0, 1]) / 2
    dy = convolve2d(depth, f_blur[None, :] * f_edge[:, None], mode="same")
    dx = convolve2d(depth, f_blur[:, None] * f_edge[None, :], mode="same")
    inv = 1 / np.sqrt(1 + dx**2 + dy**2)
    return np.stack([dx * inv, dy * inv, inv], -1)


def visualize_normals(depth: np.ndarray, acc: np.ndarray | None, scaling: float | None = None):
    """Reference vis.py:114-132."""
    depth = np.asarray(depth, np.float64)
    if scaling is None:
        mask = ~np.isnan(depth)
        x, y = np.meshgrid(np.arange(depth.shape[1]), np.arange(depth.shape[0]), indexing="xy")
        xy_var = (np.var(x[mask]) + np.var(y[mask])) / 2
        z_var = max(np.var(depth[mask]), 1e-12)
        scaling = np.sqrt(xy_var / z_var)
    normals = depth_to_normals(scaling * depth)
    vis = np.isnan(normals) + np.nan_to_num((normals + 1) / 2, nan=0)
    if acc is not None:
        vis = vis * acc[..., None] + (1 - acc[..., None])
    return vis


def render_weight_bars(
    t_vals_per_level, weights_per_level, width: int = 480, height: int = 160
) -> np.ndarray:
    """Render per-level sample weights as colored bars over ray distance —
    matplotlib-free version of the reference's nerf_weights TensorBoard image
    (train_boxpose.py:484-493).

    Args:
      t_vals_per_level: list of [S+1] fencepost arrays (one ray per level).
      weights_per_level: list of [S] weight arrays.
    """
    colors = np.array([[0.2, 0.4, 0.9], [0.2, 0.8, 0.3], [0.9, 0.3, 0.2]])
    img = np.ones((height, width, 3), np.float32)
    t_lo = min(float(np.min(t)) for t in t_vals_per_level)
    t_hi = max(float(np.max(t)) for t in t_vals_per_level)
    w_hi = max(float(np.max(w)) for w in weights_per_level) + 1e-9
    span = max(t_hi - t_lo, 1e-9)
    for li, (t_vals, weights) in enumerate(zip(t_vals_per_level, weights_per_level)):
        color = colors[li % len(colors)]
        for s in range(len(weights)):
            x0 = int((float(t_vals[s]) - t_lo) / span * (width - 1))
            x1 = max(int((float(t_vals[s + 1]) - t_lo) / span * (width - 1)), x0 + 1)
            h = int(float(weights[s]) / w_hi * (height - 1))
            if h > 0:
                img[height - h :, x0:x1] = (
                    img[height - h :, x0:x1] * 0.4 + color * 0.6
                )
    return img


def visualize_suite(depth: np.ndarray, acc: np.ndarray) -> dict:
    """Depth / wrapped-depth / normals bundle (reference vis.py:135-142)."""
    return {
        "depth": visualize_depth(depth, acc),
        "depth_mod": visualize_depth(depth, acc, modulus=0.1),
        "depth_normals": visualize_normals(depth, acc),
    }
