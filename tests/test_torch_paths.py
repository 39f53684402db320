"""What the port's apps compute and write besides renders, against the JAX
package and PIL: the camera paths of data/paths.py bit-equal to JAX's,
mathx.psnr_to_mse and compute_avg_error (float32, rtol 1e-6), and the image
writers of data/format.py read back by PIL: the float32 depth TIFF equal to
the array written, the GIF's frame count, duration, loop and every channel
within the palette's stated half step (GIF_HALF_STEP)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from durf_tpu import mathx as jmathx
from durf_tpu.data import paths as jpaths
from durf_tpu_torch import mathx
from durf_tpu_torch.data import paths
from durf_tpu_torch.data.format import GIF_HALF_STEP, write_gif, write_tiff_float32


def _poses(n=8, radius=4.0):
    out = []
    for th in np.linspace(0, np.pi / 2, n):
        pos = np.array([radius * np.cos(th), 1.5, radius * np.sin(th)], np.float32)
        out.append(jpaths.view_matrix(pos / np.linalg.norm(pos), np.array([0, 1, 0.0]), pos))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("n_views", [1, 7, 24])
def test_paths_are_bit_equal(n_views):
    poses = _poses()
    bounds = np.asarray([[1.0, 50.0]] * len(poses))
    pairs = [
        (paths.spiral_path(poses, bounds, n_views=n_views),
         jpaths.spiral_path(poses, bounds, n_views=n_views)),
        (paths.spiral_path(poses, bounds, n_views=n_views, n_rots=1, zrate=0.2),
         jpaths.spiral_path(poses, bounds, n_views=n_views, n_rots=1, zrate=0.2)),
        (paths.spherical_path(poses, n_views=n_views), jpaths.spherical_path(poses, n_views=n_views)),
        (paths.interpolate_poses(poses[:4], n_views=n_views),
         jpaths.interpolate_poses(poses[:4], n_views=n_views)),
        (paths.average_pose(poses), jpaths.average_pose(poses)),
    ]
    for ours, theirs in pairs:
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    assert pairs[0][0].shape == (n_views, 3, 4)


@pytest.mark.parametrize("psnr,ssim,lpips", [(20.0, 0.7, 0.3), (31.5, 0.95, 0.05)])
def test_avg_error_matches_jax(psnr, ssim, lpips):
    t = [torch.tensor(v) for v in (psnr, ssim, lpips)]
    j = [jnp.asarray(v, jnp.float32) for v in (psnr, ssim, lpips)]
    np.testing.assert_allclose(float(mathx.psnr_to_mse(t[0])), float(jmathx.psnr_to_mse(j[0])),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mathx.compute_avg_error(*t)),
                               float(jmathx.compute_avg_error(*j)), rtol=1e-6)
    np.testing.assert_allclose(float(mathx.mse_to_psnr(mathx.psnr_to_mse(t[0]))), psnr,
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 80)])
def test_tiff_is_read_back_by_pil(tmp_path, shape):
    depth = np.random.default_rng(0).normal(10, 5, shape).astype(np.float32)
    path = str(tmp_path / "d.tiff")
    write_tiff_float32(path, depth)
    img = Image.open(path)
    assert img.mode == "F" and img.size == shape[::-1]
    np.testing.assert_array_equal(np.asarray(img), depth)


def test_tiff_refuses_other_ranks(tmp_path):
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        write_tiff_float32(str(tmp_path / "d.tiff"), np.zeros((2, 2, 3)))


def _gif_frames(h, w, n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = [np.stack([(xx * 255 // max(w - 1, 1) + 37 * k) % 256, yy * 255 // max(h - 1, 1),
                        (xx + yy + 11 * k) % 256], -1).astype(np.uint8) for k in range(n - 1)]
    # Noise fills the 4096-code table and forces clear codes mid-frame.
    return smooth + [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)]


@pytest.mark.parametrize("h,w,n", [(1, 1, 1), (16, 20, 2), (64, 80, 3), (150, 200, 2)])
def test_gif_is_read_back_by_pil(tmp_path, h, w, n):
    frames = _gif_frames(h, w, n, seed=h)[-n:]
    path = str(tmp_path / "t.gif")
    write_gif(path, frames, duration_ms=80, loop=0)
    gif = Image.open(path)
    assert gif.format == "GIF" and gif.size == (w, h) and gif.n_frames == n
    assert gif.info["loop"] == 0
    for k, frame in enumerate(frames):
        gif.seek(k)
        assert gif.info["duration"] == 80
        err = np.abs(np.asarray(gif.convert("RGB")).astype(np.float64) - frame).max(axis=(0, 1))
        assert np.all(err <= np.asarray(GIF_HALF_STEP)), (k, err)


def test_gif_loop_count_duration_and_refusals(tmp_path):
    path = str(tmp_path / "t.gif")
    write_gif(path, _gif_frames(8, 8, 2, 0), duration_ms=120, loop=3)
    gif = Image.open(path)
    assert gif.info["loop"] == 3 and gif.info["duration"] == 120
    with pytest.raises(ValueError, match="at least one frame"):
        write_gif(path, [])
    with pytest.raises(ValueError, match="uint8"):
        write_gif(path, [np.zeros((4, 4, 3), np.float32)])
    with pytest.raises(ValueError, match="one size"):
        write_gif(path, [np.zeros((4, 4, 3), np.uint8), np.zeros((4, 5, 3), np.uint8)])
