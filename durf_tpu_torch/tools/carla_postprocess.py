"""CARLA capture -> scene-directory converter (offline post-processing).

Decodes CARLA's 24-bit RGB depth encoding, builds sky masks from the
semantic camera (CARLA sky id 13), instance-id masks from the instance
camera, downsampled image pyramids, and the poses_bounds / 3D_boxes files
the loaders read: the same files as durf_tpu.tools.carla_postprocess
writes, with the port's PNG codec and PIL-exact resampling
(data/resample.py) in place of PIL.

Expected capture layout (written by durf_tpu_torch.tools.carla_capture):
  capture_dir/
    poses.npy    dict: {"{frame:08d}_{cam}": 4x4 NeRF-convention c2w}
                 plus "hwf_{cam}": [h, w, focal]
    bboxes.npy   dict: {frame: {vehicle_id: {"center": 4x4 world pose,
                                              "extent": [3] half extents}}}
    {frame:08d}_rgb{cam}.png / _depth{cam}.png / _sem{cam}.png / _inst{cam}.png

Usage:
  python -m durf_tpu_torch.tools.carla_postprocess --capture_dir ... --out_dir ... \\
      [--factors 4] [--near 0.1 --far 1000]
"""

from __future__ import annotations

import argparse
import os
from os import path

import numpy as np

from durf_tpu_torch.data import format as diskfmt
from durf_tpu_torch.data.resample import LANCZOS, NEAREST, resample

CARLA_SKY_SEMANTIC_ID = 13
N_CAMS = 5


def decode_depth(depth_rgb: np.ndarray, max_depth: float = 1000.0) -> np.ndarray:
    """CARLA 24-bit depth: meters = (R + G*256 + B*256^2) / (2^24 - 1) * 1000.

    Args:
      depth_rgb: [H, W, 3+] uint8 from the depth camera (RGB channel order).
    """
    d = depth_rgb.astype(np.float64)
    norm = (d[..., 0] + d[..., 1] * 256.0 + d[..., 2] * 65536.0) / (2**24 - 1)
    return (norm * max_depth).astype(np.float32)


def sky_mask_from_semantic(sem: np.ndarray, sky_id: int = CARLA_SKY_SEMANTIC_ID) -> np.ndarray:
    """Binary sky mask from the semantic camera's red channel (the CARLA tag
    channel)."""
    tags = sem[..., 0] if sem.ndim == 3 else sem
    return (tags == sky_id).astype(np.float32)


def instance_ids(inst: np.ndarray) -> np.ndarray:
    """Instance ids from the instance camera: id = G + B*256 (the red channel
    carries the semantic tag)."""
    if inst.ndim == 2:
        return inst.astype(np.int32)
    return (inst[..., 1].astype(np.int32) + inst[..., 2].astype(np.int32) * 256)


def _downsample(img: np.ndarray, factor: int, nearest: bool = False) -> np.ndarray:
    if factor <= 1:
        return img
    h, w = img.shape[:2]
    arr = img if img.dtype == np.uint8 else img.astype(np.float32)
    return resample(arr, (w // factor, h // factor), NEAREST if nearest else LANCZOS)


def _min_pool_depth(depth: np.ndarray, factor: int) -> np.ndarray:
    """Min-pool metric depth (a conservative z-buffer downsample; zeros —
    no-returns — are ignored unless the whole cell is empty)."""
    if factor <= 1:
        return depth
    h, w = depth.shape
    h2, w2 = h // factor, w // factor
    d = depth[: h2 * factor, : w2 * factor].reshape(h2, factor, w2, factor)
    d = d.transpose(0, 2, 1, 3).reshape(h2, w2, -1)
    masked = np.where(d > 0, d, np.inf)
    out = masked.min(-1)
    return np.where(np.isfinite(out), out, 0.0).astype(np.float32)


def convert(
    capture_dir: str,
    out_dir: str,
    factor: int = 4,
    near: float = 0.1,
    far: float = 1000.0,
    factors=(4,),
) -> None:
    poses_dict = np.load(path.join(capture_dir, "poses.npy"), allow_pickle=True).item()
    bboxes = np.load(path.join(capture_dir, "bboxes.npy"), allow_pickle=True).item()

    frames = sorted({k.split("_")[0] for k in poses_dict if not k.startswith("hwf")})
    poses_hwf, bounds = [], []
    per_factor = {f: dict(images=[], depth=[], sky=[], inst=[]) for f in factors}

    for frame in frames:
        for cam in range(N_CAMS):
            c2w = np.asarray(poses_dict[f"{frame}_{cam}"])[:3, :4]
            hwf = np.asarray(poses_dict[f"hwf_{cam}"], np.float32)
            poses_hwf.append(np.concatenate([c2w, hwf[:, None]], axis=1))
            bounds.append([near, far])

            rgb = diskfmt.read_png(path.join(capture_dir, f"{frame}_rgb{cam}.png"))[..., :3]
            depth_rgb = diskfmt.read_png(path.join(capture_dir, f"{frame}_depth{cam}.png"))[..., :3]
            sem = diskfmt.read_png(path.join(capture_dir, f"{frame}_sem{cam}.png"))
            inst = diskfmt.read_png(path.join(capture_dir, f"{frame}_inst{cam}.png"))

            depth = decode_depth(depth_rgb, max_depth=far)
            sky = sky_mask_from_semantic(sem)
            ids = instance_ids(inst)
            for f in factors:
                per_factor[f]["images"].append(
                    _downsample(rgb, f).astype(np.float32) / 255.0
                )
                per_factor[f]["depth"].append(_min_pool_depth(depth, f))
                per_factor[f]["sky"].append(
                    (_downsample((sky * 255).astype(np.uint8), f, nearest=True) > 127).astype(
                        np.float32
                    )
                )
                per_factor[f]["inst"].append(
                    _downsample(ids.astype(np.uint8), f, nearest=True).astype(np.int32)
                )

    # Box dict: keys "{ts}_{objid}_center"/"_ext" with 1-based timesteps and
    # vehicle ids renumbered densely from 1 (the loaders discover ids from the
    # 2D masks; we renumber both consistently).
    vehicle_ids = sorted({vid for frame_boxes in bboxes.values() for vid in frame_boxes})
    id_map = {vid: i + 1 for i, vid in enumerate(vehicle_ids)}
    boxes_3d: dict = {}
    for t, frame in enumerate(sorted(bboxes)):
        for vid, box in bboxes[frame].items():
            boxes_3d[f"{t + 1}_{id_map[vid]}_center"] = np.asarray(box["center"], np.float32)
            boxes_3d[f"{t + 1}_{id_map[vid]}_ext"] = np.asarray(box["extent"], np.float32)

    os.makedirs(out_dir, exist_ok=True)
    for f in factors:
        diskfmt.save_scene(
            out_dir,
            per_factor[f]["images"],
            np.stack(poses_hwf),
            np.asarray(bounds, np.float32),
            boxes_3d,
            per_factor[f]["depth"],
            per_factor[f]["sky"],
            per_factor[f]["inst"],
            factor=f,
            base_factor=factors[0],
        )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--capture_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--factors", type=int, nargs="+", default=[4])
    p.add_argument("--near", type=float, default=0.1)
    p.add_argument("--far", type=float, default=1000.0)
    args = p.parse_args(argv)
    convert(
        args.capture_dir,
        args.out_dir,
        near=args.near,
        far=args.far,
        factors=tuple(args.factors),
    )
    print(f"wrote scene to {args.out_dir}")


if __name__ == "__main__":
    main()
