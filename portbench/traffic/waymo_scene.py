"""The `waymo_scene` traffic source: a synthetic dynamic street scene made by
the benchmark and written in the Waymo layout the port's loader reads.

The world is analytic (checkerboard ground plane, gradient sky, two moving
textured boxes) under the Waymo five-camera rig advancing 0.6 m a timestep,
rendered with exact ray casting: images, metric depth (0 on sky), sky and
instance masks, and the box poses. It is the same world as the port's
data/synthetic.py draws, copied here so that the benchmark makes its
inputs itself. `generate` returns the raw arrays; `write` writes them as a
scene directory (8-bit PNG images, poses_bounds.npy, 3D_boxes.npy with each
box's full extents, as the Waymo layout states them, and the npz stacks);
`reference_split` is the reference's reading of it.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from portbench.reference import scene as ref_scene

# Half extents (m) of the two cars; the Waymo layout stores twice these.
BOX_EXTENTS = np.array([[1.0, 0.8, 2.0], [0.8, 0.7, 1.6]], np.float32)
BOX_COLORS = np.array([[0.9, 0.15, 0.1], [0.1, 0.2, 0.9]], np.float32)
N_CAMS = 5


def yaw_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def box_trajectory(obj: int, t: int, timesteps: int, ext_y: float):
    """World centre and yaw of object `obj` (0 or 1) at timestep t, standing
    on the ground (half height `ext_y`)."""
    u = t / max(timesteps - 1, 1)
    if obj == 0:
        return np.array([-6.0 + 12.0 * u, ext_y, -14.0], np.float32), 0.15 * u
    return np.array([5.0 - 8.0 * u, ext_y, -9.0 - 3.0 * u], np.float32), -0.4 + 0.3 * u


def camera_pose(cam: int, t: int) -> np.ndarray:
    """[3, 4] camera-to-world of the rig's camera `cam` (FRONT, FRONT_LEFT,
    SIDE_LEFT, FRONT_RIGHT, SIDE_RIGHT) at timestep t."""
    offsets = [0.0, -0.8, -1.4, 0.8, 1.4]
    yaws = [0.0, 0.35, 0.9, -0.35, -0.9]
    pos = np.array([offsets[cam], 1.6, 2.0 - 0.6 * t], np.float32)
    return np.concatenate([yaw_matrix(yaws[cam]), pos[:, None]], axis=1)


def render(c2w, width, height, focal, boxes):
    """(rgb, depth, sky, instance ids) of one camera by exact ray casting."""
    x, y = np.meshgrid(np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32),
                       indexing="xy")
    cam_dirs = np.stack([(x - width / 2) / focal, -(y - height / 2) / focal, -np.ones_like(x)], -1)
    dirs = (cam_dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    origin = c2w[:3, 3]
    t_hit = np.full((height, width), np.inf, np.float32)
    rgb = np.zeros((height, width, 3), np.float32)
    inst = np.zeros((height, width), np.int32)
    dy = dirs[..., 1]
    t_ground = np.where(dy < -1e-6, -origin[1] / np.minimum(dy, -1e-6), np.inf)
    with np.errstate(invalid="ignore"):
        gx = origin[0] + t_ground * dirs[..., 0]
        gz = origin[2] + t_ground * dirs[..., 2]
        checker = np.nan_to_num((np.floor(gx / 2.0) + np.floor(gz / 2.0)) % 2).astype(np.float32)
    ground = (0.25 + 0.35 * checker)[..., None] * np.array([1.0, 0.95, 0.85], np.float32)
    hit = t_ground < t_hit
    t_hit = np.where(hit, t_ground, t_hit)
    rgb = np.where(hit[..., None], ground, rgb)
    for center, yaw, ext, obj_id, color in boxes:
        rot = yaw_matrix(yaw).T
        o = rot @ (origin - center)
        d = dirs @ rot.T
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t_lo, t_hi = (-ext - o) * inv, (ext - o) * inv
        t_near = np.nanmin(np.stack([t_lo, t_hi]), axis=0).max(-1)
        t_far = np.nanmax(np.stack([t_lo, t_hi]), axis=0).min(-1)
        hit_box = (t_far > np.maximum(t_near, 1e-6)) & (t_near < t_hit)
        p = o[None, None] + t_near[..., None] * d
        shade = 0.6 + 0.4 * np.clip(p[..., 1] / max(ext[1], 1e-6), -1, 1)
        cell = max(ext.min() / 2.0, 1e-6)
        with np.errstate(invalid="ignore"):
            tex = np.nan_to_num((np.floor(p[..., 0] / cell) + np.floor(p[..., 1] / cell)
                                 + np.floor(p[..., 2] / cell)) % 2).astype(np.float32)
        shade = shade * (0.55 + 0.45 * tex)
        t_hit = np.where(hit_box, t_near, t_hit)
        rgb = np.where(hit_box[..., None], color * shade[..., None], rgb)
        inst = np.where(hit_box, obj_id, inst)
    sky = ~np.isfinite(t_hit)
    up = np.clip(dirs[..., 1] / np.linalg.norm(dirs, axis=-1), 0, 1)
    sky_rgb = np.stack([0.55 - 0.25 * up, 0.65 - 0.15 * up, 0.9 + 0.1 * up], -1)
    rgb = np.where(sky[..., None], sky_rgb, rgb)
    depth = np.where(sky, 0.0, t_hit).astype(np.float32)
    return np.clip(rgb, 0, 1), depth, sky.astype(np.float32), inst


def generate(t: dict) -> dict:
    """The raw scene of traffic parameters `t` (timesteps, width, height,
    focal at factor 1, factor; optionally `box_scale`, the objects' size
    against two cars): images as uint8 [N, h, w, 3] (as stored), depth /
    sky / inst [N, h, w], poses_hwf [N, 3, 5] (factor-1 hwf), bounds [N, 2],
    the box dict {'{ts}_{obj}_center': 4x4, '_ext': full extents}, keys in
    the order written, and the counts `timesteps` and `n_obj`."""
    timesteps, factor = t["timesteps"], t["factor"]
    extents = BOX_EXTENTS * t.get("box_scale", 1.0)
    w_f, h_f = int(t["width"] / factor), int(t["height"] / factor)
    images, depth, sky, inst, poses, bounds, boxes_3d = [], [], [], [], [], [], {}
    for ts in range(timesteps):
        boxes = []
        for obj in range(len(BOX_EXTENTS)):
            center, yaw = box_trajectory(obj, ts, timesteps, float(extents[obj][1]))
            boxes.append((center, yaw, extents[obj], obj + 1, BOX_COLORS[obj]))
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = yaw_matrix(yaw)
            pose[:3, 3] = center
            boxes_3d[f"{ts + 1}_{obj + 1}_center"] = pose
            boxes_3d[f"{ts + 1}_{obj + 1}_ext"] = (2.0 * extents[obj]).astype(np.float32)
        for cam in range(N_CAMS):
            c2w = camera_pose(cam, ts)
            poses.append(np.concatenate(
                [c2w, np.array([[t["height"]], [t["width"]], [t["focal"]]], np.float32)], axis=1))
            bounds.append([0.5, 120.0])
            img, d, s, m = render(c2w, w_f, h_f, t["focal"] / factor, boxes)
            images.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
            depth.append(d)
            sky.append(s)
            inst.append(m)
    return {"images": np.stack(images), "depth": np.stack(depth), "sky": np.stack(sky),
            "inst": np.stack(inst), "poses_hwf": np.stack(poses), "bounds": np.asarray(bounds, np.float32),
            "boxes": boxes_3d, "factor": factor, "timesteps": timesteps, "n_obj": len(BOX_EXTENTS)}


def _png(image: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, every row unfiltered."""
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write(raw: dict, out_dir: str) -> None:
    """Write the raw scene as a scene directory at its factor."""
    f = raw["factor"]
    os.makedirs(os.path.join(out_dir, f"images_{f}"), exist_ok=True)
    for i, img in enumerate(raw["images"]):
        with open(os.path.join(out_dir, f"images_{f}", f"img_{i:04d}.png"), "wb") as fh:
            fh.write(_png(img))
    n = len(raw["images"])
    np.save(os.path.join(out_dir, "poses_bounds.npy"),
            np.concatenate([raw["poses_hwf"].reshape(n, 15), raw["bounds"]], axis=-1))
    np.save(os.path.join(out_dir, "3D_boxes.npy"), raw["boxes"], allow_pickle=True)
    np.savez(os.path.join(out_dir, "depth_images.npz"), raw["depth"])
    np.savez(os.path.join(out_dir, "sky_masks.npz"), raw["sky"])
    np.savez(os.path.join(out_dir, "2D_boxes.npz"), raw["inst"])


def reference_split(raw: dict, c: dict, split: str) -> dict:
    """The reference's reading of one split (portbench.reference.scene)."""
    return ref_scene.load(raw, c, split)
