"""Synthetic dynamic scenes (numpy): a generator writing the on-disk scene
format, and in-memory ray batches.

An analytic urban-ish world (checkerboard ground plane, gradient sky,
moving colored boxes) rendered with exact ray casting, written as a scene
directory with exact depth, sky masks, instance masks and box poses: the
same files, bit for bit, as the JAX package's generator writes.

Usage:
  python -m durf_tpu_torch.data.synthetic --out DIR [--timesteps 3]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from durf_tpu_torch.data import format as diskfmt
from durf_tpu_torch.rays import Rays

# Half extents (meters) and colors of the two moving objects.
_BOX_EXTENTS = np.array([[1.0, 0.8, 2.0], [0.8, 0.7, 1.6]], np.float32)
_BOX_COLORS = np.array([[0.9, 0.15, 0.1], [0.1, 0.2, 0.9]], np.float32)


def _yaw_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def box_spec(obj: int) -> tuple[np.ndarray, np.ndarray]:
    """(half-extents [3], base color [3]) of object `obj`. Objects 0/1 are
    hand-picked car-ish shapes; higher ids get deterministic procedural
    variation (scenes with N_obj >= 8)."""
    if obj < 2:
        return _BOX_EXTENTS[obj], _BOX_COLORS[obj]
    rng = np.random.default_rng(100 + obj)
    ext = np.array(
        [0.7 + 0.5 * rng.uniform(), 0.6 + 0.3 * rng.uniform(), 1.4 + 0.8 * rng.uniform()],
        np.float32,
    )
    color = rng.uniform(0.15, 0.9, 3).astype(np.float32)
    return ext, color


def box_trajectory(obj: int, t: int, timesteps: int) -> tuple[np.ndarray, float]:
    """World center + yaw of object `obj` at timestep `t` (0-based)."""
    u = t / max(timesteps - 1, 1)
    ext_y = float(box_spec(obj)[0][1])
    if obj == 0:
        center = np.array([-6.0 + 12.0 * u, ext_y, -14.0], np.float32)
        yaw = 0.15 * u
    elif obj == 1:
        center = np.array([5.0 - 8.0 * u, ext_y, -9.0 - 3.0 * u], np.float32)
        yaw = -0.4 + 0.3 * u
    else:
        # Extra traffic lanes: staggered x start, alternating direction,
        # receding depth — all in front of the camera rig.
        lane = obj - 2
        sign = 1.0 if lane % 2 == 0 else -1.0
        x0 = -7.0 + 3.5 * (lane % 5)
        center = np.array(
            [x0 + sign * 6.0 * u, ext_y, -8.0 - 2.0 * lane], np.float32
        )
        yaw = 0.25 * sign * u
    return center, yaw


def camera_pose(cam: int, t: int) -> np.ndarray:
    """[3, 4] camera-to-world (OpenGL: x right, y up, looking down -z).

    A 5-camera rig (FRONT, FRONT_LEFT, SIDE_LEFT, FRONT_RIGHT, SIDE_RIGHT —
    the Waymo layout, SURVEY.md §1) advancing +0.6 m in -z per timestep.
    """
    offsets = [0.0, -0.8, -1.4, 0.8, 1.4]
    yaws = [0.0, 0.35, 0.9, -0.35, -0.9]
    rot = _yaw_matrix(yaws[cam % 5])
    pos = np.array([offsets[cam % 5], 1.6, 2.0 - 0.6 * t], np.float32)
    return np.concatenate([rot, pos[:, None]], axis=1)


def _render(
    c2w: np.ndarray,
    width: int,
    height: int,
    focal: float,
    boxes: list,
):
    """Exact ray-cast render. Returns (rgb, depth, sky_mask, instance_mask).

    boxes: list of (center [3], yaw, half_extent [3], obj_id, color [3]).
    Depth is the metric distance along the (unnormalized pinhole) ray — the
    same convention the model's expected-depth losses use. Sky has depth 0
    (LIDAR no-return).
    """
    x, y = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32), indexing="xy"
    )
    cam_dirs = np.stack(
        [(x - width / 2) / focal, -(y - height / 2) / focal, -np.ones_like(x)], -1
    )
    dirs = (cam_dirs[..., None, :] * c2w[:3, :3]).sum(-1)  # [H, W, 3]
    origin = c2w[:3, 3]

    t_hit = np.full((height, width), np.inf, np.float32)
    rgb = np.zeros((height, width, 3), np.float32)
    inst = np.zeros((height, width), np.int32)

    # Ground plane y=0, checkerboard.
    dy = dirs[..., 1]
    t_ground = np.where(dy < -1e-6, -origin[1] / np.minimum(dy, -1e-6), np.inf)
    with np.errstate(invalid="ignore"):  # inf*0 on sky rays; masked out below
        gx = origin[0] + t_ground * dirs[..., 0]
        gz = origin[2] + t_ground * dirs[..., 2]
        checker = np.nan_to_num((np.floor(gx / 2.0) + np.floor(gz / 2.0)) % 2).astype(np.float32)
    ground_rgb = (0.25 + 0.35 * checker)[..., None] * np.array([1.0, 0.95, 0.85], np.float32)
    hit = t_ground < t_hit
    t_hit = np.where(hit, t_ground, t_hit)
    rgb = np.where(hit[..., None], ground_rgb, rgb)

    # Boxes (slab test in each box frame).
    for center, yaw, ext, obj_id, color in boxes:
        rot_w2o = _yaw_matrix(yaw).T
        o = rot_w2o @ (origin - center)
        d = dirs @ rot_w2o.T
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t_lo = (-ext - o) * inv
            t_hi = (ext - o) * inv
        t0 = np.nanmin(np.stack([t_lo, t_hi]), axis=0)
        t1 = np.nanmax(np.stack([t_lo, t_hi]), axis=0)
        t_near = t0.max(-1)
        t_far = t1.min(-1)
        hit_box = (t_far > np.maximum(t_near, 1e-6)) & (t_near < t_hit)
        # Lambertian-ish shading by entry face height, plus a box-frame
        # checker texture: without it the faces are uniform and translating
        # the box parallel to a face leaves the image (hence the pose
        # gradient) almost unchanged — pose-recovery studies need dense
        # photometric signal, not just silhouette edges.
        p = o[None, None] + t_near[..., None] * d
        shade = 0.6 + 0.4 * np.clip(p[..., 1] / max(ext[1], 1e-6), -1, 1)
        cell = max(ext.min() / 2.0, 1e-6)
        with np.errstate(invalid="ignore"):
            checker_box = np.nan_to_num(
                (
                    np.floor(p[..., 0] / cell)
                    + np.floor(p[..., 1] / cell)
                    + np.floor(p[..., 2] / cell)
                )
                % 2
            ).astype(np.float32)
        shade = shade * (0.55 + 0.45 * checker_box)
        t_hit = np.where(hit_box, t_near, t_hit)
        rgb = np.where(hit_box[..., None], color * shade[..., None], rgb)
        inst = np.where(hit_box, obj_id, inst)

    sky = ~np.isfinite(t_hit)
    up = np.clip(dirs[..., 1] / np.linalg.norm(dirs, axis=-1), 0, 1)
    sky_rgb = np.stack([0.55 - 0.25 * up, 0.65 - 0.15 * up, 0.9 + 0.1 * up], -1)
    rgb = np.where(sky[..., None], sky_rgb, rgb)
    depth = np.where(sky, 0.0, t_hit).astype(np.float32)
    return np.clip(rgb, 0, 1), depth, sky.astype(np.float32), inst


def generate_scene(
    out_dir: str,
    timesteps: int = 3,
    width: int = 40,
    height: int = 32,
    focal: float = 35.0,
    factors=(4,),
    num_objects: int = 2,
) -> None:
    """Write a complete synthetic scene directory.

    `width`/`height`/`focal` are the FACTOR-1 (full-res) intrinsics recorded
    in poses_bounds.npy; images are written at each downsample factor exactly
    as the loader expects (floor(h/f), floor(w/f), focal/f).
    """
    os.makedirs(out_dir, exist_ok=True)
    n_cams = 5
    poses_hwf = []
    bounds = []
    boxes_3d: dict = {}  # stays empty for num_objects=0 (static scene)
    per_factor: dict = {f: dict(images=[], depth=[], sky=[], inst=[]) for f in factors}

    for t in range(timesteps):
        boxes = []
        for obj in range(num_objects):
            center, yaw = box_trajectory(obj, t, timesteps)
            ext, color = box_spec(obj)
            boxes.append((center, yaw, ext, obj + 1, color))
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = _yaw_matrix(yaw)
            pose[:3, 3] = center
            boxes_3d[f"{t + 1}_{obj + 1}_center"] = pose
            boxes_3d[f"{t + 1}_{obj + 1}_ext"] = ext.copy()
        for cam in range(n_cams):
            c2w = camera_pose(cam, t)
            hwf = np.concatenate(
                [c2w, np.array([[height], [width], [focal]], np.float32)], axis=1
            )
            poses_hwf.append(hwf)
            bounds.append([0.5, 120.0])
            for f in factors:
                w_f, h_f = int(width / f), int(height / f)
                img, depth, sky, inst = _render(c2w, w_f, h_f, focal / f, boxes)
                per_factor[f]["images"].append(img)
                per_factor[f]["depth"].append(depth)
                per_factor[f]["sky"].append(sky)
                per_factor[f]["inst"].append(inst)

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


def example_ray_batch(
    batch_size: int = 512,
    n_obj: int = 2,
    timesteps: int = 5,
    near: float = 0.0,
    far: float = 40.0,
    seed: int = 0,
):
    """A batch of random rays plus plausible boxes, drawn from `seed` with
    numpy: the same values as the JAX package's `example_ray_batch`.

    Returns a dict of numpy arrays: rays (Rays), pixels, depth, sky, init
    [T, N_obj, 6] box poses, target/box/can, ext [N_obj, 3], ts (int32).
    """
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(batch_size, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.3
    ones = np.ones((batch_size, 1), np.float32)
    rays = Rays(
        origins=(rng.normal(size=(batch_size, 3)) * 0.1).astype(np.float32),
        directions=dirs,
        viewdirs=(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32),
        radii=ones * 0.01,
        lossmult=ones,
        near=ones * near,
        far=ones * far,
    )
    init = rng.normal(size=(timesteps, n_obj, 6)).astype(np.float32)
    init[..., :3] = init[..., :3] * 1.5 + np.array([0, 0, -4], np.float32)
    return {
        "rays": rays,
        "pixels": rng.uniform(size=(batch_size, 3)).astype(np.float32),
        "depth": (
            rng.uniform(0, 8, size=(batch_size, 1))
            * (rng.uniform(size=(batch_size, 1)) > 0.5)
        ).astype(np.float32),
        "sky": (0.975 * (rng.uniform(size=(batch_size, 1)) > 0.7)).astype(np.float32),
        "init": init,
        "target": init[1],
        "box": init[1],
        "can": init[0],
        "ext": (np.abs(rng.normal(size=(n_obj, 3))) * 0.3 + 0.3).astype(np.float32),
        "ts": np.int32(1),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--timesteps", type=int, default=3)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--focal", type=float, default=140.0)
    p.add_argument("--factors", type=int, nargs="+", default=[4])
    p.add_argument("--num_objects", type=int, default=2, help="0 = static scene")
    args = p.parse_args(argv)
    generate_scene(
        args.out,
        timesteps=args.timesteps,
        width=args.width,
        height=args.height,
        focal=args.focal,
        factors=tuple(args.factors),
        num_objects=args.num_objects,
    )
    print(f"wrote synthetic scene to {args.out}")


if __name__ == "__main__":
    main()
