"""Trajectory rendering CLI: novel camera paths (and movable boxes) from a
checkpoint (the port's counterpart of the JAX package's `render.py`).

Paths:
  --path spiral | spherical | interp (through the split's camera poses)
  --trajectory file.npz with 'poses' [K, 3, 4] (and optional 'box_poses'
    [K, N_obj, 6] to move objects independently of the camera: frame k
    renders with box_poses[min(k, K - 1)] in row --timestep of the pose
    table).

Writes frame_%04d.png, depth_%04d.png and trajectory.gif.

Usage:
  python -m durf_tpu_torch.render --data_dir=... --train_dir=... \
      --gin_file=configs/waymo_fast.gin --out_dir=frames/ --path spiral \
      --n_views 60 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from durf_tpu_torch import vis
from durf_tpu_torch.configs import load_config
from durf_tpu_torch.data.format import to_uint8, write_gif, write_png
from durf_tpu_torch.data.paths import interpolate_poses, spherical_path, spiral_path
from durf_tpu_torch.devices import resolve_device
from durf_tpu_torch.eval import restore_for_eval
from durf_tpu_torch.models.mipnerf import render_image
from durf_tpu_torch.rays import camera_rays
from durf_tpu_torch.train import make_alpha_schedule


def render_trajectory(
    config,
    data_dir: str,
    train_dir: str,
    out_dir: str,
    path: str = "spiral",
    n_views: int = 60,
    trajectory: str | None = None,
    timestep: int = 0,
    save_gif: bool = True,
    log_fn=print,
    device="cuda",
):
    """Render a camera path from the latest checkpoint on the card (unless
    the caller asks for the CPU); returns the frames, [H, W, 3] in [0, 1].

    With a trajectory's `box_poses`, each frame's boxes are written into row
    `timestep` of the model's pose table, and the checkpoint's table is put
    back when the call ends, also when a frame raises. (The JAX app passes
    them as `init_boxes`, which a restored model ignores, durf_tpu/render.py:
    83-86 against durf_tpu/models/mipnerf.py:130.)"""
    device = resolve_device(device)
    dataset, model, step, render_chunk = restore_for_eval(
        config, data_dir, train_dir, split="render", device=device
    )
    scene = dataset.scene
    alpha = float(make_alpha_schedule(config)(step))

    box_poses = None
    if trajectory is not None:
        data = np.load(trajectory)
        poses = data["poses"]
        box_poses = data.get("box_poses")
    elif path == "spiral":
        bounds = np.asarray([[scene.near + 0.5, scene.far]] * len(scene.camtoworlds))
        poses = spiral_path(scene.camtoworlds, bounds, n_views=n_views)
    elif path == "spherical":
        poses = spherical_path(scene.camtoworlds, n_views=n_views)
    elif path == "interp":
        poses = interpolate_poses(scene.camtoworlds, n_views=n_views)
    else:
        raise ValueError(f"unknown path {path!r}")

    width = int(scene.width[0])
    height = int(scene.height[0])
    focal = float(scene.focal[0])
    ext = next(dataset).get("ext")  # box extents, static over the path
    table = model.box_centers if model.dynamic and box_poses is not None else None
    saved = None if table is None else table.detach().clone()

    os.makedirs(out_dir, exist_ok=True)
    frames = []
    t0 = time.perf_counter()
    try:
        for k, c2w in enumerate(poses):
            rays = camera_rays(
                c2w, width, height, focal, scene.near, scene.far, use_ndc=not config.spherify
            )
            if table is not None:
                with torch.no_grad():
                    table[timestep] = torch.as_tensor(
                        np.asarray(box_poses[min(k, len(box_poses) - 1)], np.float32),
                        device=table.device)
            out = render_image(
                lambda r: render_chunk(r, ext, timestep, alpha), rays, chunk=config.chunk
            )
            frame = np.clip(out["rgb"], 0, 1)
            frames.append(frame)
            write_png(os.path.join(out_dir, f"frame_{k:04d}.png"), to_uint8(frame))
            write_png(os.path.join(out_dir, f"depth_{k:04d}.png"),
                      to_uint8(vis.visualize_depth(out["depth"], out["acc"])))
            log_fn(f"frame {k + 1}/{len(poses)}")
    finally:
        if table is not None:
            with torch.no_grad():
                table.copy_(saved)
    dt = time.perf_counter() - t0
    log_fn(f"rendered {len(frames)} frames of {width}x{height} in {dt:.3f} s: "
           f"{len(frames) / dt:.3f} frames/s, {len(frames) * width * height / dt:.1f} rays/s "
           f"(PNG writes included)")

    if save_gif and frames:
        t0 = time.perf_counter()
        write_gif(os.path.join(out_dir, "trajectory.gif"), [to_uint8(f) for f in frames],
                  duration_ms=80, loop=0)
        log_fn(f"trajectory.gif written in {time.perf_counter() - t0:.3f} s")
    return frames


def main(argv=None, log_fn=print):
    """The render CLI (see the module docstring); returns the frames."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--gin_file", action="append", default=[])
    p.add_argument("--gin_param", action="append", default=[])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--path", default="spiral", choices=["spiral", "spherical", "interp"])
    p.add_argument("--trajectory", default=None,
                   help="npz with poses [K,3,4] (and optional box_poses [K,N_obj,6])")
    p.add_argument("--n_views", type=int, default=60)
    p.add_argument("--timestep", type=int, default=0)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    config = load_config(args.gin_file, args.gin_param)
    if args.chunk is not None:
        config.chunk = args.chunk
    return render_trajectory(
        config,
        args.data_dir,
        args.train_dir,
        args.out_dir,
        path=args.path,
        n_views=args.n_views,
        trajectory=args.trajectory,
        timestep=args.timestep,
        log_fn=log_fn,
        device=args.device,
    )


if __name__ == "__main__":
    main()
