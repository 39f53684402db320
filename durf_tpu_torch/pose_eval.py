"""Box-pose recovery evaluation: optimized pose table vs ground truth (the
port's counterpart of the JAX package's `pose_eval.py`).

Loads the checkpointed `box_centers` table and compares it with the scene's
ground-truth box centers (and the noised initialization) per axis in meters
and rotation in degrees. Host-only numpy: nothing here runs on a device.

Usage:
  python -m durf_tpu_torch.pose_eval --data_dir=... --train_dir=... --gin_file=...
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from durf_tpu_torch.checkpoints import CheckpointManager
from durf_tpu_torch.configs import load_config
from durf_tpu_torch.data.scene import WORLD_SCALE, load_scene


def pose_errors(optimized: np.ndarray, reference: np.ndarray) -> dict:
    """Per-axis MSE (in meters, un-doing the 1/WORLD_SCALE) + angle degrees.

    optimized/reference: [T, N_obj, 6] pose tables ([x, y, z, rotvec]).
    """
    d = (optimized[..., :3] - reference[..., :3]) * WORLD_SCALE
    ang = np.linalg.norm(optimized[..., 3:] - reference[..., 3:], axis=-1) * 180.0 / np.pi
    return {
        "mse_x": float((d[..., 0] ** 2).mean()),
        "mse_y": float((d[..., 1] ** 2).mean()),
        "mse_z": float((d[..., 2] ** 2).mean()),
        "mse_total": float((d**2).sum(-1).mean()),
        "angle_deg_mean": float(ang.mean()),
        "angle_deg_max": float(ang.max()),
        # Pose entries are per-timestep parameters: a timestep whose object
        # is occluded (no LIDAR returns on it) has no box-surface anchor of
        # its own, so recovery can differ per frame.
        "per_timestep_mse": [float(v) for v in (d**2).sum(-1).mean(-1)],
    }


def evaluate_poses(config, data_dir: str, train_dir: str, log_fn=print) -> dict:
    scene = load_scene(data_dir, config, "train")
    gt = scene.init_table(use_off=False)  # [T, N_obj, 6] ground truth
    init = scene.init_table(use_off=config.random_box)  # the (noised) init

    ckpt = CheckpointManager(train_dir)
    if ckpt.latest_step is None:
        raise FileNotFoundError(f"no checkpoint in {train_dir}")
    optimized = ckpt.restore_raw()["model"]["box_centers"].numpy()

    out = {
        "step": int(ckpt.latest_step),
        "optimized_vs_gt": pose_errors(optimized, gt),
        "init_vs_gt": pose_errors(init, gt),
    }
    log_fn(json.dumps(out, indent=2))
    return out


def main(argv=None, log_fn=print) -> dict:
    """The pose-eval CLI (see the module docstring); returns the report."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--gin_file", action="append", default=[])
    p.add_argument("--gin_param", action="append", default=[])
    args = p.parse_args(argv)
    config = load_config(args.gin_file, args.gin_param)
    return evaluate_poses(config, args.data_dir, args.train_dir, log_fn=log_fn)


if __name__ == "__main__":
    main()
