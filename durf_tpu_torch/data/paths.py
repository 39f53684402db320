"""Novel camera trajectories for free rendering (the port's copy of the JAX
package's `data/paths.py`, numpy only).

Spiral and spherical orbit paths matching reference
obbpose_dataset.py:744-830, plus interpolated paths between existing camera
poses (the notebook workflow of durf_render_traj.ipynb as a library fn).
"""

from __future__ import annotations

import numpy as np


def _normalize(x):
    return x / np.linalg.norm(x)


def view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Look-at camera-to-world [3, 4] (reference obbpose_dataset.py:731-738)."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return view_matrix(vec2, up, center)


def spiral_path(
    poses: np.ndarray,
    bounds: np.ndarray,
    n_views: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
) -> np.ndarray:
    """Spiral render path around the average camera (reference
    obbpose_dataset.py:744-770).

    Args:
      poses: [N, 3, 4] camera-to-worlds; bounds: [N, 2] near/far.

    Returns: [n_views, 3, 4].
    """
    c2w = average_pose(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
    rads = np.concatenate([rads, [1.0]])
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(view_matrix(z, up, c))
    return np.stack(render_poses).astype(np.float32)


def spherical_path(poses: np.ndarray, n_views: int = 120) -> np.ndarray:
    """360-degree orbit at the cameras' mean radius/height (reference
    obbpose_dataset.py:772-830, simplified to the pose-generation core)."""
    rad = np.sqrt(np.mean(np.sum(poses[:, :3, 3] ** 2, -1)))
    centroid = np.mean(poses[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(max(rad**2 - zh**2, 1e-6))
    out = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_views):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        out.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    return np.stack(out).astype(np.float32)


def interpolate_poses(keyframes: np.ndarray, n_views: int = 60) -> np.ndarray:
    """Smooth path through [K, 3, 4] keyframe poses (slerp on rotations via
    quaternions, linear on positions)."""
    from scipy.spatial.transform import Rotation, Slerp

    k = len(keyframes)
    times = np.linspace(0, k - 1, n_views)
    rots = Rotation.from_matrix(keyframes[:, :3, :3])
    slerp = Slerp(np.arange(k), rots)
    r_interp = slerp(times).as_matrix()
    pos = np.stack(
        [np.interp(times, np.arange(k), keyframes[:, i, 3]) for i in range(3)], axis=-1
    )
    return np.concatenate([r_interp, pos[..., None]], axis=-1).astype(np.float32)
