"""Scene-graph box ops: object frames and ray/box intersection.

Counterpart of the JAX package's `ops/boxes.py` (reference
box_helpers.py:59-106 slab test, 148-167 Rodrigues, 286-341 world->object),
batched over a leading ray axis and an object axis.
"""

from __future__ import annotations

import torch

from durf_tpu_torch import mathx


def axis_angle_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] rotation vectors -> [..., 3, 3] matrices."""
    x, y, z = rotvec[..., 0], rotvec[..., 1], rotvec[..., 2]
    zero = torch.zeros_like(x)
    skew = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    angle = mathx.safe_norm(rotvec)[..., None] + 1e-12  # [..., 1, 1]
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(skew.shape)
    skew_sq = torch.matmul(skew, skew)
    return eye + (torch.sin(angle) / angle) * skew + ((1 - torch.cos(angle)) / angle**2) * skew_sq


def rotate_vec(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply [..., 3, 3] rotations to [..., 3] vectors as explicit fp32
    multiply-adds."""
    return torch.stack(
        [
            rot[..., i, 0] * v[..., 0] + rot[..., i, 1] * v[..., 1] + rot[..., i, 2] * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def rotate_yaw(p: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Rotate [..., 3] points by yaw about the +y (down-pointing) axis: the
    NSG yaw-only object-frame convention (reference box_helpers.py:109-128),
    which the full-SE(3) path supersedes for the model."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    px = c * p[..., 0] + s * p[..., 2]
    pz = -s * p[..., 0] + c * p[..., 2]
    return torch.stack([px, p[..., 1], pz], dim=-1)


def box_to_world_frames(points: torch.Tensor, box_pos: torch.Tensor,
                        box_rot: torch.Tensor) -> torch.Tensor:
    """Inverse of world_to_box_frames for points: x_w = R^T x_obj + p
    (box_rot is world->object)."""
    return rotate_vec(box_rot.transpose(-1, -2), points) + box_pos


def scale_to_unit_box(p: torch.Tensor, extent: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Scale box-frame points so the box spans [-1, 1]^3 (or back): p [..., 3],
    extent [..., 3] full box dimensions (reference box_helpers.py:184-205,
    scale factor 1 / (dim + 1e-9))."""
    scale = 1.0 / (extent + 1e-9)
    return p / scale if inverse else p * scale


def world_to_box_frames(origins, dirs, box_pos, box_rot):
    """World rays into each object's box frame, x_obj = R @ (x_world - p).

    Args:
      origins / dirs: [B, 3] world rays (dirs need not be unit).
      box_pos: [B, N_obj, 3] box centers; box_rot: [B, N_obj, 3, 3]
        world->object rotations.

    Returns (origins_o, dirs_o) [B, N_obj, 3], dirs_o unit-norm.
    """
    o = rotate_vec(box_rot, origins[:, None, :] - box_pos)
    d = rotate_vec(box_rot, dirs[:, None, :].expand(box_pos.shape))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return o, d


def ray_box_intersection(ray_o, ray_d, aabb_min, aabb_max):
    """Slab-method ray/AABB intersection over arbitrary leading dims.

    Returns (z_in, z_out, hit): entry/exit distances (zero for misses) and a
    float {0,1} mask. A hit needs z_out > z_in and z_out > 0. Misses are
    selected, not multiplied, so axis-parallel rays (±inf slab distances)
    stay finite.
    """
    inv_d = torch.reciprocal(ray_d)
    t_lo = (aabb_min - ray_o) * inv_d
    t_hi = (aabb_max - ray_o) * inv_d
    t0 = torch.minimum(t_lo, t_hi)
    t1 = torch.maximum(t_lo, t_hi)
    t_near = torch.amax(t0, dim=-1)
    t_far = torch.amin(t1, dim=-1)

    hit = torch.logical_and(t_far > t_near, t_far > 0).to(ray_o.dtype)
    zero = torch.zeros_like(t_near)
    z_in = torch.where(hit > 0, t_near, zero)
    z_out = torch.where(hit > 0, t_far, zero)
    return z_in, z_out, hit
