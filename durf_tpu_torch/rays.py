"""The Rays tuple and host-side ray generation (pinhole + NDC).

Ray generation runs on the host in numpy (once per camera); `Rays.to`
moves a batch onto a device as float32 tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class Rays(NamedTuple):
    """A batch of rays; every field has leading batch dims and a trailing
    channel dim. Fields are numpy arrays on the host or tensors."""

    origins: Any  # [..., 3]
    directions: Any  # [..., 3] (not unit-norm; NDC-space when applicable)
    viewdirs: Any  # [..., 3] world-space unit(ish) view directions
    radii: Any  # [..., 1] base radii of the cone footprint
    lossmult: Any  # [..., 1] per-ray loss multiplier
    near: Any  # [..., 1]
    far: Any  # [..., 1]

    def map(self, fn) -> "Rays":
        """Apply `fn` to every field."""
        return Rays(*(fn(f) for f in self))

    def to(self, device) -> "Rays":
        """float32 tensors on `device` (numpy fields are copied)."""
        return self.map(
            lambda f: torch.as_tensor(np.asarray(f) if not torch.is_tensor(f) else f)
            .to(device=device, dtype=torch.float32)
        )


def pinhole_rays(
    camtoworld: np.ndarray,
    width: int,
    height: int,
    focal: float,
    principal_point: Optional[np.ndarray] = None,
    half_pixel_offset: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pixel world-space rays for one pinhole camera.

    Args:
      camtoworld: [3, 4] camera-to-world matrix (OpenGL convention: camera
        looks down -z, y up).
      width/height/focal: intrinsics.
      principal_point: [2] (cx, cy); defaults to the image center.
      half_pixel_offset: sample pixel centers.

    Returns:
      (origins [H, W, 3], directions [H, W, 3], viewdirs [H, W, 3]).
    """
    if principal_point is None:
        principal_point = np.array([width * 0.5, height * 0.5], np.float32)
    off = 0.5 if half_pixel_offset else 0.0
    x, y = np.meshgrid(
        np.arange(width, dtype=np.float32),
        np.arange(height, dtype=np.float32),
        indexing="xy",
    )
    camera_dirs = np.stack(
        [
            (x - principal_point[0] + off) / focal,
            -(y - principal_point[1] + off) / focal,
            -np.ones_like(x),
        ],
        axis=-1,
    )
    directions = (camera_dirs[..., None, :] * camtoworld[:3, :3]).sum(axis=-1)
    origins = np.broadcast_to(camtoworld[:3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    return np.ascontiguousarray(origins), directions, viewdirs


def pixel_radii(directions: np.ndarray) -> np.ndarray:
    """Cone base radii from x-neighbor direction distance (reference
    obbpose_dataset.py:639-646): half the pixel pitch, scaled 2/sqrt(12)."""
    dx = np.sqrt(np.sum((directions[:-1, :, :] - directions[1:, :, :]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1, :]], 0)
    return (dx * 2 / np.sqrt(12))[..., None]


def ndc_rays(
    origins: np.ndarray,
    directions: np.ndarray,
    focal: float,
    width: float,
    height: float,
    near: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Shift rays to the near plane and project to NDC (the standard LLFF
    construction, reference obbpose_dataset.py:21-41)."""
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    dx, dy, dz = np.moveaxis(directions, -1, 0)
    ox, oy, oz = np.moveaxis(origins, -1, 0)

    o0 = -((2 * focal) / width) * (ox / oz)
    o1 = -((2 * focal) / height) * (oy / oz)
    o2 = 1 + 2 * near / oz

    d0 = -((2 * focal) / width) * (dx / dz - ox / oz)
    d1 = -((2 * focal) / height) * (dy / dz - oy / oz)
    d2 = -2 * near / oz

    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def ndc_radii(ndc_origins: np.ndarray) -> np.ndarray:
    """Radii in NDC space from both x- and y-neighbor origin distances
    (reference obbpose_dataset.py:684-695)."""
    mat = ndc_origins[None]
    dx = np.sqrt(np.sum((mat[:, :-1, :, :] - mat[:, 1:, :, :]) ** 2, -1))
    dx = np.concatenate([dx, dx[:, -2:-1, :]], 1)
    dy = np.sqrt(np.sum((mat[:, :, :-1, :] - mat[:, :, 1:, :]) ** 2, -1))
    dy = np.concatenate([dy, dy[:, :, -2:-1]], 2)
    return ((0.5 * (dx + dy))[..., None] * 2 / np.sqrt(12))[0]


def camera_rays(
    camtoworld: np.ndarray,
    width: int,
    height: int,
    focal: float,
    near: float,
    far: float,
    principal_point: Optional[np.ndarray] = None,
    use_ndc: bool = False,
) -> Rays:
    """Full Rays (numpy) for one camera: pinhole cast, optional NDC.

    viewdirs are the world directions pre-NDC; radii come from the NDC
    origins when NDC is on (reference obbpose_dataset.py:613-707).
    """
    origins, directions, viewdirs = pinhole_rays(
        camtoworld, width, height, focal, principal_point
    )
    if use_ndc:
        ndc_o, ndc_d = ndc_rays(origins, directions, focal, width, height)
        radii = ndc_radii(ndc_o)
        origins, viewdirs, directions = ndc_o, directions, ndc_d
    else:
        radii = pixel_radii(directions)
    ones = np.ones_like(origins[..., :1])
    return Rays(
        origins=origins.astype(np.float32),
        directions=directions.astype(np.float32),
        viewdirs=viewdirs.astype(np.float32),
        radii=radii.astype(np.float32),
        lossmult=ones,
        near=(ones * near).astype(np.float32),
        far=(ones * far).astype(np.float32),
    )
