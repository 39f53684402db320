"""Occupancy grid over the contracted domain, for level-0 sampling
(counterpart of the JAX package's `ops/grid.py`; a VaxNeRF / Instant-NGP
style acceleration the reference does not have).

The grid covers [-2, 2]^3, the contraction's codomain, so it spans the
unbounded scene. Training updates it after each step by a decayed
scatter-max of the rendering weights at the sample positions; level 0
queries it at the nearest voxel along each ray to build a sampling PDF.
The grid is a plain [R, R, R] float32 tensor on the training device.
"""

from __future__ import annotations

import torch

GRID_EXTENT = 2.0  # contracted space is a radius-2 ball


def make_grid(resolution: int = 96, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """A fresh all-ones grid (optimistic: everything occupied until seen)."""
    return torch.ones((resolution, resolution, resolution), dtype=dtype, device=device)


def _voxel_indices(positions: torch.Tensor, resolution: int) -> torch.Tensor:
    """Contracted [-2, 2]^3 positions [..., 3] -> int64 voxel indices
    [..., 3], clipped to the grid."""
    u = (positions + GRID_EXTENT) / (2 * GRID_EXTENT)  # [0, 1]
    idx = torch.floor(u * resolution).to(torch.int64)
    return torch.clamp(idx, 0, resolution - 1)


def _flat_index(idx: torch.Tensor, resolution: int) -> torch.Tensor:
    return (idx[..., 0] * resolution + idx[..., 1]) * resolution + idx[..., 2]


def query(grid: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel occupancy of [..., 3] contracted positions -> [...]."""
    idx = _voxel_indices(positions, grid.shape[0])
    return grid.reshape(-1)[_flat_index(idx, grid.shape[0])]


def update(
    grid: torch.Tensor,
    positions: torch.Tensor,
    weights: torch.Tensor,
    decay: float = 0.99,
) -> torch.Tensor:
    """grid <- max(grid * decay, the weights scatter-maxed into their
    voxels), as a new tensor; no gradient flows through it.

    Args:
      positions: [..., 3] contracted sample positions.
      weights: [...] non-negative occupancy evidence (rendering weights:
        w = alpha * transmittance says "this cell mattered").

    One scatter_reduce_ on the flattened voxel index, with the decayed grid
    as its starting value; max is exact and order-free, so the result does
    not depend on how the device orders the scatter.
    """
    res = grid.shape[0]
    with torch.no_grad():
        idx = _flat_index(_voxel_indices(positions.detach().reshape(-1, 3), res), res)
        w = weights.detach().reshape(-1).to(grid.dtype)
        out = (grid * decay).reshape(-1)
        out.scatter_reduce_(0, idx, w, reduce="amax", include_self=True)
    return out.reshape(grid.shape)


def ray_pdf(
    grid: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    num_probes: int,
    contract_fn,
    floor: float = 1e-2,
):
    """Per-ray sampling histogram from the occupancy along each ray.

    Probes the midpoints of `num_probes` uniform intervals of [near, far]
    (near, far [B, 1]), contracts them with `contract_fn`, looks up their
    voxels and returns (bins [B, P+1], weights [B, P]) for
    mathx.sorted_piecewise_constant_pdf; `floor` keeps a minimum density
    everywhere, so unexplored space still gets samples.
    """
    t = torch.linspace(0.0, 1.0, num_probes + 1, dtype=origins.dtype, device=origins.device)
    bins = near * (1.0 - t) + far * t  # [B, P+1]
    t_mids = 0.5 * (bins[..., :-1] + bins[..., 1:])
    pts = origins[..., None, :] + t_mids[..., None] * directions[..., None, :]
    occ = query(grid, contract_fn(pts))  # [B, P]
    return bins, occ + floor
