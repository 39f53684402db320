"""Conical-frustum / cylinder Gaussians and ray casting, coordinate-major.

Counterpart of the JAX package's `ops/frustum.py` for the diagonal-
covariance pipeline: samples travel as [3, B, S] planes. The "stable"
frustum moments algebra is kept: the naive closed form cancels
catastrophically in fp32 (reference mip.py:99-130; mip-NeRF eq. 7).
"""

from __future__ import annotations

import torch


def lift_gaussian_cm(d: torch.Tensor, t_mean: torch.Tensor, t_var: torch.Tensor, r_var: torch.Tensor):
    """Lift 1-D Gaussians along ray directions `d` [B, 3] into 3-D:
    ([3, B, S] mean, [3, B, S] covariance diagonal). Reference mip.py:76-96."""
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1), min=1e-10)  # [B]
    means, covs = [], []
    for k in range(d.shape[-1]):
        dk = d[..., k][..., None]  # [B, 1]
        d_outer_diag = dk**2
        null_outer_diag = 1 - d_outer_diag / d_mag_sq[..., None]
        means.append(dk * t_mean)
        covs.append(t_var * d_outer_diag + r_var * null_outer_diag)
    return torch.stack(means), torch.stack(covs)


def conical_frustum_to_gaussian(t0: torch.Tensor, t1: torch.Tensor, base_radius: torch.Tensor):
    """(t_mean, t_var, r_var) of conical frustums between t0 and t1 with
    cone radius `base_radius` at distance 1, by the stable algebra
    (reference mip.py:99-130)."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    denom = 3 * mu**2 + hw**2
    t_mean = mu + (2 * mu * hw**2) / denom
    t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / denom**2)
    r_var = base_radius**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - (4 / 15) * (hw**4) / denom)
    return t_mean, t_var, r_var


def cast_rays_cm(
    t_vals: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    radii: torch.Tensor,
    ray_shape: str = "cone",
):
    """Slice rays at fenceposts t_vals [B, S+1] into per-interval Gaussians:
    ([3, B, S] means, [3, B, S] covariance diagonals). Reference
    mip.py:155-179."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        t_mean, t_var, r_var = conical_frustum_to_gaussian(t0, t1, radii)
    elif ray_shape == "cylinder":
        t_mean = (t0 + t1) / 2
        r_var = radii**2 / 4
        t_var = (t1 - t0) ** 2 / 12
    else:
        raise ValueError(f"unknown ray_shape {ray_shape!r}")
    means, covs = lift_gaussian_cm(directions, t_mean, t_var, r_var)
    return means + origins.T[..., None], covs
