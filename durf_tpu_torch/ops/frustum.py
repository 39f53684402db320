"""Conical-frustum / cylinder Gaussians and ray casting.

Counterpart of the JAX package's `ops/frustum.py`: the row-major functions
(samples [..., S, 3], covariance [..., S, 3] diagonal or [..., S, 3, 3]
full) and the coordinate-major diagonal ones (samples as [3, B, S] planes).
The "stable" frustum moments algebra is the default: the naive closed form
cancels catastrophically in fp32 (reference mip.py:99-130; mip-NeRF eq. 7).
"""

from __future__ import annotations

import torch


def lift_gaussian(d: torch.Tensor, t_mean: torch.Tensor, t_var: torch.Tensor, r_var: torch.Tensor,
                  diag: bool):
    """Lift 1-D Gaussians along ray directions `d` [..., 3] into 3-D:
    (mean [..., S, 3], covariance [..., S, 3] diagonal or [..., S, 3, 3]).
    t_mean / t_var / r_var are [..., S]. Reference mip.py:76-96."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
    if diag:
        d_outer_diag = d**2
        null_outer_diag = 1 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def _frustum_moments(t0: torch.Tensor, t1: torch.Tensor, base_radius: torch.Tensor):
    """(t_mean, t_var, r_var) of conical frustums between t0 and t1 with
    cone radius `base_radius` at distance 1, by the stable algebra."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    denom = 3 * mu**2 + hw**2
    t_mean = mu + (2 * mu * hw**2) / denom
    t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / denom**2)
    r_var = base_radius**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - (4 / 15) * (hw**4) / denom)
    return t_mean, t_var, r_var


def _cylinder_moments(t0: torch.Tensor, t1: torch.Tensor, radius: torch.Tensor):
    return (t0 + t1) / 2, (t1 - t0) ** 2 / 12, radius**2 / 4


def conical_frustum_to_gaussian(d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                                base_radius: torch.Tensor, diag: bool, stable: bool = True):
    """Gaussians of conical frustums along `d` between t0 and t1 (cone
    radius `base_radius` at distance 1), lifted by lift_gaussian.
    stable=False takes the exact closed form, which cancels in fp32.
    Reference mip.py:99-130."""
    if stable:
        t_mean, t_var, r_var = _frustum_moments(t0, t1, base_radius)
    else:
        t_mean = (3 * (t1**4 - t0**4)) / (4 * (t1**3 - t0**3))
        r_var = base_radius**2 * (3 / 20 * (t1**5 - t0**5) / (t1**3 - t0**3))
        t_mosq = 3 / 5 * (t1**5 - t0**5) / (t1**3 - t0**3)
        t_var = t_mosq - t_mean**2
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                         radius: torch.Tensor, diag: bool):
    """Gaussians of cylinders along `d` (reference mip.py:133-152)."""
    return lift_gaussian(d, *_cylinder_moments(t0, t1, radius), diag)


def cast_rays(t_vals: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor,
              radii: torch.Tensor, ray_shape: str = "cone", diag: bool = False):
    """Slice rays at fenceposts t_vals [..., S+1] into per-interval
    Gaussians: (means [..., S, 3], covs [..., S, 3, 3] or, with diag,
    [..., S, 3]). origins / directions [..., 3], radii [..., 1]. Reference
    mip.py:155-179."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError(f"unknown ray_shape {ray_shape!r}")
    means, covs = gaussian_fn(directions, t0, t1, radii, diag)
    return means + origins[..., None, :], covs


def lift_gaussian_cm(d: torch.Tensor, t_mean: torch.Tensor, t_var: torch.Tensor, r_var: torch.Tensor):
    """Coordinate-major diagonal lift: ([3, B, S] mean, [3, B, S] covariance
    diagonal), the same per-element arithmetic as lift_gaussian(diag=True)
    with the coordinate axis leading."""
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1), min=1e-10)  # [B]
    means, covs = [], []
    for k in range(d.shape[-1]):
        dk = d[..., k][..., None]  # [B, 1]
        d_outer_diag = dk**2
        null_outer_diag = 1 - d_outer_diag / d_mag_sq[..., None]
        means.append(dk * t_mean)
        covs.append(t_var * d_outer_diag + r_var * null_outer_diag)
    return torch.stack(means), torch.stack(covs)


def cast_rays_cm(
    t_vals: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    radii: torch.Tensor,
    ray_shape: str = "cone",
):
    """Coordinate-major cast_rays (diagonal covariance only): fenceposts
    t_vals [B, S+1] -> ([3, B, S] means, [3, B, S] covariance diagonals)."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        t_mean, t_var, r_var = _frustum_moments(t0, t1, radii)
    elif ray_shape == "cylinder":
        t_mean, t_var, r_var = _cylinder_moments(t0, t1, radii)
    else:
        raise ValueError(f"unknown ray_shape {ray_shape!r}")
    means, covs = lift_gaussian_cm(directions, t_mean, t_var, r_var)
    return means + origins.T[..., None], covs
