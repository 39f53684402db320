"""Mip-NeRF 360 scene contraction (reference mip360.py:47-79).

contract(x) = (2 - 1/||x||) * x/||x|| beyond a norm threshold (0.1 in the
reference; the paper uses 1.0). The covariance diagonal is pushed through
the diagonal-Jacobian approximation diag(J @ 1)^2 * cov, written out here as
the closed-form directional derivative instead of forward-mode autodiff.
"""

from __future__ import annotations

import torch

from durf_tpu_torch import mathx


def contract(x: torch.Tensor, threshold: float = 0.1, dim: int = -1) -> torch.Tensor:
    """Contract unbounded points into a ball of radius 2: identity for
    ||x|| <= threshold, (2 - 1/||x||) * x/||x|| beyond it."""
    x_norm = mathx.safe_norm(x, dim=dim)
    inside = (x_norm <= threshold).to(x.dtype)
    contracted = (2.0 - torch.nan_to_num(1.0 / x_norm)) * torch.nan_to_num(x / x_norm)
    return inside * x + (1.0 - inside) * contracted


def contract_gaussian_diag(mean: torch.Tensor, cov_diag: torch.Tensor, threshold: float = 0.1, dim: int = -1):
    """(contract(mean), d^2 * cov_diag) with d = J(mean) @ 1, the Jacobian's
    row sums (reference mip360.py:63-79: jax.linearize with an all-ones
    tangent).

    Outside the threshold f(x) = 2 x/n - x/n^2 with n = ||x||, so for the
    tangent v = 1 and s = dn = sum(x)/n:
        d_i = 2/n - 1/n^2 - 2 x_i s / n^2 + 2 x_i s / n^3.
    Inside, d = 1. Where ||x||^2 < 1e-12 the norm is clamped and dn = 0.
    """
    sq = torch.sum(mean * mean, dim=dim, keepdim=True)
    n = torch.sqrt(torch.clamp(sq, min=1e-12))
    inside = (n <= threshold).to(mean.dtype)
    inv_n = torch.nan_to_num(1.0 / n)
    unit = torch.nan_to_num(mean / n)
    mean_c = inside * mean + (1.0 - inside) * (2.0 - inv_n) * unit
    s = torch.where(sq > 1e-12, torch.sum(mean, dim=dim, keepdim=True) / n, torch.zeros_like(n))
    inv_n2 = inv_n * inv_n
    d_out = 2.0 * inv_n - inv_n2 - 2.0 * mean * s * inv_n2 + 2.0 * mean * s * inv_n2 * inv_n
    d = inside + (1.0 - inside) * d_out
    return mean_c, d * d * cov_diag
