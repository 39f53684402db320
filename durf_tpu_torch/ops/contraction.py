"""Mip-NeRF 360 scene contraction (reference mip360.py:47-79).

contract(x) = (2 - 1/||x||) * x/||x|| beyond a norm threshold (0.1 in the
reference; the paper uses 1.0). The covariance is pushed through the
diagonal-Jacobian approximation D = diag(J @ 1): D cov D^T for a full
covariance, its diagonal d^2 * cov for a diagonal one. J @ 1 is written out
as the closed-form directional derivative instead of forward-mode autodiff.
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


def _contract_with_row_sums(mean: torch.Tensor, threshold: float, dim: int):
    """(contract(mean), d) with d = J(mean) @ 1, the Jacobian's row sums
    (the JAX package takes them from one jax.jvp with an all-ones tangent,
    durf_tpu/ops/contraction.py:55; reference mip360.py:63-79).

    Outside the threshold f(x) = 2 x/n - x/n^2 with n = ||x||, so for the
    tangent v = 1 and s = dn = sum(x)/n:
        d_i = 2/n - 1/n^2 - 2 x_i s / n^2 + 2 x_i s / n^3.
    Inside, f is the identity and d = 1. Where ||x||^2 < 1e-12 the norm is
    clamped and dn = 0.
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
    return mean_c, inside + (1.0 - inside) * d_out


def contract_gaussian(mean: torch.Tensor, cov: torch.Tensor, threshold: float = 0.1):
    """Push a Gaussian (mean [..., 3], full covariance [..., 3, 3]) through
    the contraction: (contract(mean), D cov D^T) with D = diag(d), d the
    Jacobian's row sums, so (D cov D^T)_ij = d_i d_j cov_ij."""
    mean_c, d = _contract_with_row_sums(mean, threshold, -1)
    return mean_c, d[..., :, None] * cov * d[..., None, :]


def contract_gaussian_diag(mean: torch.Tensor, cov_diag: torch.Tensor, threshold: float = 0.1, dim: int = -1):
    """(contract(mean), d^2 * cov_diag): the diagonal of contract_gaussian's
    covariance. With dim=0 both may be coordinate-major [3, ...]."""
    mean_c, d = _contract_with_row_sums(mean, threshold, dim)
    return mean_c, d * d * cov_diag
