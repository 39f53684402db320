"""Numerics: precision-safe primitives and inverse-CDF sampling.

Counterparts of the JAX package's `mathx` (reference internal/math.py).
"""

from __future__ import annotations

import math

import torch

_TRIG_PERIOD = 100.0 * math.pi
_F32_EPS = float(torch.finfo(torch.float32).eps)


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True) -> torch.Tensor:
    """L2 norm with the squared norm clamped at 1e-12 (reference
    math.py:27-32)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=1e-12))


def _safe_trig(x: torch.Tensor, fn) -> torch.Tensor:
    # Range-reduce very large arguments mod 100*pi (reference math.py:35-46).
    return fn(torch.where(torch.abs(x) < _TRIG_PERIOD, x, torch.remainder(x, _TRIG_PERIOD)))


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    """sin() with range reduction of large arguments."""
    return _safe_trig(x, torch.sin)


def safe_cos(x: torch.Tensor) -> torch.Tensor:
    """cos() with range reduction of large arguments."""
    return _safe_trig(x, torch.cos)


def sorted_piecewise_constant_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
) -> torch.Tensor:
    """Inverse-CDF sampling from a piecewise-constant PDF over sorted bins.

    Args:
      bins: [..., num_bins + 1] sorted fenceposts.
      weights: [..., num_bins] non-negative histogram weights.
      num_samples: samples drawn per batch element, at the deterministic
        u = linspace(0, 1 - eps) of an eval render (the stratified draw is a
        training option, not ported yet).

    Returns:
      [..., num_samples] sorted sample positions.

    Same contract as the JAX package's version (reference math.py:222-284):
    eps-padding makes all-zero weights valid, the CDF is pinned to exactly
    0 and 1 at the ends, and each u takes the LAST fencepost with cdf <= u as
    its left bracket, also where zero-weight bins duplicate CDF values. The
    JAX package finds that bracket with a one-hot matmul (a TPU gather
    workaround); here it is `torch.searchsorted(..., right=True) - 1`.
    """
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1)
    cdf = torch.cat(
        [torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1
    )

    u = torch.linspace(0.0, 1.0 - _F32_EPS, num_samples, dtype=cdf.dtype, device=cdf.device)
    u = u.expand(cdf.shape[:-1] + (num_samples,)).contiguous()

    # cdf[0] = 0 <= u < 1 = cdf[-1], so the bracket lies strictly inside.
    idx = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    idx = torch.clamp(idx, 0, cdf.shape[-1] - 2)
    bins_g0 = torch.gather(bins, -1, idx)
    bins_g1 = torch.gather(bins, -1, idx + 1)
    cdf_g0 = torch.gather(cdf, -1, idx)
    cdf_g1 = torch.gather(cdf, -1, idx + 1)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)
