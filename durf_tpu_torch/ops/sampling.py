"""Stratified and hierarchical (inverse-CDF) sampling along rays.

Counterpart of the JAX package's `ops/sampling.py` (reference
mip.py:330-416) for the coordinate-major diagonal pipeline, deterministic
(the eval render draws no randomness; the stratified jitter is a training
option, not ported yet).
"""

from __future__ import annotations

import torch

from durf_tpu_torch import mathx
from durf_tpu_torch.ops.frustum import cast_rays_cm


def sample_along_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    radii: torch.Tensor,
    num_samples: int,
    near: torch.Tensor,
    far: torch.Tensor,
    lindisp: bool,
    ray_shape: str,
):
    """num_samples+1 evenly spaced fenceposts in [near, far] and their
    Gaussians.

    Returns (t_vals [B, S+1], ([3, B, S] means, [3, B, S] covs)).
    Reference mip.py:330-370 (lindisp at 354-358).
    """
    batch_size = origins.shape[0]
    t_vals = torch.linspace(
        0.0, 1.0, num_samples + 1, dtype=origins.dtype, device=origins.device
    )
    if lindisp:
        t_vals = 1.0 / (near * (1.0 - t_vals) + far * t_vals)
    else:
        t_vals = near * (1.0 - t_vals) + far * t_vals
    t_vals = t_vals.expand(batch_size, num_samples + 1)
    return t_vals, cast_rays_cm(t_vals, origins, directions, radii, ray_shape)


def resample_along_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    radii: torch.Tensor,
    t_vals: torch.Tensor,
    weights: torch.Tensor,
    ray_shape: str,
    resample_padding: float,
    num_samples: int | None = None,
):
    """Blurpool the previous level's weights, then inverse-CDF sample.

    Args:
      t_vals: [B, S+1] previous fenceposts (the CDF bins).
      weights: [B, S] rendering weights from the previous level.
      num_samples: fenceposts drawn = num_samples + 1 (default: keep S).

    Reference mip.py:373-416 (blurpool at 394-401, padding at 404).
    """
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights = weights_blur + resample_padding

    n_out = t_vals.shape[-1] if num_samples is None else num_samples + 1
    new_t_vals = mathx.sorted_piecewise_constant_pdf(t_vals, weights, n_out).detach()
    return new_t_vals, cast_rays_cm(new_t_vals, origins, directions, radii, ray_shape)
