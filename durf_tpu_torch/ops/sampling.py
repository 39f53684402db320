"""Stratified and hierarchical (inverse-CDF) sampling along rays.

Counterpart of the JAX package's `ops/sampling.py` (reference
mip.py:330-416) for the coordinate-major diagonal pipeline. Training draws
its jitter from a `torch.Generator`; a caller may hand the draws in instead
(`t_rand`, `jitter`), which is how the tests feed both packages the same
random numbers.
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
    randomized: bool = False,
    generator: torch.Generator | None = None,
    t_rand: torch.Tensor | None = None,
):
    """num_samples+1 stratified fenceposts in [near, far] and their
    Gaussians: evenly spaced, or with randomized each jittered uniformly
    inside its stratum (reference mip.py:361-367).

    Args:
      generator: draws t_rand when randomized and `t_rand` is None.
      t_rand: [B, S+1] uniform [0, 1) draws (JAX's `jax.random.uniform(key,
        [B, S+1])`).

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
    if randomized:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
        lower = torch.cat([t_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(
                (batch_size, num_samples + 1), generator=generator,
                dtype=origins.dtype, device=origins.device,
            )
        t_vals = lower + (upper - lower) * t_rand
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
    randomized: bool = False,
    stop_grad: bool = True,
    generator: torch.Generator | None = None,
    jitter: torch.Tensor | None = None,
):
    """Blurpool the previous level's weights, then inverse-CDF sample.

    Args:
      t_vals: [B, S+1] previous fenceposts (the CDF bins).
      weights: [B, S] rendering weights from the previous level.
      num_samples: fenceposts drawn = num_samples + 1 (default: keep S).
      randomized, generator, jitter: the stratified draw of
        mathx.sorted_piecewise_constant_pdf.
      stop_grad: block gradients into the previous level through the new
        fenceposts (ModelConfig.stop_level_grad).

    Reference mip.py:373-416 (blurpool at 394-401, padding at 404).
    """
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights = weights_blur + resample_padding

    n_out = t_vals.shape[-1] if num_samples is None else num_samples + 1
    new_t_vals = mathx.sorted_piecewise_constant_pdf(
        t_vals, weights, n_out, randomized, generator, jitter
    )
    if stop_grad:
        new_t_vals = new_t_vals.detach()
    return new_t_vals, cast_rays_cm(new_t_vals, origins, directions, radii, ray_shape)
