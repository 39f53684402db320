"""Numerics: precision-safe primitives, schedules and inverse-CDF sampling.

Counterparts of the JAX package's `mathx` (reference internal/math.py). The
schedules run on the host (python floats): the port's train step is eager,
so a step's learning rate is known before its update is launched.
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


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR assuming max pixel value 1 (reference math.py:49-51)."""
    return -10.0 / math.log(10.0) * torch.log(mse)


def log_lerp_decay(
    step,
    v_init: float,
    v_final: float,
    max_steps: int,
    delay_steps: int = 0,
    delay_mult: float = 1.0,
) -> float:
    """Log-linearly interpolated decay with an optional sine-eased warmup:
    v_init at step 0, v_final at max_steps; with delay_steps > 0 the value
    is scaled by a reverse-cosine ramp starting at delay_mult (reference
    math.py:156-190)."""
    step = float(step)
    if delay_steps > 0:
        ramp = min(max(step / delay_steps, 0.0), 1.0)
        delay_rate = delay_mult + (1 - delay_mult) * math.sin(0.5 * math.pi * ramp)
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay_rate * math.exp(math.log(v_init) * (1 - t) + math.log(v_final) * t)


def freq_alpha_schedule(
    step, alpha_init: float, alpha_final: float, delay_steps: int, max_steps: int
) -> float:
    """BARF coarse-to-fine frequency window: alpha_init until delay_steps,
    then a linear ramp from 0 reaching alpha_final at max_steps (reference
    math.py:193-219)."""
    step = float(step)
    if step < delay_steps:
        return float(alpha_init)
    if step < max_steps:
        return (step - delay_steps) / (max_steps - delay_steps) * alpha_final
    return float(alpha_final)


def sorted_piecewise_constant_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    randomized: bool = False,
    generator: torch.Generator | None = None,
    jitter: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse-CDF sampling from a piecewise-constant PDF over sorted bins.

    Args:
      bins: [..., num_bins + 1] sorted fenceposts.
      weights: [..., num_bins] non-negative histogram weights.
      num_samples: samples drawn per batch element.
      randomized: stratified u = i / num_samples + jitter, capped at
        1 - eps (reference math.py:257-265); else the deterministic
        u = linspace(0, 1 - eps) of an eval render.
      generator: draws the jitter when randomized and `jitter` is None.
      jitter: [..., num_samples] draws in [0, 1 / num_samples - eps), the
        JAX package's `jax.random.uniform(key, ..., maxval=s - eps)`; lets a
        caller hand in its own random numbers.

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

    shape = cdf.shape[:-1] + (num_samples,)
    if randomized:
        s = 1.0 / num_samples
        if jitter is None:
            jitter = torch.rand(
                shape, generator=generator, dtype=cdf.dtype, device=cdf.device
            ) * (s - _F32_EPS)
        u = torch.arange(num_samples, dtype=cdf.dtype, device=cdf.device) * s + jitter
        u = torch.clamp(u, max=1.0 - _F32_EPS).contiguous()  # u in [0, 1)
    else:
        u = torch.linspace(0.0, 1.0 - _F32_EPS, num_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(shape).contiguous()

    # cdf[0] = 0 <= u < 1 = cdf[-1], so the bracket lies strictly inside.
    idx = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    idx = torch.clamp(idx, 0, cdf.shape[-1] - 2)
    bins_g0 = torch.gather(bins, -1, idx)
    bins_g1 = torch.gather(bins, -1, idx + 1)
    cdf_g0 = torch.gather(cdf, -1, idx)
    cdf_g1 = torch.gather(cdf, -1, idx + 1)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)
