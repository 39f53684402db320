"""Numerics: precision-safe primitives, schedules and inverse-CDF sampling.

Counterparts of the JAX package's `mathx` (reference internal/math.py). The
schedules run on the host (python floats): the port's train step is eager,
so a step's learning rate is known before its update is launched.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

_TRIG_PERIOD = 100.0 * math.pi
_F32_EPS = float(torch.finfo(torch.float32).eps)


@dataclass(frozen=True)
class RowShard:
    """A step's random stream on data-parallel rank `rank` of `size`
    (parallel/): `draw` draws each
    tensor with a ray axis over the global batch and keeps this rank's
    rows, so the ranks draw together exactly what one process draws, and no
    two ranks share a ray's jitter. Every rank's generator advances alike."""

    generator: torch.Generator
    rank: int
    size: int


def draw(fn: Callable, shape, generator, dim: Optional[int] = 0, **kwargs) -> torch.Tensor:
    """fn(shape, generator=generator, **kwargs) for torch.rand or
    torch.randn. With a RowShard, axis `dim` of `shape` holds this rank's
    rays: the global tensor is drawn and the rank's rows kept; `dim=None`
    marks a draw without a ray axis, drawn whole."""
    if not isinstance(generator, RowShard):
        return fn(shape, generator=generator, **kwargs)
    if dim is None:
        return fn(shape, generator=generator.generator, **kwargs)
    shape = list(shape)
    n = shape[dim]
    shape[dim] = n * generator.size
    return fn(shape, generator=generator.generator, **kwargs).narrow(dim, generator.rank * n, n)


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


def psnr_to_mse(psnr: torch.Tensor) -> torch.Tensor:
    """Inverse of mse_to_psnr (reference math.py:54-56)."""
    return torch.exp(-0.1 * math.log(10.0) * psnr)


def compute_avg_error(psnr: torch.Tensor, ssim: torch.Tensor, lpips: torch.Tensor) -> torch.Tensor:
    """Geometric mean of MSE, sqrt(1-SSIM) and LPIPS (reference math.py:59-63)."""
    mse = psnr_to_mse(psnr)
    dssim = torch.sqrt(1 - ssim)
    return torch.exp(torch.mean(torch.log(torch.stack([mse, dssim, lpips]))))


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB for inputs in [0, 1] (reference math.py:140-145)."""
    eps = torch.finfo(torch.float32).eps
    lo = 323 / 25 * linear
    hi = (211 * torch.clamp(linear, min=eps) ** (5 / 12) - 11) / 200
    return torch.where(linear <= 0.0031308, lo, hi)


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear for inputs in [0, 1] (reference math.py:148-153)."""
    eps = torch.finfo(torch.float32).eps
    lo = 25 / 323 * srgb
    hi = torch.clamp((200 * srgb + 11) / 211, min=eps) ** (12 / 5)
    return torch.where(srgb <= 0.04045, lo, hi)


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
            jitter = draw(
                torch.rand, shape, generator, dtype=cdf.dtype, device=cdf.device
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


def compute_ssim(
    img0: torch.Tensor,
    img1: torch.Tensor,
    max_val: float,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
) -> torch.Tensor:
    """SSIM between two [..., H, W, C] float32 images, as tf.image.ssim and
    the JAX package's `mathx.compute_ssim` compute it (reference
    math.py:66-137, from Google's Apache-2.0 mip-NeRF): Gaussian-windowed
    means, variances and covariance, the window applied as two 1-D "valid"
    blurs (along W, then H) with conv2d; the mean SSIM over (H, W, C), or
    the map with `return_map`."""
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    t = ((torch.arange(filter_size, dtype=torch.float32) - hw + shift) / filter_sigma) ** 2
    filt = torch.exp(-0.5 * t)
    filt = (filt / filt.sum()).to(img0.device)
    lead = img0.shape[:-3]
    height, width, channels = img0.shape[-3:]

    def blur(z):
        # [..., H, W, C] -> [N * C, 1, H, W] planes, blurred, and back.
        planes = z.reshape((-1, height, width, channels)).permute(0, 3, 1, 2)
        planes = planes.reshape(-1, 1, height, width)
        planes = torch.nn.functional.conv2d(planes, filt.view(1, 1, 1, -1))
        planes = torch.nn.functional.conv2d(planes, filt.view(1, 1, -1, 1))
        h, w = planes.shape[-2:]
        planes = planes.reshape(-1, channels, h, w).permute(0, 2, 3, 1)
        return planes.reshape(lead + (h, w, channels))

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = blur(img0**2) - mu00
    sigma11 = blur(img1**2) - mu11
    sigma01 = blur(img0 * img1) - mu01

    # Clamp (co)variances to physically valid values.
    sigma00 = torch.clamp(sigma00, min=0.0)
    sigma11 = torch.clamp(sigma11, min=0.0)
    sigma01 = torch.sign(sigma01) * torch.minimum(torch.sqrt(sigma00 * sigma11), sigma01.abs())

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    if return_map:
        return ssim_map
    return ssim_map.mean(dim=(-3, -2, -1))
