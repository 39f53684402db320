"""Alpha compositing along rays (reference mip.py:285-327).

Counterpart of the JAX package's `ops/render.py`: white, gray, black or
random backgrounds; the random one (a training option) composites one
uniform color per batch, drawn from a `torch.Generator` or handed in.
"""

from __future__ import annotations

import torch

from durf_tpu_torch.mathx import draw


def compute_weights(density: torch.Tensor, t_vals: torch.Tensor, dirs: torch.Tensor):
    """Compositing weights w_i = alpha_i * T_i.

    Args:
      density: [B, S, 1] non-negative densities.
      t_vals: [B, S+1] fenceposts.
      dirs: [B, 3] ray directions; interval lengths scale by ||dirs||.

    Returns weights [B, S], t_mids [B, S], t_dists [B, S].
    """
    eps = 1e-8
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.vector_norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(
        -torch.cat(
            [
                torch.zeros_like(density_delta[..., :1]),
                torch.cumsum(density_delta[..., :-1], dim=-1),
            ],
            dim=-1,
        )
    )
    weights = torch.nan_to_num(alpha * trans, nan=eps)
    return weights, t_mids, t_dists


def _background(comp_rgb, acc, background, generator, bg_color):
    """comp_rgb with the background composited behind the residual
    transmittance 1 - acc (reference mip.py:321-326)."""
    residual = 1.0 - acc[..., None]
    if background == "white":
        return comp_rgb + residual
    if background == "gray":
        return comp_rgb + 0.5 * residual
    if background == "random":
        if bg_color is None:
            bg_color = draw(
                torch.rand, (1, 3), generator, dim=None, dtype=comp_rgb.dtype,
                device=comp_rgb.device,
            )
        return comp_rgb + bg_color * residual
    if background != "black":
        raise ValueError(f"unknown background {background!r}")
    return comp_rgb


def volumetric_rendering(
    rgb: torch.Tensor,
    density: torch.Tensor,
    t_vals: torch.Tensor,
    dirs: torch.Tensor,
    background: str = "gray",
    generator: torch.Generator | None = None,
    bg_color: torch.Tensor | None = None,
):
    """Composite rgb [B, S, 3] and density [B, S, 1] along rays with
    fenceposts t_vals [B, S+1] and directions dirs [B, 3].

    background: 'white' | 'gray' | 'black' | 'random'; 'random' adds
    bg_color [1, 3] (drawn uniform from `generator` when None, where the
    JAX package draws from its key) behind the residual transmittance.

    Returns (comp_rgb [B, 3], depth [B], acc [B], weights [B, S], t_vals,
    t_mids, t_dists); depth is the unclipped sum of w * t_mid.
    Reference mip.py:285-327.
    """
    weights, t_mids, t_dists = compute_weights(density, t_vals, dirs)
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2)
    acc = weights.sum(dim=-1)
    depth = (weights * t_mids).sum(dim=-1)
    comp_rgb = _background(comp_rgb, acc, background, generator, bg_color)
    return comp_rgb, depth, acc, weights, t_vals, t_mids, t_dists


def volumetric_density(density: torch.Tensor, t_vals: torch.Tensor, dirs: torch.Tensor):
    """Weights and depth only, for density supervision: (weights [B, S],
    depth [B], t_vals [B, S+1], t_mids [B, S+1] padded with the last
    fencepost, t_dists [B, S]). Reference mip360.py:126-157."""
    weights, t_mids, t_dists = compute_weights(density, t_vals, dirs)
    depth = (weights * t_mids).sum(dim=-1)
    t_mids = torch.cat([t_mids, t_vals[:, -1:]], dim=-1)
    return weights, depth, t_vals, t_mids, t_dists


def distance_from_depth(depth: torch.Tensor, acc: torch.Tensor, t_vals: torch.Tensor) -> torch.Tensor:
    """depth / acc, NaN taken as +inf and clipped to each ray's sampled
    range, for visualisation (reference mip.py:318-320)."""
    distance = torch.nan_to_num(depth / acc, nan=float("inf"))
    return torch.minimum(torch.maximum(distance, t_vals[:, 0]), t_vals[:, -1])


def volumetric_rendering_cm(
    rgb_cm: torch.Tensor,
    density: torch.Tensor,
    t_vals: torch.Tensor,
    dirs: torch.Tensor,
    background: str = "gray",
    generator: torch.Generator | None = None,
    bg_color: torch.Tensor | None = None,
):
    """volumetric_rendering on coordinate-major rgb planes [3, B, S] and a
    density plane [B, S]: the same returns and per-element arithmetic."""
    weights, t_mids, t_dists = compute_weights(density[..., None], t_vals, dirs)
    comp_rgb = (weights[None] * rgb_cm).sum(dim=-1).T  # [B, 3]
    acc = weights.sum(dim=-1)
    depth = (weights * t_mids).sum(dim=-1)
    comp_rgb = _background(comp_rgb, acc, background, generator, bg_color)
    return comp_rgb, depth, acc, weights, t_vals, t_mids, t_dists
