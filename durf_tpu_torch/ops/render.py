"""Alpha compositing along rays (reference mip.py:285-327).

Counterpart of the JAX package's `ops/render.py`: white, gray, black or
random backgrounds; the random one (a training option) composites one
uniform color per batch, drawn from a `torch.Generator` or handed in.
"""

from __future__ import annotations

import torch


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


def volumetric_rendering_cm(
    rgb_cm: torch.Tensor,
    density: torch.Tensor,
    t_vals: torch.Tensor,
    dirs: torch.Tensor,
    background: str = "gray",
    generator: torch.Generator | None = None,
    bg_color: torch.Tensor | None = None,
):
    """Composite rgb planes [3, B, S] and a density plane [B, S].

    background: 'white' | 'gray' | 'black' | 'random'; 'random' adds
    bg_color [1, 3] (drawn uniform from `generator` when None) behind the
    residual transmittance (durf_tpu/ops/render.py:80-83).

    Returns (comp_rgb [B, 3], depth [B], acc [B], weights [B, S], t_vals,
    t_mids, t_dists); depth is the unclipped Σ w·t_mid.
    """
    weights, t_mids, t_dists = compute_weights(density[..., None], t_vals, dirs)

    comp_rgb = (weights[None] * rgb_cm).sum(dim=-1).T  # [B, 3]
    acc = weights.sum(dim=-1)
    depth = (weights * t_mids).sum(dim=-1)

    residual = 1.0 - acc[..., None]
    if background == "white":
        comp_rgb = comp_rgb + residual
    elif background == "gray":
        comp_rgb = comp_rgb + 0.5 * residual
    elif background == "random":
        if bg_color is None:
            bg_color = torch.rand(
                (1, 3), generator=generator, dtype=comp_rgb.dtype, device=comp_rgb.device
            )
        comp_rgb = comp_rgb + bg_color * residual
    elif background != "black":
        raise ValueError(f"unknown background {background!r}")
    return comp_rgb, depth, acc, weights, t_vals, t_mids, t_dists
