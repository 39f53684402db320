"""Alpha compositing along rays (reference mip.py:285-327).

Counterpart of the JAX package's `ops/render.py` for the eval render: the
backgrounds are white, gray or black (the random background is a training
option and is not ported yet).
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
):
    """Composite rgb planes [3, B, S] and a density plane [B, S].

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
        raise NotImplementedError("the random background is a training option, not ported yet")
    elif background != "black":
        raise ValueError(f"unknown background {background!r}")
    return comp_rgb, depth, acc, weights, t_vals, t_mids, t_dists
