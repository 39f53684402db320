"""Positional encodings: NeRF PE and coordinate-major integrated PE (IPE).

Counterpart of the JAX package's `ops/encoding.py` (reference
mip.py:36-73, 182-282) for the coordinate-major diagonal pipeline, including
the per-frequency BARF window and the recurrent IPE.
"""

from __future__ import annotations

import math

import torch

from durf_tpu_torch import mathx

# The recurrent IPE restarts from fresh transcendentals every _RESTART
# degrees, so the squaring / double-angle chains never amplify a seed's
# rounding by more than 4^4.
_RESTART = 5


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int, append_identity: bool = True) -> torch.Tensor:
    """NeRF positional encoding: sin/cos of x * 2^[min_deg, max_deg).

    Layout [x, sin(deg0 dims.., deg1 dims.., ...), cos(...)], cos realized as
    sin(x + pi/2) (reference mip.py:36-45).
    """
    scales = torch.tensor(
        [2.0**i for i in range(min_deg, max_deg)], dtype=x.dtype, device=x.device
    )
    xb = torch.reshape(x[..., None, :] * scales[:, None], x.shape[:-1] + (-1,))
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat


def _ipe_pieces_cm(x, x_var, min_deg: int, max_deg: int, safe: bool, recurrent: bool):
    """x, x_var [3, ...] -> (sin, cos) lists of [...] feature planes, ordered
    (degree, dim) like the row-major layout [sin(deg, dim)..., cos(...)].

    recurrent: degree k+1 from degree k by e <- e^4 (attenuation
    exp(-4^k v / 2)) and the double-angle formulas, restarting every
    _RESTART degrees; it calls raw sin/cos, so it assumes contracted
    (bounded) inputs.
    """
    x_var = torch.clamp(x_var, min=0.0)
    sin_p, cos_p = [], []
    if recurrent:
        e = s = c = None
        for i, deg in enumerate(range(min_deg, max_deg)):
            if i % _RESTART == 0:
                scale = 2.0**deg
                e = torch.exp((-0.5 * scale * scale) * x_var)
                s = torch.sin(scale * x)
                c = torch.cos(scale * x)
            es, ec = e * s, e * c
            sin_p.extend(es.unbind(0))
            cos_p.extend(ec.unbind(0))
            e2 = e * e
            e = e2 * e2
            s, c = 2.0 * s * c, c * c - s * s
        return sin_p, cos_p
    sinf = mathx.safe_sin if safe else torch.sin
    for deg in range(min_deg, max_deg):
        scale = 2.0**deg
        y = scale * x
        att = torch.exp(-0.5 * (scale * scale) * x_var)
        fs, fc = att * sinf(y), att * sinf(y + 0.5 * math.pi)
        sin_p.extend(fs.unbind(0))
        cos_p.extend(fc.unbind(0))
    return sin_p, cos_p


def integrated_pos_enc_cm(
    x, x_var, min_deg: int, max_deg: int, safe: bool = True, recurrent: bool = False
) -> torch.Tensor:
    """Coordinate-major IPE: ([3, ...] mean, [3, ...] var diag) -> [F, ...]
    feature planes, F = 2 * 3 * (max_deg - min_deg)."""
    sin_p, cos_p = _ipe_pieces_cm(x, x_var, min_deg, max_deg, safe, recurrent)
    return torch.stack(sin_p + cos_p, dim=0)


def barf_window(alpha, min_deg: int, max_deg: int, dtype, device) -> torch.Tensor:
    """Per-degree BARF easing w_k = (1 - cos(pi * clip(alpha - k, 0, 1))) / 2
    (reference mip.py:55-58), one entry per degree."""
    alpha = torch.as_tensor(alpha, dtype=dtype, device=device)
    k = torch.arange(min_deg, max_deg, dtype=dtype, device=device)
    return (1 - torch.cos(torch.clamp(alpha - k, 0, 1) * math.pi)) / 2


def windowed_ipe_cm(
    x, x_var, min_deg: int, max_deg: int, alpha, safe: bool = True, recurrent: bool = False
) -> torch.Tensor:
    """Coordinate-major BARF-windowed IPE with the identity (mean) prepended:
    [3 + F, ...] feature planes (reference mip.py:182-223)."""
    sin_p, cos_p = _ipe_pieces_cm(x, x_var, min_deg, max_deg, safe, recurrent)
    dims = x.shape[0]
    w = barf_window(alpha, min_deg, max_deg, x.dtype, x.device)
    sin_p = [w[i // dims] * p for i, p in enumerate(sin_p)]
    cos_p = [w[i // dims] * p for i, p in enumerate(cos_p)]
    return torch.stack(list(x.unbind(0)) + sin_p + cos_p, dim=0)
