"""Positional encodings: NeRF PE, Gaussian Fourier features and the
integrated PE (IPE), row-major and coordinate-major.

Counterpart of the JAX package's `ops/encoding.py` (reference
mip.py:25-73, 182-282), including the per-frequency BARF window aligned
with the feature layout and the recurrent IPE. Row-major features are laid
out [sin(deg, dim)..., cos(deg, dim)...]; the coordinate-major encode
gives the same values as [F, ...] planes.
"""

from __future__ import annotations

import math

import torch

from durf_tpu_torch import mathx
from durf_tpu_torch.ops.contraction import contract_gaussian_diag

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


def expected_sin(x: torch.Tensor, x_var: torch.Tensor, safe: bool = True):
    """Mean and variance of sin(z) for z ~ N(x, x_var) (reference
    mip.py:67-73); safe=False takes plain sin/cos, without the range
    reduction."""
    sin = mathx.safe_sin if safe else torch.sin
    cos = mathx.safe_cos if safe else torch.cos
    y = torch.exp(-0.5 * x_var) * sin(x)
    y_var = torch.clamp(0.5 * (1 - torch.exp(-2 * x_var) * cos(2 * x)) - y**2, min=0.0)
    return y, y_var


def gaussian_fourier_enc(
    x: torch.Tensor,
    scale: float,
    generator: torch.Generator | None = None,
    num_features: int = 3,
    append_identity: bool = False,
    bvals: torch.Tensor | None = None,
) -> torch.Tensor:
    """Random Gaussian Fourier features (Tancik et al.): sin and cos of
    2 pi x B^T, B ~ N(0, scale^2) of shape [num_features, D] (reference
    mip.py:25-33).

    Args:
      generator: draws B when `bvals` is None.
      bvals: the frequencies B (the JAX package's `jax.random.normal(key,
        ...) * scale`), for a caller that hands in its own draw.

    The projection is an elementwise product and sum in x's dtype, so no
    reduced-precision matmul mode reaches it.
    """
    if bvals is None:
        bvals = torch.randn(
            (num_features, x.shape[-1]), generator=generator, dtype=x.dtype, device=x.device
        ) * scale
    proj = ((2.0 * math.pi * x)[..., None, :] * bvals).sum(dim=-1)
    feat = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    if append_identity:
        return torch.cat([x, feat], dim=-1)
    return feat


def _barf_window(alpha, min_deg: int, max_deg: int, dims: int, dtype, device) -> torch.Tensor:
    """The BARF window of the row-major layout: each degree's weight
    repeated over the `dims` coordinates, for the sin and the cos half."""
    w = barf_window(alpha, min_deg, max_deg, dtype, device).repeat_interleave(dims)
    return torch.cat([w, w], dim=-1)


def windowed_pos_enc(
    x: torch.Tensor, min_deg: int, max_deg: int, alpha, append_identity: bool = True
) -> torch.Tensor:
    """BARF coarse-to-fine windowed positional encoding (reference
    mip.py:48-64); without the identity it returns the windowed features."""
    feat = pos_enc(x, min_deg, max_deg, append_identity=False)
    feat = _barf_window(alpha, min_deg, max_deg, x.shape[-1], feat.dtype, feat.device) * feat
    if append_identity:
        return torch.cat([x, feat], dim=-1)
    return feat


def _ipe_features_recurrent(x, x_cov_diag, min_deg: int, max_deg: int):
    """Row-major recurrent IPE of ([..., 3] mean, [..., 3] variance
    diagonal): degree k+1 from degree k by e <- e^4 and the double-angle
    formulas, restarting every _RESTART degrees (see _ipe_pieces_cm);
    layout [sin(deg, dim)..., cos(deg, dim)...]."""
    x_cov_diag = torch.clamp(x_cov_diag, min=0.0)
    e = s = c = None
    sin_feats, cos_feats = [], []
    for i, deg in enumerate(range(min_deg, max_deg)):
        if i % _RESTART == 0:
            scale = 2.0**deg
            e = torch.exp((-0.5 * scale * scale) * x_cov_diag)
            s = torch.sin(scale * x)
            c = torch.cos(scale * x)
        sin_feats.append(e * s)
        cos_feats.append(e * c)
        e2 = e * e
        e = e2 * e2
        s, c = 2.0 * s * c, c * c - s * s
    shape = x.shape[:-1] + (-1,)
    return torch.cat(
        [
            torch.stack(sin_feats, dim=-2).reshape(shape),
            torch.stack(cos_feats, dim=-2).reshape(shape),
        ],
        dim=-1,
    )


def _ipe_features(x_coord, min_deg: int, max_deg: int, diag: bool, safe: bool = True):
    """Row-major IPE of (mean [..., 3], covariance [..., 3] diagonal or
    [..., 3, 3] full): the expected sin of the means and variances
    projected onto the basis [2^min_deg I, ..., 2^(max_deg-1) I].

    The JAX package projects the full covariance by two matmuls at HIGHEST
    precision (durf_tpu/ops/encoding.py:150-156). Each column of that basis
    holds one power of two, so every projected value is one exact scaling
    (x_j 2^k, Sigma_jj 4^k) plus exact zeros: the elementwise form below,
    on the covariance's diagonal, is the same function, and no TF32 or
    other reduced-precision matmul mode can reach it.
    """
    x, x_cov = x_coord
    x_var = x_cov if diag else torch.diagonal(x_cov, dim1=-2, dim2=-1)
    # 2^min_deg ... 2^(max_deg-1), exact, made on x's device (a fill and a
    # cumulative product): no host copy of a scale list per call.
    scales = torch.full((max_deg - min_deg,), 2.0, dtype=x.dtype, device=x.device)
    scales = scales.cumprod(0) * 2.0 ** (min_deg - 1)
    shape = x.shape[:-1] + (-1,)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (x_var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    # Variances are non-negative for any PSD covariance; the clamp keeps a
    # numerically indefinite one from reaching exp(+|y_var|) = inf.
    y_var = torch.clamp(y_var, min=0.0)
    return expected_sin(
        torch.cat([y, y + 0.5 * math.pi], dim=-1), torch.cat([y_var] * 2, dim=-1), safe=safe
    )[0]


def integrated_pos_enc(
    x_coord, min_deg: int, max_deg: int, diag: bool = False, safe: bool = True,
    recurrent: bool = False,
) -> torch.Tensor:
    """Row-major IPE of a Gaussian (means [..., 3], covs [..., 3, 3] or,
    with diag, [..., 3]) -> [..., 2 * 3 * (max_deg - min_deg)].
    `recurrent` (diagonal only) takes the double-angle form, which ignores
    `safe`. Reference mip.py:226-282."""
    if recurrent and diag:
        return _ipe_features_recurrent(x_coord[0], x_coord[1], min_deg, max_deg)
    return _ipe_features(x_coord, min_deg, max_deg, diag, safe)


def windowed_ipe(
    x_coord, min_deg: int, max_deg: int, alpha, diag: bool = False, safe: bool = True,
    recurrent: bool = False,
) -> torch.Tensor:
    """Row-major BARF-windowed IPE with the identity (mean) prepended: the
    object MLPs' input (reference mip.py:182-223)."""
    feat = integrated_pos_enc(x_coord, min_deg, max_deg, diag, safe, recurrent)
    w = _barf_window(alpha, min_deg, max_deg, x_coord[0].shape[-1], feat.dtype, feat.device)
    return torch.cat([x_coord[0], w * feat], dim=-1)


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


def background_ipe_cm(
    x, x_var, hit, min_deg: int, max_deg: int, contraction: bool, threshold: float = 0.1,
    safe: bool = True, recurrent: bool = False,
) -> torch.Tensor:
    """The background MLP's input from coordinate-major samples ([3, B, S]
    mean and variance diagonal): with `hit` ([B, N_obj] 0/1) the samples
    masked by the complement clamp(1 - sum_o hit_o, 0) of their ray (a ray
    hitting two boxes would otherwise flip the covariance negative,
    reference obbpose_model.py:205), then with `contraction`
    contract_gaussian_diag, then integrated_pos_enc_cm: [F, B, S]."""
    if hit is not None:
        mask = torch.clamp(1.0 - hit.sum(dim=-1), min=0.0).detach()[None, :, None]
        x, x_var = mask * x, mask * x_var
    if contraction:
        x, x_var = contract_gaussian_diag(x, x_var, threshold=threshold, dim=0)
    return integrated_pos_enc_cm(x, x_var, min_deg, max_deg, safe, recurrent)
