"""E1: the model's encodings as one hand-written kernel, its three modes'
wrappers and the autograd Function that joins forward and backward.

Kernel: `csrc/encode.cu`, CUDA C++ for sm_90a built by `build.py`. It
replaces no Pallas kernel (the JAX package leaves its encodings to XLA,
which fuses them): eager PyTorch ran each encoding as 100-170 elementwise
launches a level over whole [B, S] planes. One pass per mode computes
what a plain composition of ops/encoding.py computes, in the same float32
operations:

  * `windowed_ipe`: encoding.windowed_ipe_cm, the object MLPs' input
    [3 + F, ...]; the BARF window is formed in the kernel from `alpha`
    (a number, or a float32 tensor on the samples' device read by
    pointer), so no host-to-device copy or wait;
  * `background_ipe`: encoding.background_ipe_cm, the background's hit
    mask, contraction and IPE, [F, ...];
  * `view_pe`: encoding.pos_enc(viewdirs, 0, deg, append_identity=True),
    [B, 3 + 6 deg].

On CPU tensors each wrapper runs its plain composition, unchanged; on CUDA
tensors it launches the kernel or raises. Where the inputs need a gradient,
`EncodeFn` runs the kernel's backward (recomputing the features, the
chain rule written out). `encode.launches` counts forward launches
(`encode.mode_launches` by mode), `encode_bwd.launches` backward ones;
while a profiler records, `enc.samples` counts the samples each point
encoding takes and `enc.kernel_samples` those the kernel encodes.
"""

from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from durf_tpu_torch import metrics
from durf_tpu_torch.ops import encoding
from durf_tpu_torch.ops.kernels import build
from durf_tpu_torch.ops.kernels.fused_mlp import stream_of

MODES = ("windowed", "background", "view")
WINDOWED, BACKGROUND, VIEW = range(3)
MAX_DEGS = 32  # csrc/encode.cu's MAX_DEGS

_c = ctypes
_P, _I, _L, _F = _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_float
_COMMON = [_I, _I, _I, _I, _P, _P, _P, _I, _I, _L, _I, _I, _F, _P, _F]


@dataclass(frozen=True)
class Spec:
    """One encoding call: the mode, its flags and the tensors it reads
    besides the mean and variance (`hit` [B, N_obj] for the background's
    mask, `alpha_t` a device alpha)."""

    mode: int
    min_deg: int
    max_deg: int
    recurrent: bool = False
    safe: bool = False
    contraction: bool = False
    threshold: float = 0.0
    alpha: float = 0.0
    alpha_t: Optional[torch.Tensor] = None
    hit: Optional[torch.Tensor] = None

    def features(self) -> int:
        f = 6 * (self.max_deg - self.min_deg)
        return f if self.mode == BACKGROUND else f + 3


def _function(name: str, extra):
    fn = getattr(build.load("encode"), name)
    fn.argtypes = _COMMON + extra
    fn.restype = _c.c_int
    return fn


def _head(spec: Spec, x, v):
    """The launchers' common leading arguments."""
    hit = spec.hit
    n = x.shape[0] if spec.mode == VIEW else x.numel() // 3
    n_obj = s_per_ray = 0
    if hit is not None:
        n_obj, s_per_ray = hit.shape[1], n // hit.shape[0]
    return (
        spec.mode, int(spec.recurrent), int(spec.safe), int(spec.contraction), x.data_ptr(),
        None if v is None else v.data_ptr(), None if hit is None else hit.data_ptr(), n_obj,
        s_per_ray, n, spec.min_deg, spec.max_deg, spec.alpha,
        None if spec.alpha_t is None else spec.alpha_t.data_ptr(), spec.threshold,
    ), n


def encode(spec: Spec, x, v):
    """Launch the forward: [F, ...] planes of x's trailing shape (VIEW: [B,
    F] rows)."""
    head, n = _head(spec, x, v)
    shape = (x.shape[0], spec.features()) if spec.mode == VIEW else (spec.features(),) + x.shape[1:]
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    fn = _function("durf_encode_fwd", [_P, _P])
    with torch.cuda.device(x.device):
        err = fn(*head, out.data_ptr(), stream_of(x.device))
    build.check(err, f"encode ({MODES[spec.mode]})")
    encode.launches += 1
    encode.mode_launches[MODES[spec.mode]] += 1
    if spec.mode != VIEW:
        metrics.count("enc.kernel_samples", n)
    return out


encode.launches = 0
encode.mode_launches = collections.Counter()


def encode_bwd(spec: Spec, x, v, g):
    """Launch the backward on the forward's inputs and the cotangent g (laid
    out as the forward's output): (dx, dv), dv None in VIEW."""
    head, _ = _head(spec, x, v)
    g = g.contiguous()
    dx = torch.empty_like(x)
    dv = None if v is None else torch.empty_like(v)
    fn = _function("durf_encode_bwd", [_P, _P, _P, _P])
    with torch.cuda.device(x.device):
        err = fn(*head, g.data_ptr(), dx.data_ptr(), None if dv is None else dv.data_ptr(),
                 stream_of(x.device))
    build.check(err, f"encode backward ({MODES[spec.mode]})")
    encode_bwd.launches += 1
    return dx, dv


encode_bwd.launches = 0


class EncodeFn(torch.autograd.Function):
    """The kernel's forward and backward as one differentiable op of the
    mean (or view directions) and variance; `hit` and alpha get no
    gradient."""

    @staticmethod
    def forward(ctx, spec, x, v):
        ctx.spec = spec
        ctx.save_for_backward(x, v)
        return encode(spec, x, v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        dx, dv = encode_bwd(ctx.spec, x, v, g)
        return None, dx, dv


def _operand(t: torch.Tensor, name: str, device, rows: int = 0) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if rows and (t.dim() < 2 or t.shape[0] != rows):
        raise ValueError(f"{name} must be [{rows}, ...], got {tuple(t.shape)}")
    return t.contiguous()


def _alpha(alpha, device):
    """(alpha as a number, alpha on the card or None): a CPU tensor is read
    on the host (no wait on the card), a CUDA one by the kernel."""
    if torch.is_tensor(alpha):
        if alpha.numel() != 1:
            raise ValueError(f"alpha must hold one value, got {tuple(alpha.shape)}")
        if alpha.device.type == "cuda":
            if alpha.device != device:
                raise ValueError(f"alpha is on {alpha.device}, expected {device}")
            return 0.0, alpha.detach().reshape(1).to(torch.float32).contiguous()
        alpha = float(alpha)
    return float(alpha), None


def _run(spec: Spec, x, v):
    """Check the operands, then the kernel, through EncodeFn where x or v
    needs a gradient."""
    if not 0 <= spec.max_deg - spec.min_deg <= MAX_DEGS:
        raise ValueError(f"the kernel takes 0 to {MAX_DEGS} degrees, got "
                         f"[{spec.min_deg}, {spec.max_deg})")
    operands = (x,) if v is None else (x, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return EncodeFn.apply(spec, x, v)
    return encode(spec, x, v)


def _check_device(x, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")


def windowed_ipe(x, x_var, min_deg: int, max_deg: int, alpha, safe: bool = True,
                 recurrent: bool = False) -> torch.Tensor:
    """encoding.windowed_ipe_cm: ([3, ...] mean, [3, ...] variance
    diagonal) -> [3 + F, ...] float32 planes, the mean's then the windowed
    IPE's."""
    _check_device(x, "windowed_ipe")
    metrics.count("enc.samples", x.numel() // 3)
    if x.device.type == "cpu":
        return encoding.windowed_ipe_cm(x, x_var, min_deg, max_deg, alpha, safe, recurrent)
    x, x_var = _operand(x, "x", x.device, 3), _operand(x_var, "x_var", x.device, 3)
    if x_var.shape != x.shape:
        raise ValueError(f"x_var has shape {tuple(x_var.shape)}, x {tuple(x.shape)}")
    value, tensor = _alpha(alpha, x.device)
    spec = Spec(WINDOWED, min_deg, max_deg, recurrent, safe and not recurrent, alpha=value,
                alpha_t=tensor)
    return _run(spec, x, x_var)


def background_ipe(x, x_var, hit, min_deg: int, max_deg: int, contraction: bool,
                   threshold: float = 0.1, safe: bool = True,
                   recurrent: bool = False) -> torch.Tensor:
    """encoding.background_ipe_cm: ([3, B, S] mean, [3, B, S] variance
    diagonal, [B, N_obj] 0/1 hit mask or None) -> [F, B, S] float32."""
    _check_device(x, "background_ipe")
    metrics.count("enc.samples", x.numel() // 3)
    if x.device.type == "cpu":
        return encoding.background_ipe_cm(x, x_var, hit, min_deg, max_deg, contraction,
                                          threshold, safe, recurrent)
    x, x_var = _operand(x, "x", x.device, 3), _operand(x_var, "x_var", x.device, 3)
    if x_var.shape != x.shape or x.dim() != 3:
        raise ValueError(f"x and x_var must be [3, B, S], got {tuple(x.shape)}, "
                         f"{tuple(x_var.shape)}")
    if hit is not None:
        hit = _operand(hit.detach(), "hit", x.device)
        if hit.dim() != 2 or hit.shape[0] != x.shape[1]:
            raise ValueError(f"hit must be [{x.shape[1]}, N_obj], got {tuple(hit.shape)}")
    spec = Spec(BACKGROUND, min_deg, max_deg, recurrent, safe and not recurrent, contraction,
                float(threshold), hit=hit)
    return _run(spec, x, x_var)


def view_pe(viewdirs, deg: int) -> torch.Tensor:
    """encoding.pos_enc(viewdirs, 0, deg, append_identity=True): [B, 3]
    -> [B, 3 + 6 deg] float32."""
    _check_device(viewdirs, "view_pe")
    if viewdirs.device.type == "cpu":
        return encoding.pos_enc(viewdirs, 0, deg, append_identity=True)
    x = _operand(viewdirs, "viewdirs", viewdirs.device)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"viewdirs must be [B, 3], got {tuple(x.shape)}")
    return _run(Spec(VIEW, 0, deg), x, None)
