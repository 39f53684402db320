"""K3: the objects-in-grid MLP forward, its plain version, and
`obj_mlps_apply`, the scene graph's object pass.

Kernel: `csrc/obj_mlp.cu` (CUDA C++ for sm_90a, built by `build.py`). It
replaces durf_tpu/ops/pallas/obj_mlp.py:fused_obj_mlp (the `_obj_forward`
pallas_call). It computes sum_o hit_o * MLP_o(x) for every sample: one CTA
loads a tile of shared features once, runs every object's MLP on it and
keeps the gated sums in registers, so per-object outputs never reach device
memory and no cross-CTA reduction is needed. Bound on the H100: operations,
0.33 MFLOP of bf16 products per sample per object at the flagship width
(8x128, F_in 63, head 128).

For a 0/1 hit mask, hit * MLP(hit*x + (1-hit)*c0) == hit * MLP(x), so the
masked-encode blend of the batched path disappears. The per-ray condition
`viewdirs_enc @ head_0_kernel[width:]` is computed outside the kernel, once
per ray and object, and rounded to the compute dtype before it enters (as
durf_tpu/ops/pallas/obj_mlp.py:391-410 does).

On a CPU tensor `fused_obj_mlp` computes `fused_obj_mlp_reference`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from durf_tpu_torch.ops.kernels import build
from durf_tpu_torch.ops.kernels.fused_mlp import (
    check_cuda_operand,
    check_kernel_config,
    dot,
    head0_index,
    pack_weights,
    split_matmul_forward,
)


def fused_obj_mlp_reference(x, hit, cond_lin, weights, config, s_per_ray: int):
    """Plain PyTorch version of K3: per object the split-matmul MLP with
    bf16-rounded operands and float32 accumulation, gated and summed in
    object order.

    x: [F, N] float32; hit: [N_obj, B] 0/1; cond_lin: [N_obj, B, W_c] float32
    per-ray condition rows; weights: stacked operand list ([N_obj, ...]).
    Returns (rgb [C_rgb, N], density [C_den, N]) float32.
    """
    n_obj = hit.shape[0]
    rgb_acc = den_acc = None
    for o in range(n_obj):
        rows = cond_lin[o].repeat_interleave(s_per_ray, dim=0)
        rgb, den = split_matmul_forward(
            config, x.T, rows, [w[o] for w in weights], torch.bfloat16
        )
        g = hit[o].repeat_interleave(s_per_ray)[:, None]
        if o == 0:
            rgb_acc, den_acc = g * rgb, g * den
        else:
            rgb_acc, den_acc = rgb_acc + g * rgb, den_acc + g * den
    return rgb_acc.T.contiguous(), den_acc.T.contiguous()


_c = ctypes
_K3_ARGTYPES = [_c.c_void_p] * 7 + [_c.c_longlong, _c.c_longlong] + [_c.c_int] * 10 + [
    _c.POINTER(_c.c_longlong), _c.POINTER(_c.c_longlong), _c.c_int,
    _c.c_longlong, _c.c_longlong, _c.c_void_p,
]


def _k3_function():
    fn = build.load("obj_mlp").durf_fused_obj_mlp_fwd
    fn.argtypes = _K3_ARGTYPES
    fn.restype = _c.c_int
    return fn


def fused_obj_mlp(x, hit, cond_lin, weights, config, s_per_ray: int):
    """K3 forward: (rgb [C_rgb, N], density [C_den, N]) float32, the
    hit-gated sum over objects of every object MLP's raw outputs.

    Args:
      x: [F, N] float32 feature-major shared features, N = B * s_per_ray.
      hit: [N_obj, B] float32 0/1 per-ray hit mask.
      cond_lin: [N_obj, B, W_c] float32 per-ray condition rows.
      weights: stacked operand list (every leaf [N_obj, ...]).
    """
    in_dim, n = x.shape
    n_obj, n_rays = hit.shape
    if n != n_rays * s_per_ray:
        raise ValueError(f"x has {n} samples, hit has {n_rays} rays x {s_per_ray}")
    if x.device.type == "cpu":
        return fused_obj_mlp_reference(x, hit, cond_lin, weights, config, s_per_ray)
    if x.device.type != "cuda":
        raise ValueError(f"fused_obj_mlp runs on CUDA or CPU tensors, got {x.device}")
    check_kernel_config(config, in_dim)
    check_cuda_operand(x, "x", x.device)
    check_cuda_operand(hit, "hit", x.device)
    check_cuda_operand(cond_lin, "cond_lin", x.device, (n_obj, n_rays, config.net_width_condition))
    if weights[0].dim() != 3 or weights[0].shape[0] != n_obj:
        raise ValueError(f"weights must be stacked over {n_obj} objects")
    w, b, w_offs, b_offs, w_stride, b_stride = pack_weights(weights, config, x.device)
    rgb = torch.empty((config.num_rgb_channels, n), dtype=torch.float32, device=x.device)
    den = torch.empty((config.num_density_channels, n), dtype=torch.float32, device=x.device)
    fn = _k3_function()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), hit.data_ptr(), cond_lin.data_ptr(), w.data_ptr(), b.data_ptr(),
            rgb.data_ptr(), den.data_ptr(), n, n_rays, s_per_ray, n_obj, in_dim,
            config.net_width, config.net_depth, config.skip_layer,
            config.net_width_condition, config.net_depth_condition,
            config.num_rgb_channels, config.num_density_channels,
            build.offsets(w_offs), build.offsets(b_offs), len(w_offs), w_stride, b_stride,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "fused_obj_mlp")
    fused_obj_mlp.launches += 1
    return rgb, den


fused_obj_mlp.launches = 0


def obj_mlps_apply(weights, config, enc_fm, viewdirs_enc, hit, compute_dtype):
    """Every object MLP through the objects-in-grid kernel (the counterpart
    of durf_tpu/ops/pallas/obj_mlp.py:obj_mlps_apply).

    Args:
      weights: stacked operand list of the object MLPs ([N_obj, ...]).
      config: MLPConfig of the object MLPs.
      enc_fm: [F, B, S] float32 shared windowed-IPE features.
      viewdirs_enc: [B, F_c] per-ray encoded view directions.
      hit: [B, N_obj] 0/1 ray-box hit mask.
      compute_dtype: dtype of the per-ray condition product's operands.

    Returns (obj_rgbs [C_rgb, B, S], obj_densities [C_den, B, S]) float32.
    """
    f, bsz, s = enc_fm.shape
    cond_lin = dot(
        viewdirs_enc, weights[head0_index(config)][:, config.net_width :, :], compute_dtype
    )
    cond_lin = cond_lin.to(compute_dtype).float().contiguous()  # [N_obj, B, W_c]
    rgb, den = fused_obj_mlp(
        enc_fm.reshape(f, bsz * s),
        hit.T.contiguous().float(),
        cond_lin,
        weights,
        config,
        s,
    )
    return (
        rgb.reshape(config.num_rgb_channels, bsz, s),
        den.reshape(config.num_density_channels, bsz, s),
    )
