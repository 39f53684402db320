"""K3 and K4: the objects-in-grid MLP forward and backward, their plain
versions, the autograd Function that joins them, and `obj_mlps_apply`, the
scene graph's object pass.

Kernels: `csrc/obj_mlp.cu` (K3) and `csrc/obj_mlp_bwd.cu` (K4), CUDA C++
for sm_90a built by `build.py`. They replace durf_tpu/ops/pallas/
obj_mlp.py:fused_obj_mlp (the `_obj_forward` pallas_call and its custom-vjp
backward `_obj_bwd`). K3 computes sum_o hit_o * MLP_o(x) for every sample:
one CTA loads a tile of shared features once, runs the object MLPs on it
and keeps the gated sums in registers, so per-object outputs never reach
device memory and no cross-CTA reduction is needed. K4 is its vjp: per
object the cotangents scaled by hit_o, dx summed over objects, d cond_lin
per object and ray, stacked weight grads, no gradient for the 0/1 mask.
Bound on the H100: operations, 0.33 MFLOP of bf16 products per sample per
object forward (twice that backward) at the flagship width (8x128, F_in 63,
head 128), for the pairs that run.

At the object MLPs' width (128 / 128) both are wgmma + TMA kernels
(csrc/mlp_obj.cuh; maps and schedules in hopper_mlp.py) that run only the
(128-sample tile, object) pairs some ray of the tile hits (`kept_pairs`):
for a 0/1 mask a skipped pair adds exactly 0, so the outputs are those of
the dense plain versions. At other widths K3 runs the mma.sync kernel of
csrc/mlp_tile.cuh on every pair; K4 is built for 128 / 128 only.

For a 0/1 hit mask, hit * MLP(hit*x + (1-hit)*c0) == hit * MLP(x), so the
masked-encode blend of the batched path disappears. The per-ray condition
`viewdirs_enc @ head_0_kernel[width:]` is computed outside the kernel, once
per ray and object, and rounded to the compute dtype before it enters (as
durf_tpu/ops/pallas/obj_mlp.py:391-410 does).

`FusedObjMlpFn` runs K3 (saving the activations K4 reads) and K4 on CUDA
tensors, the plain versions on CPU tensors; on a CUDA tensor every wrapper
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from durf_tpu_torch.ops.kernels import build, hopper_mlp
from durf_tpu_torch.ops.kernels.fused_mlp import (
    check_bwd_config,
    check_cuda_operand,
    check_obj_config,
    dot,
    g_layout,
    grad_layout,
    head0_index,
    job_table,
    pack_weights,
    save_buffers,
    split_matmul_backward,
    split_matmul_forward,
    stream_of,
    take_residuals,
    unpack_grads,
    wide_dw_chunk,
    x_cols,
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


def fused_obj_mlp_bwd_reference(
    x, hit, cond_lin, weights, config, s_per_ray: int, g_rgb, g_den, dtype=torch.bfloat16
):
    """Plain PyTorch version of K4: per object the explicit vjp of the
    split-matmul MLP (fused_mlp.split_matmul_backward, the kernels' rounding
    points) on the cotangents scaled by hit_o.

    x: [F, N]; hit: [N_obj, B]; cond_lin: [N_obj, B, W_c]; g_rgb: [C_rgb, N];
    g_den: [C_den, N]. Returns (dx [F, N] summed over objects, d cond_lin
    [N_obj, B, W_c], stacked weight grads in operand order).
    """
    n_obj, b = hit.shape
    dx = torch.zeros_like(x.T)
    dconds, grads = [], []
    for o in range(n_obj):
        gate = hit[o].repeat_interleave(s_per_ray)[:, None]
        rows = cond_lin[o].repeat_interleave(s_per_ray, dim=0)
        dx_o, d_rows, g_o = split_matmul_backward(
            config, x.T, rows, [w[o] for w in weights], gate * g_rgb.T, gate * g_den.T, dtype
        )
        dx = dx + dx_o
        dconds.append(d_rows.reshape(b, s_per_ray, -1).sum(1))
        grads.append(g_o)
    stacked = [torch.stack([g[i] for g in grads]) for i in range(len(weights))]
    return dx.T.contiguous(), torch.stack(dconds), stacked


TILE_ROWS = 128  # samples per tile of K3 and K4


def kept_pairs(hit, n: int, s_per_ray: int, rows: int = TILE_ROWS):
    """[tiles, N_obj] bool: whether the kernels run the (tile, object) pair.
    A tile of `rows` samples spans the rays tile0 // S .. (tile0 + rows -
    1) // S, clipped to the batch; the pair runs iff some ray of that span
    hits the object (K3 and K4 evaluate the same predicate on the card).
    hit: [N_obj, B] 0/1."""
    n_obj = hit.shape[0]
    t0 = torch.arange(0, n, rows, device=hit.device)
    r0 = t0 // s_per_ray
    r1 = torch.clamp(t0 + rows - 1, max=n - 1) // s_per_ray
    count = torch.zeros((n_obj, hit.shape[1] + 1), dtype=torch.int64, device=hit.device)
    count[:, 1:] = (hit != 0).long().cumsum(1)
    return (count[:, r1 + 1] - count[:, r0] > 0).T


# Set to a list to log (hit, N, S) of every K3 launch (K4 runs the same
# pairs as the K3 launch whose residuals it reads); profile.py reads the
# share of pairs that ran from it. None: no log.
pair_log = None


def pairs_ran(log) -> tuple:
    """(pairs that ran, pairs) summed over a pair_log."""
    ran = total = 0
    for hit, n, s in log:
        kept = kept_pairs(hit, n, s)
        ran += int(kept.sum())
        total += kept.numel()
    return ran, total


_c = ctypes
_P, _I, _L = _c.c_void_p, _c.c_int, _c.c_longlong
_OFFS = _c.POINTER(_c.c_longlong)
_PLAN = [_OFFS, _I, _OFFS, _I]
_NO_PLAN = (None, 0, None, 0)
_K3_ARGTYPES = [_P] * 7 + [_L, _L] + [_I] * 10 + [_OFFS, _OFFS, _I, _L, _L] + [
    _P, _P, _OFFS, _I, _L] + _PLAN + [_P]
_K4_ARGTYPES = (
    [_P, _P, _P, _L] + [_P] * 8 + [_I, _I, _I, _L, _P, _P, _L, _L] + [_I] * 10
    + [_OFFS, _OFFS, _I, _L, _L, _L] + _PLAN + [_P]
)


def _k3_function():
    fn = build.load("obj_mlp").durf_fused_obj_mlp_fwd
    fn.argtypes = _K3_ARGTYPES
    fn.restype = _c.c_int
    return fn


def _k3_launch(x, hit, cond_lin, weights, config, s_per_ray: int, save: bool):
    """Launch K3. Returns (rgb, den, residuals) with residuals = (x_save,
    act, act offsets, stride, forward weight pack, in_dim) when `save`, else
    None."""
    in_dim, n = x.shape
    n_obj, n_rays = hit.shape
    check_obj_config(config, in_dim)
    check_cuda_operand(x, "x", x.device)
    check_cuda_operand(hit, "hit", x.device)
    check_cuda_operand(cond_lin, "cond_lin", x.device, (n_obj, n_rays, config.net_width_condition))
    if weights[0].dim() != 3 or weights[0].shape[0] != n_obj:
        raise ValueError(f"weights must be stacked over {n_obj} objects")
    w, b, w_offs, b_offs, w_stride, b_stride = pack_weights(weights, config, x.device)
    rgb = torch.empty((config.num_rgb_channels, n), dtype=torch.float32, device=x.device)
    den = torch.empty((config.num_density_channels, n), dtype=torch.float32, device=x.device)
    res, ptrs = None, (None, None, None, 0, 0)
    if save:
        x_save, act, act_offs, act_stride = save_buffers(config, in_dim, n, n_obj, x.device)
        res = (x_save, act, act_offs, act_stride, (w, w_offs, w_stride), in_dim)
        ptrs = (x_save.data_ptr(), act.data_ptr(), build.offsets(act_offs), len(act_offs), act_stride)
    plan = _NO_PLAN
    if hopper_mlp.is_obj(config):
        plan = hopper_mlp.c_obj_plan("obj_fwd", config, in_dim, n, n_obj, w_offs, w_stride,
                                     x_cols(config, in_dim))
    fn = _k3_function()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), hit.data_ptr(), cond_lin.data_ptr(), w.data_ptr(), b.data_ptr(),
            rgb.data_ptr(), den.data_ptr(), n, n_rays, s_per_ray, n_obj, in_dim,
            config.net_width, config.net_depth, config.skip_layer,
            config.net_width_condition, config.net_depth_condition,
            config.num_rgb_channels, config.num_density_channels,
            build.offsets(w_offs), build.offsets(b_offs), len(w_offs), w_stride, b_stride,
            *ptrs, *plan, stream_of(x.device),
        )
    build.check(err, "fused_obj_mlp")
    fused_obj_mlp.launches += 1
    if pair_log is not None:
        pair_log.append((hit, n, s_per_ray))
    return rgb, den, res


def _k4_launch(residuals, hit, g_rgb, g_den, config, s_per_ray: int, need_dx: bool):
    """Allocate K4's workspace and launch it (csrc/obj_mlp_bwd.cu) on the
    residuals K3 saved. Returns (dx [F, N] or None, d cond_lin [N_obj, B,
    W_c], flat weight grads [N_obj * per-object total])."""
    check_bwd_config(config, "obj_mlp_bwd")
    x_save, act, act_offs, act_stride, (w, w_offs, w_stride), in_dim = residuals
    dev = x_save.device
    n = x_save.shape[0]
    n_obj, n_rays = hit.shape
    check_cuda_operand(hit, "hit", dev, (n_obj, n // s_per_ray))
    zeros = lambda c: torch.zeros((c, n), dtype=torch.float32, device=dev)  # noqa: E731
    g_rgb = zeros(config.num_rgb_channels) if g_rgb is None else g_rgb.contiguous()
    g_den = zeros(config.num_density_channels) if g_den is None else g_den.contiguous()
    check_cuda_operand(g_rgb, "g_rgb", dev, (config.num_rgb_channels, n))
    check_cuda_operand(g_den, "g_den", dev, (config.num_density_channels, n))
    g_offs, _ = g_layout(config, n)
    g_stride = hopper_mlp.obj_g_stride(config, n)
    # Rows of pairs that no ray hits are never written: empty, not zeros.
    g = torch.empty((n_obj * g_stride,), dtype=torch.bfloat16, device=dev)
    jobs, jobs_host, n_tiles = job_table(config, in_dim, n, 1, dev)  # one object's jobs
    _, per_obj = grad_layout(config, in_dim)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = wide_dw_chunk(n, n_tiles * n_obj, sms)
    n_splits = -(-n // chunk)
    part = torch.empty((n_splits, n_obj * per_obj), dtype=torch.float32, device=dev)
    flat = torch.empty((n_obj * per_obj,), dtype=torch.float32, device=dev)
    dx = torch.empty((in_dim, n), dtype=torch.float32, device=dev) if need_dx else None
    dcond = torch.empty((n_obj, n_rays, config.net_width_condition), dtype=torch.float32, device=dev)
    plan = hopper_mlp.c_obj_plan("obj_bwd", config, in_dim, n, n_obj, w_offs, w_stride, need_dx)
    fn = build.load("obj_mlp_bwd").durf_fused_obj_mlp_bwd
    fn.argtypes = _K4_ARGTYPES
    fn.restype = _c.c_int
    with torch.cuda.device(dev):
        err = fn(
            g_rgb.data_ptr(), g_den.data_ptr(), hit.data_ptr(), n_rays, w.data_ptr(),
            act.data_ptr(), x_save.data_ptr(), g.data_ptr(), None if dx is None else dx.data_ptr(),
            dcond.data_ptr(), jobs.data_ptr(), jobs_host.data_ptr(), jobs.shape[0], n_tiles,
            n_splits, chunk, part.data_ptr(), flat.data_ptr(), per_obj, n, s_per_ray, n_obj,
            in_dim, config.net_width, config.net_depth, config.skip_layer,
            config.net_width_condition, config.net_depth_condition, config.num_rgb_channels,
            config.num_density_channels, build.offsets(w_offs), build.offsets(g_offs),
            len(w_offs), w_stride, act_stride, g_stride, *plan, stream_of(dev),
        )
    build.check(err, "fused_obj_mlp_bwd")
    return dx, dcond, flat


def fused_obj_mlp_bwd(residuals, hit, g_rgb, g_den, weights, config, s_per_ray: int, need_dx=True):
    """K4: the backward of K3 from the residuals its forward saved.

    Returns (dx [F, N] float32 or None when not `need_dx`, d cond_lin
    [N_obj, B, W_c], stacked weight grads in operand order)."""
    dx, dcond, flat = _k4_launch(residuals, hit, g_rgb, g_den, config, s_per_ray, need_dx)
    fused_obj_mlp_bwd.launches += 1
    return dx, dcond, unpack_grads(flat, weights, config, residuals[5], stacked=True)


fused_obj_mlp_bwd.launches = 0


class FusedObjMlpFn(torch.autograd.Function):
    """K3 forward and K4 backward as one differentiable op of (x [F, N],
    hit [N_obj, B], cond_lin [N_obj, B, W_c], *stacked weights); the plain
    versions for CPU tensors. The hit mask gets a zero gradient."""

    @staticmethod
    def forward(ctx, x, hit, cond_lin, config, s_per_ray, *weights):
        ctx.config, ctx.s_per_ray = config, s_per_ray
        ctx.save_for_backward(x, hit, cond_lin, *weights)
        if x.device.type == "cpu":
            return fused_obj_mlp_reference(x, hit, cond_lin, weights, config, s_per_ray)
        check_bwd_config(config, "obj_mlp_bwd")
        rgb, den, ctx.residuals = _k3_launch(
            x, hit, cond_lin, weights, config, s_per_ray, save=True
        )
        return rgb, den

    @staticmethod
    def backward(ctx, g_rgb, g_den):
        x, hit, cond_lin, *weights = ctx.saved_tensors
        config, s = ctx.config, ctx.s_per_ray
        if x.device.type == "cpu":
            g_rgb = torch.zeros_like(x[: config.num_rgb_channels]) if g_rgb is None else g_rgb
            g_den = torch.zeros_like(x[: config.num_density_channels]) if g_den is None else g_den
            dx, dcond, grads = fused_obj_mlp_bwd_reference(
                x, hit, cond_lin, weights, config, s, g_rgb, g_den
            )
        else:
            residuals = take_residuals(ctx, "fused_obj_mlp")
            dx, dcond, grads = fused_obj_mlp_bwd(
                residuals, hit, g_rgb, g_den, weights, config, s, ctx.needs_input_grad[0]
            )
        dhit = torch.zeros_like(hit) if ctx.needs_input_grad[1] else None
        return (dx, dhit, dcond, None, None, *grads)


def fused_obj_mlp(x, hit, cond_lin, weights, config, s_per_ray: int):
    """K3 forward, differentiable through K4: (rgb [C_rgb, N], density
    [C_den, N]) float32, the hit-gated sum over objects of every object
    MLP's raw outputs.

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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_obj_mlp runs on CUDA or CPU tensors, got {x.device}")
    operands = (x, hit, cond_lin, *weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return FusedObjMlpFn.apply(x, hit, cond_lin, config, s_per_ray, *weights)
    if x.device.type == "cpu":
        return fused_obj_mlp_reference(x, hit, cond_lin, weights, config, s_per_ray)
    rgb, den, _ = _k3_launch(x, hit, cond_lin, weights, config, s_per_ray, save=False)
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
