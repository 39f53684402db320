"""K1 and K2: the fused NeRF-MLP forward and backward; K5 and K6: the same
MLP with its input gated in the kernel; their plain versions, the autograd
Functions that join each pair, and the split-matmul math and workspace
layouts they share with K3/K4.

Kernels: `csrc/fused_mlp.cu` (K1) and `csrc/fused_mlp_bwd.cu` (K2), CUDA
C++ for sm_90a built by `build.py`. They replace durf_tpu/ops/pallas/
fused_mlp.py:fused_nerf_mlp (the `_fused_forward` pallas_call and its
custom-vjp backward `_fused_bwd`). Bound on the H100: operations, 1.18 MFLOP
of bf16 products per sample forward and twice that backward at the flagship
width (8x256 trunk, head 128); when training, the bytes of the saved
activations and cotangents. The forward keeps the tile's activations in
shared memory through all layers and runs the wide layers on the tensor
cores with fp32 accumulation. Both are wgmma + TMA kernels, their maps and
schedules built in hopper_mlp.py: at the flagship widths (256 / 128) those
of csrc/mlp_wide.cuh; at 128 / 128 (the object MLPs on the per-object
route; the width of the 4x128 proposal MLP) the mask-free build of K3's
and K4's kernels (csrc/mlp_obj.cuh): one object, every tile, no mask, with
K3's and K4's plans for one object. The forward at other widths ((128,
256), (256, 256)) runs the mma.sync kernel of csrc/mlp_tile.cuh; the
backward is not built there (BWD_WIDTHS).

Layouts: x arrives feature-major [F, N] in float32, the coordinate-major
encode's native layout (N = rays x samples, ray-major); outputs are
feature-major rgb [3, N] and density [1, N] in float32. The view condition
enters per RAY: `cond_lin = cond @ head_0_kernel[width:]` is computed once
per ray (bf16 operands, fp32 accumulation, as the JAX kernel computes it per
sample) outside the kernel, by autograd-visible PyTorch, and added to every
sample of the ray; its gradient is the per-ray sum of head_0's cotangent.

`FusedNerfMlpFn` runs K1 forward (saving the bf16 activations K2 reads) and
K2 backward on CUDA tensors, and the plain versions on CPU tensors. On a
CUDA tensor every wrapper launches its kernel or raises.

K5 (`csrc/fused_mlp_gated.cu`) and K6 (`csrc/fused_mlp_gated_bwd.cu`)
replace durf_tpu/ops/pallas/fused_mlp.py:fused_nerf_mlp_gated (the same
pallas_calls with a gate and a fill row): the MLP on bf16(g * x + (1 - g) *
fill) blended in the tile from row-major bf16 rows x [N, F], a per-ray gate
g and one fill row; K6 adds dgate and dfill to K2's outputs. At 128 / 128
both are K1's and K2's builds there with the gate (csrc/mlp_obj.cuh, TAG 5
and 6), on K3's and K4's plans for one object; K5 at other widths runs the
mma.sync kernel, and K6 is built only at 128 / 128 (BWD_WIDTHS).
`FusedNerfMlpGatedFn` joins them as FusedNerfMlpFn joins K1 and K2.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from durf_tpu_torch.ops.kernels import build, hopper_mlp

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
_KERNEL_WIDTHS = (128, 256)
HEAD_COLS = 8  # padded width of the density / rgb head cotangent rows
DW_TILE = 128  # output rows (and columns, below 256 / 128) of a weight-gradient tile
WIDE_DW_COLS = 256  # output columns of a tile of the wide dW kernel (csrc/mlp_wide.cuh)
JOB_FIELDS = 12


def layer_dims(config, in_dim: int) -> list:
    """Input dim of every trunk layer (the skip concat folded in): layer i
    re-reads the input when (i - 1) % skip_layer == 0 and i > 1."""
    return [
        in_dim if i == 0 else config.net_width + in_dim if reads_x(config, i) else config.net_width
        for i in range(config.net_depth)
    ]


def reads_x(config, i: int) -> bool:
    """Whether trunk layer i takes the input x (layer 0 and skip layers)."""
    return i == 0 or ((i - 1) % config.skip_layer == 0 and (i - 1) > 0)


def mlp_params(layers, config, has_condition: bool = True) -> list:
    """Flatten a NerfMLP's layers into the operand list: per trunk layer
    (kernel, bias), then density_head, bottleneck, head_i..., rgb_head (the
    order of durf_tpu/ops/pallas/fused_mlp.py:mlp_params_from_flax).

    `layers` maps layer names to objects with `kernel` and `bias` entries
    (modules with those attributes, or dicts)."""

    def pair(name):
        layer = layers[name]
        if isinstance(layer, dict):
            return [layer["kernel"], layer["bias"]]
        return [layer.kernel, layer.bias]

    names = [f"trunk_{i}" for i in range(config.net_depth)] + ["density_head"]
    if has_condition:
        names += ["bottleneck"] + [f"head_{i}" for i in range(config.net_depth_condition)]
    names.append("rgb_head")
    return [t for name in names for t in pair(name)]


def head0_index(config) -> int:
    """Index of head_0's kernel in the operand list."""
    return 2 * config.net_depth + 4


class _RoundBf16(torch.autograd.Function):
    """Round to bf16 and back; the gradient passes through unrounded, as the
    JAX package's `_dot` returns float32 operand gradients."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to `dtype` and back to float32 (identity for float32)."""
    if dtype != torch.bfloat16:
        return t.float()
    return _RoundBf16.apply(t) if t.requires_grad else t.to(torch.bfloat16).float()


def dot(a: torch.Tensor, w: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """a @ w with operands rounded to `dtype` and float32 accumulation (the
    JAX package's `_dot`); float32 operands run at full precision."""
    return torch.matmul(_round(a, dtype), _round(w, dtype))


def cond_linear(cond: torch.Tensor, head0_kernel: torch.Tensor, config, dtype=torch.bfloat16):
    """Per-ray condition rows cond @ head_0_kernel[width:] in float32:
    [B, F_c] x [..., W + F_c, W_c] -> [..., B, W_c]."""
    return dot(cond, head0_kernel[..., config.net_width :, :], dtype)


def split_matmul_forward(config, x, cond_rows, weights, dtype=torch.bfloat16):
    """The NerfMLP forward on row-major samples x [N, F] (split-matmul form,
    durf_tpu/ops/pallas/fused_mlp.py:206-279).

    cond_rows: [N, W_c] float32 condition rows already multiplied by
    head_0_kernel[width:] (None: no view condition, rgb from the trunk).
    weights: operand list in mlp_params order.
    Returns (raw_rgb [N, C_rgb], raw_density [N, C_den]) in float32.
    """
    it = iter(weights)
    width = config.net_width
    h = None
    for i in range(config.net_depth):
        k, b = next(it), next(it)
        if i == 0:
            h = dot(x, k, dtype) + b
        elif reads_x(config, i):
            # concat(h, x) @ k == h @ k[:W] + x @ k[W:]
            h = dot(h, k[:width], dtype) + dot(x, k[width:], dtype) + b
        else:
            h = dot(h, k, dtype) + b
        h = torch.relu(h)
    dk, db = next(it), next(it)
    raw_density = dot(h, dk, dtype) + db
    g = h
    if cond_rows is not None:
        bk, bb = next(it), next(it)
        g = dot(h, bk, dtype) + bb
        for i in range(config.net_depth_condition):
            hk, hb = next(it), next(it)
            if i == 0:
                g = dot(g, hk[:width], dtype) + cond_rows + hb
            else:
                g = dot(g, hk, dtype) + hb
            g = torch.relu(g)
    rk, rb = next(it), next(it)
    raw_rgb = dot(g, rk, dtype) + rb
    return raw_rgb, raw_density


def stored_activations(config, x, cond_rows, weights, dtype=torch.bfloat16):
    """The forward's activations as the kernels store them (rounded to
    `dtype`): (x, [trunk_0 .. trunk_{depth-1}], bottleneck, [head_0 ..]),
    each [N, width]."""
    r = lambda t: _round(t, dtype)  # noqa: E731
    width = config.net_width
    pairs = [(weights[2 * i], weights[2 * i + 1]) for i in range(len(weights) // 2)]
    xr = r(x)
    trunk, h = [], None
    for i in range(config.net_depth):
        k, b = pairs[i]
        if i == 0:
            pre = xr @ r(k) + b
        elif reads_x(config, i):
            pre = h @ r(k[:width]) + xr @ r(k[width:]) + b
        else:
            pre = h @ r(k) + b
        h = r(torch.relu(pre))
        trunk.append(h)
    bk, bb = pairs[config.net_depth + 1]
    bneck = r(h @ r(bk) + bb)
    heads, g = [], bneck
    for i in range(config.net_depth_condition):
        hk, hb = pairs[config.net_depth + 2 + i]
        pre = g @ r(hk[:width]) + cond_rows + hb if i == 0 else g @ r(hk) + hb
        g = r(torch.relu(pre))
        heads.append(g)
    return xr, trunk, bneck, heads


def split_matmul_backward(config, x, cond_rows, weights, g_rgb, g_den, dtype=torch.bfloat16):
    """The explicit vjp of `split_matmul_forward` (with a view condition) at
    the kernels' rounding points: activations stored in `dtype`, every
    cotangent rounded to `dtype` before a product, float32 sums, relu masks
    from the stored activations (durf_tpu/ops/pallas/fused_mlp.py:58-77 with
    act_dtype=bf16). In float32 it equals autograd of the forward.

    x: [N, F]; cond_rows: [N, W_c]; g_rgb: [N, C_rgb]; g_den: [N, C_den].
    Returns (dx [N, F], d cond_rows [N, W_c], weight grads in operand order;
    head_0's condition rows get zero, their gradient flows through
    cond_rows).
    """
    r = lambda t: _round(t, dtype)  # noqa: E731
    width, depth, dc = config.net_width, config.net_depth, config.net_depth_condition
    pairs = [(weights[2 * i], weights[2 * i + 1]) for i in range(len(weights) // 2)]
    xr, trunk, bneck, heads = stored_activations(config, x, cond_rows, weights, dtype)
    bk = pairs[depth + 1][0]

    grads = [None] * len(weights)
    rk = pairs[depth + 2 + dc][0]
    gr = r(g_rgb)
    grads[-2], grads[-1] = heads[-1].T @ gr, gr.sum(0)
    dg = gr @ r(rk).T
    d_rows = None
    for i in reversed(range(dc)):
        hk = pairs[depth + 2 + i][0]
        gi = r(dg * (heads[i] > 0))
        li = depth + 2 + i
        if i == 0:
            dk = bneck.T @ gi
            grads[2 * li] = torch.cat([dk, dk.new_zeros((hk.shape[0] - width, dk.shape[1]))])
            d_rows = gi
            dg = gi @ r(hk[:width]).T
        else:
            grads[2 * li] = heads[i - 1].T @ gi
            dg = gi @ r(hk).T
        grads[2 * li + 1] = gi.sum(0)
    g_bn = r(dg)
    grads[2 * depth + 2], grads[2 * depth + 3] = trunk[-1].T @ g_bn, g_bn.sum(0)
    gd = r(g_den)
    grads[2 * depth], grads[2 * depth + 1] = trunk[-1].T @ gd, gd.sum(0)
    dh = g_bn @ r(bk).T + gd @ r(pairs[depth][0]).T
    dx = torch.zeros_like(x)
    for i in reversed(range(depth)):
        k = pairs[i][0]
        gi = r(dh * (trunk[i] > 0))
        grads[2 * i + 1] = gi.sum(0)
        if i == 0:
            grads[0] = xr.T @ gi
            dx = dx + gi @ r(k).T
        elif reads_x(config, i):
            grads[2 * i] = torch.cat([trunk[i - 1].T @ gi, xr.T @ gi])
            dx = dx + gi @ r(k[width:]).T
            dh = gi @ r(k[:width]).T
        else:
            grads[2 * i] = trunk[i - 1].T @ gi
            dh = gi @ r(k).T
    return dx, d_rows, grads


def _plain_forward(x, cond_lin, weights, config, s_per_ray: int):
    """Plain version of K1 on per-ray condition rows cond_lin [B, W_c]."""
    rows = cond_lin.repeat_interleave(s_per_ray, dim=0)
    rgb, den = split_matmul_forward(config, x.T, rows, weights, torch.bfloat16)
    return rgb.T.contiguous(), den.T.contiguous()


def fused_nerf_mlp_reference(x, cond, weights, config, s_per_ray: int):
    """Plain PyTorch version of K1: the same split-matmul math with
    bf16-rounded operands and float32 accumulation.

    x: [F, N] float32 feature-major; cond: [B, F_c] per-ray condition with
    N = B * s_per_ray. Returns (rgb [C_rgb, N], density [C_den, N]) float32.
    """
    cond_lin = cond_linear(cond, weights[head0_index(config)], config)
    return _plain_forward(x, cond_lin, weights, config, s_per_ray)


def fused_nerf_mlp_bwd_reference(
    x, cond_lin, weights, config, s_per_ray: int, g_rgb, g_den, dtype=torch.bfloat16
):
    """Plain PyTorch version of K2: the vjp of K1 with the kernel's rounding
    points (split_matmul_backward), on feature-major tensors.

    x: [F, N]; cond_lin: [B, W_c] per-ray rows; g_rgb: [C_rgb, N]; g_den:
    [C_den, N]. Returns (dx [F, N], d cond_lin [B, W_c], weight grads in
    operand order with zero rows for head_0's condition rows).
    """
    b = cond_lin.shape[0]
    rows = cond_lin.repeat_interleave(s_per_ray, dim=0)
    dx, d_rows, grads = split_matmul_backward(
        config, x.T, rows, weights, g_rgb.T, g_den.T, dtype
    )
    dcond = d_rows.reshape(b, s_per_ray, -1).sum(1)
    return dx.T.contiguous(), dcond, grads


def kernel_layers(weights, config) -> list:
    """(kernel, bias) per kernel layer; head_0 keeps its first `width` rows
    (its condition rows are applied as per-ray rows)."""
    pairs = [(weights[2 * i], weights[2 * i + 1]) for i in range(len(weights) // 2)]
    k, b = pairs[config.net_depth + 2]
    pairs[config.net_depth + 2] = (k[..., : config.net_width, :], b)
    return pairs


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def pack_weights(weights, config, device):
    """Pack the operand list (leaves [K, N], or stacked [N_obj, K, N]) into
    the kernels' flat buffers: bf16 kernels and fp32 biases, one segment
    per object. Returns (w, b, w_offsets, b_offsets, w_stride, b_stride);
    every kernel segment starts 16-byte aligned."""
    pairs = kernel_layers(weights, config)
    stacked = pairs[0][0].dim() == 3
    n_obj = pairs[0][0].shape[0] if stacked else 1
    w_offs, b_offs, wo, bo = [], [], 0, 0
    for k, b in pairs:
        w_offs.append(wo)
        b_offs.append(bo)
        wo += _round8(k.shape[-2] * k.shape[-1])
        bo += _round8(b.shape[-1])
    wbuf = torch.zeros((n_obj, wo), dtype=torch.bfloat16, device=device)
    bbuf = torch.zeros((n_obj, bo), dtype=torch.float32, device=device)
    for (k, b), w0, b0 in zip(pairs, w_offs, b_offs):
        kk = k.detach().reshape(n_obj, -1)
        bb = b.detach().reshape(n_obj, -1)
        wbuf[:, w0 : w0 + kk.shape[1]] = kk.to(torch.bfloat16)
        bbuf[:, b0 : b0 + bb.shape[1]] = bb.float()
    return wbuf.reshape(-1), bbuf.reshape(-1), w_offs, b_offs, wo, bo


def pack_weights_t(weights, config, in_dim: int, device):
    """Pack the transposed weights K1 at 256 / 128 multiplies activations
    with (hopper_mlp.fwd_plan's maps): per kernel layer l with a wide
    product, the h-part W_l[:K]^T as [J][K] bf16 (K = width, or the head
    width for head_i with i >= 1) and, for layer 0 and the skip layers, the
    x-part W_l[x rows]^T as ceil(in_dim / 64) matrices
    [J][64], zero past in_dim. Returns (buffer, wt_offsets, wtx_offsets,
    stride); -1 marks no part."""
    w = config.net_width
    depth, dc = config.net_depth, config.net_depth_condition
    stacked = weights[0].dim() == 3
    n_obj = weights[0].shape[0] if stacked else 1
    x_chunks = -(-in_dim // 64)
    parts, wt_offs, wtx_offs, off = [], [], [], 0

    def add(mat):  # mat: [n_obj, J, K] float
        nonlocal off
        parts.append((off, mat))
        start = off
        off += _round8(mat.shape[1] * mat.shape[2])
        return start

    for l in range(depth + dc + 3):
        k = weights[2 * l].detach().reshape((n_obj,) + weights[2 * l].shape[-2:])
        kt = k.transpose(1, 2)  # [n_obj, J, rows]
        wt_offs.append(-1)
        wtx_offs.append(-1)
        if l < depth:
            if l > 0:
                wt_offs[l] = add(kt[:, :, :w])
            if reads_x(config, l):
                xs = kt[:, :, w:] if l > 0 else kt
                pad = torch.zeros((n_obj, xs.shape[1], 64 * x_chunks), dtype=xs.dtype, device=xs.device)
                pad[:, :, :in_dim] = xs
                first = None
                for c in range(x_chunks):
                    o = add(pad[:, :, 64 * c : 64 * (c + 1)])
                    first = o if first is None else first
                wtx_offs[l] = first
        elif l == depth + 1 or l == depth + 2:  # bottleneck; head_0's first width rows
            wt_offs[l] = add(kt[:, :, :w])
        elif depth + 2 < l < depth + 2 + dc:  # head_i, i >= 1
            wt_offs[l] = add(kt)
    buf = torch.zeros((n_obj, off), dtype=torch.bfloat16, device=device)
    for start, mat in parts:
        buf[:, start : start + mat.shape[1] * mat.shape[2]] = (
            mat.reshape(n_obj, -1).to(device=device, dtype=torch.bfloat16)
        )
    return buf.reshape(-1), wt_offs, wtx_offs, off


def act_layout(config, n: int):
    """Saved-activation segments of one MLP on n samples (elements of a bf16
    buffer): trunk_0..trunk_{depth-1} and the bottleneck [n, width], then
    head_0.. [n, head width]. Returns (offsets, per-object stride)."""
    w, wc = config.net_width, config.net_width_condition
    d, dc = config.net_depth, config.net_depth_condition
    offs = [i * w * n for i in range(d + 1)] + [(d + 1) * w * n + i * wc * n for i in range(dc)]
    return offs, ((d + 1) * w + dc * wc) * n


def g_widths(config) -> list:
    """Row width of each kernel layer's cotangent G_l in the workspace."""
    w, wc = config.net_width, config.net_width_condition
    d, dc = config.net_depth, config.net_depth_condition
    return [w] * d + [HEAD_COLS, w] + [wc] * dc + [HEAD_COLS]


def g_layout(config, n: int):
    """Offsets of G_l [n, g_widths[l]] (bf16 elements) and the per-object
    stride of the cotangent workspace. The segments lie in the order trunk,
    bottleneck, heads, density, rgb, so that the trunk and bottleneck ones,
    and the head ones, follow each other at a fixed stride (one tensor map
    each in the wide K2)."""
    d, dc = config.net_depth, config.net_depth_condition
    widths = g_widths(config)
    order = list(range(d)) + [d + 1] + [d + 2 + i for i in range(dc)] + [d, d + 2 + dc]
    offs, o = [0] * len(widths), 0
    for l in order:
        offs[l] = o
        o += widths[l] * n
    return offs, o


def grad_layout(config, in_dim: int):
    """Flat fp32 layout of one object's weight gradients, as the dW
    reduction writes them: per kernel layer a [(K + 1), J] block, K = the
    kernel rows the backward forms (head_0: width), the last row the bias.
    Returns ([(offset, K, J)], per-object total)."""
    w, wc = config.net_width, config.net_width_condition
    d, dc = config.net_depth, config.net_depth_condition
    rows = layer_dims(config, in_dim) + [w, w, w] + [wc] * (dc - 1) + [wc]
    cols = [w] * d + [config.num_density_channels, w] + [wc] * dc + [config.num_rgb_channels]
    out, o = [], 0
    for k, j in zip(rows, cols):
        out.append((o, k, j))
        o += (k + 1) * j
    return out, o


def dw_jobs(config, in_dim, n_obj, act_offs, act_stride, g_offs, g_stride, x_cols,
            tile_cols=DW_TILE):
    """The weight-gradient products as the dW kernels' job table (int64
    rows of JOB_FIELDS, fields in csrc/mlp_wide.cuh) and the number of output
    tiles (DW_TILE rows x tile_cols columns). Each job is dW = A^T G over all
    samples, A a saved activation (or the saved input, x_cols wide), G a
    cotangent workspace block; both are given by element offsets from their
    buffers' bases, so the table holds no address."""
    w, wc = config.net_width, config.net_width_condition
    d = config.net_depth
    layout, per_obj = grad_layout(config, in_dim)
    gws = g_widths(config)
    rows, tiles = [], 0

    def job(a_buf, a_off, lda, k, g_off, ldg, j, out, bias):
        nonlocal tiles
        mt, nt = -(-k // DW_TILE), -(-j // tile_cols)
        rows.append([a_buf, a_off, lda, g_off, ldg, k, j, out, bias, tiles, mt, nt])
        tiles += mt * nt

    for o in range(n_obj):
        base = o * per_obj
        act = lambda seg: o * act_stride + act_offs[seg]  # noqa: E731, B023
        for l, (off, k, j) in enumerate(layout):
            out, bias = base + off, base + off + k * j
            g_off, ldg = o * g_stride + g_offs[l], gws[l]
            if l == 0:
                job(0, 0, x_cols, in_dim, g_off, ldg, j, out, bias)
            elif l < d:
                job(1, act(l - 1), w, w, g_off, ldg, j, out, bias)
                if reads_x(config, l):
                    job(0, 0, x_cols, in_dim, g_off, ldg, j, out + w * j, -1)
            elif l in (d, d + 1):  # density head, bottleneck: A = trunk_{d-1}
                job(1, act(d - 1), w, w, g_off, ldg, j, out, bias)
            elif l == d + 2:  # head_0: A = bottleneck
                job(1, act(d), w, w, g_off, ldg, j, out, bias)
            else:  # head_i (i >= 1) and rgb: A = head_{i-1}
                job(1, act(l - 2), wc, wc, g_off, ldg, j, out, bias)
    return rows, tiles


@functools.lru_cache(maxsize=32)
def _job_table(config, in_dim, n, n_obj, device):
    act_offs, act_stride = act_layout(config, n)
    g_offs, g_stride = g_layout(config, n)
    wide = hopper_mlp.is_wide(config) and n_obj == 1
    rows, tiles = dw_jobs(config, in_dim, n_obj, act_offs, act_stride, g_offs, g_stride,
                          x_cols(config, in_dim), WIDE_DW_COLS if wide else DW_TILE)
    host = torch.tensor(rows, dtype=torch.int64)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True), host, tiles


@functools.lru_cache(maxsize=64)
def wide_dw_chunk(n: int, tiles: int, sms: int) -> int:
    """Samples per split of the wide dW kernel, which launches tiles x splits
    blocks, one per SM at a time: the split count whose blocks fill their
    last wave best, among those giving 2 to 8 waves (within 1%: fewer blocks).
    A multiple of its 64-sample stages."""
    best = None
    for s in range(1, 1025):
        chunk = -(-n // s)
        chunk = -(-chunk // 64) * 64
        blocks = -(-n // chunk) * tiles
        if not 2 * sms <= blocks <= 8 * sms:
            continue
        fill = blocks / (-(-blocks // sms) * sms)
        if best is None or fill > best[0] + 0.01:
            best = (fill, chunk)
    return best[1] if best is not None else max(64, -(-n // 64) * 64)


def job_table(config, in_dim: int, n: int, n_obj: int, device):
    """The dW job table of one backward shape: (on `device`, in host memory
    (pinned for a CUDA device), tiles). Built once per (config, in_dim, n,
    n_obj) and kept; the copy to the card is asynchronous, so a launch
    makes no host sync."""
    device = torch.device(device)
    return _job_table(hopper_mlp.Keyed(config), in_dim, n, n_obj, device)


def unpack_grads(flat, weights, config, in_dim: int, stacked: bool):
    """Weight grads in operand order from the flat dW output ([n_obj *
    per-object total] fp32); head_0's condition rows get zeros."""
    layout, per_obj = grad_layout(config, in_dim)
    n_obj = flat.numel() // per_obj
    flat = flat.reshape(n_obj, per_obj)
    grads = []
    for l, (off, k, j) in enumerate(layout):
        dk = flat[:, off : off + k * j].reshape(n_obj, k, j)
        db = flat[:, off + k * j : off + (k + 1) * j]
        full = weights[2 * l].shape[-2]
        if full > k:  # head_0: rows [width:] come from the per-ray product
            dk = torch.cat([dk, dk.new_zeros((n_obj, full - k, j))], dim=1)
        grads += [dk, db] if stacked else [dk[0], db[0]]
    return grads


def kernel_smem_bytes(config, in_dim: int) -> int:
    """Shared memory of one forward CTA of the mma.sync or wide kernels
    (mirrors smem_bytes in csrc/mlp_tile.cuh, fwd_smem in csrc/mlp_wide.cuh);
    the wide backward CTA needs 230 KB. The object kernels (csrc/mlp_obj.cuh,
    also K1, K2, K5 and K6 at 128 / 128) fit at every in_dim they take
    (check_obj_config)."""
    if hopper_mlp.is_wide(config):
        xc = hopper_mlp.x_chunks(in_dim)
        return 1024 + 128 * 256 * 2 + xc * 128 * 128 + 4 * hopper_mlp.SLICE_BYTES + 64
    in_pad = (in_dim + 31) // 32 * 32
    hmax = max(config.net_width, config.net_width_condition)
    return 2 * (128 * (in_pad + 8) + 128 * (hmax + 8) + 2 * 32 * (hmax + 8))


def check_kernel_config(config, in_dim: int) -> None:
    """Raise if the kernels do not take this MLP shape."""
    if config.net_activation != "relu":
        raise ValueError("the fused MLP kernels implement relu only")
    if config.net_width not in _KERNEL_WIDTHS or config.net_width_condition not in _KERNEL_WIDTHS:
        raise ValueError(
            f"the fused MLP kernels take widths {_KERNEL_WIDTHS}; got "
            f"net_width={config.net_width}, net_width_condition={config.net_width_condition}"
        )
    if config.net_depth_condition < 1 or config.skip_layer < 1:
        raise ValueError("the fused MLP kernels need net_depth_condition >= 1 and skip_layer >= 1")
    if config.num_rgb_channels > 4 or config.num_density_channels > 4:
        raise ValueError("the fused MLP kernels take at most 4 rgb and 4 density channels")
    if config.net_depth + config.net_depth_condition + 3 > 24:
        raise ValueError("the fused MLP kernels take at most 24 layers")
    if hopper_mlp.is_wide(config) and (
        hopper_mlp.x_chunks(in_dim) > hopper_mlp.MAX_X_CHUNKS or config.net_depth_condition > 2
    ):
        raise ValueError(
            "the wide MLP kernels take in_dim <= 128 and net_depth_condition <= 2; got "
            f"{in_dim} and {config.net_depth_condition}"
        )
    if kernel_smem_bytes(config, in_dim) > SMEM_LIMIT:
        raise ValueError(f"in_dim {in_dim} needs more shared memory than a block has")


def check_obj_config(config, in_dim: int) -> None:
    """Raise if the kernels of csrc/mlp_obj.cuh do not take this MLP shape
    where they run it (K3, K4, and K1, K2, K5 and K6 at 128 / 128): at that
    width they take in_dim <= 128."""
    check_kernel_config(config, in_dim)
    if hopper_mlp.is_obj(config) and hopper_mlp.x_chunks(in_dim) > hopper_mlp.MAX_X_CHUNKS:
        raise ValueError(f"the object MLP kernels at width 128 take in_dim <= 128; got {in_dim}")


# The (net_width, net_width_condition) pairs each backward kernel is built
# for: K2 the flagship background MLP (csrc/mlp_wide.cuh) and the 128-wide
# MLPs (the object MLPs on the per-object route, the proposal MLP's width;
# the mask-free build of csrc/mlp_obj.cuh); K4 and K6 the object MLPs.
BWD_WIDTHS = {
    "fused_mlp_bwd": ((256, 128), (128, 128)),
    "obj_mlp_bwd": ((128, 128),),
    "fused_mlp_gated_bwd": ((128, 128),),
}


def check_bwd_config(config, what: str) -> None:
    """Raise if the backward kernel of csrc/<what>.cu is not built for this
    MLP's widths."""
    widths = (config.net_width, config.net_width_condition)
    if widths not in BWD_WIDTHS[what]:
        raise ValueError(
            f"{what} is built for (net_width, net_width_condition) in {BWD_WIDTHS[what]}; "
            f"got {widths}"
        )


def check_cuda_operand(t: torch.Tensor, name: str, device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def x_cols(config, in_dim: int) -> int:
    """Columns of the saved input rows: in_dim rounded up to the wide
    kernels' 64-column boxes, or to the mma.sync kernels' 32-row slices."""
    step = hopper_mlp.BOX if hopper_mlp.is_wide(config) else 32
    return -(-in_dim // step) * step


def save_buffers(config, in_dim: int, n: int, n_obj: int, device):
    """(x_save [n, x_cols] bf16, act [n_obj * stride] bf16, act offsets,
    stride): the residuals the forward kernels write for the backward."""
    offs, stride = act_layout(config, n)
    x_save = torch.empty((n, x_cols(config, in_dim)), dtype=torch.bfloat16, device=device)
    act = torch.empty((n_obj * stride,), dtype=torch.bfloat16, device=device)
    return x_save, act, offs, stride


_c = ctypes
_P, _I, _L = _c.c_void_p, _c.c_int, _c.c_longlong
_OFFS = _c.POINTER(_c.c_longlong)
# The forward entry points' shared arguments (K5 prefixes its gate and
# appends its plan, K1 appends the wide kernel's transposed pack and its
# plan); the last is the stream.
_FWD_ARGTYPES = [_P] * 6 + [_L] + [_I] * 9 + [_OFFS, _OFFS, _I, _P, _P, _OFFS, _I, _P]
_PLAN_ARGTYPES = [_OFFS, _I, _OFFS, _I]
_K1_ARGTYPES = _FWD_ARGTYPES[:-1] + [_P] + _PLAN_ARGTYPES + [_P]
_K5_ARGTYPES = [_P, _P] + _FWD_ARGTYPES[:-1] + _PLAN_ARGTYPES + [_P]
# The K2 / K6 entry point (DURF_DEFINE_BWD_ENTRY in csrc/mlp_bwd.cuh).
BWD_ARGTYPES = (
    [_P, _P, _L] + [_P] * 8 + [_I, _I, _I, _L, _P, _P, _L, _L] + [_I] * 9
    + [_OFFS] * 3 + [_I] + [_P] * 6 + _PLAN_ARGTYPES + [_P]
)
_NO_PLAN = (None, 0, None, 0)


def _k1_function():
    fn = build.load("fused_mlp").durf_fused_nerf_mlp_fwd
    fn.argtypes = _K1_ARGTYPES
    fn.restype = _c.c_int
    return fn


def _k1_launch(x, cond_lin, weights, config, s_per_ray: int, save: bool):
    """Launch K1. Returns (rgb, den, residuals) with residuals = (x_save,
    act, act offsets, stride, forward weight pack, in_dim) when `save`, else
    None."""
    in_dim, n = x.shape
    check_obj_config(config, in_dim)
    check_cuda_operand(x, "x", x.device)
    check_cuda_operand(cond_lin, "cond_lin", x.device, (n // s_per_ray, config.net_width_condition))
    w, b, w_offs, b_offs, w_stride, _ = pack_weights(weights, config, x.device)
    rgb = torch.empty((config.num_rgb_channels, n), dtype=torch.float32, device=x.device)
    den = torch.empty((config.num_density_channels, n), dtype=torch.float32, device=x.device)
    res, ptrs = None, (None, None, None, 0)
    act_offs, _ = act_layout(config, n)
    if save:
        x_save, act, act_offs, act_stride = save_buffers(config, in_dim, n, 1, x.device)
        res = (x_save, act, act_offs, act_stride, (w, w_offs, w_stride), in_dim)
        ptrs = (x_save.data_ptr(), act.data_ptr(), build.offsets(act_offs), len(act_offs))
    wt, plan = None, _NO_PLAN
    if hopper_mlp.is_wide(config):  # B of the wgmma products: the transposed pack
        wt, wt_offs, wtx_offs, _ = pack_weights_t(weights, config, in_dim, x.device)
        plan = hopper_mlp.c_plan("fwd", config, in_dim, n, (wt_offs, wtx_offs, act_offs))
    elif hopper_mlp.is_obj(config):  # K3's plan for one object: B is the forward pack
        plan = hopper_mlp.c_obj_plan("obj_fwd", config, in_dim, n, 1, w_offs, w_stride,
                                     x_cols(config, in_dim))
    fn = _k1_function()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), cond_lin.data_ptr(), w.data_ptr(), b.data_ptr(),
            rgb.data_ptr(), den.data_ptr(), n, s_per_ray, in_dim,
            config.net_width, config.net_depth, config.skip_layer,
            config.net_width_condition, config.net_depth_condition,
            config.num_rgb_channels, config.num_density_channels,
            build.offsets(w_offs), build.offsets(b_offs), len(w_offs), *ptrs,
            None if wt is None else wt.data_ptr(), *plan, stream_of(x.device),
        )
    build.check(err, "fused_nerf_mlp")
    fused_nerf_mlp.launches += 1
    fused_nerf_mlp.width_launches[(config.net_width, config.net_width_condition)] += 1
    return rgb, den, res


def launch_bwd(name, what, residuals, g_rgb, g_den, weights, config, s_per_ray, need_dx,
               gate=None):
    """Allocate the backward's workspace and launch K2 or K6 (the C entry
    point `name` of csrc/<what>.cu) on the residuals the forward saved: the
    wgmma + TMA kernels, whose B is the forward pack, on the plan of the
    wide kernels (256 / 128) or K4's for one object (128 / 128).
    `gate` = (x rows [N, F] bf16, gate [B] fp32, fill [F] bf16) for K6, whose
    dx is then always formed. Returns (dx [F, N] or None, d cond_lin [B,
    W_c], flat weight grads, and for K6 (dgate [N] per sample, dfill [F]))."""
    check_bwd_config(config, what)
    x_save, act, act_offs, _, (w, w_offs, w_stride), in_dim = residuals
    dev = x_save.device
    n = x_save.shape[0]
    n_rays = n // s_per_ray
    g_rgb = g_rgb.contiguous() if g_rgb is not None else torch.zeros(
        (config.num_rgb_channels, n), dtype=torch.float32, device=dev)
    g_den = g_den.contiguous() if g_den is not None else torch.zeros(
        (config.num_density_channels, n), dtype=torch.float32, device=dev)
    check_cuda_operand(g_rgb, "g_rgb", dev, (config.num_rgb_channels, n))
    check_cuda_operand(g_den, "g_den", dev, (config.num_density_channels, n))
    need_dx = need_dx or gate is not None
    g_offs, g_size = g_layout(config, n)
    if hopper_mlp.is_wide(config):
        plan = hopper_mlp.c_plan("bwd", config, in_dim, n, (w_offs, act_offs, g_offs), need_dx)
    else:  # K4's kernels for one object, on its cotangent workspace of whole planes
        plan = hopper_mlp.c_obj_plan("obj_bwd", config, in_dim, n, 1, w_offs, w_stride, need_dx)
        g_size = hopper_mlp.obj_g_stride(config, n)
    g = torch.empty((g_size,), dtype=torch.bfloat16, device=dev)
    jobs, jobs_host, n_tiles = job_table(config, in_dim, n, 1, dev)
    _, total = grad_layout(config, in_dim)
    chunk = wide_dw_chunk(n, n_tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    n_splits = max(1, -(-n // chunk))
    part = torch.empty((n_splits, total), dtype=torch.float32, device=dev)
    flat = torch.empty((total,), dtype=torch.float32, device=dev)
    # The tile kernels store every row of dx.
    dx = torch.empty((in_dim, n), dtype=torch.float32, device=dev) if need_dx else None
    dcond = torch.empty((n_rays, config.net_width_condition), dtype=torch.float32, device=dev)
    gate_ptrs, gate_out = [None] * 6, ()
    if gate is not None:
        x_rows, gate_ray, fill_row = gate
        dgate = torch.empty((n,), dtype=torch.float32, device=dev)
        dfill_part = torch.empty((in_dim, -(-n // 128)), dtype=torch.float32, device=dev)
        dfill = torch.empty((in_dim,), dtype=torch.float32, device=dev)
        gate_ptrs = [t.data_ptr() for t in (x_rows, gate_ray, fill_row, dgate, dfill_part, dfill)]
        gate_out = (dgate, dfill)
    fn = getattr(build.load(what), name)
    fn.argtypes = BWD_ARGTYPES
    fn.restype = _c.c_int
    with torch.cuda.device(dev):
        err = fn(
            g_rgb.data_ptr(), g_den.data_ptr(), n_rays, w.data_ptr(), act.data_ptr(),
            x_save.data_ptr(), g.data_ptr(), None if dx is None else dx.data_ptr(),
            dcond.data_ptr(), jobs.data_ptr(), jobs_host.data_ptr(),
            jobs.shape[0], n_tiles, n_splits, chunk,
            part.data_ptr(), flat.data_ptr(), total, n, s_per_ray, in_dim,
            config.net_width, config.net_depth, config.skip_layer,
            config.net_width_condition, config.net_depth_condition,
            config.num_rgb_channels, config.num_density_channels,
            build.offsets(w_offs), build.offsets(act_offs), build.offsets(g_offs), len(w_offs),
            *gate_ptrs, *plan, stream_of(dev),
        )
    build.check(err, what)
    return (dx, dcond, flat) + gate_out


def fused_nerf_mlp_bwd(residuals, g_rgb, g_den, weights, config, s_per_ray: int, need_dx=True):
    """K2: the backward of K1 from the residuals its forward saved.

    Returns (dx [F, N] float32 or None when not `need_dx`, d cond_lin
    [B, W_c], weight grads in operand order)."""
    dx, dcond, flat = launch_bwd(
        "durf_fused_nerf_mlp_bwd", "fused_mlp_bwd", residuals, g_rgb, g_den,
        weights, config, s_per_ray, need_dx,
    )
    fused_nerf_mlp_bwd.launches += 1
    fused_nerf_mlp_bwd.width_launches[(config.net_width, config.net_width_condition)] += 1
    return dx, dcond, unpack_grads(flat, weights, config, residuals[5], stacked=False)


fused_nerf_mlp_bwd.launches = 0
# The same launches by (net_width, net_width_condition): 256/128 runs the
# wide kernels, 128/128 the mask-free object kernels.
fused_nerf_mlp_bwd.width_launches = collections.Counter()


def take_residuals(ctx, what: str):
    """The workspace a kernel forward saved on `ctx`, released as it is
    taken: it is gigabytes at the flagship step, so it lives for one
    backward only. A second backward through the same graph raises."""
    residuals = getattr(ctx, "residuals", None)
    if residuals is None:
        raise RuntimeError(
            f"{what}: the backward kernel's saved workspace was already used by an earlier "
            "backward; backward through this op twice (retain_graph=True) is not supported"
        )
    ctx.residuals = None
    return residuals


class FusedNerfMlpFn(torch.autograd.Function):
    """K1 forward and K2 backward as one differentiable op of
    (x [F, N], cond_lin [B, W_c], *weights); the plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, x, cond_lin, config, s_per_ray, *weights):
        ctx.config, ctx.s_per_ray = config, s_per_ray
        ctx.save_for_backward(x, cond_lin, *weights)
        if x.device.type == "cpu":
            return _plain_forward(x, cond_lin, weights, config, s_per_ray)
        check_bwd_config(config, "fused_mlp_bwd")
        rgb, den, ctx.residuals = _k1_launch(x, cond_lin, weights, config, s_per_ray, save=True)
        return rgb, den

    @staticmethod
    def backward(ctx, g_rgb, g_den):
        x, cond_lin, *weights = ctx.saved_tensors
        config, s = ctx.config, ctx.s_per_ray
        if x.device.type == "cpu":
            g_rgb = torch.zeros_like(x[: config.num_rgb_channels]) if g_rgb is None else g_rgb
            g_den = torch.zeros_like(x[: config.num_density_channels]) if g_den is None else g_den
            dx, dcond, grads = fused_nerf_mlp_bwd_reference(
                x, cond_lin, weights, config, s, g_rgb, g_den
            )
        else:
            residuals = take_residuals(ctx, "fused_nerf_mlp")
            dx, dcond, grads = fused_nerf_mlp_bwd(
                residuals, g_rgb, g_den, weights, config, s, ctx.needs_input_grad[0]
            )
        return (dx, dcond, None, None, *grads)


def fused_nerf_mlp(x, cond, weights, config, s_per_ray: int):
    """K1 forward, differentiable through K2: (raw_rgb [C_rgb, N],
    raw_density [C_den, N]) float32.

    Args:
      x: [F, N] float32 feature-major encoded samples, N = B * s_per_ray.
      cond: [B, F_c] per-ray encoded view directions.
      weights: operand list (mlp_params order), float32.
      config: MLPConfig.
      s_per_ray: samples per ray.
    """
    in_dim, n = x.shape
    if n != cond.shape[0] * s_per_ray:
        raise ValueError(f"x has {n} samples, cond has {cond.shape[0]} rays x {s_per_ray}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_nerf_mlp runs on CUDA or CPU tensors, got {x.device}")
    cond_lin = cond_linear(cond, weights[head0_index(config)], config).contiguous()
    operands = (x, cond_lin, *weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return FusedNerfMlpFn.apply(x, cond_lin, config, s_per_ray, *weights)
    if x.device.type == "cpu":
        return _plain_forward(x, cond_lin, weights, config, s_per_ray)
    rgb, den, _ = _k1_launch(x, cond_lin, weights, config, s_per_ray, save=False)
    return rgb, den


fused_nerf_mlp.launches = 0
fused_nerf_mlp.width_launches = collections.Counter()  # by (net_width, net_width_condition)


# ---- K5 / K6: the MLP on an input gated in the tile ----


def gated_blend(x, gate, fill, s_per_ray: int):
    """K5's prologue in float32: bf16(g * x' + (1 - g) * fill'), x' and fill'
    the row-major input x [N, F] and the fill row (F elements) rounded to
    bf16 (as the JAX package's NerfMLP feeds its gated kernel), g the per-ray
    gate [B] repeated over the ray's samples. Rounding passes the gradient
    through unrounded."""
    g = gate.repeat_interleave(s_per_ray)[:, None]
    xr, fr = _round(x, torch.bfloat16), _round(fill.reshape(1, -1), torch.bfloat16)
    return _round(g * xr + (1.0 - g) * fr, torch.bfloat16)


def _gated_plain_forward(x, gate, fill, cond_lin, weights, config, s_per_ray: int):
    rows = cond_lin.repeat_interleave(s_per_ray, dim=0)
    return split_matmul_forward(
        config, gated_blend(x, gate, fill, s_per_ray), rows, weights, torch.bfloat16
    )


def fused_nerf_mlp_gated_reference(x, gate, fill, cond, weights, config, s_per_ray: int = 1):
    """Plain PyTorch version of K5: the split-matmul MLP (bf16 operands,
    float32 sums) on gated_blend(x, gate, fill).

    x: [N, F] row-major; gate: [B] or [B, 1] per ray; fill: F elements;
    cond: [B, F_c] per ray, N = B * s_per_ray (s_per_ray = 1: per sample, as
    the JAX package's function takes them). Returns row-major (rgb
    [N, C_rgb], density [N, C_den]) float32.
    """
    cond_lin = cond_linear(cond, weights[head0_index(config)], config)
    return _gated_plain_forward(
        x, gate.reshape(-1), fill, cond_lin, weights, config, s_per_ray
    )


def fused_nerf_mlp_gated_bwd_reference(
    x, gate, fill, cond_lin, weights, config, s_per_ray: int, g_rgb, g_den
):
    """Plain PyTorch version of K6: K2's explicit vjp (split_matmul_backward)
    on the blended input, then the gate's vjp on the blend's cotangent dxe.

    x: [N, F]; gate: [B]; fill: F elements; cond_lin: [B, W_c]; g_rgb:
    [N, C_rgb]; g_den: [N, C_den]. Returns (dx [N, F] = g * dxe, dgate [B]
    = sum over the ray's samples and features of (x' - fill') * dxe, dfill
    [F] = sum_n (1 - g) * dxe, d cond_lin [B, W_c], weight grads in operand
    order with zero rows for head_0's condition rows).
    """
    b = cond_lin.shape[0]
    xe = gated_blend(x, gate, fill, s_per_ray)
    rows = cond_lin.repeat_interleave(s_per_ray, dim=0)
    dxe, d_rows, grads = split_matmul_backward(config, xe, rows, weights, g_rgb, g_den)
    g = gate.repeat_interleave(s_per_ray)[:, None]
    xr, fr = _round(x, torch.bfloat16), _round(fill.reshape(1, -1), torch.bfloat16)
    dgate = ((xr - fr) * dxe).sum(-1).reshape(b, s_per_ray).sum(1)
    dfill = ((1.0 - g) * dxe).sum(0)
    dcond = d_rows.reshape(b, s_per_ray, -1).sum(1)
    return g * dxe, dgate, dfill, dcond, grads


def _k5_launch(x, gate, fill, cond_lin, weights, config, s_per_ray: int, save: bool):
    """Launch K5 on x [N, F] (rounded to bf16 here), gate [B] and the fill
    row; at 128 / 128 with K3's plan for one object. Returns (rgb [N,
    C_rgb], den [N, C_den], residuals) with residuals = (K2-style residuals
    of the blended input, (x rows bf16, gate, fill bf16)) when `save`, else
    None."""
    n, in_dim = x.shape
    check_obj_config(config, in_dim)
    dev = x.device
    x_rows = x.detach().to(torch.bfloat16).contiguous()
    fill_row = fill.detach().reshape(-1).to(torch.bfloat16).contiguous()
    gate = gate.detach().float().contiguous()
    check_cuda_operand(gate, "gate", dev, (n // s_per_ray,))
    check_cuda_operand(cond_lin, "cond_lin", dev, (n // s_per_ray, config.net_width_condition))
    if fill_row.numel() != in_dim or x_rows.device != dev or fill_row.device != dev:
        raise ValueError(f"fill must hold {in_dim} values on {dev}")
    w, b, w_offs, b_offs, w_stride, _ = pack_weights(weights, config, dev)
    rgb = torch.empty((n, config.num_rgb_channels), dtype=torch.float32, device=dev)
    den = torch.empty((n, config.num_density_channels), dtype=torch.float32, device=dev)
    res, ptrs = None, (None, None, None, 0)
    if save:
        x_save, act, act_offs, act_stride = save_buffers(config, in_dim, n, 1, dev)
        res = (
            (x_save, act, act_offs, act_stride, (w, w_offs, w_stride), in_dim),
            (x_rows, gate, fill_row),
        )
        ptrs = (x_save.data_ptr(), act.data_ptr(), build.offsets(act_offs), len(act_offs))
    plan = _NO_PLAN
    if hopper_mlp.is_obj(config):
        plan = hopper_mlp.c_obj_plan("obj_fwd", config, in_dim, n, 1, w_offs, w_stride,
                                     x_cols(config, in_dim))
    fn = build.load("fused_mlp_gated").durf_fused_nerf_mlp_gated_fwd
    fn.argtypes = _K5_ARGTYPES
    fn.restype = _c.c_int
    with torch.cuda.device(dev):
        err = fn(
            x_rows.data_ptr(), gate.data_ptr(), fill_row.data_ptr(), cond_lin.data_ptr(),
            w.data_ptr(), b.data_ptr(), rgb.data_ptr(), den.data_ptr(), n, s_per_ray, in_dim,
            config.net_width, config.net_depth, config.skip_layer,
            config.net_width_condition, config.net_depth_condition,
            config.num_rgb_channels, config.num_density_channels,
            build.offsets(w_offs), build.offsets(b_offs), len(w_offs), *ptrs, *plan,
            stream_of(dev),
        )
    build.check(err, "fused_nerf_mlp_gated")
    fused_nerf_mlp_gated.launches += 1
    return rgb, den, res


def fused_nerf_mlp_gated_bwd(residuals, g_rgb, g_den, weights, config, s_per_ray: int):
    """K6: the backward of K5 from the residuals its forward saved; g_rgb
    [N, C_rgb] and g_den [N, C_den] row-major (None: zeros).

    Returns (dx [N, F] float32, a transposed view of the kernel's
    feature-major rows; dgate [B]; dfill [F]; d cond_lin [B, W_c]; weight
    grads in operand order)."""
    mlp_res, gate_res = residuals
    t = lambda g: None if g is None else g.T  # noqa: E731  the kernel reads [C, N]
    dx, dcond, flat, dgate, dfill = launch_bwd(
        "durf_fused_nerf_mlp_gated_bwd", "fused_mlp_gated_bwd", mlp_res, t(g_rgb),
        t(g_den), weights, config, s_per_ray, True, gate=gate_res,
    )
    fused_nerf_mlp_gated_bwd.launches += 1
    n_rays = dcond.shape[0]
    return (
        dx.T, dgate.reshape(n_rays, s_per_ray).sum(1), dfill, dcond,
        unpack_grads(flat, weights, config, mlp_res[5], stacked=False),
    )


fused_nerf_mlp_gated_bwd.launches = 0


class FusedNerfMlpGatedFn(torch.autograd.Function):
    """K5 forward and K6 backward as one differentiable op of (x [N, F],
    gate [B], fill, cond_lin [B, W_c], *weights); the plain versions for
    CPU tensors."""

    @staticmethod
    def forward(ctx, x, gate, fill, cond_lin, config, s_per_ray, *weights):
        ctx.config, ctx.s_per_ray = config, s_per_ray
        ctx.save_for_backward(x, gate, fill, cond_lin, *weights)
        if x.device.type == "cpu":
            return _gated_plain_forward(x, gate, fill, cond_lin, weights, config, s_per_ray)
        check_bwd_config(config, "fused_mlp_gated_bwd")
        rgb, den, ctx.residuals = _k5_launch(
            x, gate, fill, cond_lin, weights, config, s_per_ray, save=True
        )
        return rgb, den

    @staticmethod
    def backward(ctx, g_rgb, g_den):
        x, gate, fill, cond_lin, *weights = ctx.saved_tensors
        config, s = ctx.config, ctx.s_per_ray
        if x.device.type == "cpu":
            n = x.shape[0]
            g_rgb = x.new_zeros((n, config.num_rgb_channels)) if g_rgb is None else g_rgb
            g_den = x.new_zeros((n, config.num_density_channels)) if g_den is None else g_den
            dx, dgate, dfill, dcond, grads = fused_nerf_mlp_gated_bwd_reference(
                x, gate, fill, cond_lin, weights, config, s, g_rgb, g_den
            )
        else:
            residuals = take_residuals(ctx, "fused_nerf_mlp_gated")
            dx, dgate, dfill, dcond, grads = fused_nerf_mlp_gated_bwd(
                residuals, g_rgb, g_den, weights, config, s
            )
        return (dx, dgate, dfill.reshape(fill.shape), dcond, None, None, *grads)


def fused_nerf_mlp_gated(x, gate, fill, cond, weights, config, s_per_ray: int = 1):
    """K5 forward, differentiable through K6: the MLP on the input gated in
    the tile, bf16(g * x' + (1 - g) * fill') with x' and fill' rounded to
    bf16 (see gated_blend). Returns row-major (raw_rgb [N, C_rgb],
    raw_density [N, C_den]) float32.

    Args:
      x: [N, F] row-major encoded samples, N = B * s_per_ray.
      gate: [B] or [B, 1] per-ray gate (0/1 for the scene graph's hit mask).
      fill: the constant row (F elements) used where the gate is 0.
      cond: [B, F_c] per-ray encoded view directions.
      weights: operand list (mlp_params order), float32.
      config: MLPConfig.
      s_per_ray: samples per ray; 1 gives the JAX package's per-sample gate
        and condition.
    """
    n, in_dim = x.shape
    b = cond.shape[0]
    if n != b * s_per_ray:
        raise ValueError(f"x has {n} samples, cond has {b} rays x {s_per_ray}")
    gate = gate.reshape(-1)
    if gate.shape[0] != b or fill.numel() != in_dim:
        raise ValueError(f"gate needs {b} values and fill {in_dim}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_nerf_mlp_gated runs on CUDA or CPU tensors, got {x.device}")
    cond_lin = cond_linear(cond, weights[head0_index(config)], config).contiguous()
    operands = (x, gate, fill, cond_lin, *weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return FusedNerfMlpGatedFn.apply(x, gate, fill, cond_lin, config, s_per_ray, *weights)
    if x.device.type == "cpu":
        return _gated_plain_forward(x, gate, fill, cond_lin, weights, config, s_per_ray)
    rgb, den, _ = _k5_launch(x, gate, fill, cond_lin, weights, config, s_per_ray, save=False)
    return rgb, den


fused_nerf_mlp_gated.launches = 0
