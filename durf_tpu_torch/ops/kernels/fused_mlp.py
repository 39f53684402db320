"""K1: the fused background NeRF-MLP forward, its plain version and the
split-matmul math they share.

Kernel: `csrc/fused_mlp.cu` (CUDA C++ for sm_90a, built by `build.py`).
It replaces durf_tpu/ops/pallas/fused_mlp.py:fused_nerf_mlp (the
`_fused_forward` pallas_call). Bound on the H100: operations, 1.18 MFLOP of
bf16 products per sample at the flagship width (8x256 trunk, head 128)
against ~256 bytes moved, so the kernel keeps the tile's activations in
shared memory through all layers and runs the wide layers on the tensor
cores with fp32 accumulation (see csrc/mlp_tile.cuh).

Layouts: x arrives feature-major [F, N] in float32, the coordinate-major
encode's native layout (N = rays x samples, ray-major); outputs are
feature-major rgb [3, N] and density [1, N] in float32. The view condition
arrives per RAY, [B, F_c]: its head_0 product `cond @ head_0_kernel[width:]`
is computed once per ray (bf16 operands, fp32 accumulation, as the JAX
kernel computes it per sample) and added to every sample of the ray.

On a CPU tensor `fused_nerf_mlp` computes `fused_nerf_mlp_reference`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from durf_tpu_torch.ops.kernels import build

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
_KERNEL_WIDTHS = (128, 256)


def layer_dims(config, in_dim: int) -> list:
    """Input dim of every trunk layer (the skip concat folded in): layer i
    re-reads the input when (i - 1) % skip_layer == 0 and i > 1."""
    dims = []
    for i in range(config.net_depth):
        if i == 0:
            dims.append(in_dim)
        elif (i - 1) % config.skip_layer == 0 and (i - 1) > 0:
            dims.append(config.net_width + in_dim)
        else:
            dims.append(config.net_width)
    return dims


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


def dot(a: torch.Tensor, w: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """a @ w with operands rounded to `dtype` and float32 accumulation (the
    JAX package's `_dot`); float32 operands run at full precision."""
    if dtype == torch.bfloat16:
        a = a.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    return torch.matmul(a.float(), w.float())


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
        elif (i - 1) % config.skip_layer == 0 and (i - 1) > 0:
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


def fused_nerf_mlp_reference(x, cond, weights, config, s_per_ray: int):
    """Plain PyTorch version of K1: the same split-matmul math with
    bf16-rounded operands and float32 accumulation.

    x: [F, N] float32 feature-major; cond: [B, F_c] per-ray condition with
    N = B * s_per_ray. Returns (rgb [C_rgb, N], density [C_den, N]) float32.
    """
    cond_lin = cond_linear(cond, weights[head0_index(config)], config)
    rows = cond_lin.repeat_interleave(s_per_ray, dim=0)
    rgb, den = split_matmul_forward(config, x.T, rows, weights, torch.bfloat16)
    return rgb.T.contiguous(), den.T.contiguous()


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
        kk = k.reshape(n_obj, -1)
        bb = b.reshape(n_obj, -1)
        wbuf[:, w0 : w0 + kk.shape[1]] = kk.to(torch.bfloat16)
        bbuf[:, b0 : b0 + bb.shape[1]] = bb.float()
    return wbuf.reshape(-1), bbuf.reshape(-1), w_offs, b_offs, wo, bo


def kernel_smem_bytes(config, in_dim: int) -> int:
    """Shared memory of one CTA (mirrors smem_bytes in csrc/mlp_tile.cuh)."""
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
    if kernel_smem_bytes(config, in_dim) > SMEM_LIMIT:
        raise ValueError(f"in_dim {in_dim} needs more shared memory than a block has")


def check_cuda_operand(t: torch.Tensor, name: str, device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


_c = ctypes
_K1_ARGTYPES = [_c.c_void_p] * 6 + [_c.c_longlong] + [_c.c_int] * 9 + [
    _c.POINTER(_c.c_longlong), _c.POINTER(_c.c_longlong), _c.c_int, _c.c_void_p,
]


def _k1_function():
    fn = build.load("fused_mlp").durf_fused_nerf_mlp_fwd
    fn.argtypes = _K1_ARGTYPES
    fn.restype = _c.c_int
    return fn


def fused_nerf_mlp(x, cond, weights, config, s_per_ray: int):
    """K1 forward: (raw_rgb [C_rgb, N], raw_density [C_den, N]) float32.

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
    if x.device.type == "cpu":
        return fused_nerf_mlp_reference(x, cond, weights, config, s_per_ray)
    if x.device.type != "cuda":
        raise ValueError(f"fused_nerf_mlp runs on CUDA or CPU tensors, got {x.device}")
    check_kernel_config(config, in_dim)
    check_cuda_operand(x, "x", x.device)
    cond_lin = cond_linear(cond, weights[head0_index(config)], config).contiguous()
    check_cuda_operand(cond_lin, "cond_lin", x.device, (cond.shape[0], config.net_width_condition))
    w, b, w_offs, b_offs, _, _ = pack_weights(weights, config, x.device)
    rgb = torch.empty((config.num_rgb_channels, n), dtype=torch.float32, device=x.device)
    den = torch.empty((config.num_density_channels, n), dtype=torch.float32, device=x.device)
    fn = _k1_function()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), cond_lin.data_ptr(), w.data_ptr(), b.data_ptr(),
            rgb.data_ptr(), den.data_ptr(), n, s_per_ray, in_dim,
            config.net_width, config.net_depth, config.skip_layer,
            config.net_width_condition, config.net_depth_condition,
            config.num_rgb_channels, config.num_density_channels,
            build.offsets(w_offs), build.offsets(b_offs), len(w_offs),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "fused_nerf_mlp")
    fused_nerf_mlp.launches += 1
    return rgb, den


fused_nerf_mlp.launches = 0
