"""The NeRF trunk MLP with skip connections and a view-conditioned head.

Counterpart of the JAX package's `models/mlp.py` (reference
obbpose_model.py:293-418). One parameter layout, two execution paths:
  * the plain path: the split-matmul formulation in `compute_dtype`
    (operands rounded, float32 accumulation), differentiable by autograd;
  * the kernel path (`use_kernel=True`): K1 forward and K2 backward, the
    fused CUDA kernels behind one autograd Function
    (ops/kernels/fused_mlp.py), for a single MLP with a view condition.
A stacked module (`num_stack=N_obj`) holds every object MLP with a leading
object axis on each leaf, like the JAX package's nn.vmap'd `object_mlps`.

Inputs are feature-major [F, B, S] (the coordinate-major encode's layout);
outputs are feature-major [C, B, S] float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.ops.kernels import fused_mlp as k1

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": nn.functional.softplus,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def get_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {name!r}") from None


class Dense(nn.Module):
    """A layer's kernel [in, out] and bias [out] (flax nn.Dense layout),
    with an optional leading stack axis."""

    def __init__(self, in_dim: int, features: int, stack: int | None = None):
        super().__init__()
        lead = () if stack is None else (stack,)
        self.kernel = nn.Parameter(torch.zeros(lead + (in_dim, features)))
        self.bias = nn.Parameter(torch.zeros(lead + (features,)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform kernel (per stacked slice), zero bias."""
        fan_in, fan_out = self.kernel.shape[-2:]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(self.kernel.shape, generator=generator, dtype=torch.float32)
        with torch.no_grad():
            self.kernel.copy_((2.0 * u - 1.0) * limit)
            self.bias.zero_()


class NerfMLP(nn.Module):
    """Trunk of `net_depth` relu layers (input re-read after every
    `skip_layer` layers), a density head, and, with a view condition, a
    bottleneck plus a conditioned color head (reference
    obbpose_model.py:305-354)."""

    def __init__(
        self,
        config: MLPConfig,
        in_dim: int,
        cond_dim: int,
        compute_dtype: str = "float32",
        use_kernel: bool = False,
        num_stack: int | None = None,
    ):
        super().__init__()
        if config.net_activation != "relu":
            raise NotImplementedError("the split-matmul MLP paths assume relu")
        self.config = config
        self.in_dim = in_dim
        self.cond_dim = cond_dim
        self.compute_dtype = get_dtype(compute_dtype)
        self.use_kernel = use_kernel
        self.num_stack = num_stack
        cfg = config
        layers = {}
        for i, d in enumerate(k1.layer_dims(cfg, in_dim)):
            layers[f"trunk_{i}"] = Dense(d, cfg.net_width, num_stack)
        layers["density_head"] = Dense(cfg.net_width, cfg.num_density_channels, num_stack)
        head_width = cfg.net_width
        if cond_dim > 0:
            layers["bottleneck"] = Dense(cfg.net_width, cfg.net_width, num_stack)
            for i in range(cfg.net_depth_condition):
                d = cfg.net_width + cond_dim if i == 0 else cfg.net_width_condition
                layers[f"head_{i}"] = Dense(d, cfg.net_width_condition, num_stack)
            head_width = cfg.net_width_condition
        layers["rgb_head"] = Dense(head_width, cfg.num_rgb_channels, num_stack)
        self.layers = nn.ModuleDict(layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers.values():
            layer.reset_parameters(generator)

    def operands(self) -> list:
        """The operand list in mlp_params order (stacked leaves when
        num_stack is set)."""
        return k1.mlp_params(self.layers, self.config, self.cond_dim > 0)

    def _plain(self, x_fm, condition, weights):
        """Plain path on [F, B, S] features -> ([C, B, S], [C, B, S])."""
        cfg = self.config
        f, b, s = x_fm.shape
        rows = None
        if condition is not None:
            cond_lin = k1.cond_linear(
                condition, weights[k1.head0_index(cfg)], cfg, self.compute_dtype
            )
            rows = cond_lin.repeat_interleave(s, dim=0)
        rgb, den = k1.split_matmul_forward(
            cfg, x_fm.reshape(f, b * s).T, rows, weights, self.compute_dtype
        )
        return rgb.T.reshape(-1, b, s), den.T.reshape(-1, b, s)

    def forward(self, x_fm: torch.Tensor, condition: torch.Tensor | None = None):
        """x_fm: [F, B, S] encoded samples; condition: [B, F_c] per-ray
        encoded view directions. Returns (raw_rgb [C_rgb, B, S],
        raw_density [C_den, B, S]) float32."""
        if self.num_stack is not None:
            raise ValueError("a stacked NerfMLP runs through forward_objects")
        if (condition is None) != (self.cond_dim == 0):
            raise ValueError("condition must be given exactly when cond_dim > 0")
        if not self.use_kernel:
            return self._plain(x_fm, condition, self.operands())
        if condition is None:
            raise NotImplementedError("the MLP kernel needs a view condition")
        f, b, s = x_fm.shape
        rgb, den = k1.fused_nerf_mlp(
            x_fm.reshape(f, b * s), condition, self.operands(), self.config, s
        )
        return rgb.reshape(-1, b, s), den.reshape(-1, b, s)

    def forward_objects(self, x_fm, condition, gate, fill):
        """Plain path of a stacked module: object o runs on the masked
        features gate_o * x + (1 - gate_o) * fill.

        x_fm: [F, B, S]; condition: [B, F_c] or None; gate: [N_obj, B, 1]
        0/1; fill: [F, 1, 1] (the zero-sample encoding). Returns
        (raw_rgb [N_obj, C_rgb, B, S], raw_density [N_obj, C_den, B, S]).
        """
        weights = self.operands()
        rgbs, dens = [], []
        for o in range(self.num_stack):
            g = gate[o][None]  # [1, B, 1]
            x_o = g * x_fm + (1.0 - g) * fill
            rgb, den = self._plain(x_o, condition, [w[o] for w in weights])
            rgbs.append(rgb)
            dens.append(den)
        return torch.stack(rgbs), torch.stack(dens)
