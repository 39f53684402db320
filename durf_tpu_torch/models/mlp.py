"""The NeRF trunk MLP with skip connections and a view-conditioned head.

Counterpart of the JAX package's `models/mlp.py` (reference
obbpose_model.py:293-418). One parameter layout, three execution paths:
  * the plain path: the split-matmul formulation in `compute_dtype`
    (operands rounded, float32 accumulation), differentiable by autograd;
    with `remat` it runs under torch.utils.checkpoint, so the backward
    recomputes the trunk instead of keeping every layer's activations;
  * the kernel path (`use_kernel=True`, on a call with a view condition):
    K1 forward and K2 backward behind one autograd Function
    (ops/kernels/fused_mlp.py). A call without a condition takes the plain
    path, as in the JAX package (mlp.py:166 there), which has no kernel
    for an MLP without one;
  * with `pallas_gate_in_kernel` as well, a gated call on row-major input
    and output runs K5 forward and K6 backward, which blend
    gate * x + (1 - gate) * fill inside the kernel (mlp.py:166-181 of the
    JAX package). Every other gated call blends in PyTorch first.
A stacked module (`num_stack=N_obj`) holds every object MLP with a leading
object axis on each leaf, like the JAX package's nn.vmap'd `object_mlps`
(shared input, condition and fill; one gate per object); it runs the same
routes one object's weights at a time, so the kernels launch once per
object and autograd sums the objects' input gradients.

Inputs are feature-major [F, ..., S] (the coordinate-major encode's layout)
or row-major [..., S, F]; outputs feature-major [C, ..., S] or row-major
[..., S, C], float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
        pallas_gate_in_kernel: bool = False,
        remat: bool = False,
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
        # Blend a gated call's input inside K5/K6 (row-major in and out only)
        # instead of in PyTorch before K1/K2; nothing in MipNerf sets it, as
        # in the JAX package.
        self.pallas_gate_in_kernel = pallas_gate_in_kernel
        # Recompute the plain path's trunk in the backward (ModelConfig.
        # remat_mlp); no effect on the kernel path, whose backward already
        # recomputes in the tile.
        self.remat = remat
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

    def forward(
        self,
        x: torch.Tensor,
        condition: torch.Tensor | None = None,
        gate: torch.Tensor | None = None,
        fill: torch.Tensor | None = None,
        x_feature_major: bool = True,
        out_feature_major: bool = True,
    ):
        """Args:
          x: [F, ..., S] encoded samples (x_feature_major) or [..., S, F].
          condition: [..., F_c] per-ray encoded view directions (no sample
            axis; broadcast over the samples).
          gate: optional per-ray [..., 1] (a stacked module: [N_obj, ..., 1],
            one per object); the input is gate * x + (1 - gate) * fill.
          fill: the constant input row (F elements) where the gate is 0.
          out_feature_major: return [C, ..., S] planes, else [..., S, C].

        Returns (raw_rgb, raw_density) float32, with a leading N_obj axis
        for a stacked module.
        """
        if (condition is None) != (self.cond_dim == 0):
            raise ValueError("condition must be given exactly when cond_dim > 0")
        if (gate is None) != (fill is None):
            raise ValueError("gate and fill go together")
        weights = self.operands()
        args = (x, condition, fill, x_feature_major, out_feature_major)
        if self.num_stack is None:
            return self._route(weights, gate, *args)
        outs = [
            self._route([w[o] for w in weights], None if gate is None else gate[o], *args)
            for o in range(self.num_stack)
        ]
        return torch.stack([r for r, _ in outs]), torch.stack([d for _, d in outs])

    def _plain(self, flat, cond, s, fm, *weights):
        """The plain path on [N, F] (or feature-major [F, N]) input and the
        per-ray condition [N / s, F_c] (or None): ([N, 3], [N, 1])."""
        cfg = self.config
        cond_rows = None
        if cond is not None:
            cond_lin = k1.cond_linear(cond, weights[k1.head0_index(cfg)], cfg, self.compute_dtype)
            cond_rows = cond_lin.repeat_interleave(s, dim=0)
        return k1.split_matmul_forward(cfg, flat.T if fm else flat, cond_rows, list(weights),
                                       self.compute_dtype)

    def _route(self, weights, gate, x, condition, fill, fm, out_fm):
        """One MLP's route (see the module docstring)."""
        cfg = self.config
        in_dim = x.shape[0] if fm else x.shape[-1]
        batch_shape = x.shape[1:] if fm else x.shape[:-1]
        s = batch_shape[-1]
        n = math.prod(batch_shape)
        flat = x.reshape(in_dim, n) if fm else x.reshape(n, in_dim)
        cond = None if condition is None else condition.reshape(n // s, -1)
        g = None if gate is None else gate.reshape(n // s)
        kernel = self.use_kernel and cond is not None
        if kernel and g is not None and self.pallas_gate_in_kernel and not fm and not out_fm:
            rgb, den = k1.fused_nerf_mlp_gated(flat, g, fill, cond, weights, cfg, s)
        else:
            if g is not None:  # blend in the input's own layout
                gs = g.repeat_interleave(s)
                gs, fr = (gs[None], fill.reshape(in_dim, 1)) if fm else (gs[:, None], fill.reshape(1, in_dim))
                flat = gs * flat + (1.0 - gs) * fr
            if kernel:
                rgb, den = k1.fused_nerf_mlp(flat if fm else flat.T.contiguous(), cond, weights, cfg, s)
                rgb, den = rgb.T, den.T
            elif self.remat and torch.is_grad_enabled():
                rgb, den = checkpoint(self._plain, flat, cond, s, fm, *weights, use_reentrant=False)
            else:
                rgb, den = self._plain(flat, cond, s, fm, *weights)
        if out_fm:
            return rgb.T.reshape((-1,) + batch_shape), den.T.reshape((-1,) + batch_shape)
        return rgb.reshape(batch_shape + (-1,)), den.reshape(batch_shape + (-1,))
