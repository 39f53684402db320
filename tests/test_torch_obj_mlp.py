"""K3's plain version (durf_tpu_torch.ops.kernels.obj_mlp) against the JAX
package's objects-in-grid Pallas kernel in interpret mode, through both
packages' `obj_mlps_apply`, and against the port's batched masked-blend
object path.

bf16 tolerance atol 2e-2 (as tests/test_obj_kernel.py): bf16-rounded
operands on both sides, float32 sums in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.ops.pallas.obj_mlp import obj_mlps_apply as j_apply
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.models.mlp import NerfMLP
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import obj_mlp as k3

F_IN, F_C = 63, 27
SHAPE = dict(net_depth=6, net_width=32, net_width_condition=16)


def _layer_names(cfg):
    return (
        [f"trunk_{i}" for i in range(cfg.net_depth)]
        + ["density_head", "bottleneck"]
        + [f"head_{i}" for i in range(cfg.net_depth_condition)]
        + ["rgb_head"]
    )


def _stacked_tree(cfg, n_obj, seed=0):
    """flax-style {layer: {kernel, bias}} with [N_obj, ...] numpy leaves."""
    rng = np.random.default_rng(seed)
    shapes = [(d, cfg.net_width) for d in k1.layer_dims(cfg, F_IN)]
    shapes += [(cfg.net_width, 1), (cfg.net_width, cfg.net_width)]
    shapes += [(cfg.net_width + F_C, cfg.net_width_condition), (cfg.net_width_condition, 3)]
    tree = {}
    for name, (fan_in, fan_out) in zip(_layer_names(cfg), shapes):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        tree[name] = {
            "kernel": rng.uniform(-lim, lim, size=(n_obj, fan_in, fan_out)).astype(np.float32),
            "bias": (rng.normal(size=(n_obj, fan_out)) * 0.1).astype(np.float32),
        }
    return tree


def _inputs(n_obj, b, s, seed=1):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(F_IN, b, s)).astype(np.float32)
    vd = rng.normal(size=(b, F_C)).astype(np.float32)
    hit = rng.integers(0, 2, size=(b, n_obj)).astype(np.float32)
    return enc, vd, hit


def _torch_ops(tree, cfg):
    t = {n: {k: torch.from_numpy(v) for k, v in leaves.items()} for n, leaves in tree.items()}
    return k1.mlp_params(t, cfg)


@pytest.mark.parametrize("n_obj", [2, 3])
def test_plain_k3_matches_pallas_interpret(n_obj):
    cfg, jcfg = MLPConfig(**SHAPE), JMLPConfig(**SHAPE)
    tree = _stacked_tree(cfg, n_obj)
    b, s = 20, 8  # 160 samples: not a multiple of the 128-sample tile
    enc, vd, hit = _inputs(n_obj, b, s)
    j_rgb, j_den = j_apply(
        {n: {k: jnp.asarray(v) for k, v in l.items()} for n, l in tree.items()},
        jcfg, jnp.asarray(enc), jnp.asarray(vd), jnp.asarray(hit), jnp.bfloat16,
        tile=128, interpret=True,
    )
    t_rgb, t_den = k3.obj_mlps_apply(
        _torch_ops(tree, cfg), cfg, torch.from_numpy(enc), torch.from_numpy(vd),
        torch.from_numpy(hit), torch.bfloat16,
    )
    assert t_rgb.shape == (3, b, s) and t_den.shape == (1, b, s)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), atol=2e-2)
    np.testing.assert_allclose(t_den.numpy(), np.asarray(j_den), atol=2e-2)


def test_plain_k3_matches_masked_blend_path():
    """hit * MLP(hit*x + (1-hit)*c0) == hit * MLP(x) for a 0/1 mask: K3's
    plain version equals the batched masked-blend path of the port's
    stacked NerfMLP (the model's path without kernels)."""
    n_obj = 2
    cfg = MLPConfig(**SHAPE)
    tree = _stacked_tree(cfg, n_obj, seed=4)
    enc, vd, hit = _inputs(n_obj, 6, 5, seed=5)
    mlp = NerfMLP(cfg, F_IN, F_C, "bfloat16", num_stack=n_obj)
    mlp.load_state_dict(
        {f"layers.{n}.{k}": torch.from_numpy(v) for n, l in tree.items() for k, v in l.items()}
    )
    enc_t, vd_t, hit_t = (torch.from_numpy(a) for a in (enc, vd, hit))
    fill = torch.from_numpy(np.random.default_rng(6).normal(size=(F_IN, 1, 1)).astype(np.float32))
    with torch.no_grad():
        rgb_o, den_o = mlp(enc_t, vd_t, hit_t.T[..., None], fill)
        hit_fm = hit_t.T[:, None, :, None]
        ref_rgb, ref_den = (hit_fm * rgb_o).sum(0), (hit_fm * den_o).sum(0)
        # bf16-rounded condition rows, as obj_mlps_apply feeds the kernel
        t_rgb, t_den = k3.obj_mlps_apply(
            mlp.operands(), cfg, enc_t, vd_t, hit_t, torch.bfloat16
        )
    np.testing.assert_allclose(t_rgb.numpy(), ref_rgb.numpy(), atol=2e-2)
    np.testing.assert_allclose(t_den.numpy(), ref_den.numpy(), atol=2e-2)
