"""K1's plain version (durf_tpu_torch.ops.kernels.fused_mlp) against the JAX
package's fused Pallas MLP in interpret mode and its XLA reference forward.

Same numpy weights and inputs on both sides. bf16 tolerance atol 2e-2 (as
tests/test_pallas_mlp.py): the operands are rounded to bf16 on both sides,
but the float32 sums run in different orders, and through the relu layers a
pre-activation near zero can land on either side. net_depth=6 makes layer 5
re-read the input (the skip split).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.ops.pallas.fused_mlp import fused_nerf_mlp as j_fused, mlp_reference_forward
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.ops.kernels import fused_mlp as k1

F_IN, F_C = 60, 27
SHAPE = dict(net_depth=6, net_width=32, net_width_condition=16)


def _weights(cfg, in_dim, cond_dim, seed=0):
    """Operand list (mlp_params order) of numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    shapes = [(d, cfg.net_width) for d in k1.layer_dims(cfg, in_dim)]
    shapes += [(cfg.net_width, 1), (cfg.net_width, cfg.net_width)]
    shapes += [(cfg.net_width + cond_dim, cfg.net_width_condition)]
    shapes += [(cfg.net_width_condition, 3)]
    ops = []
    for fan_in, fan_out in shapes:
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        ops.append(rng.uniform(-lim, lim, size=(fan_in, fan_out)).astype(np.float32))
        ops.append((rng.normal(size=(fan_out,)) * 0.1).astype(np.float32))
    return ops


def _inputs(b, s, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(F_IN, b * s)).astype(np.float32)
    cond = rng.normal(size=(b, F_C)).astype(np.float32)
    return x, cond


@pytest.fixture(scope="module")
def setup():
    cfg = MLPConfig(**SHAPE)
    return cfg, JMLPConfig(**SHAPE), _weights(cfg, F_IN, F_C)


@pytest.mark.parametrize("b,s", [(8, 16), (7, 9)])  # N = 128 and N = 63
def test_plain_k1_matches_pallas_interpret(setup, b, s):
    cfg, jcfg, w = setup
    x, cond = _inputs(b, s)
    cond_ps = np.repeat(cond, s, axis=0)  # the JAX kernel takes a per-sample cond
    j_rgb, j_den = j_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(cond_ps, jnp.bfloat16),
        [jnp.asarray(a) for a in w], jcfg, 64, True, True, True,
    )
    t_rgb, t_den = k1.fused_nerf_mlp(
        torch.from_numpy(x), torch.from_numpy(cond), [torch.from_numpy(a) for a in w], cfg, s
    )
    assert t_rgb.shape == (3, b * s) and t_den.shape == (1, b * s)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), atol=2e-2)
    np.testing.assert_allclose(t_den.numpy(), np.asarray(j_den), atol=2e-2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_matmul_matches_xla_reference(setup, dtype):
    cfg, jcfg, w = setup
    b, s = 5, 6
    x, cond = _inputs(b, s, seed=2)
    cond_ps = np.repeat(cond, s, axis=0)
    j_rgb, j_den = mlp_reference_forward(
        jcfg, jnp.asarray(x), jnp.asarray(cond_ps), [jnp.asarray(a) for a in w],
        dtype=jnp.dtype(dtype), x_fm=True, out_fm=True,
    )
    tw = [torch.from_numpy(a) for a in w]
    tdt = getattr(torch, dtype)
    rows = k1.cond_linear(torch.from_numpy(cond), tw[k1.head0_index(cfg)], cfg, tdt)
    t_rgb, t_den = k1.split_matmul_forward(
        cfg, torch.from_numpy(x).T, rows.repeat_interleave(s, 0), tw, tdt
    )
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(t_rgb.T.numpy(), np.asarray(j_rgb), atol=atol)
    np.testing.assert_allclose(t_den.T.numpy(), np.asarray(j_den), atol=atol)


def test_pack_weights_layout(setup):
    cfg, _, w = setup
    tw = [torch.from_numpy(a) for a in w]
    wbuf, bbuf, w_offs, b_offs, w_stride, b_stride = k1.pack_weights(tw, cfg, "cpu")
    assert len(w_offs) == cfg.net_depth + cfg.net_depth_condition + 3
    assert all(o % 8 == 0 for o in w_offs)  # 16-byte aligned bf16 segments
    for (k, b), wo, bo in zip(k1.kernel_layers(tw, cfg), w_offs, b_offs):
        seg = wbuf[wo : wo + k.numel()].reshape(k.shape)
        assert torch.equal(seg, k.to(torch.bfloat16))
        assert torch.equal(bbuf[bo : bo + b.numel()], b)
    head0 = k1.kernel_layers(tw, cfg)[cfg.net_depth + 2][0]
    assert head0.shape == (cfg.net_width, cfg.net_width_condition)  # condition rows hoisted


@pytest.mark.parametrize(
    "shape,ok",
    [
        (dict(net_width=256, net_width_condition=128), True),
        (dict(net_width=128, net_width_condition=128), True),
        (dict(net_width=64, net_width_condition=128), False),
        (dict(net_width=256, net_width_condition=128, net_depth_condition=0), False),
    ],
)
def test_kernel_config_check(shape, ok):
    cfg = MLPConfig(**shape)
    if ok:
        k1.check_kernel_config(cfg, 63)
        assert k1.kernel_smem_bytes(cfg, 63) <= k1.SMEM_LIMIT
    else:
        with pytest.raises(ValueError):
            k1.check_kernel_config(cfg, 63)
