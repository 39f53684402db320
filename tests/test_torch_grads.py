"""The K2 and K4 autograd Functions (durf_tpu_torch.ops.kernels) against the
JAX package's fused Pallas MLPs in interpret mode, with the same numpy
weights, inputs and output cotangents on both sides; and the explicit plain
backward against autograd of the plain forward.

On CPU tensors the Functions run their plain forward and backward, which
carry the CUDA kernels' rounding points. Tolerances are those of the JAX
package's own gradient tests: atol 8e-2 / rtol 2e-2 on weight gradients and
5e-2 / 1e-2 on the input and condition gradients (test_pallas_mlp.py:78-81)
for K2, atol 1.2e-1 / rtol 2e-2 for K4 (test_obj_kernel.py:106-108): bf16
operands on both sides, but the port also rounds every cotangent to bf16
as the TPU kernel does, while JAX on the CPU keeps them in float32, and a
relu whose pre-activation lands near 0 can flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.ops.pallas.fused_mlp import fused_nerf_mlp as j_fused
from durf_tpu.ops.pallas.obj_mlp import obj_mlps_apply as j_obj_apply
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import obj_mlp as k3

F_C = 27


def _shapes(cfg, in_dim):
    shapes = [(d, cfg.net_width) for d in k1.layer_dims(cfg, in_dim)]
    shapes += [(cfg.net_width, 1), (cfg.net_width, cfg.net_width)]
    shapes += [(cfg.net_width + F_C, cfg.net_width_condition)]
    shapes += [(cfg.net_width_condition,) * 2] * (cfg.net_depth_condition - 1)
    shapes += [(cfg.net_width_condition, 3)]
    return shapes


def _weights(cfg, in_dim, n_obj=None, seed=0):
    """Operand list (mlp_params order) of float32 numpy arrays, stacked
    [n_obj, ...] when n_obj is given."""
    rng = np.random.default_rng(seed)
    lead = () if n_obj is None else (n_obj,)
    ops = []
    for fan_in, fan_out in _shapes(cfg, in_dim):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        ops.append(rng.uniform(-lim, lim, size=lead + (fan_in, fan_out)).astype(np.float32))
        ops.append((rng.normal(size=lead + (fan_out,)) * 0.1).astype(np.float32))
    return ops


def _names(cfg):
    return (
        [f"trunk_{i}" for i in range(cfg.net_depth)]
        + ["density_head", "bottleneck"]
        + [f"head_{i}" for i in range(cfg.net_depth_condition)]
        + ["rgb_head"]
    )


def _leaf(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)


K2_SHAPE = dict(net_depth=8, net_width=64, net_width_condition=32)  # test_pallas_mlp.py:20-24
K2_IN, K2_RAYS, K2_S = 63, 12, 8


@pytest.fixture(scope="module")
def k2_case():
    """JAX's gradients through the fused Pallas MLP (interpret mode) and
    the port's through FusedNerfMlpFn, computed once for the module."""
    cfg, jcfg = MLPConfig(**K2_SHAPE), JMLPConfig(**K2_SHAPE)
    w = _weights(cfg, K2_IN)
    rng = np.random.default_rng(1)
    n = K2_RAYS * K2_S
    x = rng.normal(size=(n, K2_IN)).astype(np.float32)
    cond = rng.normal(size=(K2_RAYS, F_C)).astype(np.float32)
    c_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    c_den = rng.normal(size=(n, 1)).astype(np.float32)

    def j_loss(w_, x_, c_):
        rgb, den = j_fused(x_, c_, w_, jcfg, 32, True)
        return jnp.sum(rgb * c_rgb) + jnp.sum(den * c_den)

    cond_ps = np.repeat(cond, K2_S, axis=0)  # the JAX kernel takes per-sample rows
    jw, jx, jc = jax.grad(j_loss, argnums=(0, 1, 2))(
        [jnp.asarray(a) for a in w], jnp.asarray(x), jnp.asarray(cond_ps)
    )
    tw, tx, tc = [_leaf(a) for a in w], _leaf(x.T), _leaf(cond)
    rgb, den = k1.fused_nerf_mlp(tx, tc, tw, cfg, K2_S)
    loss = (rgb * torch.from_numpy(c_rgb.T)).sum() + (den * torch.from_numpy(c_den.T)).sum()
    loss.backward()
    j_out = dict(x=np.asarray(jx), cond=np.asarray(jc).reshape(K2_RAYS, K2_S, F_C).sum(1),
                 w=[np.asarray(g) for g in jw])
    t_out = dict(x=tx.grad.T.numpy(), cond=tc.grad.numpy(), w=[t.grad.numpy() for t in tw])
    return cfg, j_out, t_out


def test_k2_input_and_condition_grads_match_jax(k2_case):
    _, j, t = k2_case
    np.testing.assert_allclose(t["x"], j["x"], atol=5e-2, rtol=1e-2)
    np.testing.assert_allclose(t["cond"], j["cond"], atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("layer", _names(MLPConfig(**K2_SHAPE)))
def test_k2_weight_grads_match_jax(k2_case, layer):
    cfg, j, t = k2_case
    i = _names(cfg).index(layer)
    for leaf in (2 * i, 2 * i + 1):
        assert t["w"][leaf].shape == j["w"][leaf].shape
        np.testing.assert_allclose(t["w"][leaf], j["w"][leaf], atol=8e-2, rtol=2e-2,
                                   err_msg=f"{layer} operand {leaf}")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_plain_backward_matches_autograd(dtype, tol):
    """fused_nerf_mlp_bwd_reference (the explicit vjp with K2's rounding
    points) against autograd of the plain split-matmul forward: equal in
    float32 (1e-5), within K2's card tolerance (relative L2 2e-2) in bf16,
    where the explicit form also rounds cotangents."""
    cfg = MLPConfig(net_depth=6, net_width=32, net_width_condition=16, net_depth_condition=2)
    b, s = 5, 7
    w = [_leaf(a) for a in _weights(cfg, 60, seed=2)]
    rng = np.random.default_rng(3)
    x = _leaf(rng.normal(size=(60, b * s)))
    cond_lin = _leaf(rng.normal(size=(b, cfg.net_width_condition)))
    g_rgb = torch.from_numpy(rng.normal(size=(3, b * s)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(1, b * s)).astype(np.float32))
    rgb, den = k1.split_matmul_forward(cfg, x.T, cond_lin.repeat_interleave(s, 0), w, dtype)
    auto = torch.autograd.grad((rgb * g_rgb.T).sum() + (den * g_den.T).sum(), [x, cond_lin] + w)
    dx, dcond, grads = k1.fused_nerf_mlp_bwd_reference(
        x.detach(), cond_lin.detach(), [t.detach() for t in w], cfg, s, g_rgb, g_den, dtype
    )
    h0 = k1.head0_index(cfg)
    for i, (a, ref) in enumerate(zip([dx, dcond] + grads, auto)):
        if i - 2 == h0:  # the Function leaves head_0's condition rows to autograd
            ref = torch.cat([ref[: cfg.net_width], torch.zeros_like(ref[cfg.net_width :])])
        assert _rel(a, ref) <= tol, f"output {i}: {_rel(a, ref)}"


K4_SHAPE = dict(net_depth=4, net_width=32, net_width_condition=32)  # test_obj_kernel.py:22-24
K4_IN, K4_RAYS, K4_S = 63, 40, 4


@pytest.mark.parametrize("n_obj", [2, 4])
def test_k4_grads_match_jax(n_obj):
    cfg, jcfg = MLPConfig(**K4_SHAPE), JMLPConfig(**K4_SHAPE)
    w = _weights(cfg, K4_IN, n_obj, seed=4)
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(K4_IN, K4_RAYS, K4_S)).astype(np.float32)
    cond = rng.normal(size=(K4_RAYS, F_C)).astype(np.float32)
    hit = rng.integers(0, 2, size=(K4_RAYS, n_obj)).astype(np.float32)
    c_rgb = rng.normal(size=(3, K4_RAYS, K4_S)).astype(np.float32)
    c_den = rng.normal(size=(1, K4_RAYS, K4_S)).astype(np.float32)
    names = _names(cfg)

    def j_loss(tree, enc_, cond_):
        rgb, den = j_obj_apply(tree, jcfg, enc_, cond_, jnp.asarray(hit), jnp.bfloat16,
                               tile=128, interpret=True)
        return jnp.sum(rgb * c_rgb) + jnp.sum(den * c_den)

    tree = {n: {"kernel": jnp.asarray(w[2 * i]), "bias": jnp.asarray(w[2 * i + 1])}
            for i, n in enumerate(names)}
    jt, je, jc = jax.grad(j_loss, argnums=(0, 1, 2))(tree, jnp.asarray(enc), jnp.asarray(cond))

    tw, te, tc = [_leaf(a) for a in w], _leaf(enc), _leaf(cond)
    rgb, den = k3.obj_mlps_apply(tw, cfg, te, tc, torch.from_numpy(hit), torch.bfloat16)
    ((rgb * torch.from_numpy(c_rgb)).sum() + (den * torch.from_numpy(c_den)).sum()).backward()

    tol = dict(atol=1.2e-1, rtol=2e-2)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(je), err_msg="enc", **tol)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), err_msg="cond", **tol)
    for i, name in enumerate(names):
        for j, leaf in enumerate(("kernel", "bias")):
            np.testing.assert_allclose(tw[2 * i + j].grad.numpy(), np.asarray(jt[name][leaf]),
                                       err_msg=f"{name}.{leaf}", **tol)
