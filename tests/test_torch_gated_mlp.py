"""K5/K6, the MLP with its input gated in the kernel, on the CPU.

  * fused_nerf_mlp_gated's plain version (values) and the plain backward
    behind its autograd Function (the gradients of x, gate, fill, the
    condition and every weight) against the JAX package's
    fused_nerf_mlp_gated in interpret mode, as tests/test_pallas_mlp.py
    runs it, on bf16-representable inputs and a gate that is not only 0/1;
  * the stacked NerfMLP with pallas_gate_in_kernel against the JAX
    package's nn.vmap'd NerfMLP with the same switch, built here;
  * which route a NerfMLP call takes;
  * a replay of K6's gate epilogue (csrc/mlp_obj.cuh, TAG 6) through the
    layouts the kernel writes (per-sample dgate, dfill partials per tile in
    the persistent blocks' order, summed in a fixed order), GateEpilogue,
    which test_torch_narrow_layout.py also runs on the replayed walk;
  * that profile.py counts the launches of K5's and K6's builds as theirs.

Tolerances: values atol 2e-2, gradients atol 8e-2 / rtol 2e-2 (bf16
operands, float32 sums in other orders; test_pallas_mlp.py:51,81); the
replay relative L2 1e-5 (the same float32 arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.models.mlp import NerfMLP as JNerfMLP
from durf_tpu.ops.pallas.fused_mlp import fused_nerf_mlp_gated as j_gated
from durf_tpu.ops.pallas.fused_mlp import mlp_params_from_flax
from durf_tpu_torch import profile
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.models.mlp import NerfMLP
from durf_tpu_torch.ops.kernels import fused_mlp as k1

F_IN, F_C = 63, 27
VALUE_TOL = dict(atol=2e-2, rtol=0.0)
GRAD_TOL = dict(atol=8e-2, rtol=2e-2)


def _bf16(a):
    """numpy float32 values that bf16 represents exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def single():
    shape = dict(net_depth=6, net_width=32, net_width_condition=16)
    rng = np.random.default_rng(0)
    n = 96
    x = _bf16(rng.normal(size=(n, F_IN)))
    cond = rng.normal(size=(n, F_C)).astype(np.float32)
    gate = rng.choice(np.array([0.0, 1.0, 0.25, 0.7], np.float32), size=(n, 1))
    fill = _bf16(rng.normal(size=(1, F_IN)))
    cot = (rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 1)).astype(np.float32))
    mlp = JNerfMLP(JMLPConfig(**shape), compute_dtype=jnp.bfloat16)
    variables = mlp.init(jax.random.key(0), jnp.asarray(x)[:, None, :], jnp.asarray(cond))
    weights = [np.array(w) for w in mlp_params_from_flax(variables["params"], JMLPConfig(**shape))]
    return shape, x, cond, gate, fill, weights, cot


def test_plain_gated_matches_pallas_interpret_values_and_grads(single):
    shape, x, cond, gate, fill, weights, (c_rgb, c_den) = single
    jcfg, cfg = JMLPConfig(**shape), MLPConfig(**shape)

    def j_loss(w, x_, g_, f_, c_):
        rgb, den = j_gated(x_, g_, f_, c_, w, jcfg, 32, True)
        return jnp.sum(rgb * c_rgb) + jnp.sum(den * c_den), (rgb, den)

    (j_val, (j_rgb, j_den)), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        [jnp.asarray(w) for w in weights], *(jnp.asarray(a) for a in (x, gate, fill, cond))
    )
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in (x, gate, fill, cond)]
    t_w = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    rgb, den = k1.fused_nerf_mlp_gated(t_in[0], t_in[1], t_in[2], t_in[3], t_w, cfg)
    ref = k1.fused_nerf_mlp_gated_reference(*(t.detach() for t in t_in[:3]), t_in[3].detach(),
                                            [w.detach() for w in t_w], cfg)
    assert torch.equal(rgb.detach(), ref[0]) and torch.equal(den.detach(), ref[1])
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb), **VALUE_TOL)
    np.testing.assert_allclose(den.detach().numpy(), np.asarray(j_den), **VALUE_TOL)
    loss = (rgb * torch.from_numpy(c_rgb)).sum() + (den * torch.from_numpy(c_den)).sum()
    loss.backward()
    j_w, *j_in = j_grads
    for name, t, jg in zip(("dx", "dgate", "dfill", "dcond"), t_in, j_in):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), err_msg=name, **GRAD_TOL)
    for i, (t, jg) in enumerate(zip(t_w, j_w)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), err_msg=f"operand {i}", **GRAD_TOL)


def test_gated_cpu_tensors_take_the_plain_version_uncounted(single):
    shape, x, cond, gate, fill, weights, _ = single
    w = [torch.from_numpy(a) for a in weights]
    args = (torch.from_numpy(x), torch.from_numpy(gate), torch.from_numpy(fill), torch.from_numpy(cond))
    rgb, den = k1.fused_nerf_mlp_gated(*args, w, MLPConfig(**shape))
    ref = k1.fused_nerf_mlp_gated_reference(*args, w, MLPConfig(**shape))
    assert torch.equal(rgb, ref[0]) and torch.equal(den, ref[1])
    assert k1.fused_nerf_mlp_gated.launches == 0 and k1.fused_nerf_mlp_gated_bwd.launches == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k1.fused_nerf_mlp_gated(*(a.to("meta") for a in args), [t.to("meta") for t in w],
                                MLPConfig(**shape))


SMALL = dict(net_depth=4, net_width=32, net_width_condition=16, skip_layer=2)
N_OBJ, B, S = 2, 6, 8


def _stack_inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    vd = rng.normal(size=(B, F_C)).astype(np.float32)
    gate = rng.integers(0, 2, size=(N_OBJ, B, 1)).astype(np.float32)
    fill = rng.normal(size=(1, 1, F_IN)).astype(np.float32)
    return x, vd, gate, fill


def _stack_cotangents(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_OBJ, B, S, 3)).astype(np.float32),
            rng.normal(size=(N_OBJ, B, S, 1)).astype(np.float32))


@pytest.fixture(scope="module")
def stacked():
    """The JAX package's vmapped NerfMLP with the gate in the kernel: its
    params, outputs and gradients (x and every weight) of <rgb, c_rgb> +
    <density, c_den> for fixed random cotangents."""
    x, vd, gate, fill = _stack_inputs()
    c_rgb, c_den = _stack_cotangents()
    vm = fnn.vmap(
        JNerfMLP,
        in_axes=(None, None, 0, None, None, None),
        out_axes=0,
        variable_axes={"params": 0},
        split_rngs={"params": True},
    )(JMLPConfig(**SMALL), compute_dtype=jnp.bfloat16, use_pallas=True, pallas_gate_in_kernel=True,
      pallas_tile=64)
    args = tuple(jnp.asarray(a) for a in (x, vd, gate, fill))
    variables = vm.init(jax.random.key(0), *args, False, False)

    def loss(params, x_):
        rgb, den = vm.apply({"params": params}, x_, args[1], args[2], args[3], False, False)
        return jnp.sum(rgb * c_rgb) + jnp.sum(den * c_den), (rgb, den)

    (_, (rgb, den)), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], args[0]
    )
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return as_np(variables["params"]), np.asarray(rgb), np.asarray(den), as_np(g_params), np.asarray(g_x)


def _port_stack(tree, use_kernel):
    m = NerfMLP(MLPConfig(**SMALL), F_IN, F_C, "bfloat16", use_kernel, N_OBJ,
                pallas_gate_in_kernel=True)
    m.load_state_dict({f"layers.{n}.{k}": torch.from_numpy(np.array(v)) for n, l in tree.items()
                       for k, v in l.items()})
    return m


@pytest.mark.parametrize("use_kernel", [True, False])
def test_stacked_gated_nerf_mlp_matches_vmapped_jax(stacked, use_kernel):
    """Row-major in and out: with use_kernel the K5/K6 route (its plain
    versions here), without it the blend-then-plain route; both against the
    JAX package's vmapped in-kernel gate."""
    tree, j_rgb, j_den, j_gparams, j_gx = stacked
    x, vd, gate, fill = (torch.from_numpy(a) for a in _stack_inputs())
    m = _port_stack(tree, use_kernel)
    xt = x.clone().requires_grad_(True)
    rgb, den = m(xt, vd, gate, fill, x_feature_major=False, out_feature_major=False)
    assert rgb.shape == (N_OBJ, B, S, 3) and den.shape == (N_OBJ, B, S, 1)
    np.testing.assert_allclose(rgb.detach().numpy(), j_rgb, **VALUE_TOL)
    np.testing.assert_allclose(den.detach().numpy(), j_den, **VALUE_TOL)
    c_rgb, c_den = (torch.from_numpy(a) for a in _stack_cotangents())
    ((rgb * c_rgb).sum() + (den * c_den).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), j_gx, err_msg="dx", **GRAD_TOL)
    for name, p in m.named_parameters():
        _, layer, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(), j_gparams[layer][leaf], err_msg=name, **GRAD_TOL)


def test_nerf_mlp_routes(monkeypatch, stacked):
    """The in-kernel gate takes only a gated, row-major call of a kernel
    module with pallas_gate_in_kernel; other gated calls blend first and
    run K1; a feature-major call gives the row-major result transposed."""
    tree = stacked[0]
    calls = []
    for name in ("fused_nerf_mlp_gated", "fused_nerf_mlp"):
        real = getattr(k1, name)
        monkeypatch.setattr(k1, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    x, vd, gate, fill = (torch.from_numpy(a) for a in _stack_inputs())
    m = _port_stack(tree, True)
    with torch.no_grad():
        row = m(x, vd, gate, fill, x_feature_major=False, out_feature_major=False)
        assert calls == ["fused_nerf_mlp_gated"] * N_OBJ
        calls.clear()
        fm = m(x.permute(2, 0, 1), vd, gate, fill)
        assert calls == ["fused_nerf_mlp"] * N_OBJ
        m.pallas_gate_in_kernel = False
        calls.clear()
        off = m(x, vd, gate, fill, x_feature_major=False, out_feature_major=False)
        assert calls == ["fused_nerf_mlp"] * N_OBJ
    np.testing.assert_allclose(fm[0].permute(0, 2, 3, 1).numpy(), row[0].numpy(), **VALUE_TOL)
    np.testing.assert_allclose(off[0].numpy(), row[0].numpy(), **VALUE_TOL)


class GateEpilogue:
    """K6's gate epilogue (csrc/mlp_obj.cuh gate_epilogue) on the tiles the
    tile kernel walks, and feature_sum_kernel, over the buffers they
    address: dgate [n] and dfill_part [in_dim * tiles] (element f * tiles +
    tile, or `index(tile, block)`), both from NaN.

    A call takes one tile's dxe, dxa [128, 64 xc] (the x-parts' summed
    products, columns past in_dim holding the next pack rows' products),
    and returns dxa scaled by the rows' gates, the dx rows the kernel
    stores. The sums run in the kernel's order: a thread owns rows 64 wg +
    16 w + k + 8 i (i = 0, 1; k = lane / 4) and the columns 64 c + 8 j + 2 q
    + e (q = lane % 4); dgate adds the thread's columns in order, then the
    quad (xor 1, 2); dfill the thread's two rows, the lanes sharing q (xor
    4, 8, 16), then the 8 warps in order."""

    def __init__(self, x_rows, gate, fill_row, s_per_ray, index=lambda tile, block: tile):
        self.n, self.in_dim = x_rows.shape
        self.tiles = -(-self.n // 128)
        self.x, self.fill = x_rows, fill_row
        self.g = gate.repeat_interleave(s_per_ray)
        self.index = index
        self.dgate = torch.full((self.n,), float("nan"))
        self.part = torch.full((self.in_dim * self.tiles,), float("nan"))

    def __call__(self, tile0, dxa, block=None):
        n, in_dim = self.n, self.in_dim
        rows = torch.arange(tile0, tile0 + 128)
        valid = rows < n
        rc = torch.clamp(rows, max=n - 1)
        g = torch.where(valid, self.g[rc], torch.zeros(()))
        omg = torch.where(valid, 1 - self.g[rc], torch.zeros(()))
        x = torch.where(valid[:, None], self.x[rc], torch.zeros(()))
        p = torch.zeros((128, 4))  # dgate partials per (row, q)
        for c in range(dxa.shape[1] // 64):
            for j in range(8):
                for e in range(2):
                    f = 64 * c + 8 * j + 2 * torch.arange(4) + e
                    ok = (f < in_dim)[None, :] & valid[:, None]
                    fc = torch.clamp(f, max=in_dim - 1)
                    p = p + torch.where(ok, (x[:, fc] - self.fill[fc]) * dxa[:, f], torch.zeros(()))
        p = p + p[:, [1, 0, 3, 2]]
        p = p + p[:, [2, 3, 0, 1]]
        self.dgate[rows[valid]] = p[valid, 0]
        # [wg, warp, i, k, column]: row 64 wg + 16 warp + 8 i + k
        w = (omg[:, None] * dxa).reshape(2, 4, 2, 8, -1)
        v = w[:, :, 1] + w[:, :, 0]
        for bit in (1, 2, 4):
            v = v + v[:, :, torch.arange(8) ^ bit]
        v = v[:, :, 0].reshape(8, -1)
        s = v[0]
        for k in range(1, 8):
            s = s + v[k]
        tile = tile0 // 128
        at = self.index(tile, block) + self.tiles * torch.arange(in_dim)
        self.part[at] = s[:in_dim]
        return dxa * g[:, None]

    def dfill(self):
        """feature_sum_kernel: 256 threads, strided over the tiles, then a
        shared-memory tree."""
        assert not torch.isnan(self.part).any(), "a partial no tile writes"
        out = torch.empty(self.in_dim)
        for f in range(self.in_dim):
            red = torch.zeros(256)
            for t in range(self.tiles):
                red[t % 256] += self.part[f * self.tiles + t]
            w = 128
            while w > 0:
                red[:w] = red[:w] + red[w : 2 * w]
                w //= 2
            out[f] = red[0]
        return out


def _replay_persistent(epi, dxe_rows, grid):
    """The tile kernel's persistent blocks (block b walks tiles b, b + grid,
    ...) running the gate epilogue on dxe [n, in_dim]. Returns dx [n,
    in_dim]."""
    n, in_dim = dxe_rows.shape
    dx = torch.full((n, in_dim), float("nan"))
    for block in range(grid):
        for tile in range(block, epi.tiles, grid):
            r0, r1 = 128 * tile, min(n, 128 * tile + 128)
            dxa = torch.zeros((128, 64 * -(-in_dim // 64)))
            dxa[: r1 - r0, :in_dim] = dxe_rows[r0:r1]
            dx[r0:r1] = epi(128 * tile, dxa, block)[: r1 - r0, :in_dim]
    return dx


def test_k6_gate_epilogue_layout_replay_matches_plain_backward():
    cfg = MLPConfig(**SMALL)
    in_dim, b, s = 21, 37, 9  # 333 samples: three tiles, the last one partial
    rng = np.random.default_rng(7)
    m = NerfMLP(cfg, in_dim, F_C)
    m.reset_parameters(torch.Generator().manual_seed(2))
    w = [t.detach() for t in m.operands()]
    x = torch.from_numpy(rng.normal(size=(b * s, in_dim)).astype(np.float32))
    gate = torch.from_numpy(rng.choice(np.array([0.0, 1.0, 0.25, 0.7], np.float32), size=(b,)))
    fill = torch.from_numpy(rng.normal(size=(in_dim,)).astype(np.float32))
    cond_lin = torch.from_numpy(rng.normal(size=(b, cfg.net_width_condition)).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(size=(b * s, 3)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(b * s, 1)).astype(np.float32))
    dx, dgate, dfill, dcond, grads = k1.fused_nerf_mlp_gated_bwd_reference(
        x, gate, fill, cond_lin, w, cfg, s, g_rgb, g_den
    )
    # The reverse walk's dxe (K2's dataflow, replayed in test_torch_narrow_layout.py)
    # on the blended input K5 saves.
    xe = k1.gated_blend(x, gate, fill, s)
    dxe, _, _ = k1.split_matmul_backward(cfg, xe, cond_lin.repeat_interleave(s, 0), w, g_rgb, g_den)
    x_rows = x.to(torch.bfloat16).float()
    fill_row = fill.to(torch.bfloat16).float()
    # Two persistent blocks: block 0 walks tiles 0 and 2.
    epi = GateEpilogue(x_rows, gate, fill_row, s)
    r_dx = _replay_persistent(epi, dxe, grid=2)
    rel = lambda a, c: float((a - c).norm() / c.norm())  # noqa: E731
    assert rel(r_dx, dx) < 1e-5
    assert rel(epi.dgate.reshape(b, s).sum(1), dgate) < 1e-5  # the wrapper's per-ray sum
    assert rel(epi.dfill(), dfill) < 1e-5
    # Partials indexed by block, not tile: block 0's second tile overwrites
    # its first, and tile 2's slot stays unwritten.
    by_block = GateEpilogue(x_rows, gate, fill_row, s, index=lambda tile, block: block)
    _replay_persistent(by_block, dxe, grid=2)
    with pytest.raises(AssertionError, match="no tile writes"):
        by_block.dfill()


@pytest.mark.parametrize("kernel,group", [
    ("void durf::obj::obj_mlp_fwd_kernel<5, 1>(float const*, float const*)", "K5"),
    ("void durf::obj::obj_mlp_fwd_kernel<1, 1>(float const*, float const*)", "K1"),
    ("void durf::obj::obj_mlp_fwd_kernel<3, 2>(float const*, float const*)", "K3"),
    ("void durf::obj::obj_mlp_bwd_kernel<6, 1>(float const*, float const*)", "K6"),
    ("void durf::obj::obj_mlp_bwd_kernel<2, 1>(float const*, float const*)", "K2"),
    ("void durf::wide::wide_dw_kernel<6, false>(long long const*, int)", "K6"),
    ("void durf::wide::wide_dw_kernel<4, true>(long long const*, int)", "K4"),
    ("void durf::reduce_kernel<6>(float const*, int, long long, float*)", "K6"),
    ("void durf::ray_sum_kernel<6>(__nv_bfloat16 const*, long long)", "K6"),
    ("void durf::feature_sum_kernel<6>(float const*, int, float*)", "K6"),
])
def test_profile_names_the_gated_kernels_launches(kernel, group):
    """profile.py counts each launch of K5's and K6's builds as theirs: the
    object kernels' TAG 5 and 6, and K6's dW, reduction, ray and d fill
    sums; TAG 5 is not K1's, TAG 6 not K2's."""
    assert profile.group_of(kernel) == group
