"""The backward kernels' workspace layouts, held on the CPU.

K2 and K4 (csrc/mlp_bwd.cuh) run only on the card, but everything they
address is built in Python: the saved-activation segments, the transposed
weight pack, the cotangent workspace, the weight-gradient job table and the
flat gradient layout. These tests replay the kernels' dataflow step by step
in PyTorch (the tile kernel's reverse walk, the dW jobs read through the
offsets of the job table, the per-ray sums) on exactly those buffers, and
hold the result against the plain backward. Same rounding points on both
sides; the tolerance (relative L2 1e-3) covers float32 sums in another order
landing on the other side of a bf16 rounding boundary.
"""

import types

import numpy as np
import pytest
import torch

from durf_tpu_torch.configs import MLPConfig, ModelConfig
from durf_tpu_torch.models.mlp import NerfMLP
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import obj_mlp as k3

F_C = 27


def _bf(t):
    return t.to(torch.bfloat16).float()


def _job_view(buf, off, ld, n, cols):
    """The [n][ld] rows a dW job reads at element `off` of `buf`, first
    `cols` columns, in float32."""
    return buf.reshape(-1)[off : off + n * ld].reshape(n, ld)[:, :cols].float()


def _emulate(x, hit, cond_lin, weights, cfg, s_per_ray, g_rgb, g_den):
    """The K2/K4 dataflow on the CPU through the kernels' own layouts."""
    in_dim, n = x.shape
    stacked = hit is not None
    n_obj = hit.shape[0] if stacked else 1
    ws = weights if stacked else [w[None] for w in weights]
    hit = hit if stacked else torch.ones((1, n // s_per_ray))
    cond_lin = cond_lin if stacked else cond_lin[None]
    w_, wc = cfg.net_width, cfg.net_width_condition
    d, dc = cfg.net_depth, cfg.net_depth_condition
    n_rgb, n_den = cfg.num_rgb_channels, cfg.num_density_channels

    # K1/K3 with save: x and the stored activations in their segments.
    x_save, act, act_offs, act_stride = k1.save_buffers(cfg, in_dim, n, n_obj, "cpu")
    x_save.zero_()
    x_save[:, :in_dim] = x.T.to(torch.bfloat16)
    for o in range(n_obj):
        rows = cond_lin[o].repeat_interleave(s_per_ray, 0)
        _, trunk, bneck, heads = k1.stored_activations(cfg, x.T, rows, [w[o] for w in ws])
        for seg, a in enumerate(trunk + [bneck] + heads):
            start = o * act_stride + act_offs[seg]
            act[start : start + a.numel()] = a.reshape(-1).to(torch.bfloat16)

    wpack, _, w_offs, _, w_stride, _ = k1.pack_weights(ws, cfg, "cpu")
    wt, wt_offs, wtx_offs, wt_stride = k1.pack_weights_t(ws, cfg, in_dim, "cpu")
    g_offs, g_stride = k1.g_layout(cfg, n)
    gbuf = torch.zeros((n_obj * g_stride,), dtype=torch.bfloat16)
    dx = torch.zeros((in_dim, n))

    def seg(buf, start, rows, cols):
        return buf[start : start + rows * cols].reshape(rows, cols).float()

    for o in range(n_obj):
        a_seg = lambda s_, width: seg(act, o * act_stride + act_offs[s_], n, width)  # noqa: E731
        wt_mat = lambda off, rows, cols: seg(wt, o * wt_stride + off, rows, cols)  # noqa: E731

        def put(l, v):
            gw = k1.g_widths(cfg)[l]
            start = o * g_stride + g_offs[l]
            gbuf[start : start + n * gw] = v.reshape(-1).to(torch.bfloat16)

        sc = hit[o].repeat_interleave(s_per_ray)[:, None]
        gr, gd = _bf(sc * g_rgb.T), _bf(sc * g_den.T)
        l_den, l_bn, l_h0 = d, d + 1, d + 2
        l_rgb = l_h0 + dc
        put(l_rgb, torch.nn.functional.pad(gr, (0, 8 - n_rgb)))
        put(l_den, torch.nn.functional.pad(gd, (0, 8 - n_den)))
        w_rgb = seg(wpack, o * w_stride + w_offs[l_rgb], wc, n_rgb)
        w_den = seg(wpack, o * w_stride + w_offs[l_den], w_, n_den)
        gs = _bf((gr @ w_rgb.T) * (a_seg(d + dc, wc) > 0))
        put(l_rgb - 1, gs)
        for i in range(dc - 1, 0, -1):
            gs = _bf((gs @ wt_mat(wt_offs[l_h0 + i], wc, wc)) * (a_seg(d + i, wc) > 0))
            put(l_h0 + i - 1, gs)
        gs = _bf(gs @ wt_mat(wt_offs[l_h0], wc, w_))
        put(l_bn, gs)
        v = gs @ wt_mat(wt_offs[l_bn], w_, w_) + gd @ w_den.T
        gs = _bf(v * (a_seg(d - 1, w_) > 0))
        put(d - 1, gs)
        for i in range(d - 1, -1, -1):
            if k1.reads_x(cfg, i):
                for c in range(-(-in_dim // 64)):
                    part = gs @ wt_mat(wtx_offs[i] + c * w_ * 64, w_, 64)
                    cols = min(64, in_dim - 64 * c)
                    dx[64 * c : 64 * c + cols] += part[:, :cols].T
            if i == 0:
                break
            gs = _bf((gs @ wt_mat(wt_offs[i], w_, w_)) * (a_seg(i - 1, w_) > 0))
            put(i - 1, gs)

    jobs, _, n_tiles = k1.job_table(cfg, in_dim, n, n_obj, "cpu")
    _, per_obj = k1.grad_layout(cfg, in_dim)
    flat = torch.full((n_obj * per_obj,), float("nan"))
    assert int(jobs[-1, 9] + jobs[-1, 10] * jobs[-1, 11]) == n_tiles
    for a_buf, a_off, lda, g_off, ldg, k, j, out, bias, _, _, _ in jobs.tolist():
        a = _job_view(x_save if a_buf == 0 else act, a_off, lda, n, k)
        g = _job_view(gbuf, g_off, ldg, n, j)
        flat[out : out + k * j] = (a.T @ g).reshape(-1)
        if bias >= 0:
            flat[bias : bias + j] = g.sum(0)
    assert not torch.isnan(flat).any(), "a gradient element no job writes"
    grads = k1.unpack_grads(flat, ws, cfg, in_dim, stacked=True)
    dcond = torch.stack([
        seg(gbuf, o * g_stride + g_offs[d + 2], n, wc).reshape(-1, s_per_ray, wc).sum(1)
        for o in range(n_obj)
    ])
    if not stacked:
        return dx, dcond[0], [t[0] for t in grads]
    return dx, dcond, grads


def _rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-12))


def _mlp(cfg, in_dim, stack, seed):
    m = NerfMLP(cfg, in_dim, F_C, num_stack=stack)
    gen = torch.Generator().manual_seed(seed)
    m.reset_parameters(gen)
    with torch.no_grad():
        for layer in m.layers.values():
            layer.bias.copy_(0.1 * torch.randn(layer.bias.shape, generator=gen))
    return [t.detach() for t in m.operands()]


SHAPES = [
    (dict(net_depth=6, net_width=32, net_width_condition=16), 60, 6, 8),
    (dict(net_depth=4, net_width=16, net_width_condition=8, net_depth_condition=2,
          skip_layer=2), 70, 3, 5),
]


@pytest.mark.parametrize("shape,in_dim,b,s", SHAPES)
def test_k2_layout_replay_matches_plain_backward(shape, in_dim, b, s):
    cfg = MLPConfig(**shape)
    w = _mlp(cfg, in_dim, None, 0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(in_dim, b * s)).astype(np.float32))
    cond_lin = torch.from_numpy(rng.normal(size=(b, cfg.net_width_condition)).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(size=(3, b * s)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(1, b * s)).astype(np.float32))
    ref = k1.fused_nerf_mlp_bwd_reference(x, cond_lin, w, cfg, s, g_rgb, g_den)
    emu = _emulate(x, None, cond_lin, w, cfg, s, g_rgb, g_den)
    assert _rel(emu[0], ref[0]) < 1e-3 and _rel(emu[1], ref[1]) < 1e-3
    for i, (a, r) in enumerate(zip(emu[2], ref[2])):
        assert a.shape == r.shape and _rel(a, r) < 1e-3, f"operand {i}: {_rel(a, r)}"


@pytest.mark.parametrize("n_obj", [2, 3])
def test_k4_layout_replay_matches_plain_backward(n_obj):
    cfg = MLPConfig(net_depth=6, net_width=32, net_width_condition=16)
    in_dim, b, s = 63, 7, 6
    w = _mlp(cfg, in_dim, n_obj, 2)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(in_dim, b * s)).astype(np.float32))
    hit = torch.from_numpy(rng.integers(0, 2, size=(n_obj, b)).astype(np.float32))
    cond_lin = _bf(torch.from_numpy(rng.normal(size=(n_obj, b, 16)).astype(np.float32)))
    g_rgb = torch.from_numpy(rng.normal(size=(3, b * s)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(1, b * s)).astype(np.float32))
    ref = k3.fused_obj_mlp_bwd_reference(x, hit, cond_lin, w, cfg, s, g_rgb, g_den)
    emu = _emulate(x, hit, cond_lin, w, cfg, s, g_rgb, g_den)
    assert _rel(emu[0], ref[0]) < 1e-3 and _rel(emu[1], ref[1]) < 1e-3
    for i, (a, r) in enumerate(zip(emu[2], ref[2])):
        assert a.shape == r.shape and _rel(a, r) < 1e-3, f"operand {i}: {_rel(a, r)}"


def test_dw_jobs_cover_every_gradient_once():
    """Each weight and bias element of the flat layout is written by exactly
    one job (the kernel never zeroes its output), and the table addresses its
    operands by offsets inside the workspace buffers."""
    cfg = MLPConfig()  # flagship background MLP: 8x256, skip at layer 5
    in_dim, n, n_obj = 60, 256, 2
    _, act_stride = k1.act_layout(cfg, n)
    act_offs, _ = k1.act_layout(cfg, n)
    g_offs, g_stride = k1.g_layout(cfg, n)
    rows, tiles = k1.dw_jobs(cfg, in_dim, n_obj, act_offs, act_stride, g_offs, g_stride,
                             k1.x_cols(cfg, in_dim))
    jobs = torch.tensor(rows)
    _, per_obj = k1.grad_layout(cfg, in_dim)
    count = torch.zeros(n_obj * per_obj, dtype=torch.int32)
    for a_buf, a_off, lda, g_off, ldg, k, j, out, bias, _, _, _ in rows:
        count[out : out + k * j] += 1
        if bias >= 0:
            count[bias : bias + j] += 1
        a_size = n * k1.x_cols(cfg, in_dim) if a_buf == 0 else n_obj * act_stride
        assert 0 <= a_off and a_off + n * lda <= a_size and k <= lda
        assert 0 <= g_off and g_off + n * ldg <= n_obj * g_stride and j <= ldg
    assert torch.equal(count, torch.ones_like(count))
    # one job per kernel layer, plus the skip layer's x rows, per object
    assert jobs.shape == (n_obj * (cfg.net_depth + 1 + 4), k1.JOB_FIELDS)
    assert tiles == int((jobs[:, 10] * jobs[:, 11]).sum())


@pytest.mark.parametrize(
    "what,widths,ok",
    [
        ("fused_mlp_bwd", (256, 128), True),
        ("fused_mlp_bwd", (128, 256), False),
        ("obj_mlp_bwd", (128, 128), True),
        ("obj_mlp_bwd", (256, 128), False),
        ("fused_mlp_bwd", (128, 128), True),
        ("fused_mlp_gated_bwd", (128, 128), True),
        ("fused_mlp_gated_bwd", (256, 128), False),
    ],
)
def test_backward_kernels_take_the_flagship_widths(what, widths, ok):
    """Each backward kernel is built for the widths of the flagship MLPs
    that run it: K2 the background MLP and, on the per-object route, the
    object MLPs; K4 and K6 the object MLPs. Others raise."""
    model = ModelConfig()
    flagship = {
        "fused_mlp_bwd": model.mlp, "obj_mlp_bwd": model.box_mlp, "fused_mlp_gated_bwd": model.box_mlp,
    }[what]
    assert (flagship.net_width, flagship.net_width_condition) in k1.BWD_WIDTHS[what]
    assert (model.box_mlp.net_width, model.box_mlp.net_width_condition) in k1.BWD_WIDTHS[what]
    cfg = MLPConfig(net_width=widths[0], net_width_condition=widths[1])
    if ok:
        k1.check_bwd_config(cfg, what)
    else:
        with pytest.raises(ValueError, match=what):
            k1.check_bwd_config(cfg, what)


def test_kernel_workspace_serves_one_backward():
    """The forward kernel's saved workspace is released by the backward that
    takes it; a second backward through the same op raises."""
    ctx = types.SimpleNamespace(residuals=("workspace",))
    assert k1.take_residuals(ctx, "fused_nerf_mlp") == ("workspace",)
    assert ctx.residuals is None
    with pytest.raises(RuntimeError, match="retain_graph"):
        k1.take_residuals(ctx, "fused_nerf_mlp")


def test_cpu_function_backward_repeats_under_retain_graph():
    """On CPU tensors the Functions run the plain backward, which keeps no
    workspace: two backwards through one graph give the same gradients."""
    cfg = MLPConfig(net_depth=4, net_width=16, net_width_condition=8)
    in_dim, b, s = 21, 3, 4
    w = [t.requires_grad_(True) for t in _mlp(cfg, in_dim, None, 4)]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(in_dim, b * s)).astype(np.float32))
    cond = torch.from_numpy(rng.normal(size=(b, F_C)).astype(np.float32))
    rgb, den = k1.fused_nerf_mlp(x, cond, w, cfg, s)
    loss = rgb.square().sum() + den.sum()
    first = torch.autograd.grad(loss, w, retain_graph=True)
    second = torch.autograd.grad(loss, w)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
