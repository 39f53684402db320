"""K1 and K2 at 128 / 128 (the object MLPs on the per-object route, the 4x128
proposal MLP), and K5 and K6 (the same MLP with its input gated in the
kernel), held on the CPU.

At that width K1 and K2 run the mask-free build of K3's and K4's kernels
(csrc/mlp_obj.cuh): one object on every tile, no hit mask, with K3's and
K4's plans for one object; K5 and K6 the same build with the gate (TAG 5
and 6). Those kernels run only on the card, but what the wrappers hand
them comes from Python. Here the C entry points are replaced by recorders
(no library is loaded, no kernel runs), the wrappers are called on CPU
tensors, and:

  * the plans they hand over (tensor maps, slice schedules, the dW split)
    are replayed through test_torch_obj_layout's replays of the object
    kernels' dataflow, from NaN workspaces, with a hit mask of ones (every
    tile runs its one object, every gate is 1: the mask-free walk), and
    held against fused_nerf_mlp_reference / fused_nerf_mlp_bwd_reference
    at relative L2 1e-3 and atol 2e-2 on forward outputs, as for K3/K4;
    K5's with its prologue (the blend, written to x_save) and K6's with its
    gate epilogue (test_torch_gated_mlp.GateEpilogue: per-sample dgate,
    per-tile dfill partials, dx scaled by g) against
    fused_nerf_mlp_gated_reference / fused_nerf_mlp_gated_bwd_reference;
  * a mutated plan (offset, plane, slice order) fails the replay;
  * the route: 128 / 128 hands the wgmma kernels a plan and no transposed
    pack (K5 and K6 too), 256 / 128 its wide plan; a width no build takes
    (hopper_mlp.BUILDS) raises before any entry point, as do other
    unsupported shapes, and a failed launch raises and counts nothing
    (there is no fallback);
  * the port's plain K1 and its backward match the JAX package's fused MLP
    in interpret mode at 8x128 and 4x128 (tolerances of
    test_torch_fused_mlp.py and tests/test_pallas_mlp.py:78-81).
"""

import contextlib
import copy
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_obj_layout as obj
import torch
from test_torch_gated_mlp import GateEpilogue

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.ops.pallas.fused_mlp import fused_nerf_mlp as j_fused
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.ops.kernels import build
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import hopper_mlp as hm
from durf_tpu_torch.ops.kernels import obj_mlp as k3

F_C = 27
B, S = 6, 40  # 240 samples: two tiles, the second ragged, rays across the tile edge
DEEP = MLPConfig(net_width=128)  # the object MLPs: 8x128, skip at layer 5
PROPOSAL = MLPConfig(net_depth=4, net_width=128)  # waymo_fast.gin's ProposalMLP
NARROW = [pytest.param(DEEP, 63, id="8x128"), pytest.param(PROPOSAL, 60, id="4x128")]
# Argument positions of the K2 / K6 entry point (fused_mlp.BWD_ARGTYPES).
K2_W, K2_JOBS_HOST, K2_CHUNK = 3, 10, 14


class _Entry:
    """A C entry point's stand-in: records its arguments, returns `err`."""

    def __init__(self, log, name, state):
        self.log, self.name, self.state = log, name, state
        self.argtypes = self.restype = None

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), self.name
        self.log.append((self.name, args))
        return self.state["err"]


class _Spy:
    def __init__(self, monkeypatch):
        self.log, self.state = [], {"err": 0}
        monkeypatch.setattr(build, "load", lambda lib: types.SimpleNamespace(
            **{name: _Entry(self.log, name, self.state) for name in (
                "durf_fused_nerf_mlp_fwd", "durf_fused_nerf_mlp_bwd",
                "durf_fused_nerf_mlp_gated_fwd", "durf_fused_nerf_mlp_gated_bwd",
                "durf_fused_obj_mlp_fwd")}))
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        # Four SMs: the dW split gives this small batch two splits.
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda d: types.SimpleNamespace(multi_processor_count=4))
        monkeypatch.setattr(k1, "stream_of", lambda d: 0)
        for fn in (k1.fused_nerf_mlp, k1.fused_nerf_mlp_bwd, k1.fused_nerf_mlp_gated,
                   k1.fused_nerf_mlp_gated_bwd, k3.fused_obj_mlp):
            monkeypatch.setattr(fn, "launches", 0)

    def last(self, name):
        calls = [args for n, args in self.log if n == name]
        assert calls, f"{name} was not called"
        return calls[-1]


@pytest.fixture
def spy(monkeypatch):
    return _Spy(monkeypatch)


def _plan(args):
    """(specs, slices) of the plan an entry point was handed, or None."""
    specs, n_specs, slices, n_slices = args[-5:-1]
    if n_specs == 0:
        return None
    return ([list(specs[9 * i : 9 * i + 9]) for i in range(n_specs)],
            [list(slices[4 * i : 4 * i + 4]) for i in range(n_slices)])


def _case(cfg, in_dim, seed=0):
    """x [F, N], cond [B, F_c], cond_lin, operand list, cotangents."""
    rng = np.random.default_rng(seed + 7)
    n = B * S
    w = [t[0] for t in obj._weights(cfg, in_dim, 1, seed, F_C)]
    x = torch.from_numpy(rng.uniform(-1, 1, size=(in_dim, n)).astype(np.float32))
    cond = torch.from_numpy(rng.uniform(-1, 1, size=(B, F_C)).astype(np.float32))
    cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
    g_rgb = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32))
    return x, cond, cond_lin, w, g_rgb, g_den


def _worst(errors) -> float:
    """The largest error, NaN (a row never written) counting as infinite."""
    return max(float("inf") if np.isnan(e) else e for e in errors)


def _fwd_errors(cfg, x, cond, cond_lin, w, plan):
    """The K1 replay of `plan` against the plain K1: (max abs error of the
    outputs, worst relative L2 error of the saved residuals)."""
    ones = torch.ones((1, B))
    rgb, den, x_save, act = obj._replay_k3(cfg, x, ones, cond_lin[None], [t[None] for t in w], S,
                                           plan=lambda *a: plan)
    ref_rgb, ref_den = k1.fused_nerf_mlp_reference(x, cond, w, cfg, S)
    out = _worst([float((rgb - ref_rgb).abs().max()), float((den - ref_den).abs().max())])
    xr, trunk, bneck, heads = k1.stored_activations(cfg, x.T, cond_lin.repeat_interleave(S, 0), w)
    offs, _ = k1.act_layout(cfg, x.shape[1])
    res = [obj._rel(x_save[:, : x.shape[0]].float(), xr)]
    res += [obj._rel(act[offs[seg] :][: a.numel()].reshape(a.shape).float(), a)
            for seg, a in enumerate(trunk + [bneck] + heads)]
    return out, _worst(res)


def _bwd_errors(cfg, x, cond_lin, w, g_rgb, g_den, plan, chunk):
    """The K2 replay of `plan` against the plain K2: the worst relative L2
    error over dx, d cond_lin and every gradient, and the dW coverage."""
    ones = torch.ones((1, B))
    dx, dcond, grads, count = obj._replay_k4(cfg, x, ones, cond_lin[None], [t[None] for t in w], S,
                                             g_rgb, g_den, chunk, plan=lambda *a: plan)
    ref_dx, ref_dcond, ref_grads = k1.fused_nerf_mlp_bwd_reference(x, cond_lin, w, cfg, S, g_rgb,
                                                                   g_den)
    errs = [obj._rel(dx, ref_dx), obj._rel(dcond[0], ref_dcond)]
    errs += [obj._rel(a[0], r) for a, r in zip(grads, ref_grads)]
    assert all(a[0].shape == r.shape for a, r in zip(grads, ref_grads))
    return _worst(errs), count


def _k1_k2_plans(spy, cfg, x, cond_lin, w, g_rgb, g_den):
    """The plans the K1 (saving) and K2 wrappers hand their entry points,
    and K2's dW chunk."""
    _, _, res = k1._k1_launch(x, cond_lin, w, cfg, S, save=True)
    k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, S)
    fwd, bwd = spy.last("durf_fused_nerf_mlp_fwd"), spy.last("durf_fused_nerf_mlp_bwd")
    return _plan(fwd), _plan(bwd), bwd[K2_CHUNK]


# ---- (a) the plans K1 and K2 hand over, replayed ----


@pytest.mark.parametrize("cfg,in_dim", NARROW)
def test_k1_128_plan_replays_the_forward(spy, cfg, in_dim):
    x, cond, cond_lin, w, g_rgb, g_den = _case(cfg, in_dim)
    fwd, _, _ = _k1_k2_plans(spy, cfg, x, cond_lin, w, g_rgb, g_den)
    out, res = _fwd_errors(cfg, x, cond, cond_lin, w, fwd)
    assert out < 2e-2 and res < 1e-3, (out, res)


@pytest.mark.parametrize("cfg,in_dim", NARROW)
def test_k2_128_plan_replays_the_backward(spy, cfg, in_dim):
    x, _, cond_lin, w, g_rgb, g_den = _case(cfg, in_dim, seed=1)
    _, bwd, chunk = _k1_k2_plans(spy, cfg, x, cond_lin, w, g_rgb, g_den)
    err, count = _bwd_errors(cfg, x, cond_lin, w, g_rgb, g_den, bwd, chunk)
    assert err < 1e-3, err
    # Every gradient element formed once per split (8x128: two splits).
    assert torch.equal(count, torch.ones_like(count))
    assert count.shape[0] == (2 if cfg is DEEP else 1)


def test_k1_k2_128_plans_are_the_object_plans_for_one_object(spy):
    """K1's and K2's plans at 128 / 128 are K3's and K4's for N_obj = 1: the
    same maps (the object count as the planes) and the same slices."""
    x, _, cond_lin, w, g_rgb, g_den = _case(DEEP, 63)
    fwd, bwd, _ = _k1_k2_plans(spy, DEEP, x, cond_lin, w, g_rgb, g_den)
    _, _, w_offs, _, w_stride, _ = k1.pack_weights(w, DEEP, "cpu")
    n = x.shape[1]
    assert fwd == tuple(hm.obj_fwd_plan(DEEP, 63, n, 1, w_offs, w_stride, k1.x_cols(DEEP, 63)))
    assert bwd == tuple(hm.obj_bwd_plan(DEEP, 63, n, 1, w_offs, w_stride, True))
    assert len(fwd[1]) == 20 and len(bwd[1]) == 22
    assert fwd[0][hm.O_ACT][4] == 10 and bwd[0][hm.OB_G][4] == 11


# ---- (b) a wrong plan fails ----


@pytest.mark.parametrize("mutation", ["offset", "plane", "order"])
def test_a_wrong_narrow_plan_fails_the_replay(spy, mutation):
    """A shifted weight offset, a wrong activation plane stride or two
    swapped slices break both replays."""
    cfg, in_dim = PROPOSAL, 60
    x, cond, cond_lin, w, g_rgb, g_den = _case(cfg, in_dim, seed=2)
    fwd, bwd, chunk = _k1_k2_plans(spy, cfg, x, cond_lin, w, g_rgb, g_den)

    def mutate(plan, wmap, amap):
        specs, slices = copy.deepcopy(plan)
        if mutation == "offset":  # one row of the pack further
            specs[wmap][1] += 128
            specs[wmap][3] -= 1
        elif mutation == "plane":  # activation planes one row short
            specs[amap][6] -= 128
        else:
            slices[0], slices[1] = slices[1], slices[0]
        return specs, slices

    out, res = _fwd_errors(cfg, x, cond, cond_lin, w, mutate(fwd, hm.O_W, hm.O_ACT))
    fwd_bad = not (out < 2e-2 and res < 1e-3)
    err, _ = _bwd_errors(cfg, x, cond_lin, w, g_rgb, g_den, mutate(bwd, hm.OB_W, hm.OB_ACT), chunk)
    assert fwd_bad and not err < 1e-3


# ---- (c) the route ----


def _mlp(widths, in_dim=60, depth=4):
    cfg = MLPConfig(net_depth=depth, net_width=widths[0], net_width_condition=widths[1])
    return cfg, [t[0] for t in obj._weights(cfg, in_dim, 1, 3, F_C)]


@pytest.mark.parametrize("widths,route", [
    ((128, 128), "wgmma, object kernels"), ((256, 128), "wgmma, wide kernels"),
])
def test_k1_takes_the_wgmma_kernels_at_128_and_256_by_128(spy, widths, route):
    cfg, w = _mlp(widths)
    n = B * S
    x = torch.rand((60, n))
    cond_lin = torch.rand((B, widths[1]))
    k1._k1_launch(x, cond_lin, w, cfg, S, save=True)
    args = spy.last("durf_fused_nerf_mlp_fwd")
    plan, wt = _plan(args), args[-6]
    if route == "wgmma, object kernels":  # no transposed pack: B is the forward pack
        assert wt is None and [m[0] for m in plan[0]] == [hm.XSAVE, hm.ACT, hm.W]
    else:  # B is the transposed pack
        assert wt is not None and plan[0][hm.F_ACT][0] == hm.ACT
        assert {m[0] for m in plan[0][3:]} == {hm.WT}
    assert k1.fused_nerf_mlp.launches == 1


def _refused_launch(kernel, widths):
    """A K1, K3 or K5 launch at `widths` and the launch counter it would
    bump."""
    cfg, w = _mlp(widths)
    n, wc = B * S, widths[1]
    if kernel == "K1":
        return (lambda: k1._k1_launch(torch.rand((60, n)), torch.rand((B, wc)), w, cfg, S, True),
                k1.fused_nerf_mlp)
    if kernel == "K3":
        ws = obj._weights(cfg, 60, 2, 3, F_C)
        return (lambda: k3._k3_launch(torch.rand((60, n)), torch.ones((2, B)), torch.rand((2, B, wc)),
                                      ws, cfg, S, True), k3.fused_obj_mlp)
    return (lambda: k1._k5_launch(torch.rand((n, 60)), torch.ones(B), torch.rand(60),
                                  torch.rand((B, wc)), w, cfg, S, True), k1.fused_nerf_mlp_gated)


@pytest.mark.parametrize("kernel,widths", [
    ("K1", (128, 256)), ("K1", (256, 256)), ("K3", (256, 128)), ("K5", (256, 128)),
])
def test_widths_no_build_takes_raise_before_any_entry_point(spy, kernel, widths):
    """Outside hopper_mlp.BUILDS a forward raises a ValueError that names
    the widths its pair is built for, calls no entry point and counts no
    launch: no other kernel stands in."""
    launch, counted = _refused_launch(kernel, widths)
    pair = {"K1": "K1/K2", "K3": "K3/K4", "K5": "K5/K6"}[kernel]
    named = f"{pair} is built for the widths (net_width, net_width_condition) in "
    with pytest.raises(ValueError, match=re.escape(f"{named}{tuple(hm.BUILDS[pair])}; got {widths}")):
        launch()
    assert spy.log == [] and counted.launches == 0


@pytest.mark.parametrize("widths", [(128, 128), (256, 128)])
def test_k2_takes_the_wgmma_kernels_without_a_transposed_pack(spy, widths):
    cfg, w = _mlp(widths)
    x = torch.rand((60, B * S))
    _, _, res = k1._k1_launch(x, torch.rand((B, widths[1])), w, cfg, S, save=True)
    k1.fused_nerf_mlp_bwd(res, torch.rand((3, B * S)), torch.rand((1, B * S)), w, cfg, S)
    args = spy.last("durf_fused_nerf_mlp_bwd")
    specs, slices = _plan(args)
    # B is the forward pack K1 used; the entry point takes no other.
    assert args[K2_W] == res[4][0].data_ptr() and args[K2_JOBS_HOST] is not None
    if widths == (128, 128):  # K4's maps: activations, cotangents, W K-major, W's x rows
        assert [m[0] for m in specs] == [hm.ACT, hm.G, hm.W, hm.W]
        assert all(sl[0] in (hm.OB_W, hm.OB_WX) for sl in slices)
    else:  # cotangent maps, then W; the relu masks come from K1's bit plane, not from act
        assert [m[0] for m in specs[:2]] == [hm.G, hm.G]
        assert {m[0] for m in specs[2:]} == {hm.W}
        mask, mask_off = args[-7:-5]
        assert mask == res[6][0].data_ptr() and list(mask_off) == res[6][1]
    assert k1.fused_nerf_mlp_bwd.launches == 1


def test_k5_k6_take_the_wgmma_object_kernels(spy):
    """K5 hands over K3's plan for one object; K6 K4's maps and schedule,
    the forward pack K5 used as B (no transposed pack) and a host job table;
    each counts one launch."""
    cfg, w = _mlp((128, 128), 63, 8)
    n = B * S
    x, gate, fill = torch.rand((n, 63)), (torch.rand(B) < 0.5).float(), torch.rand(63)
    cond_lin = torch.rand((B, 128))
    _, _, res = k1._k5_launch(x, gate, fill, cond_lin, w, cfg, S, save=True)
    k1.fused_nerf_mlp_gated_bwd(res, torch.rand((n, 3)), torch.rand((n, 1)), w, cfg, S)
    _, _, w_offs, _, w_stride, _ = k1.pack_weights(w, cfg, "cpu")
    k5 = spy.last("durf_fused_nerf_mlp_gated_fwd")
    assert len(k5) == len(k1._K5_ARGTYPES)
    assert _plan(k5) == tuple(hm.obj_fwd_plan(cfg, 63, n, 1, w_offs, w_stride, k1.x_cols(cfg, 63)))
    k6 = spy.last("durf_fused_nerf_mlp_gated_bwd")
    specs, slices = _plan(k6)
    assert (specs, slices) == tuple(hm.obj_bwd_plan(cfg, 63, n, 1, w_offs, w_stride, True))
    assert [m[0] for m in specs] == [hm.ACT, hm.G, hm.W, hm.W]
    assert k6[K2_W] == res[0][4][0].data_ptr() and k6[K2_JOBS_HOST] is not None
    assert k1.fused_nerf_mlp_gated.launches == k1.fused_nerf_mlp_gated_bwd.launches == 1


# ---- K5 and K6: the plans replayed with the prologue and the gate epilogue ----


GATED = MLPConfig(net_width=128)  # the object MLPs, which the gate serves


def _gated_case(b, s, gates, seed=0):
    """x [N, 63] row-major, gate [B], fill [63], cond_lin, operand list,
    row-major cotangents."""
    rng = np.random.default_rng(seed + 11)
    n = b * s
    w = [t[0] for t in obj._weights(GATED, 63, 1, seed, F_C)]
    x = torch.from_numpy(rng.uniform(-1, 1, size=(n, 63)).astype(np.float32))
    gate = torch.from_numpy(rng.choice(np.array(gates, np.float32), size=(b,)))
    fill = torch.from_numpy(rng.uniform(-1, 1, size=(63,)).astype(np.float32))
    cond = torch.from_numpy(rng.uniform(-1, 1, size=(b, F_C)).astype(np.float32))
    cond_lin = k1.cond_linear(cond, w[k1.head0_index(GATED)], GATED).contiguous()
    g_rgb = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    return x, gate, fill, cond, cond_lin, w, g_rgb, g_den


def _k5_k6_plans(spy, s, x, gate, fill, cond_lin, w, g_rgb, g_den):
    """The plans the K5 (saving) and K6 wrappers hand their entry points,
    and K6's dW chunk."""
    _, _, res = k1._k5_launch(x, gate, fill, cond_lin, w, GATED, s, save=True)
    k1.fused_nerf_mlp_gated_bwd(res, g_rgb, g_den, w, GATED, s)
    fwd, bwd = spy.last("durf_fused_nerf_mlp_gated_fwd"), spy.last("durf_fused_nerf_mlp_gated_bwd")
    return _plan(fwd), _plan(bwd), bwd[K2_CHUNK]


def _blend_prologue(x, gate, fill, s):
    """gated_input (csrc/mlp_obj.cuh): a tile's rows of bf16(g x' + (1 - g)
    fill') from the bf16 rows, each product and the sum rounded apart (no
    fused multiply-add), zero past in_dim and n."""
    n, f_in = x.shape
    xr, fr = obj._bf(x), obj._bf(fill)
    g = gate.repeat_interleave(s)

    def prologue(rows, valid):
        xt = torch.zeros((128, 64 * hm.x_chunks(f_in)))
        r = rows[valid]
        xt[valid, :f_in] = obj._bf(g[r, None] * xr[r] + (1 - g[r, None]) * fr)
        return xt
    return prologue


def _k5_errors(s, x, gate, fill, cond, cond_lin, w, plan):
    """The K5 replay of `plan` against the plain K5: (max abs error of the
    row-major outputs, worst relative L2 error of the saved residuals: the
    blended input and the activations on it)."""
    b = gate.shape[0]
    rgb, den, x_save, act = obj._replay_k3(GATED, x.T, torch.ones((1, b)), cond_lin[None],
                                           [t[None] for t in w], s, plan=lambda *a: plan,
                                           prologue=_blend_prologue(x, gate, fill, s))
    ref_rgb, ref_den = k1.fused_nerf_mlp_gated_reference(x, gate, fill, cond, w, GATED, s)
    out = _worst([float((rgb.T - ref_rgb).abs().max()), float((den.T - ref_den).abs().max())])
    xe = k1.gated_blend(x, gate, fill, s)
    xr, trunk, bneck, heads = k1.stored_activations(GATED, xe, cond_lin.repeat_interleave(s, 0), w)
    offs, _ = k1.act_layout(GATED, x.shape[0])
    res = [obj._rel(x_save[:, :63].float(), xr)]
    res += [obj._rel(act[offs[seg] :][: a.numel()].reshape(a.shape).float(), a)
            for seg, a in enumerate(trunk + [bneck] + heads)]
    return out, _worst(res)


def _k6_errors(s, x, gate, fill, cond_lin, w, g_rgb, g_den, plan, chunk):
    """The K6 replay of `plan` (K2's walk on the blended residuals, the gate
    epilogue, dW, the sums) against the plain K6: the worst relative L2
    error over dx, dgate, dfill, d cond_lin and every gradient."""
    b = gate.shape[0]
    xe = k1.gated_blend(x, gate, fill, s)
    epi = GateEpilogue(obj._bf(x), gate, obj._bf(fill), s)
    dx, dcond, grads, count = obj._replay_k4(
        GATED, xe.T, torch.ones((1, b)), cond_lin[None], [t[None] for t in w], s, g_rgb.T,
        g_den.T, chunk, plan=lambda *a: plan, epilogue=epi)
    assert torch.equal(count, torch.ones_like(count))
    ref_dx, ref_dgate, ref_dfill, ref_dcond, ref_grads = k1.fused_nerf_mlp_gated_bwd_reference(
        x, gate, fill, cond_lin, w, GATED, s, g_rgb, g_den)
    errs = [obj._rel(dx.T, ref_dx), obj._rel(epi.dgate.reshape(b, s).sum(1), ref_dgate),
            obj._rel(epi.dfill(), ref_dfill), obj._rel(dcond[0], ref_dcond)]
    errs += [obj._rel(a[0], r) for a, r in zip(grads, ref_grads)]
    return _worst(errs)


@pytest.mark.parametrize("b,s,gates", [
    pytest.param(B, S, (0.0, 1.0), id="6x40-gates-0-1"),
    # Fractional gates, rays straddling tile edges (S = 77), 7 tiles with a
    # ragged last one, and two dW splits with a ragged last one.
    pytest.param(11, 77, (0.0, 1.0, 0.25, 0.7), id="11x77-gates-fractional"),
])
def test_k5_k6_plans_replay_the_gated_forward_and_backward(spy, b, s, gates):
    x, gate, fill, cond, cond_lin, w, g_rgb, g_den = _gated_case(b, s, gates)
    assert set(np.float32(gates).tolist()) == set(gate.tolist())
    fwd, bwd, chunk = _k5_k6_plans(spy, s, x, gate, fill, cond_lin, w, g_rgb, g_den)
    n = b * s
    assert -(-n // chunk) >= 2 and n % chunk != 0, (n, chunk)
    out, res = _k5_errors(s, x, gate, fill, cond, cond_lin, w, fwd)
    assert out < 2e-2 and res < 1e-3, (out, res)
    err = _k6_errors(s, x, gate, fill, cond_lin, w, g_rgb, g_den, bwd, chunk)
    assert err < 1e-3, err


@pytest.mark.parametrize("mutation", ["offset", "plane", "order"])
def test_a_wrong_gated_plan_fails_the_replay(spy, mutation):
    x, gate, fill, cond, cond_lin, w, g_rgb, g_den = _gated_case(B, S, (0.0, 1.0, 0.5), seed=3)
    fwd, bwd, chunk = _k5_k6_plans(spy, S, x, gate, fill, cond_lin, w, g_rgb, g_den)

    def mutate(plan, wmap, amap):
        specs, slices = copy.deepcopy(plan)
        if mutation == "offset":  # one row of the pack further
            specs[wmap][1] += 128
            specs[wmap][3] -= 1
        elif mutation == "plane":  # activation planes one row short
            specs[amap][6] -= 128
        else:
            slices[0], slices[1] = slices[1], slices[0]
        return specs, slices

    out, res = _k5_errors(S, x, gate, fill, cond, cond_lin, w, mutate(fwd, hm.O_W, hm.O_ACT))
    err = _k6_errors(S, x, gate, fill, cond_lin, w, g_rgb, g_den, mutate(bwd, hm.OB_W, hm.OB_ACT),
                     chunk)
    assert not (out < 2e-2 and res < 1e-3) and not err < 1e-3


def test_refused_k5_k6_launches_raise_and_count_nothing(spy):
    cfg, w = _mlp((128, 128), 63, 8)
    n = B * S
    x, gate, fill = torch.rand((n, 63)), (torch.rand(B) < 0.5).float(), torch.rand(63)
    cond_lin = torch.rand((B, 128))
    _, _, res = k1._k5_launch(x, gate, fill, cond_lin, w, cfg, S, save=True)
    spy.state["err"] = 1
    calls = len(spy.log)
    with pytest.raises(RuntimeError, match="fused_nerf_mlp_gated"):
        k1._k5_launch(x, gate, fill, cond_lin, w, cfg, S, save=False)
    with pytest.raises(RuntimeError, match="fused_mlp_gated_bwd"):
        k1.fused_nerf_mlp_gated_bwd(res, torch.rand((n, 3)), torch.rand((n, 1)), w, cfg, S)
    assert len(spy.log) == calls + 2
    assert k1.fused_nerf_mlp_gated.launches == 1 and k1.fused_nerf_mlp_gated_bwd.launches == 0


def test_unsupported_shapes_and_failed_launches_raise(spy):
    cfg, w = _mlp((128, 128), 129)
    with pytest.raises(ValueError, match="in_dim <= 128"):
        k1._k1_launch(torch.rand((129, B * S)), torch.rand((B, 128)), w, cfg, S, save=True)
    cfg, w = _mlp((128, 256))
    with pytest.raises(ValueError, match="built for the widths"):
        k1._k1_launch(torch.rand((60, B * S)), torch.rand((B, 256)), w, cfg, S, save=True)
    cfg, w = _mlp((64, 128))
    with pytest.raises(ValueError, match="widths"):
        k1._k1_launch(torch.rand((60, B * S)), torch.rand((B, 128)), w, cfg, S, save=False)
    # A launch that fails raises and counts nothing: no other kernel or
    # plain version stands in.
    spy.state["err"] = 1
    cfg, w = _mlp((128, 128))
    calls, launches = len(spy.log), k1.fused_nerf_mlp.launches
    with pytest.raises(RuntimeError, match="fused_nerf_mlp"):
        k1._k1_launch(torch.rand((60, B * S)), torch.rand((B, 128)), w, cfg, S, save=False)
    assert len(spy.log) == calls + 1 and k1.fused_nerf_mlp.launches == launches


# ---- (d) the plain K1 and K2 against the JAX package ----


@pytest.mark.parametrize("cfg,in_dim", NARROW)
def test_plain_k1_128_matches_pallas_interpret(cfg, in_dim):
    jcfg = JMLPConfig(net_depth=cfg.net_depth, net_width=128)
    rng = np.random.default_rng(5)
    b, s = 8, 16
    w = [t[0].numpy() for t in obj._weights(cfg, in_dim, 1, 5, F_C)]
    x = rng.normal(size=(in_dim, b * s)).astype(np.float32)
    cond = rng.normal(size=(b, F_C)).astype(np.float32)
    j_rgb, j_den = j_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(np.repeat(cond, s, 0), jnp.bfloat16),
        [jnp.asarray(a) for a in w], jcfg, 64, True, True, True,
    )
    t_rgb, t_den = k1.fused_nerf_mlp(torch.from_numpy(x), torch.from_numpy(cond),
                                     [torch.from_numpy(a) for a in w], cfg, s)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), atol=2e-2)
    np.testing.assert_allclose(t_den.numpy(), np.asarray(j_den), atol=2e-2)


@pytest.mark.parametrize("cfg,in_dim", NARROW)
def test_k1_k2_128_function_grads_match_jax(cfg, in_dim):
    jcfg = JMLPConfig(net_depth=cfg.net_depth, net_width=128)
    rng = np.random.default_rng(6)
    b, s = 12, 8
    n = b * s
    w = [t[0].numpy() for t in obj._weights(cfg, in_dim, 1, 6, F_C)]
    x = rng.normal(size=(n, in_dim)).astype(np.float32)
    cond = rng.normal(size=(b, F_C)).astype(np.float32)
    c_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    c_den = rng.normal(size=(n, 1)).astype(np.float32)

    def j_loss(w_, x_, c_):
        rgb, den = j_fused(x_, c_, w_, jcfg, 32, True)
        return jnp.sum(rgb * c_rgb) + jnp.sum(den * c_den)

    jw, jx, jc = jax.grad(j_loss, argnums=(0, 1, 2))(
        [jnp.asarray(a) for a in w], jnp.asarray(x), jnp.asarray(np.repeat(cond, s, 0)))
    leaf = lambda a: torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)  # noqa: E731
    tw, tx, tc = [leaf(a) for a in w], leaf(x.T), leaf(cond)
    rgb, den = k1.fused_nerf_mlp(tx, tc, tw, cfg, s)
    ((rgb * torch.from_numpy(c_rgb.T)).sum() + (den * torch.from_numpy(c_den.T)).sum()).backward()
    np.testing.assert_allclose(tx.grad.T.numpy(), np.asarray(jx), atol=5e-2, rtol=1e-2)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc).reshape(b, s, F_C).sum(1),
                               atol=5e-2, rtol=1e-2)
    for i, (t, j) in enumerate(zip(tw, jw)):
        assert t.grad.shape == j.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=8e-2, rtol=2e-2,
                                   err_msg=f"operand {i}")
