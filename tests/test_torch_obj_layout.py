"""What K3 and K4 at the object width (8x128, csrc/mlp_obj.cuh) read and
write, and which (tile, object) pairs they skip, held on the CPU.

Those kernels run only on the card, but every address they use and every
pair they skip comes from Python: the tensor-map specs and one object's
slice schedule (ops/kernels/hopper_mlp.py: obj_fwd_plan, obj_bwd_plan), the
dW job table (fused_mlp.job_table), and the pair predicate the kernels
evaluate from `hit` (obj_mlp.kept_pairs; a 64-sample dW stage runs iff a
ray it spans hits the object). These tests replay the kernels' dataflow in
PyTorch through exactly those descriptions: every TMA box is cut from its
buffer by the spec's offset, dims, strides, plane and box (zeros past the
dims, stores clipped at them); the tile walks take one object's slices per
pair that runs, the object added to the plane; the workspaces start as NaN,
so a reader that touches a row a skipped pair never wrote shows up. The
replays are held against the plain versions at relative L2 1e-3 (both round
at the same points; float32 sums in another order can land a bf16 rounding
on the other side) and atol 2e-2 for forward outputs, as the chip check.
A mutated plan (offset, stride, plane, slice order) must fail the replay.

The skip itself is exact: the dense plain version equals one that sees only
the kept pairs' data, bitwise. And the port's plain version agrees with the
JAX package's objects-in-grid kernel in interpret mode at a 3% hit share,
where an object that no ray hits gets exactly zero weight gradients on both.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.ops.pallas.obj_mlp import obj_mlps_apply as j_obj_apply
from durf_tpu_torch import metrics
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import hopper_mlp as hm
from durf_tpu_torch.ops.kernels import obj_mlp as k3

F_IN, F_C = 63, 27
ROWS = 128  # samples per tile
NAN = float("nan")


def _bf(t):
    return t.to(torch.bfloat16).float()


def _rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-12))


def _weights(cfg, in_dim, n_obj, seed=0, f_c=F_C):
    """Stacked operand list [n_obj, ...] of float32 tensors (glorot kernels,
    small random biases)."""
    rng = np.random.default_rng(seed)
    shapes = [(d, cfg.net_width) for d in k1.layer_dims(cfg, in_dim)]
    shapes += [(cfg.net_width, 1), (cfg.net_width, cfg.net_width)]
    shapes += [(cfg.net_width + f_c, cfg.net_width_condition)]
    shapes += [(cfg.net_width_condition,) * 2] * (cfg.net_depth_condition - 1)
    shapes += [(cfg.net_width_condition, 3)]
    ops = []
    for fan_in, fan_out in shapes:
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        ops.append(rng.uniform(-lim, lim, size=(n_obj, fan_in, fan_out)).astype(np.float32))
        ops.append((rng.normal(size=(n_obj, fan_out)) * 0.1).astype(np.float32))
    return [torch.from_numpy(a) for a in ops]


def _hit(n_obj, b, seed):
    """A 0/1 mask [n_obj, b] with kept and skipped pairs: object 0 hits ray
    1 only, object 1 ray 6 (which spans both tiles at S = 20), the last
    object none, the rest at random."""
    rng = np.random.default_rng(seed)
    hit = (rng.random((n_obj, b)) < 0.2).astype(np.float32)
    hit[0] = 0.0
    hit[0, 1] = 1.0
    if n_obj > 2:
        hit[1] = 0.0
        hit[1, 6] = 1.0
        hit[-1] = 0.0
    return torch.from_numpy(hit)


def _case(n_obj, cfg, b=10, s=20, seed=0):
    rng = np.random.default_rng(seed + 100)
    n = b * s
    x = torch.from_numpy(rng.uniform(-1, 1, size=(F_IN, n)).astype(np.float32))
    cond_lin = _bf(torch.from_numpy(rng.normal(size=(n_obj, b, cfg.net_width_condition)).astype(np.float32)))
    g_rgb = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32))
    return x, _hit(n_obj, b, seed), cond_lin, _weights(cfg, F_IN, n_obj, seed), s, g_rgb, g_den


# ---- the pair predicate ----


@pytest.mark.parametrize("s_per_ray,b", [(128, 5), (77, 10), (5, 51)])
def test_a_pair_is_skipped_iff_every_ray_of_its_tile_misses(s_per_ray, b):
    rng = np.random.default_rng(s_per_ray)
    n_obj, n = 3, b * s_per_ray
    hit = torch.from_numpy((rng.random((n_obj, b)) < 0.15).astype(np.float32))
    hit[2] = 0.0
    kept = k3.kept_pairs(hit, n, s_per_ray)
    tiles = -(-n // ROWS)
    assert kept.shape == (tiles, n_obj)
    for t in range(tiles):
        rays = {i // s_per_ray for i in range(t * ROWS, min(n, (t + 1) * ROWS))}
        for o in range(n_obj):
            assert bool(kept[t, o]) == any(float(hit[o, r]) != 0 for r in rays), (t, o)
    assert not kept[:, 2].any()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        k3.count_pairs(hit, n, s_per_ray)
    counts = metrics.counters()
    assert (counts["k3.pairs_ran"], counts["k3.pairs"]) == (int(kept.sum()), tiles * n_obj)


def _restricted(x, hit, cond_lin, weights, cfg, s, g_rgb, g_den):
    """The plain forward and backward that see only the kept pairs' data:
    per object, the input and condition rows of every skipped tile are
    zeroed before the MLP runs (the kernels never read them)."""
    n = x.shape[1]
    kept = k3.kept_pairs(hit, n, s).repeat_interleave(ROWS, 0)[:n]  # [n, n_obj]
    rgb_acc = den_acc = None
    dx = torch.zeros_like(x.T)
    dconds, grads = [], []
    for o in range(hit.shape[0]):
        m = kept[:, o : o + 1].float()
        xo = (x * m.T).T  # the dense version's [N, F] layout
        rows = cond_lin[o].repeat_interleave(s, dim=0) * m
        w_o = [w[o] for w in weights]
        gate = hit[o].repeat_interleave(s)[:, None]
        rgb, den = k1.split_matmul_forward(cfg, xo, rows, w_o, torch.bfloat16)
        rgb_acc = gate * rgb if o == 0 else rgb_acc + gate * rgb
        den_acc = gate * den if o == 0 else den_acc + gate * den
        dx_o, d_rows, g_o = k1.split_matmul_backward(
            cfg, xo, rows, w_o, gate * g_rgb.T, gate * g_den.T, torch.bfloat16)
        dx = dx + dx_o
        dconds.append(d_rows.reshape(-1, s, d_rows.shape[-1]).sum(1))
        grads.append(g_o)
    stacked = [torch.stack([g[i] for g in grads]) for i in range(len(weights))]
    return (rgb_acc.T, den_acc.T), (dx.T, torch.stack(dconds), stacked)


@pytest.mark.parametrize("s_per_ray,b", [(128, 3), (77, 5), (5, 51)])
def test_skipping_the_pairs_no_ray_hits_is_exact(s_per_ray, b):
    cfg = MLPConfig(net_depth=4, net_width=32, net_width_condition=32, skip_layer=2)
    n_obj = 3
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(F_IN, b * s_per_ray)).astype(np.float32))
    hit = torch.from_numpy((rng.random((n_obj, b)) < 0.3).astype(np.float32))
    hit[0, 0], hit[2] = 1.0, 0.0
    cond_lin = _bf(torch.from_numpy(rng.normal(size=(n_obj, b, 32)).astype(np.float32)))
    w = _weights(cfg, F_IN, n_obj, seed=b)
    g_rgb = torch.from_numpy(rng.normal(size=(3, b * s_per_ray)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(1, b * s_per_ray)).astype(np.float32))
    kept = k3.kept_pairs(hit, b * s_per_ray, s_per_ray)
    assert 0 < int(kept.sum()) < kept.numel()
    (r_rgb, r_den), (r_dx, r_dc, r_g) = _restricted(x, hit, cond_lin, w, cfg, s_per_ray, g_rgb, g_den)
    rgb, den = k3.fused_obj_mlp_reference(x, hit, cond_lin, w, cfg, s_per_ray)
    dx, dc, g = k3.fused_obj_mlp_bwd_reference(x, hit, cond_lin, w, cfg, s_per_ray, g_rgb, g_den)
    assert torch.equal(rgb, r_rgb) and torch.equal(den, r_den)
    assert torch.equal(dx, r_dx) and torch.equal(dc, r_dc)
    for i, (a, r) in enumerate(zip(g, r_g)):
        assert torch.equal(a, r), f"operand {i}"
    for i in range(len(g)):  # the object no ray hits: exactly zero gradients
        assert not g[i][2].any(), f"operand {i}"


# ---- the maps and schedules, replayed ----


def _plane(buf, spec, z):
    _, off, d0, d1, _, s1, s2, _, _ = spec
    return buf.reshape(-1)[off + z * s2 :].as_strided((d1, d0), (s1, 1))


def _box(buf, spec, c0, c1, c2):
    """The [box1][box0] float32 box a TMA load at (c0, c1, c2) brings in,
    zeros past the dims."""
    _, _, d0, d1, d2, _, _, b0, b1 = spec
    assert 0 <= c2 < d2, (c2, d2)
    out = torch.zeros((b1, b0))
    part = _plane(buf, spec, c2)[max(c1, 0) : c1 + b1, c0 : c0 + b0].float()
    out[: part.shape[0], : part.shape[1]] = part
    return out


def _store(buf, spec, tile, c0, c1, c2):
    _, _, d0, d1, d2, _, _, b0, b1 = spec
    assert tile.shape == (b1, b0) and 0 <= c2 < d2
    dst = _plane(buf, spec, c2)[c1 : c1 + b1, c0 : c0 + b0]
    dst.copy_(tile[: dst.shape[0], : dst.shape[1]].to(buf.dtype))


def _store_tile(buf, spec, tile, tile0, z):
    for wg in range(2):
        for blk in range(tile.shape[1] // 64):
            _store(buf, spec, tile[64 * wg : 64 * wg + 64, 64 * blk : 64 * blk + 64], 64 * blk,
                   tile0 + 64 * wg, z)


def _load_tile(buf, spec, tile0, z, cols):
    return torch.cat([
        torch.cat([_box(buf, spec, 64 * blk, tile0 + 64 * wg, z) for blk in range(cols // 64)], 1)
        for wg in range(2)
    ])


class _Ring:
    """The consumers' side of the ring for one object: its schedule's
    slices with the object added to the plane. K3's slices are 64-row
    blocks of W (two boxes side by side, MN-major); K4's one K-major box."""

    def __init__(self, buf, specs, slices, o, mn_major):
        self.buf, self.specs, self.o, self.mn = buf, specs, o, mn_major
        self.it = iter(slices)

    def product(self, a, n_slices):
        acc = 0.0
        for s in range(n_slices):
            m, c0, c1, c2 = next(self.it)
            spec = self.specs[m]
            if self.mn:
                b = torch.cat([_box(self.buf, spec, c0 + 64 * k, c1, c2 + self.o)
                               for k in range(hm.OBJ_FWD_BOXES)], 1)
            else:
                b = _box(self.buf, spec, c0, c1, c2 + self.o).T
            acc = acc + a[:, 64 * s : 64 * s + 64] @ b
        return acc

    def done(self):
        assert next(self.it, None) is None, "the schedule has slices no consumer takes"


def _fwd_plan(cfg, in_dim, n, n_obj, w_offs, w_stride):
    return hm.obj_fwd_plan(cfg, in_dim, n, n_obj, w_offs, w_stride, k1.x_cols(cfg, in_dim))


def _replay_k3(cfg, x, hit, cond_lin, weights, s, plan=_fwd_plan, prologue=None):
    """K3's tile walk through its maps and schedule, only the kept pairs
    (with a hit mask of ones, K1's mask-free walk at 128 / 128: every tile,
    gates of 1). prologue(rows, valid) gives a tile's input rows [128, 64
    xc] in place of x's (K5's blend). Returns (rgb, den, x_save, act)."""
    (f_in, n), n_obj = x.shape, hit.shape[0]
    d, dc, w = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    xc = hm.x_chunks(f_in)
    wpack, bpack, w_offs, b_offs, w_stride, b_stride = k1.pack_weights(weights, cfg, "cpu")
    x_save, act, _, _ = k1.save_buffers(cfg, f_in, n, n_obj, "cpu")
    x_save.fill_(NAN)
    act.fill_(NAN)
    specs, slices = plan(cfg, f_in, n, n_obj, w_offs, w_stride)
    planes = hm.obj_planes(cfg)[0]
    kept = k3.kept_pairs(hit, n, s)
    rgb, den = torch.full((3, n), NAN), torch.full((1, n), NAN)
    for ti, tile0 in enumerate(range(0, n, ROWS)):
        rows = torch.arange(tile0, tile0 + ROWS)
        valid = rows < n
        ray = torch.clamp(rows, max=n - 1) // s
        acc_rgb, acc_den = torch.zeros((ROWS, 3)), torch.zeros((ROWS, 1))
        if kept[ti].any():
            xt = torch.zeros((ROWS, 64 * xc))
            xt[valid, :f_in] = _bf(x.T[rows[valid]])
            if prologue is not None:
                xt = prologue(rows, valid)
            _store_tile(x_save, specs[hm.O_XSAVE], xt, tile0, 0)
        for o in range(n_obj):
            if not kept[ti, o]:
                continue
            ring = _Ring(wpack, specs, slices, o, mn_major=True)
            bias = lambda l, c: bpack[o * b_stride + b_offs[l] :][:c]  # noqa: E731, B023
            head = lambda l, c: wpack[o * w_stride + w_offs[l] :][: w * c].reshape(w, c).float()  # noqa: E731, B023
            h = None
            for i in range(d):
                acc = ring.product(h, w // 64) if i > 0 else 0.0
                if k1.reads_x(cfg, i):
                    acc = acc + ring.product(xt, xc)
                h = _bf(torch.relu(acc + bias(i, w)))
                _store_tile(act, specs[hm.O_ACT], h, tile0, o * planes + i)
            dn = h @ head(d, 1) + bias(d, 1)
            h = _bf(ring.product(h, w // 64) + bias(d + 1, w))
            _store_tile(act, specs[hm.O_ACT], h, tile0, o * planes + d)
            for i in range(dc):
                a = ring.product(h, w // 64) + bias(d + 2 + i, w)
                if i == 0:
                    a = a + cond_lin[o][ray]
                h = _bf(torch.relu(a))
                _store_tile(act, specs[hm.O_ACT], h, tile0, o * planes + d + 1 + i)
            rg = h @ head(d + 2 + dc, 3) + bias(d + 2 + dc, 3)
            ring.done()
            g = hit[o][ray][:, None]
            acc_rgb, acc_den = acc_rgb + g * rg, acc_den + g * dn
        rgb[:, rows[valid]] = acc_rgb[valid].T
        den[:, rows[valid]] = acc_den[valid].T
    return rgb, den, x_save, act


def _stage_runs(hit_o, s0, n, s):
    return any(float(hit_o[r]) != 0 for r in range(s0 // s, (min(s0 + 63, n - 1)) // s + 1))


def _bwd_plan(cfg, in_dim, n, n_obj, w_offs, w_stride):
    return hm.obj_bwd_plan(cfg, in_dim, n, n_obj, w_offs, w_stride, True)


def _replay_k4(cfg, x, hit, cond_lin, weights, s, g_rgb, g_den, chunk, plan=_bwd_plan,
               epilogue=None):
    """K4's four launches through their maps, schedule and job table: the
    tile walk of the kept pairs, the dW tiles per object and split over the
    stages that run, the fixed-order reduction and the gated per-ray sums.
    The residuals are the plain version's, written only for the kept pairs
    (as K3 writes them; with a hit mask of ones, K2's mask-free walk at 128
    / 128). epilogue(tile0, dxa) maps a tile's summed x-part products [128,
    64 xc] to the dx rows stored (K6's gate epilogue). Returns (dx, d
    cond_lin, weight grads, coverage counts [splits, N_obj * per-object
    total])."""
    (f_in, n), n_obj = x.shape, hit.shape[0]
    d, dc, w = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    xc = hm.x_chunks(f_in)
    wpack, _, w_offs, _, w_stride, _ = k1.pack_weights(weights, cfg, "cpu")
    x_save, act, act_offs, act_stride = k1.save_buffers(cfg, f_in, n, n_obj, "cpu")
    x_save.fill_(NAN)
    act.fill_(NAN)
    kept = k3.kept_pairs(hit, n, s)
    for o in range(n_obj):
        xr, trunk, bneck, heads = k1.stored_activations(
            cfg, x.T, cond_lin[o].repeat_interleave(s, 0), [t[o] for t in weights])
        for ti in range(kept.shape[0]):
            r0, r1 = ti * ROWS, min(n, ti * ROWS + ROWS)
            if kept[ti].any():
                x_save[r0:r1] = 0.0
                x_save[r0:r1, :f_in] = xr[r0:r1]
            if kept[ti, o]:
                for seg, a in enumerate(trunk + [bneck] + heads):
                    dst = act[o * act_stride + act_offs[seg] :][: n * w].reshape(n, w)
                    dst[r0:r1] = a[r0:r1]
    g_offs, _ = k1.g_layout(cfg, n)
    g_stride = hm.obj_g_stride(cfg, n)
    gbuf = torch.full((n_obj * g_stride,), NAN, dtype=torch.bfloat16)
    specs, slices = plan(cfg, f_in, n, n_obj, w_offs, w_stride)
    ap, gp = hm.obj_planes(cfg)
    head = lambda o, l, c: wpack[o * w_stride + w_offs[l] :][: w * c].reshape(w, c).float()  # noqa: E731
    dx = torch.full((f_in, n), NAN)
    l_rgb = d + 2 + dc
    for ti, tile0 in enumerate(range(0, n, ROWS)):
        rows = torch.arange(tile0, tile0 + ROWS)
        valid = (rows < n)[:, None]
        rc = torch.clamp(rows, max=n - 1)
        dxa = torch.zeros((ROWS, 64 * xc))
        for o in range(n_obj):
            if not kept[ti, o]:
                continue
            ring = _Ring(wpack, specs, slices, o, mn_major=False)
            h = hit[o][rc // s][:, None] * valid
            gr = _bf(h * g_rgb.T[rc])
            act_last = _load_tile(act, specs[hm.OB_ACT], tile0, o * ap + d + dc, w)
            g = _bf((gr @ head(o, l_rgb, 3).T) * (act_last > 0)) * valid
            for l, src in ((l_rgb, g_rgb), (d, g_den)):
                rows8 = torch.zeros((ROWS, 8))
                rows8[:, : src.shape[0]] = _bf(h * src.T[rc])
                seg = gbuf[o * g_stride + g_offs[l] :][: 8 * n].reshape(n, 8)
                seg[rows[valid[:, 0]]] = rows8[valid[:, 0]].to(torch.bfloat16)
            _store_tile(gbuf, specs[hm.OB_G], g, tile0, o * gp + d + dc)
            for i in range(dc - 1, 0, -1):
                mask = _load_tile(act, specs[hm.OB_ACT], tile0, o * ap + d + i, w)
                g = _bf(ring.product(g, w // 64) * (mask > 0)) * valid
                _store_tile(gbuf, specs[hm.OB_G], g, tile0, o * gp + d + i)
            g = _bf(ring.product(g, w // 64)) * valid
            _store_tile(gbuf, specs[hm.OB_G], g, tile0, o * gp + d)
            mask = _load_tile(act, specs[hm.OB_ACT], tile0, o * ap + d - 1, w)
            gd = _bf(h * g_den.T[rc])
            g = _bf((ring.product(g, w // 64) + gd @ head(o, d, 1).T) * (mask > 0)) * valid
            _store_tile(gbuf, specs[hm.OB_G], g, tile0, o * gp + d - 1)
            for i in range(d - 1, -1, -1):
                if k1.reads_x(cfg, i):
                    for c in range(xc):
                        dxa[:, 64 * c : 64 * c + 64] += ring.product(g, w // 64)
                if i == 0:
                    break
                mask = _load_tile(act, specs[hm.OB_ACT], tile0, o * ap + i - 1, w)
                g = _bf(ring.product(g, w // 64) * (mask > 0)) * valid
                _store_tile(gbuf, specs[hm.OB_G], g, tile0, o * gp + i - 1)
            ring.done()
        if epilogue is not None:
            dxa = epilogue(tile0, dxa)
        dx[:, rows[valid[:, 0]]] = dxa[valid[:, 0], :f_in].T

    # dW: one object's jobs; blocks per (tile, object, split) over the stages that run.
    jobs, _, n_tiles = k1.job_table(cfg, f_in, n, 1, "cpu")
    _, per_obj = k1.grad_layout(cfg, f_in)
    total = n_obj * per_obj
    n_splits = -(-n // chunk)
    part = torch.full((n_splits, total), NAN)
    count = torch.zeros((n_splits, total), dtype=torch.int32)
    for split in range(n_splits):
        s0, s1 = split * chunk, min(n, (split + 1) * chunk)
        for o in range(n_obj):
            for tile in range(n_tiles):
                job = next(r for r in reversed(jobs.tolist()) if r[9] <= tile)
                a_buf, a_off, lda, g_off, ldg, k, j, out, bias, first, _, nt = job
                assert nt == 1 and j <= 128
                tm = tile - first
                shared = a_buf == hm.XSAVE
                a_spec = [a_buf, a_off, lda, n, 1 if shared else n_obj, lda,
                          lda * n if shared else act_stride, 64, 64]
                g_spec = [hm.G, g_off, ldg, n, n_obj, ldg, g_stride, 64, 64]
                src = x_save if shared else act
                acc, bsum = torch.zeros((128, 64 * -(-j // 64))), torch.zeros(64 * -(-j // 64))
                for st in range(s0, s1, 64):
                    if not _stage_runs(hit[o], st, n, s):
                        continue
                    boxes = min(2, -(-(k - 128 * tm) // 64))
                    a = torch.cat([_box(src, a_spec, 128 * tm + 64 * bb, st, 0 if shared else o)
                                   for bb in range(boxes)], 1)
                    gg = torch.cat([_box(gbuf, g_spec, 64 * c, st, o) for c in range(-(-j // 64))], 1)
                    acc[: 64 * boxes] += a.T @ gg
                    bsum = bsum + gg.sum(0)
                base = o * per_obj
                r0, r1 = 128 * tm, min(k, 128 * tm + 128)
                part[split, base + out :][: k * j].reshape(k, j)[r0:r1] = acc[: r1 - r0, :j]
                count[split, base + out :][: k * j].reshape(k, j)[r0:r1] += 1
                if bias >= 0 and tm == 0:
                    part[split, base + bias :][:j] = bsum[:j]
                    count[split, base + bias :][:j] += 1
    flat = part[0].clone()
    for split in range(1, n_splits):  # reduce_kernel: slices in order
        flat = flat + part[split]
    grads = k1.unpack_grads(flat, weights, cfg, f_in, stacked=True)
    dcond = torch.zeros((n_obj, n // s, w))
    for o in range(n_obj):
        g_h0 = gbuf[o * g_stride + g_offs[d + 2] :][: n * w].reshape(-1, s, w).float()
        for r in range(n // s):
            if float(hit[o, r]) != 0:
                dcond[o, r] = g_h0[r].sum(0)
    return dx, dcond, grads, count


DEEP = MLPConfig(net_width=128)  # ModelConfig.box_mlp: 8x128, skip at layer 5, head 128
SHALLOW = MLPConfig(net_depth=4, net_width=128, skip_layer=2)


@pytest.mark.parametrize("n_obj,cfg", [(1, SHALLOW), (2, DEEP), (8, SHALLOW)])
def test_k3_maps_and_schedule_replay_the_forward(n_obj, cfg):
    x, hit, cond_lin, w, s, _, _ = _case(n_obj, cfg)
    rgb, den, x_save, act = _replay_k3(cfg, x, hit, cond_lin, w, s)
    ref_rgb, ref_den = k3.fused_obj_mlp_reference(x, hit, cond_lin, w, cfg, s)
    assert float((rgb - ref_rgb).abs().max()) < 2e-2 and float((den - ref_den).abs().max()) < 2e-2
    # The saved residuals: the plain version's for the kept pairs, untouched
    # (NaN) for the skipped ones and for tiles no object hits.
    n = x.shape[1]
    kept = k3.kept_pairs(hit, n, s).repeat_interleave(ROWS, 0)[:n]
    any_kept = kept.any(1)
    assert torch.equal(x_save[any_kept, :F_IN].float(), _bf(x.T[any_kept]))
    assert torch.isnan(x_save[~any_kept].float()).all()
    offs, stride = k1.act_layout(cfg, n)
    for o in range(n_obj):
        xr, trunk, bneck, heads = k1.stored_activations(
            cfg, x.T, cond_lin[o].repeat_interleave(s, 0), [t[o] for t in w])
        for seg, a in enumerate(trunk + [bneck] + heads):
            got = act[o * stride + offs[seg] :][: a.numel()].reshape(a.shape).float()
            assert _rel(got[kept[:, o]], a[kept[:, o]]) < 1e-3, (o, seg)
            assert torch.isnan(got[~kept[:, o]]).all(), (o, seg)


@pytest.mark.parametrize("n_obj,cfg,chunk", [(1, SHALLOW, 64), (2, DEEP, 128), (8, SHALLOW, 64)])
def test_k4_maps_schedule_and_dw_replay_the_backward(n_obj, cfg, chunk):
    x, hit, cond_lin, w, s, g_rgb, g_den = _case(n_obj, cfg, seed=n_obj)
    dx, dcond, grads, count = _replay_k4(cfg, x, hit, cond_lin, w, s, g_rgb, g_den, chunk)
    ref_dx, ref_dcond, ref_grads = k3.fused_obj_mlp_bwd_reference(
        x, hit, cond_lin, w, cfg, s, g_rgb, g_den)
    assert _rel(dx, ref_dx) < 1e-3 and _rel(dcond, ref_dcond) < 1e-3
    for i, (a, r) in enumerate(zip(grads, ref_grads)):
        assert a.shape == r.shape and _rel(a, r) < 1e-3, f"operand {i}: {_rel(a, r)}"
    # Every gradient element of every object is formed by exactly one
    # (tile, split) per split, and the reduction adds the splits in order.
    assert torch.equal(count, torch.ones_like(count))
    if n_obj > 2:  # the object no ray hits
        assert not dcond[-1].any() and all(not g[-1].any() for g in grads)


@pytest.mark.parametrize("mutation", ["offset", "stride", "plane", "order"])
def test_a_wrong_plan_fails_the_replay(mutation):
    """The replays see every field of the plan: a shifted offset, a wrong
    row stride, a wrong plane count or two swapped slices break them."""
    cfg, n_obj = SHALLOW, 2
    x, hit, cond_lin, w, s, g_rgb, g_den = _case(n_obj, cfg, seed=3)
    hit[1, 8] = 1.0  # object 1 runs: its weights are plane 1

    def mutate(plan_fn):
        def plan(*args):
            specs, slices = copy.deepcopy(plan_fn(*args))
            wmap = hm.O_W if plan_fn is _fwd_plan else hm.OB_W
            if mutation == "offset":  # one row of the pack further
                specs[wmap][1] += 128
                specs[wmap][3] -= 1
            elif mutation == "stride":
                specs[wmap][5] -= 8
            elif mutation == "plane":
                specs[wmap][6] -= 128
            else:
                slices[0], slices[1] = slices[1], slices[0]
            return specs, slices
        return plan

    rgb, den, _, _ = _replay_k3(cfg, x, hit, cond_lin, w, s, plan=mutate(_fwd_plan))
    ref_rgb, _ = k3.fused_obj_mlp_reference(x, hit, cond_lin, w, cfg, s)
    fwd_bad = not float((rgb - ref_rgb).abs().max()) < 2e-2
    dx, _, grads, _ = _replay_k4(cfg, x, hit, cond_lin, w, s, g_rgb, g_den, 64,
                                 plan=mutate(_bwd_plan))
    ref_dx, _, ref_grads = k3.fused_obj_mlp_bwd_reference(x, hit, cond_lin, w, cfg, s, g_rgb, g_den)
    bwd_bad = not (_rel(dx, ref_dx) < 1e-3 and all(_rel(a, r) < 1e-3 for a, r in zip(grads, ref_grads)))
    assert fwd_bad and bwd_bad


def test_obj_plans_hold_any_object_count():
    """The maps take the object as their plane, so the plan's maps and
    slices, and the dW job table, do not grow with N_obj."""
    cfg, n = DEEP, 4096 * 128
    _, _, w_offs, _, w_stride, _ = k1.pack_weights(_weights(cfg, F_IN, 1), cfg, "cpu")
    plans = {}
    for n_obj in (1, 2, 8):
        f_specs, f_slices = hm.obj_fwd_plan(cfg, F_IN, n, n_obj, w_offs, w_stride, 64)
        b_specs, b_slices = hm.obj_bwd_plan(cfg, F_IN, n, n_obj, w_offs, w_stride, True)
        assert len(f_specs) == 3 and len(b_specs) == 4
        assert len(f_slices) == 20 and len(b_slices) == 22 <= hm.MAX_SLICES
        assert f_specs[hm.O_ACT][4] == n_obj * 10 and b_specs[hm.OB_G][4] == n_obj * 11
        plans[n_obj] = (f_slices, b_slices)
    assert plans[1] == plans[2] == plans[8]
    jobs, _, tiles = k1.job_table(cfg, F_IN, n, 1, "cpu")
    assert jobs.shape[0] == 13 <= hm.MAX_JOBS and tiles == 13
    _, no_dx = hm.obj_bwd_plan(cfg, F_IN, n, 2, w_offs, w_stride, False)
    assert len(plans[2][1]) - len(no_dx) == 2 * 2  # layers 0 and 5: one 64-row x block, 2 slices
    a = hm.c_obj_plan("obj_bwd", cfg, F_IN, n, 2, w_offs, w_stride, True)
    assert a is hm.c_obj_plan("obj_bwd", MLPConfig(net_width=128), F_IN, n, 2, w_offs, w_stride, True)
    # the cotangent workspace: whole planes, density and rgb rows in the last
    g_offs, g_size = k1.g_layout(cfg, n)
    assert hm.obj_g_stride(cfg, n) == 11 * 128 * n >= g_size
    assert g_offs[cfg.net_depth] >= 10 * 128 * n


def test_obj_kernels_refuse_what_they_do_not_take():
    cfg = MLPConfig(net_width=128)
    k3.check_obj_config(cfg, 63)
    k3.check_obj_config(cfg, 128)
    with pytest.raises(ValueError, match="in_dim <= 128"):
        k3.check_obj_config(cfg, 129)
    with pytest.raises(ValueError, match="whole 128-wide row"):
        hm.obj_fwd_plan(cfg, F_IN, 256, 2, [0, 8000], 16384, 64)


# ---- the JAX package at sparse hits ----


def _leaf(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_(True)


def test_sparse_hits_match_jax_and_a_missed_object_gets_zero_grads():
    """durf_tpu's fused_obj_mlp (interpret mode) against the port's plain
    version at a 3% hit share, object 1 hit by no ray. Tolerances as
    tests/test_torch_grads.py's K4 case (test_obj_kernel.py:106-108)."""
    shape = dict(net_depth=4, net_width=32, net_width_condition=32)
    cfg, jcfg = MLPConfig(**shape), JMLPConfig(**shape)
    n_obj, b, s = 3, 200, 4
    rng = np.random.default_rng(11)
    w = [t.numpy() for t in _weights(cfg, F_IN, n_obj, seed=11)]
    enc = rng.normal(size=(F_IN, b, s)).astype(np.float32)
    cond = rng.normal(size=(b, F_C)).astype(np.float32)
    hit = (rng.random((b, n_obj)) < 0.03).astype(np.float32)
    hit[:, 1] = 0.0
    hit[3, 0] = hit[7, 2] = 1.0
    assert 0 < hit.mean() < 0.05
    c_rgb = rng.normal(size=(3, b, s)).astype(np.float32)
    c_den = rng.normal(size=(1, b, s)).astype(np.float32)
    names = ([f"trunk_{i}" for i in range(cfg.net_depth)] + ["density_head", "bottleneck"]
             + [f"head_{i}" for i in range(cfg.net_depth_condition)] + ["rgb_head"])

    def j_loss(tree, enc_, cond_):
        rgb, den = j_obj_apply(tree, jcfg, enc_, cond_, jnp.asarray(hit), jnp.bfloat16,
                               tile=128, interpret=True)
        return jnp.sum(rgb * c_rgb) + jnp.sum(den * c_den), (rgb, den)

    tree = {nm: {"kernel": jnp.asarray(w[2 * i]), "bias": jnp.asarray(w[2 * i + 1])}
            for i, nm in enumerate(names)}
    (jt, je, jc), (j_rgb, j_den) = jax.grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        tree, jnp.asarray(enc), jnp.asarray(cond))

    tw, te, tc = [_leaf(a) for a in w], _leaf(enc), _leaf(cond)
    rgb, den = k3.obj_mlps_apply(tw, cfg, te, tc, torch.from_numpy(hit), torch.bfloat16)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb), atol=2e-2)
    np.testing.assert_allclose(den.detach().numpy(), np.asarray(j_den), atol=2e-2)
    ((rgb * torch.from_numpy(c_rgb)).sum() + (den * torch.from_numpy(c_den)).sum()).backward()
    tol = dict(atol=1.2e-1, rtol=2e-2)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(je), err_msg="enc", **tol)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), err_msg="cond", **tol)
    for i, name in enumerate(names):
        for j, leaf in enumerate(("kernel", "bias")):
            t_g, j_g = tw[2 * i + j].grad.numpy(), np.asarray(jt[name][leaf])
            np.testing.assert_allclose(t_g, j_g, err_msg=f"{name}.{leaf}", **tol)
            assert not t_g[1].any() and not j_g[1].any(), f"{name}.{leaf} of the missed object"
