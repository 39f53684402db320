"""What the wgmma + TMA kernels (K1 and K2 at the flagship widths,
csrc/mlp_wide.cuh) read and write, held on the CPU.

Those kernels run only on the card, but every address they use comes from
Python: the tensor-map specs and the producer's slice schedule of
ops/kernels/hopper_mlp.py, the relu masks' bit plane (mask_layout,
pack_masks), and the dW job table of ops/kernels/fused_mlp.py. These tests
replay the kernels' dataflow in PyTorch through exactly those
descriptions: each TMA box is cut from its buffer by the spec's offset,
dims, strides and box (zeros past the dims, stores clipped at them), the
tile walks take their weight slices in schedule order, and K1 writes, K2
reads, each tile's mask words at the layer's offset. A wrong offset,
stride, box, slice or word order changes the result. The replays are held against
the plain versions (and the forward against the JAX package's XLA reference)
at the flagship widths on a ragged N. Tolerances: relative L2 1e-3 where
both sides round at the same points (float32 sums in another order can land
a bf16 rounding on the other side), atol 2e-2 for forward outputs (as the
chip check).
"""

import collections
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.ops.pallas.fused_mlp import mlp_reference_forward
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.ops.kernels import build
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import hopper_mlp as hm

F_IN, F_C = 60, 27
ROWS = 128  # samples per tile of the wide kernels


def _bf(t):
    return t.to(torch.bfloat16).float()


def _rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-12))


def _weights(cfg, in_dim, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(d, cfg.net_width) for d in k1.layer_dims(cfg, in_dim)]
    shapes += [(cfg.net_width, 1), (cfg.net_width, cfg.net_width)]
    shapes += [(cfg.net_width + F_C, cfg.net_width_condition)]
    shapes += [(cfg.net_width_condition, cfg.net_width_condition)] * (cfg.net_depth_condition - 1)
    shapes += [(cfg.net_width_condition, 3)]
    ops = []
    for fan_in, fan_out in shapes:
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        ops.append(rng.uniform(-lim, lim, size=(fan_in, fan_out)).astype(np.float32))
        ops.append((rng.normal(size=(fan_out,)) * 0.1).astype(np.float32))
    return ops


def _plane(buf, spec, z):
    """Plane z of a spec's tensor: [dim1][dim0] over the flat buffer."""
    _, off, d0, d1, _, s1, s2, _, _ = spec
    return buf.reshape(-1)[off + z * s2 :].as_strided((d1, d0), (s1, 1))


def _box(buf, spec, c0, c1, c2):
    """The [box1][box0] float32 box a TMA load at (c0, c1, c2) brings in,
    zeros past the dims."""
    _, _, d0, d1, d2, _, _, b0, b1 = spec
    assert 0 <= c2 < d2
    out = torch.zeros((b1, b0))
    part = _plane(buf, spec, c2)[c1 : c1 + b1, c0 : c0 + b0].float()
    out[: part.shape[0], : part.shape[1]] = part
    return out


def _store(buf, spec, tile, c0, c1, c2):
    """A TMA store of `tile` [box1][box0] at (c0, c1, c2), clipped at the dims."""
    _, _, d0, d1, d2, _, _, b0, b1 = spec
    assert tile.shape == (b1, b0) and 0 <= c2 < d2
    dst = _plane(buf, spec, c2)[c1 : c1 + b1, c0 : c0 + b0]
    dst.copy_(tile[: dst.shape[0], : dst.shape[1]].to(buf.dtype))


def _store_tile(buf, spec, tile, tile0, z):
    """store_rows for both warpgroups: 64-row x 64-column boxes."""
    for wg in range(2):
        for b in range(tile.shape[1] // 64):
            _store(buf, spec, tile[64 * wg : 64 * wg + 64, 64 * b : 64 * b + 64], 64 * b,
                   tile0 + 64 * wg, z)


def _load_tile(buf, spec, tile0, z, cols):
    """load_rows for both warpgroups: the [128][cols] tile of plane z."""
    return torch.cat([
        torch.cat([_box(buf, spec, 64 * b, tile0 + 64 * wg, z) for b in range(cols // 64)], 1)
        for wg in range(2)
    ])


class _Ring:
    """The consumers' side of the ring: the next slice of the schedule."""

    def __init__(self, buf, specs, slices):
        self.buf, self.specs, self.it = buf, specs, iter(slices)

    def product(self, a, n_slices):
        """acc = A[:, 64 s ...] B_s^T over the next n_slices slices (B_s: the
        slice's [N][64] K-major box)."""
        acc = 0.0
        for s in range(n_slices):
            m, c0, c1, c2 = next(self.it)
            acc = acc + a[:, 64 * s : 64 * s + 64] @ _box(self.buf, self.specs[m], c0, c1, c2).T
        return acc

    def done(self):
        assert next(self.it, None) is None, "the schedule has slices no consumer takes"


def _unpack_masks(words, cols):
    """hm.pack_masks' inverse, as K2's threads read their words: the
    [rows][cols] bool masks of whole tiles."""
    bits = (words.long()[:, None] >> torch.arange(32)) & 1
    # dims: tile, wg, warp, lane // 4, lane % 4, i, h, e, jj
    a = bits.reshape(-1, 2, 4, 8, 4, 2, cols // 128, 2, 16).permute(0, 1, 2, 5, 3, 6, 8, 4, 7)
    return a.reshape(-1, cols).bool()


def _tile_words(masks, off, tile0, cols):
    """The mask words of one layer's 128-row tile at tile0: 4 x cols words."""
    return masks[off + tile0 // ROWS * 4 * cols :][: 4 * cols]


def _mask_plane(cfg, n, trunk, heads):
    """The relu-mask plane of the stored activations (trunk_0.., head_0..),
    packed whole layer by layer, rows past n zero."""
    offs, words = hm.mask_layout(cfg, n)
    masks = torch.zeros((words,), dtype=torch.int32)
    tiles = -(-n // ROWS)
    for off, a in zip(offs, trunk + heads):
        active = torch.zeros((tiles * ROWS, a.shape[1]), dtype=torch.bool)
        active[:n] = a > 0
        masks[off : off + tiles * 4 * a.shape[1]] = hm.pack_masks(active)
    return masks


def _replay_k1(cfg, in_dim, x, cond_lin, weights, s_per_ray):
    """K1's tile walk through its maps, schedule and mask layout. Returns
    (rgb [3, N], den [1, N], x_save, act, the forward pack, the mask plane)."""
    n = x.shape[1]
    d, dc, w, wc = cfg.net_depth, cfg.net_depth_condition, cfg.net_width, cfg.net_width_condition
    xc = hm.x_chunks(in_dim)
    wpack, bpack, w_offs, b_offs, _, _ = k1.pack_weights(weights, cfg, "cpu")
    wt, wt_offs, wtx_offs, _ = k1.pack_weights_t(weights, cfg, in_dim, "cpu")
    x_save, act, act_offs, _ = k1.save_buffers(cfg, in_dim, n, 1, "cpu")
    x_save.fill_(float("nan"))
    act.fill_(float("nan"))
    mask_offs, words = hm.mask_layout(cfg, n)
    masks = torch.full((words,), -1, dtype=torch.int32)
    specs, slices = hm.fwd_plan(cfg, in_dim, n, wt_offs, wtx_offs, act_offs)
    bias = lambda l, cols: bpack[b_offs[l] : b_offs[l] + cols]  # noqa: E731
    head = lambda l, k, c: wpack[w_offs[l] : w_offs[l] + k * c].reshape(k, c).float()  # noqa: E731
    rgb, den = torch.zeros((3, n)), torch.zeros((1, n))
    for tile0 in range(0, n, ROWS):
        ring = _Ring(wt, specs, slices)
        rows = torch.arange(tile0, tile0 + ROWS)
        valid = rows < n

        def store_masks(seg, h):  # the epilogue's mask words: stored value > 0, 0 past n
            _tile_words(masks, mask_offs[seg], tile0, h.shape[1])[:] = hm.pack_masks(
                (h > 0) & valid[:, None])

        xt = torch.zeros((ROWS, 64 * xc))
        xt[valid, :in_dim] = _bf(x.T[rows[valid]])
        _store_tile(x_save, specs[hm.F_XSAVE], xt, tile0, 0)
        h = None
        for i in range(d):
            acc = ring.product(h, w // 64) if i > 0 else 0.0
            if k1.reads_x(cfg, i):
                acc = acc + ring.product(xt, xc)
            h = _bf(torch.relu(acc + bias(i, w)))
            _store_tile(act, specs[hm.F_ACT], h, tile0, i)
            store_masks(i, h)
        dn = h @ _bf(head(d, w, 1)) + bias(d, 1)
        h = _bf(ring.product(h, w // 64) + bias(d + 1, w))
        _store_tile(act, specs[hm.F_ACT], h, tile0, d)
        ray = torch.clamp(rows, max=n - 1) // s_per_ray
        for i in range(dc):
            acc = ring.product(h, (w if i == 0 else wc) // 64) + bias(d + 2 + i, wc)
            if i == 0:
                acc = acc + cond_lin[ray]
            h = _bf(torch.relu(acc))
            _store_tile(act, specs[hm.F_ACT_HEAD], h, tile0, i)
            store_masks(d + i, h)
        rg = h @ head(d + 2 + dc, wc, 3) + bias(d + 2 + dc, 3)
        ring.done()
        rgb[:, rows[valid]] = rg[valid].T
        den[:, rows[valid]] = dn[valid].T
    return rgb, den, x_save, act, (wpack, w_offs), masks


def _clusters(pairs, n_splits):
    """The clusters of csrc/mlp_wide.cuh:cluster_wide_dw_kernel over a pair
    table (fused_mlp.dw_pairs) in launch order, as its blocks find them:
    ((tile, split) of rank 0, (tile, split) of rank 1 or None, shared).
    First every split's shared pairs, split by split; then the one-row-tile
    tiles of all splits two to a cluster, item i being tile i % singles of
    split i // singles, the last one alone when their number is odd."""
    shared = [p for p in pairs if p[2]]
    single = [p[0] for p in pairs if not p[2]]
    out = [((t0, s), (t1, s), True) for s in range(n_splits) for t0, t1, _ in shared]
    items = [(t, s) for s in range(n_splits) for t in single]
    items.append(None)
    out += [(items[i], items[i + 1], False) for i in range(0, len(items) - 1, 2)]
    return out


def _replay_k2(cfg, in_dim, x, cond_lin, weights, s_per_ray, g_rgb, g_den, chunk,
               masks_from="plane", need_dx=True):
    """K2's three launches through their maps, schedule, mask layout and job
    table: the tile walk, the dW tiles over sample splits (chunk samples
    each), the fixed-order reduction and the per-ray sums. The walk takes
    its relu masks from K1's bit plane, as the kernel does, or (masks_from
    "act") from the saved activations through 3-D maps over them: the walk
    the plane must match bitwise. Returns (dx or None, d cond_lin, weight
    grads in operand order, coverage counts [splits, total], the G
    workspace)."""
    n = x.shape[1]
    d, dc, w, wc = cfg.net_depth, cfg.net_depth_condition, cfg.net_width, cfg.net_width_condition
    xc = hm.x_chunks(in_dim)
    # The residuals as the plain version stores them (the K1 replay above
    # checks that K1 writes these), so both sides round at the same points.
    wpack, _, w_offs, _, _, _ = k1.pack_weights(weights, cfg, "cpu")
    x_save, act, act_offs, _ = k1.save_buffers(cfg, in_dim, n, 1, "cpu")
    xr, trunk, bneck, heads = k1.stored_activations(
        cfg, x.T, cond_lin.repeat_interleave(s_per_ray, 0), weights)
    x_save.zero_()
    x_save[:, :in_dim] = xr
    for seg, a in enumerate(trunk + [bneck] + heads):
        act[act_offs[seg] : act_offs[seg] + a.numel()] = a.reshape(-1)
    masks, (mask_offs, _) = _mask_plane(cfg, n, trunk, heads), hm.mask_layout(cfg, n)
    act_maps = [hm.spec(hm.ACT, act_offs[0], w, n, d + 1), hm.spec(hm.ACT, act_offs[d + 1], wc, n, dc)]

    def relu_mask(tile0, seg, cols):  # trunk_seg, or head_{seg - d}
        if masks_from == "plane":
            return _unpack_masks(_tile_words(masks, mask_offs[seg], tile0, cols), cols)
        trunk_seg = seg < d
        return _load_tile(act, act_maps[0 if trunk_seg else 1], tile0, seg if trunk_seg else seg - d,
                          cols) > 0

    g_offs, g_stride = k1.g_layout(cfg, n)
    gbuf = torch.full((g_stride,), float("nan"), dtype=torch.bfloat16)
    specs, slices = hm.bwd_plan(cfg, in_dim, n, w_offs, g_offs, need_dx)
    head = lambda l, k, c: wpack[w_offs[l] : w_offs[l] + k * c].reshape(k, c).float()  # noqa: E731
    dx = torch.zeros((in_dim, n)) if need_dx else None
    l_rgb = d + 2 + dc
    for tile0 in range(0, n, ROWS):
        ring = _Ring(wpack, specs, slices)
        rows = torch.arange(tile0, tile0 + ROWS)
        valid = (rows < n)[:, None]
        rc = torch.clamp(rows, max=n - 1)
        gr = _bf(g_rgb.T[rc]) * valid
        g = _bf((gr @ head(l_rgb, wc, 3).T) * relu_mask(tile0, d + dc - 1, wc))
        for l, src in ((l_rgb, g_rgb), (d, g_den)):
            rows8 = torch.zeros((ROWS, 8))
            rows8[:, : src.shape[0]] = _bf(src.T[rc])
            seg = gbuf[g_offs[l] : g_offs[l] + 8 * n].reshape(n, 8)
            seg[rows[valid[:, 0]]] = rows8[valid[:, 0]].to(torch.bfloat16)
        _store_tile(gbuf, specs[hm.B_G_HEAD], g, tile0, dc - 1)
        for i in range(dc - 1, 0, -1):
            g = _bf(ring.product(g, wc // 64) * relu_mask(tile0, d + i - 1, wc)) * valid
            _store_tile(gbuf, specs[hm.B_G_HEAD], g, tile0, i - 1)
        g = _bf(ring.product(g, wc // 64)) * valid
        _store_tile(gbuf, specs[hm.B_G], g, tile0, d)
        gd = _bf(g_den.T[rc]) * valid
        g = _bf((ring.product(g, w // 64) + gd @ head(d, w, 1).T) * relu_mask(tile0, d - 1, w)) * valid
        _store_tile(gbuf, specs[hm.B_G], g, tile0, d - 1)
        for i in range(d - 1, -1, -1):
            if need_dx and k1.reads_x(cfg, i):
                for c in range(xc):
                    part = ring.product(g, w // 64)
                    cols = min(64, in_dim - 64 * c)
                    dx[64 * c : 64 * c + cols, rows[valid[:, 0]]] += part[valid[:, 0], :cols].T
            if i == 0:
                break
            g = _bf(ring.product(g, w // 64) * relu_mask(tile0, i - 1, w)) * valid
            _store_tile(gbuf, specs[hm.B_G], g, tile0, i - 1)
        ring.done()

    # dW: tiles of 128 features x all j columns, one partial per split, two
    # tiles to a cluster in the kernel's order (_clusters): where a pair
    # shares G, each CTA's producer issues every other G box of a stage into
    # both CTAs' stages; a one-row-tile tile walks its own ring.
    rows_, n_tiles = k1.dw_jobs(cfg, in_dim, 1, *k1.act_layout(cfg, n), g_offs, g_stride,
                                k1.x_cols(cfg, in_dim), k1.WIDE_DW_COLS)
    _, total = k1.grad_layout(cfg, in_dim)
    n_splits = -(-n // chunk)
    part = torch.full((n_splits, total), float("nan"))
    count = torch.zeros((n_splits, total), dtype=torch.int32)

    def tile_job(tile):
        job = next(r for r in reversed(rows_) if r[9] <= tile)
        g_off, ldg, j = job[3], job[4], job[6]
        assert job[11] == 1 and j <= k1.WIDE_DW_COLS
        return job, tile - job[9], [hm.G, g_off, ldg, n, 1, ldg, ldg * n, 64, 64], -(-j // 64)

    for r0, r1, shared in _clusters(k1.dw_pairs(rows_)[0], n_splits):
        ctas = [c for c in (r0, r1) if c is not None]  # (tile, split)
        if shared:
            assert r0[1] == r1[1] and tile_job(r0[0])[0] is tile_job(r1[0])[0]
        for ring in [ctas] if shared else [[c] for c in ctas]:  # the CTAs a ring's stages feed
            split = ring[0][1]
            s0, s1 = split * chunk, min(n, (split + 1) * chunk)
            acc = {t: torch.zeros((128, 64 * tile_job(t)[3])) for t, _ in ring}
            bsum = {t: 0.0 for t, _ in ring}
            for st in range(s0, s1, 64):  # one ring stage: 64 samples
                got = {t: {} for t, _ in ring}  # each CTA's G boxes of the stage
                for rank, (tile, _) in enumerate(ring):  # the producers
                    _, _, g_spec, gb = tile_job(tile)
                    for c in range(rank, gb, 2) if shared else range(gb):
                        for dst, _ in ring:
                            assert c not in got[dst]
                            got[dst][c] = _box(gbuf, g_spec, 64 * c, st, 0)
                for tile, _ in ring:  # the consumers, once the stage's bytes are all in
                    job, tm, _, gb = tile_job(tile)
                    a_buf, a_off, lda, k = job[0], job[1], job[2], job[5]
                    assert sorted(got[tile]) == list(range(gb))
                    a_spec = [a_buf, a_off, lda, n, 1, lda, lda * n, 64, 64]
                    src = x_save if a_buf == hm.XSAVE else act
                    boxes = min(2, -(-(k - 128 * tm) // 64))
                    a = torch.cat([_box(src, a_spec, 128 * tm + 64 * b, st, 0) for b in range(boxes)], 1)
                    gg = torch.cat([got[tile][c] for c in range(gb)], 1)
                    acc[tile][: 64 * boxes] += a.T @ gg
                    bsum[tile] = bsum[tile] + gg.sum(0)
            for tile, _ in ring:
                job, tm, _, _ = tile_job(tile)
                k, j, out, bias = job[5], job[6], job[7], job[8]
                lo, hi = 128 * tm, min(k, 128 * tm + 128)
                blk = part[split, out : out + k * j].reshape(k, j)
                blk[lo:hi] = acc[tile][: hi - lo, :j]
                count[split, out : out + k * j].reshape(k, j)[lo:hi] += 1
                if bias >= 0 and tm == 0:
                    part[split, bias : bias + j] = bsum[tile][:j]
                    count[split, bias : bias + j] += 1
    flat = part[0].clone()
    for split in range(1, n_splits):  # reduce_kernel: slices in order
        flat = flat + part[split]
    grads = k1.unpack_grads(flat, weights, cfg, in_dim, stacked=False)
    g_h0 = gbuf[g_offs[d + 2] : g_offs[d + 2] + n * wc].reshape(-1, s_per_ray, wc).float()
    return dx, g_h0.sum(1), grads, count, gbuf


@pytest.fixture(scope="module")
def flagship():
    """The flagship background MLP (8x256, skip at layer 5, head 128) on a
    ragged N (two tiles, the second 55 rows)."""
    cfg = MLPConfig()
    assert hm.is_wide(cfg)
    b, s = 3, 61
    rng = np.random.default_rng(7)
    w = [torch.from_numpy(a) for a in _weights(cfg, F_IN)]
    x = torch.from_numpy(rng.uniform(-1, 1, size=(F_IN, b * s)).astype(np.float32))
    cond = torch.from_numpy(rng.uniform(-1, 1, size=(b, F_C)).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(size=(3, b * s)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(1, b * s)).astype(np.float32))
    cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg)
    return cfg, w, x, cond, cond_lin, s, g_rgb, g_den


def test_k1_maps_and_schedule_replay_the_forward(flagship):
    cfg, w, x, cond, cond_lin, s, _, _ = flagship
    rgb, den, x_save, act, _, _ = _replay_k1(cfg, F_IN, x, cond_lin, w, s)
    ref_rgb, ref_den = k1.fused_nerf_mlp_reference(x, cond, w, cfg, s)
    assert float((rgb - ref_rgb).abs().max()) < 2e-2 and float((den - ref_den).abs().max()) < 2e-2
    # The saved residuals are the plain version's stored activations.
    n = x.shape[1]
    xr, trunk, bneck, heads = k1.stored_activations(
        cfg, x.T, cond_lin.repeat_interleave(s, 0), w)
    assert torch.equal(x_save[:, :F_IN].float(), xr) and not x_save[:, F_IN:].float().any()
    offs, _ = k1.act_layout(cfg, n)
    for seg, a in enumerate(trunk + [bneck] + heads):
        got = act[offs[seg] : offs[seg] + a.numel()].reshape(a.shape).float()
        assert _rel(got, a) < 1e-3, seg
    # and the JAX package's XLA forward (bf16 operands) on the same numpy inputs
    jcfg = JMLPConfig(**{f: getattr(cfg, f) for f in (
        "net_depth", "net_width", "net_depth_condition", "net_width_condition", "skip_layer")})
    j_rgb, j_den = mlp_reference_forward(
        jcfg, jnp.asarray(x.numpy()), jnp.asarray(np.repeat(cond.numpy(), s, 0)),
        [jnp.asarray(t.numpy()) for t in w], dtype=jnp.bfloat16, x_fm=True, out_fm=True,
    )
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=2e-2)
    np.testing.assert_allclose(den.numpy(), np.asarray(j_den), atol=2e-2)


@pytest.mark.parametrize("chunk", [64, 128])
def test_k2_maps_schedule_and_dw_tiles_replay_the_backward(flagship, chunk):
    cfg, w, x, _, cond_lin, s, g_rgb, g_den = flagship
    dx, dcond, grads, count, _ = _replay_k2(cfg, F_IN, x, cond_lin, w, s, g_rgb, g_den, chunk)
    ref_dx, ref_dcond, ref_grads = k1.fused_nerf_mlp_bwd_reference(x, cond_lin, w, cfg, s, g_rgb, g_den)
    assert _rel(dx, ref_dx) < 1e-3 and _rel(dcond, ref_dcond) < 1e-3
    for i, (a, r) in enumerate(zip(grads, ref_grads)):
        assert a.shape == r.shape and _rel(a, r) < 1e-3, f"operand {i}: {_rel(a, r)}"
    # Every gradient element is formed by exactly one (tile, split) per split.
    assert torch.equal(count, torch.ones_like(count))


def test_k1_writes_the_relu_masks_as_bits(flagship):
    """K1's mask plane, bit for bit: the activations it stored > 0, packed
    layer by layer (trunk_0.., head_0..), rows past n zero; against the
    plain version's stored activations it differs only where a stored value
    does (a float32 sum in another order rounding to the other bf16)."""
    cfg, w, x, _, cond_lin, s, _, _ = flagship
    _, _, _, act, _, masks = _replay_k1(cfg, F_IN, x, cond_lin, w, s)
    n, d = x.shape[1], cfg.net_depth
    _, trunk, _, heads = k1.stored_activations(cfg, x.T, cond_lin.repeat_interleave(s, 0), w)
    act_offs, _ = k1.act_layout(cfg, n)
    segs = list(range(d)) + [d + 1 + i for i in range(cfg.net_depth_condition)]
    stored = [act[act_offs[seg] :][: a.numel()].reshape(a.shape).float() for seg, a in
              zip(segs, trunk + heads)]
    offs, words = hm.mask_layout(cfg, n)
    assert words == -(-n // ROWS) * 4 * (d * cfg.net_width + cfg.net_width_condition)
    assert torch.equal(masks, _mask_plane(cfg, n, stored[:d], stored[d:]))
    for off, a, got in zip(offs, trunk + heads, stored):
        bits = _unpack_masks(masks[off:][: -(-n // ROWS) * 4 * a.shape[1]], a.shape[1])
        assert not bits[n:].any()
        assert not ((bits[:n] != (a > 0)) & (got == a)).any()
    assert 0 < float(torch.cat([a > 0 for a in trunk], 1).float().mean()) < 1


@pytest.mark.parametrize("cols", [128, 256])
def test_mask_words_follow_the_accumulator_fragments(cols):
    """pack_masks puts (row, column) where csrc/mlp_wide.cuh's threads keep
    it: thread p = 128 wg + t, word i N / 128 + j / 16 of its N / 64, bit
    16 e + j % 16, for row 64 wg + acc_row(t, i) and column acc_col(t, j) + e."""
    active = torch.rand((2 * ROWS, cols), generator=torch.Generator().manual_seed(3)) < 0.5
    words = hm.pack_masks(active)
    assert words.dtype == torch.int32 and words.numel() == 2 * 4 * cols
    for tile in range(2):
        for p in range(256):
            wg, t = divmod(p, 128)
            for i in range(2):
                row = ROWS * tile + 64 * wg + (t >> 5) * 16 + ((t & 31) >> 2) + 8 * i
                for j in range(cols // 8):
                    word = int(words[tile * 4 * cols + p * (cols // 64) + i * (cols // 128) + j // 16])
                    for e in range(2):
                        col = 8 * j + 2 * (t & 3) + e
                        assert (word >> (16 * e + j % 16)) & 1 == int(active[row, col])
    assert torch.equal(_unpack_masks(words, cols), active)


@pytest.mark.parametrize("need_dx", [True, False])
def test_k2_reads_its_masks_from_the_plane_bitwise(flagship, need_dx):
    """The tile walk on K1's bit plane gives bitwise the G workspace, dx,
    d cond_lin and gradients of the walk that tests the saved activations."""
    cfg, w, x, _, cond_lin, s, g_rgb, g_den = flagship
    bits = _replay_k2(cfg, F_IN, x, cond_lin, w, s, g_rgb, g_den, 64, "plane", need_dx)
    acts = _replay_k2(cfg, F_IN, x, cond_lin, w, s, g_rgb, g_den, 64, "act", need_dx)
    dx, dcond, grads, _, gbuf = bits
    assert torch.equal(gbuf.float().nan_to_num(7.0), acts[4].float().nan_to_num(7.0))
    assert (dx is None) == (not need_dx) and (dx is None or torch.equal(dx, acts[0]))
    assert torch.equal(dcond, acts[1]) and all(torch.equal(a, b) for a, b in zip(grads, acts[2]))
    # every row of G the walk writes was written
    n = x.shape[1]
    g_offs, _ = k1.g_layout(cfg, n)
    assert not gbuf[g_offs[0] : g_offs[0] + n * cfg.net_width].float().isnan().any()


def test_wide_dw_tiles_span_whole_layers():
    """At the flagship widths a dW tile is 128 features x all (<= 256)
    columns, so each layer's G slab is one box row per stage."""
    cfg = MLPConfig()
    n = 1000
    act_offs, act_stride = k1.act_layout(cfg, n)
    g_offs, g_stride = k1.g_layout(cfg, n)
    rows, tiles = k1.dw_jobs(cfg, F_IN, 1, act_offs, act_stride, g_offs, g_stride,
                             k1.x_cols(cfg, F_IN), k1.WIDE_DW_COLS)
    assert len(rows) == 13 <= hm.MAX_JOBS and all(r[11] == 1 and r[6] <= 256 for r in rows)
    assert tiles == sum(-(-r[5] // 128) for r in rows) == 23
    assert [r[9] for r in rows] == sorted(r[9] for r in rows)


@pytest.mark.parametrize("kw,in_dim,n_splits", [({}, F_IN, 17), ({"net_depth_condition": 2}, F_IN, 3),
                                                ({}, 128, 2), ({"skip_layer": 2}, 100, 1)])
def test_wide_dw_clusters_run_every_tile_once_per_split(kw, in_dim, n_splits):
    """K2's dW clusters (dw_pairs, _clusters): every (job, row tile) runs
    once per split, on one CTA; a cluster that shares G holds the two row
    tiles of one job (one G map) on one split; the one-row-tile tiles pair
    up without sharing, an odd one out last and with no partner."""
    cfg = MLPConfig(**kw)
    n = 1000
    rows, tiles = k1.dw_jobs(cfg, in_dim, 1, *k1.act_layout(cfg, n), *k1.g_layout(cfg, n),
                             k1.x_cols(cfg, in_dim), k1.WIDE_DW_COLS)
    pairs, shared = k1.dw_pairs(rows)
    assert all(len(p) == k1.PAIR_FIELDS for p in pairs)
    assert [p[2] for p in pairs] == sorted((p[2] for p in pairs), reverse=True)  # shared first
    job = lambda t: next(r for r in reversed(rows) if r[9] <= t)  # noqa: E731
    for t0, t1, sh in pairs:
        if sh:
            assert job(t0) is job(t1) and (t0 - job(t0)[9], t1 - job(t1)[9]) == (0, 1)
        else:
            assert job(t0)[10] == 1 and t1 == -1
    assert shared == 2 * sum(p[2] for p in pairs) == sum(2 * (r[10] // 2) for r in rows)
    clusters = _clusters(pairs, n_splits)
    ran = sorted(c for r0, r1, _ in clusters for c in (r0, r1) if c is not None)
    assert ran == [(t, s) for t in range(tiles) for s in range(n_splits)]
    for r0, r1, sh in clusters:
        if sh:
            assert r0[1] == r1[1] and [r0[0], r1[0], 1] in pairs
        else:
            assert job(r0[0])[10] == 1 and (r1 is None or job(r1[0])[10] == 1)
    assert [r1 for _, r1, _ in clusters].count(None) == (tiles - shared) * n_splits % 2
    assert all(r1 is not None for _, r1, _ in clusters[:-1])
    singles = (tiles - shared) * n_splits
    assert len(clusters) == shared // 2 * n_splits + -(-singles // 2)


def test_wide_dw_pairs_share_g_at_the_flagship_widths():
    """At the flagship widths 20 of the 23 dW tiles take G by multicast: of
    the 10,112 B of G boxes the tiles load a sample, 4,480 cross from L2
    once instead of twice (the trunk's layers 1-7, bottleneck, head_0 and
    the density head); l0, the skip layer's x rows and rgb load their own.
    At the first training cell's 17 splits the card runs 196 clusters, one
    CTA idle, where the tiles alone are 391 blocks."""
    cfg = MLPConfig()
    n = 4096
    rows, tiles = k1.dw_jobs(cfg, F_IN, 1, *k1.act_layout(cfg, n), *k1.g_layout(cfg, n),
                             k1.x_cols(cfg, F_IN), k1.WIDE_DW_COLS)
    pairs, shared = k1.dw_pairs(rows)
    assert (shared, tiles, len(pairs)) == (20, 23, 13)
    a, g, saved = k1.dw_box_bytes(rows, pairs)
    assert (a + g, g, saved) == (15744, 10112, 4480)
    assert k1.dw_box_bytes(rows, []) == (a, g, 0)
    assert k1.dw_ingest_bytes(cfg, F_IN, n) == (11264 * n, 15744 * n)
    assert pairs[-3:] == [[0, -1, 0], [11, -1, 0], [22, -1, 0]]
    clusters = _clusters(pairs, 17)
    assert len(clusters) == 196 and clusters[-1][1] is None
    # Built with the job table, once per shape, and kept.
    host, shared_ = k1.dw_pair_table(cfg, F_IN, n, "cpu")
    assert host.tolist() == pairs and shared_ == 20
    assert k1.dw_pair_table(cfg, F_IN, n, "cpu")[0] is host
    # No pairs for the object build's job tables.
    assert k1.dw_pair_table(MLPConfig(net_width=128), 63, n, "cpu") == (None, 0)


@pytest.mark.parametrize("widths,counts", [((256, 128), (23, 20)), ((128, 128), None)])
def test_k2_counts_its_dw_tiles(monkeypatch, widths, counts):
    """The wide K2 counts, while a profiler records, the dW tiles a launch
    runs (`k2.dw_tiles`) and those whose G arrives by multicast
    (`k2.dw_tiles_shared`), and hands the entry point its pair table; the
    128 / 128 build counts neither and gets none. The C entry points are
    recorders here."""
    from durf_tpu_torch import metrics

    seen = {}

    def entry(name):
        def call(*args):
            seen[name] = args
            return 0
        return call

    monkeypatch.setattr(build, "load", lambda lib: types.SimpleNamespace(
        durf_fused_nerf_mlp_fwd=entry("fwd"), durf_fused_nerf_mlp_bwd=entry("bwd")))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=4))
    monkeypatch.setattr(k1, "stream_of", lambda d: 0)
    for fn in (k1.fused_nerf_mlp, k1.fused_nerf_mlp_bwd):  # the recorded launches count nowhere
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "width_launches", collections.Counter())
    cfg = MLPConfig(net_width=widths[0], net_width_condition=widths[1])
    w = [torch.from_numpy(a) for a in _weights(cfg, F_IN)]
    b, s = 2, 64
    _, _, res = k1._k1_launch(torch.rand((F_IN, b * s)), torch.rand((b, widths[1])), w, cfg, s,
                              save=True)
    metrics.counters()
    with torch.profiler.profile():
        k1.fused_nerf_mlp_bwd(res, torch.rand((3, b * s)), torch.rand((1, b * s)), w, cfg, s)
    got = metrics.counters()
    pairs, n_pairs = seen["bwd"][15:17]
    if counts is None:
        assert "k2.dw_tiles" not in got and (pairs, n_pairs) == (None, 0)
    else:
        assert (got["k2.dw_tiles"], got["k2.dw_tiles_shared"]) == counts
        host, _ = k1.dw_pair_table(cfg, F_IN, b * s, "cpu")
        assert (pairs, n_pairs) == (host.data_ptr(), 13)


def test_job_table_is_built_once_and_holds_offsets():
    cfg = MLPConfig()
    n = 4096
    dev1, host1, tiles1 = k1.job_table(cfg, F_IN, n, 1, "cpu")
    _ = torch.empty((1 << 20,))  # other allocations change no entry
    dev2, host2, tiles2 = k1.job_table(cfg, F_IN, n, 1, "cpu")
    assert dev1 is dev2 and host1 is host2 and tiles1 == tiles2
    rows, _ = k1.dw_jobs(cfg, F_IN, 1, *k1.act_layout(cfg, n), *k1.g_layout(cfg, n),
                         k1.x_cols(cfg, F_IN), k1.WIDE_DW_COLS)
    assert host1.tolist() == rows
    # offsets inside the buffers, never addresses
    _, act_stride = k1.act_layout(cfg, n)
    _, g_stride = k1.g_layout(cfg, n)
    assert int(host1[:, 1].max()) < act_stride and int(host1[:, 3].max()) < g_stride
    # a per-object table (K4's) is separate and uses 128-column tiles
    box = MLPConfig(net_depth=4, net_width=128)
    _, host4, _ = k1.job_table(box, 63, n, 2, "cpu")
    assert host4 is not host1 and set(host4[:, 11].tolist()) == {1}


def test_plans_are_cached_and_drop_the_dx_slices():
    cfg = MLPConfig()
    n = 4096
    w = [torch.from_numpy(a) for a in _weights(cfg, F_IN)]
    _, _, w_offs, _, _, _ = k1.pack_weights(w, cfg, "cpu")
    g_offs, _ = k1.g_layout(cfg, n)
    a = hm.c_plan("bwd", cfg, F_IN, n, (w_offs, g_offs))
    b = hm.c_plan("bwd", MLPConfig(), F_IN, n, (w_offs, g_offs))
    assert a is b and a[1] <= hm.MAX_MAPS and a[3] <= hm.MAX_SLICES
    _, with_dx = hm.bwd_plan(cfg, F_IN, n, w_offs, g_offs, True)
    _, no_dx = hm.bwd_plan(cfg, F_IN, n, w_offs, g_offs, False)
    # layers 0 and 5 read x: 4 slices of their x rows each
    assert len(with_dx) - len(no_dx) == 2 * 4 * hm.x_chunks(F_IN) and a[3] == len(with_dx)


def test_wide_layouts_keep_segments_at_a_fixed_stride():
    """The 3-D maps need the trunk and bottleneck segments, and the head
    segments, of act and g at a fixed stride; x_save rows span whole boxes."""
    cfg = MLPConfig(net_depth_condition=2)
    n = 77
    w, wc, d = cfg.net_width, cfg.net_width_condition, cfg.net_depth
    g_offs, g_stride = k1.g_layout(cfg, n)
    assert [g_offs[l] for l in range(d)] + [g_offs[d + 1]] == [i * w * n for i in range(d + 1)]
    assert g_offs[d + 3] - g_offs[d + 2] == wc * n
    assert sorted(g_offs) == g_offs[: d] + [g_offs[d + 1], g_offs[d + 2], g_offs[d + 3],
                                            g_offs[d], g_offs[d + 4]]
    assert g_stride == sum(k1.g_widths(cfg)) * n
    act_offs, _ = k1.act_layout(cfg, n)
    assert act_offs[: d + 1] == [i * w * n for i in range(d + 1)]
    assert k1.x_cols(cfg, 60) == 64 and k1.x_cols(cfg, 65) == 128
    assert k1.x_cols(MLPConfig(net_width=128), 60) == 64 and k1.x_cols(MLPConfig(net_width=128), 63) == 64
    assert k1.x_cols(MLPConfig(net_width=128), 70) == 96


@pytest.mark.parametrize(
    "kw,in_dim,ok",
    [({}, 60, True), ({}, 128, True), ({}, 129, False), ({"net_depth_condition": 3}, 60, False)],
)
def test_wide_kernels_refuse_what_they_do_not_take(kw, in_dim, ok):
    cfg = MLPConfig(**kw)
    if ok:
        k1.check_kernel_config(cfg, in_dim)
    else:
        with pytest.raises(ValueError, match="wide"):
            k1.check_kernel_config(cfg, in_dim)
