#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one fails the run, with a non-zero exit, if it goes wrong):
  1. print the card's name and power limit;
  2. build the CUDA kernels from durf_tpu_torch/csrc/ with nvcc, all
     sources at once; print ptxas's registers and spills, and how often the
     K1-K6 libraries' machine code holds wgmma (HGMMA), TMA (UTMALDG /
     UTMASTG) and mbarrier (SYNCS) instructions, also in the kernels of the
     mask-free builds at 128/128 (TAG 1, 2, 5, 6) alone;
  3. K1 (fused background MLP forward, the wgmma + TMA kernel at the
     flagship widths) against its plain PyTorch version at N = 8192 x 128
     (a render chunk) and at an N that is not a tile multiple, atol 2e-2
     (bf16 operands, float32 sums in another order); timed at the render
     chunk, and at the training step's shape (N = 4096 x 128) with the
     residuals saved for K2, against its plain version and its bound (the
     larger of operations and bytes, the save's bytes counted);
  4. K2 (its backward) against the plain backward at N = 4096 x 128 and
     1000 x 77 on random cotangents: every output (dx, d cond_lin, each
     weight and bias gradient) finite and within relative L2 2e-2, and two
     calls on the same inputs bitwise equal; at 4096 x 128 also the whole
     autograd Function (K1 then K2, with the per-ray condition product)
     against autograd of the plain forward, and its time and bound;
  5. K3 (objects-in-grid MLP forward, the wgmma + TMA kernel that skips
     the (tile, object) pairs no ray hits) like K1 at N_obj = 2, 4, 8 and
     hit shares 1.0, 0.5, 0.03 (N = 8192 x 128), at 1000 x 77, and at the
     compacted step's shape (256 x 128, the first 117 rays hitting); each
     prints the share of pairs that ran; timed at N_obj 2 against two
     bounds, the dense one and that of the pairs that ran; an object no ray
     hits leaves the outputs bitwise those of the other object alone;
  6. K4 (its backward) like K2 at the same object counts and shares (N =
     4096 x 128), at 1000 x 77 and at the step's shape, two calls bitwise
     equal, its Function against autograd of the plain forward at N_obj =
     2, and an object no ray hits gets exactly zero weight gradients and
     d cond_lin while dx stays bitwise that of the other object alone;
  7. K1 and K2 at 128/128 (the per-object route's build, and the width of
     the proposal MLP: the mask-free build of K3's and K4's kernels) for the
     8x128 object MLP (F_in 63) and the 4x128 proposal MLP (F_in 60), at N
     = 4096 x 128 and 1000 x 77: K1 with and without saving residuals like
     K1, K2 on what it saved like K2 (two calls bitwise equal), at 8x128 and
     4096 x 128 their Function against autograd of the plain forward; each
     timed at 4096 x 128 beside its bound and plain version; K5 (gated MLP
     forward, the input blended in the tile; at 128/128 the mask-free
     object kernel's TAG 5) and K6 (its backward, TAG 6) against their plain
     versions at the object width (8x128, F_in 63) on row-major features
     with a per-ray 0/1 gate letting 100%, 50% and 3% of the rays in, at N =
     4096 x 128 and 1000 x 77, two K6 calls bitwise equal; at 4096 x 128
     and 3% their Function against autograd of the plain forward, and their
     times;
  8. the gated stacked object MLPs: NerfMLP(num_stack=2,
     pallas_gate_in_kernel=True) on row-major flagship features through
     forward and backward, against the same module on the plain path; K5
     and K6 must each launch N_obj = 2 times;
  9. the render slice: the flagship model at the kernel operating point
     renders two 128x128 frames through make_render_fn + render_image in
     chunks of 8192 rays; K1 and K3 must each launch levels x chunks = 8
     times; the images must be finite with rgb and acc in [0, 1]; one chunk
     is held against the same model on the plain versions (atol 2e-2), and
     against the per-object route (K1 per object, levels x 3 launches);
 10. the training slice, the main path: entry.train_entry() (batch 4096,
     seed 0, bench.py's object-ray compaction at capacity 0.0625, k = 256),
     2 warm-up then 10 timed steps; K1-K4 must each launch levels x steps =
     20 times, every stat be finite and obj/overflow_rays 0; ms per step,
     rays/s, ray-samples/s; then the same without compaction (the earlier main path)
     for comparison;
 11. compaction is exact: one step's loss and raw gradients with and
     without compaction on the same weights and random stream (loss within
     relative 1e-5, every gradient leaf within relative L2 1e-3);
 12. the per-object route (fused_objects=False): one step's loss and raw
     gradients against the fused route (relative 1e-2 and L2 5e-2), K1 and
     K2 launching levels x (1 + N_obj) = 6 times, K3 and K4 none; timed
     beside the fused route's step;
 13. one step with the centering prior on (centering_loss_mult 0.1): the
     loss and loss/centering_* finite;
 14. descent: 20 steps at a constant lr of 5e-3, the last loss below the
     first;
 15. one step's loss and raw gradients on the kernel path against the
     plain path with the same weights and random stream (batch 1024): loss
     within relative 1e-2, every gradient leaf within relative L2 5e-2;
 16. proposal levels (bench.py --proposal, configs/waymo_fast.gin's
     switch): entry.train_entry(proposal=True), the 4x128 proposal MLP on
     level 0 (K1/K2 at 128/128), the background MLP on the final level;
     2 warm-up then 10 timed steps at batch 4096 with compaction, beside
     the flagship compacted step timed in the same phase; K1-K4 must each
     launch 20 times, K1 and K2 10 at 256/128 and 10 at 128/128; one
     step against the plain step (as phase 15), one render chunk against
     the plain render (K1 once at each width, K3 twice), one step at
     proposal_samples 64 finite with loss/interlevel, a 20-step descent;
 17. a JSON line with every kernel's numbers (launches from the path that
     runs the kernel: K1-K4 the main path, K5/K6 phase 8, K1 and K2 at
     128/128 phase 16, with phase 12's beside them; K3 and K4 timed at the
     compacted step's shape, their bound that of the pairs that ran, with
     the dense bound, the pair share and the times at each hit share beside
     it), then the card's name and power limit, and as the last line
     {"ok": true, "device": {...}}.

Exits non-zero without printing a result when CUDA is not available, or
when run outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
TOL = 2e-2
# Shapes: (rays, samples per ray) of the two K1 checks, the K3 checks'
# rays, samples and object counts, and the slice's frame size and chunk.
K1_SHAPES = ((8192, 128), (1000, 77))
K3_RAYS, K3_SAMPLES, K3_OBJECTS = 8192, 128, (2, 4, 8)
SLICE_SIZE, SLICE_CHUNK = 128, 8192
# Backward checks: the training step's shape (4096 rays x 128 samples) and
# one that is not a tile multiple; K4 at these object counts.
BWD_SHAPES = ((4096, 128), (1000, 77))
K4_OBJECTS = (2, 4, 8)
# Relative L2 error per backward output: bf16 operands, float32 sums in
# another order, and isolated relu flips.
BWD_TOL = 2e-2
# Training phases: the flagship batch (bench.py:31), steps, and the smaller
# batch of the kernel-vs-plain step comparison.
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS, DESCENT_STEPS = 4096, 2, 10, 20
COMPARE_BATCH = 1024
# bench.py's object-ray compaction fraction (bench.py:59-67).
OBJ_CAPACITY = 0.0625
# K5/K6: the share of rays whose gate is 1 (the flagship batch hits ~3%).
GATE_HIT = 0.03
# K3/K4: the hit shares checked and timed (every pair; today's checks; the
# flagship batch), the compacted step's rays and how many of them hit a box
# (PERF.md section 4), and the kernels' tile.
HIT_SHARES = (1.0, 0.5, GATE_HIT)
MAIN_RAYS, MAIN_HITTING, OBJ_TILE = 256, 117, 128
# The proposal phase's untimed step: proposal levels of 64 samples before
# the final 128.
PROPOSAL_SAMPLES = 64
# Compaction permutes the object pipeline's rays: the same values, float32
# sums over samples in another order.
EXACT_LOSS_TOL, EXACT_GRAD_TOL = 1e-5, 1e-3


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `iters` calls, timed with CUDA
    events after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operation and the byte time."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mlp_macs(cfg, in_dim: int, cond_dim: int):
    """(multiply-adds per sample inside the kernel, per ray for the hoisted
    condition rows, parameter count)."""
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    w, wc = cfg.net_width, cfg.net_width_condition
    per_sample = sum(d * w for d in k1.layer_dims(cfg, in_dim))
    per_sample += w * cfg.num_density_channels + w * w + w * wc
    per_sample += (cfg.net_depth_condition - 1) * wc * wc + wc * cfg.num_rgb_channels
    per_ray = cond_dim * wc
    params = per_sample + per_ray + w * (cfg.net_depth + 1) + wc * cfg.net_depth_condition
    params += cfg.num_rgb_channels + cfg.num_density_channels
    return per_sample, per_ray, params


def random_mlp(cfg, in_dim, cond_dim, stack, gen, device):
    """A NerfMLP's operand list with glorot kernels and small random biases."""
    import torch

    from durf_tpu_torch.models.mlp import NerfMLP

    mlp = NerfMLP(cfg, in_dim, cond_dim, "bfloat16", num_stack=stack)
    mlp.reset_parameters(gen)
    with torch.no_grad():
        for layer in mlp.layers.values():
            layer.bias.copy_(0.1 * torch.randn(layer.bias.shape, generator=gen))
    return [t.detach().to(device) for t in mlp.operands()]


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def k1_bytes(cfg, f_in, f_c, b, n, params, save: bool) -> float:
    """Bytes K1 must move: x, the per-ray condition, the weights and the
    [4, N] outputs, and with `save` the residuals it writes for K2 (the bf16
    input rows and every stored activation)."""
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    nbytes = 4.0 * (f_in * n + f_c * b + params + 4 * n)
    if save:
        _, stride = k1.act_layout(cfg, n)
        nbytes += 2.0 * (k1.x_cols(cfg, f_in) * n + stride)
    return nbytes


def check_k1(dev, gen):
    """K1 against its plain version at the render chunk's shape and a ragged
    one; timed at the render chunk (no save) and at the training step's
    shape with save, which the kernels line carries."""
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    cfg, f_in, f_c = MLPConfig(), 60, 27
    w = random_mlp(cfg, f_in, f_c, None, gen, dev)
    per_sample, per_ray, params = mlp_macs(cfg, f_in, f_c)
    result = None
    for i, (b, s) in enumerate(K1_SHAPES):
        n = b * s
        x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
        cond = (2 * torch.rand((b, f_c), generator=gen) - 1).to(dev)
        out = k1.fused_nerf_mlp(x, cond, w, cfg, s)
        torch.cuda.synchronize()
        ref = k1.fused_nerf_mlp_reference(x, cond, w, cfg, s)
        err = max_err(out, ref)
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        print(f"K1 fused_nerf_mlp_fwd N={n} (B={b}, S={s}): max_abs_err {err:.3e} finite={finite}")
        if not finite or err > TOL:
            raise SystemExit(f"K1 disagrees with its plain version: {err} > {TOL}")
        if i == 0:
            ms = time_ms(lambda: k1.fused_nerf_mlp(x, cond, w, cfg, s), iters=10)
            flops = 2.0 * (per_sample * n + per_ray * b)
            bound_ms, bound_by = bound(flops, k1_bytes(cfg, f_in, f_c, b, n, params, False))
            print(f"K1 N={n} (render, no save): kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s), bound {bound_ms:.3f} ms ({bound_by})")
        del x, cond, out, ref
    # The training step's shape, saving the residuals for K2.
    b, s = BWD_SHAPES[0]
    n = b * s
    x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
    cond = (2 * torch.rand((b, f_c), generator=gen) - 1).to(dev)
    cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
    out = k1._k1_launch(x, cond_lin, w, cfg, s, save=True)
    torch.cuda.synchronize()
    ref = k1.fused_nerf_mlp_reference(x, cond, w, cfg, s)
    err = max_err(out[:2], ref)
    del out
    if err > TOL:
        raise SystemExit(f"K1 with save disagrees with its plain version: {err} > {TOL}")
    ms = time_ms(lambda: k1._k1_launch(x, cond_lin, w, cfg, s, save=True), iters=10)
    plain_ms = time_ms(lambda: k1.fused_nerf_mlp_reference(x, cond, w, cfg, s), 3, 1)
    flops = 2.0 * (per_sample * n + per_ray * b)
    nbytes = k1_bytes(cfg, f_in, f_c, b, n, params, True)
    bound_ms, bound_by = bound(flops, nbytes)
    print(
        f"K1 N={n} (training step, save): max_abs_err {err:.3e}; kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)"
    )
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    del x, cond, cond_lin, ref
    torch.cuda.empty_cache()
    return result


def obj_hit(n_obj, b, share, gen, dev):
    """A 0/1 hit mask [n_obj, b]: each ray hits each object with probability
    `share`, or (share "main") the compacted training step's pattern, the
    first MAIN_HITTING of its rays hitting each object with probability 0.6
    and the rest nothing."""
    import torch

    if share == "main":
        hit = torch.zeros((n_obj, b))
        hit[:, :MAIN_HITTING] = (torch.rand((n_obj, MAIN_HITTING), generator=gen) < 0.6).float()
    else:
        hit = (torch.rand((n_obj, b), generator=gen) < share).float()
    return hit.to(dev)


def obj_bounds(flops_per_sample, nbytes, x_bytes_per_sample, hit, n, s):
    """(dense bound ms, bound ms of the pairs that ran, its bound_by, share of
    (tile, object) pairs that ran): the operations and bytes of every pair,
    and those of the pairs K3/K4 ran (their tiles' samples; the input x is
    read only for tiles that run some object)."""
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    import torch

    kept = k3.kept_pairs(hit, n, s).cpu().float()
    t0 = torch.arange(0, n, OBJ_TILE)
    rows = torch.clamp(n - t0, max=OBJ_TILE).float()
    samples_ran = float((kept * rows[:, None]).sum())
    idle = float((rows * (kept.sum(1) == 0).float()).sum())  # samples of tiles that run nothing
    dense_ms, _ = bound(flops_per_sample * n * hit.shape[0], nbytes)
    ran_ms, ran_by = bound(flops_per_sample * samples_ran, nbytes - x_bytes_per_sample * idle)
    return dense_ms, ran_ms, ran_by, float(kept.mean())


def check_k3(dev, gen):
    """K3 against its plain version at N_obj 2, 4, 8 and hit shares 1.0,
    0.5, 0.03 (N = 8192 x 128), at 1000 x 77, and at the compacted step's
    shape; one object that no ray hits contributes exactly nothing. Timed
    at N_obj 2 at each share and at the step's shape, which the kernels line
    carries."""
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    cfg, f_in, f_c = MLPConfig(net_width=128), 63, 27
    per_sample, _, params = mlp_macs(cfg, f_in, f_c)
    weights = {n_obj: random_mlp(cfg, f_in, f_c, n_obj, gen, dev) for n_obj in K3_OBJECTS}
    cases = [((K3_RAYS, K3_SAMPLES), n_obj, share) for n_obj in K3_OBJECTS for share in HIT_SHARES]
    cases += [(BWD_SHAPES[1], 2, 0.5), ((MAIN_RAYS, K3_SAMPLES), 2, "main")]
    result, by_share, xs = None, {}, {}
    for (b, s), n_obj, share in cases:
        n = b * s
        if (b, s) not in xs:
            xs = {(b, s): (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)}
        x, w = xs[(b, s)], weights[n_obj]
        hit = obj_hit(n_obj, b, share, gen, dev)
        cond_lin = torch.randn((n_obj, b, cfg.net_width_condition), generator=gen)
        cond_lin = cond_lin.to(torch.bfloat16).float().to(dev)
        out = k3.fused_obj_mlp(x, hit, cond_lin, w, cfg, s)
        torch.cuda.synchronize()
        ref = k3.fused_obj_mlp_reference(x, hit, cond_lin, w, cfg, s)
        err = max_err(out, ref)
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        nbytes = 4.0 * (f_in * n + n_obj * b * (1 + cfg.net_width_condition) + n_obj * params + 4 * n)
        dense_ms, ran_ms, ran_by, pairs = obj_bounds(2.0 * per_sample, nbytes, 4.0 * f_in, hit, n, s)
        line = (f"K3 fused_obj_mlp_fwd N_obj={n_obj} N={n} (B={b}, S={s}) hit share {share}: "
                f"max_abs_err {err:.3e} finite={finite}; pairs ran {pairs:.4f}")
        if n_obj == 2 and (b, s) != BWD_SHAPES[1]:
            ms = time_ms(lambda: k3.fused_obj_mlp(x, hit, cond_lin, w, cfg, s), iters=10)
            line += (f"; kernel {ms:.3f} ms, bound {dense_ms:.3f} ms dense (operations), "
                     f"{ran_ms:.3f} ms for the pairs that ran ({ran_by})")
            by_share[f"{b}x{s}_hit_{share}"] = dict(ms=ms, bound_ms=ran_ms, dense_bound_ms=dense_ms,
                                                    pair_share=pairs)
            if share in ("main", 1.0):
                plain_ms = time_ms(lambda: k3.fused_obj_mlp_reference(x, hit, cond_lin, w, cfg, s), 3, 1)
                line += f", plain {plain_ms:.3f} ms"
            if share == "main":
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=ran_ms,
                              bound_by=ran_by, dense_bound_ms=dense_ms, pair_share=pairs)
        print(line)
        if not finite or err > TOL:
            raise SystemExit(f"K3 disagrees with its plain version at N_obj={n_obj}, hit share "
                             f"{share}: {err} > {TOL}")
        del hit, cond_lin, out, ref
    # One object that no ray hits: the outputs are those of the other alone.
    b, s = K3_RAYS, K3_SAMPLES
    x = xs.get((b, s), None)
    x = (2 * torch.rand((f_in, b * s), generator=gen) - 1).to(dev) if x is None else x
    hit = obj_hit(2, b, GATE_HIT, gen, dev)
    hit[1] = 0.0
    cond_lin = torch.randn((2, b, cfg.net_width_condition), generator=gen).to(torch.bfloat16).float().to(dev)
    w = weights[2]
    both = k3.fused_obj_mlp(x, hit, cond_lin, w, cfg, s)
    alone = k3.fused_obj_mlp(x, hit[:1].contiguous(), cond_lin[:1].contiguous(), [t[:1] for t in w], cfg, s)
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(both, alone))
    finite = all(bool(torch.isfinite(t).all()) for t in both)
    print(f"K3 with an object no ray hits: outputs bitwise those of the other object alone: {same}, "
          f"finite={finite}")
    if not same or not finite:
        raise SystemExit("K3: an object that no ray hits changed the outputs")
    del xs, x, hit, cond_lin, both, alone, weights
    torch.cuda.empty_cache()
    result["by_share"] = by_share
    return result


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| (0 when both are 0)."""
    den = float(b.norm())
    return float((a - b).norm()) / den if den > 0 else float((a - b).norm())


def compare_grads(what, out, ref, names=("dx", "dcond_lin")):
    """Every backward output finite and within BWD_TOL relative L2 of the
    plain version; returns the largest max_abs_err."""
    import torch

    names = list(names) + [f"operand{i}" for i in range(len(out) - len(names))]
    worst_rel, worst_abs = 0.0, 0.0
    for name, a, b in zip(names, out, ref):
        finite = bool(torch.isfinite(a).all())
        rel, mab = rel_err(a, b), float((a - b).abs().max())
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, mab)
        if not finite or rel > BWD_TOL:
            raise SystemExit(f"{what}: {name} disagrees with the plain backward: rel {rel} "
                             f"(tol {BWD_TOL}), max_abs {mab}, finite={finite}")
    print(f"{what}: max rel L2 {worst_rel:.3e}, max_abs_err {worst_abs:.3e} over {len(out)} outputs")
    return worst_abs


def check_function(what, kernel_fn, plain_fn, leaves, names, g_rgb, g_den):
    """The autograd Function with its glue (the per-ray condition product,
    need_dx, head_0's zero condition rows) against autograd of the plain
    forward: gradients of <rgb, g_rgb> + <den, g_den> for every leaf."""
    import torch

    grads = []
    for fn in (kernel_fn, plain_fn):
        inputs = [t.detach().requires_grad_(True) for t in leaves]
        rgb, den = fn(*inputs)
        loss = (rgb * g_rgb).sum() + (den * g_den).sum()
        grads.append(torch.autograd.grad(loss, inputs))
        del rgb, den, loss, inputs
    compare_grads(what, grads[0], grads[1], names)
    del grads
    torch.cuda.empty_cache()


def check_k2(dev, gen):
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    cfg, f_in, f_c = MLPConfig(), 60, 27
    w = random_mlp(cfg, f_in, f_c, None, gen, dev)
    per_sample, _, params = mlp_macs(cfg, f_in, f_c)
    result = None
    for i, (b, s) in enumerate(BWD_SHAPES):
        n = b * s
        x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
        cond = (2 * torch.rand((b, f_c), generator=gen) - 1).to(dev)
        cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
        g_rgb = torch.randn((3, n), generator=gen).to(dev)
        g_den = torch.randn((1, n), generator=gen).to(dev)
        _, _, res = k1._k1_launch(x, cond_lin, w, cfg, s, save=True)
        dx, dcond, grads = k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, s)
        again = k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, s)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip([dx, dcond, *grads], [again[0], again[1], *again[2]]))
        print(f"K2 N={n}: two calls on the same inputs bitwise equal: {same}")
        if not same:
            raise SystemExit("K2 is not bitwise reproducible")
        del again
        ref = k1.fused_nerf_mlp_bwd_reference(x, cond_lin, w, cfg, s, g_rgb, g_den)
        err = compare_grads(f"K2 fused_nerf_mlp_bwd N={n} (B={b}, S={s})",
                            [dx, dcond, *grads], [ref[0], ref[1], *ref[2]])
        del ref, dx, dcond, grads
        if i == 0:
            check_function(
                f"K2 through FusedNerfMlpFn vs autograd of the plain forward N={n}",
                lambda x_, c_, *w_: k1.fused_nerf_mlp(x_, c_, w_, cfg, s),
                lambda x_, c_, *w_: k1.fused_nerf_mlp_reference(x_, c_, w_, cfg, s),
                [x, cond, *w], ("dx", "dcond"), g_rgb, g_den,
            )
            ms = time_ms(lambda: k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, s), iters=10)
            plain_ms = time_ms(
                lambda: k1.fused_nerf_mlp_bwd_reference(x, cond_lin, w, cfg, s, g_rgb, g_den), 3, 1
            )
            flops = 4.0 * per_sample * n  # the dX and dW products
            # Read: the residuals K1 saved, the cotangents, the weights;
            # written: dx, d cond_lin, the gradients.
            nbytes = k1_bytes(cfg, f_in, 0, 0, n, 0, True) - 4.0 * (f_in + 4) * n
            nbytes += 4.0 * (f_in * n + 4 * n + cfg.net_width_condition * b + 2 * params)
            bound_ms, bound_by = bound(flops, nbytes)
            print(
                f"K2 N={n}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: {flops / 1e12:.3f} "
                f"TFLOP, {nbytes / 1e9:.3f} GB)"
            )
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del x, cond, cond_lin, g_rgb, g_den, res
        torch.cuda.empty_cache()
    return result


def check_k4(dev, gen):
    """K4 against the plain backward at N_obj 2, 4, 8 and hit shares 1.0,
    0.5, 0.03 (N = 4096 x 128), at 1000 x 77 and at the compacted step's
    shape; two calls bitwise equal; its Function against autograd of the
    plain forward; one object that no ray hits gets exactly zero gradients.
    Timed at N_obj 2 at each share and at the step's shape (the kernels
    line's figure)."""
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    cfg, f_in, f_c = MLPConfig(net_width=128), 63, 27
    per_sample, _, params = mlp_macs(cfg, f_in, f_c)
    result, by_share = None, {}
    cases = [(BWD_SHAPES[0], n_obj, share) for n_obj in K4_OBJECTS for share in HIT_SHARES]
    cases += [(BWD_SHAPES[1], 2, 0.5), ((MAIN_RAYS, K3_SAMPLES), 2, "main")]
    for (b, s), n_obj, share in cases:
        n = b * s
        w = random_mlp(cfg, f_in, f_c, n_obj, gen, dev)
        x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
        hit = obj_hit(n_obj, b, share, gen, dev)
        cond_lin = torch.randn((n_obj, b, cfg.net_width_condition), generator=gen)
        cond_lin = cond_lin.to(torch.bfloat16).float().to(dev)
        g_rgb = torch.randn((3, n), generator=gen).to(dev)
        g_den = torch.randn((1, n), generator=gen).to(dev)
        _, _, res = k3._k3_launch(x, hit, cond_lin, w, cfg, s, save=True)
        dx, dcond, grads = k3.fused_obj_mlp_bwd(res, hit, g_rgb, g_den, w, cfg, s)
        torch.cuda.synchronize()
        ref = k3.fused_obj_mlp_bwd_reference(x, hit, cond_lin, w, cfg, s, g_rgb, g_den)
        what = f"K4 fused_obj_mlp_bwd N_obj={n_obj} N={n} (B={b}, S={s}) hit share {share}"
        err = compare_grads(what, [dx, dcond, *grads], [ref[0], ref[1], *ref[2]])
        del ref
        if n_obj == 2 and share in (1.0, "main"):
            again = k3.fused_obj_mlp_bwd(res, hit, g_rgb, g_den, w, cfg, s)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in
                       zip([dx, dcond, *grads], [again[0], again[1], *again[2]]))
            print(f"{what}: two calls on the same inputs bitwise equal: {same}")
            if not same:
                raise SystemExit("K4 is not bitwise reproducible")
            del again
        del dx, dcond, grads
        if (b, s) == BWD_SHAPES[0] and n_obj == 2 and share == 0.5:
            check_function(
                f"K4 through FusedObjMlpFn vs autograd of the plain forward N_obj={n_obj} N={n}",
                lambda x_, c_, *w_: k3.fused_obj_mlp(x_, hit, c_, w_, cfg, s),
                lambda x_, c_, *w_: k3.fused_obj_mlp_reference(x_, hit, c_, w_, cfg, s),
                [x, cond_lin, *w], ("dx", "dcond_lin"), g_rgb, g_den,
            )
        if n_obj == 2 and (b, s) != BWD_SHAPES[1]:
            ms = time_ms(lambda: k3.fused_obj_mlp_bwd(res, hit, g_rgb, g_den, w, cfg, s), iters=10)
            nbytes = 4.0 * (2 * f_in * n + n_obj * b * (1 + 2 * cfg.net_width_condition)
                            + 2 * n_obj * params + 4 * n)
            dense_ms, ran_ms, ran_by, pairs = obj_bounds(4.0 * per_sample, nbytes, 4.0 * f_in, hit, n,
                                                         s)
            line = (f"K4 N_obj={n_obj} N={n} hit share {share}: pairs ran {pairs:.4f}; kernel "
                    f"{ms:.3f} ms, bound {dense_ms:.3f} ms dense (operations), {ran_ms:.3f} ms for "
                    f"the pairs that ran ({ran_by})")
            by_share[f"{b}x{s}_hit_{share}"] = dict(ms=ms, bound_ms=ran_ms, dense_bound_ms=dense_ms,
                                                    pair_share=pairs)
            if share in ("main", 1.0):
                plain_ms = time_ms(
                    lambda: k3.fused_obj_mlp_bwd_reference(x, hit, cond_lin, w, cfg, s, g_rgb, g_den),
                    2, 1,
                )
                line += f", plain {plain_ms:.3f} ms"
            if share == "main":
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=ran_ms,
                              bound_by=ran_by, dense_bound_ms=dense_ms, pair_share=pairs)
            print(line)
        del w, x, hit, cond_lin, g_rgb, g_den, res
        torch.cuda.empty_cache()
    # One object that no ray hits: its gradients and d cond_lin exactly zero,
    # dx bitwise that of the other object alone, everything finite.
    b, s = BWD_SHAPES[0]
    n = b * s
    w = random_mlp(cfg, f_in, f_c, 2, gen, dev)
    x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
    hit = obj_hit(2, b, GATE_HIT, gen, dev)
    hit[1] = 0.0
    cond_lin = torch.randn((2, b, cfg.net_width_condition), generator=gen).to(torch.bfloat16).float().to(dev)
    g_rgb = torch.randn((3, n), generator=gen).to(dev)
    g_den = torch.randn((1, n), generator=gen).to(dev)
    _, _, res = k3._k3_launch(x, hit, cond_lin, w, cfg, s, save=True)
    dx, dcond, grads = k3.fused_obj_mlp_bwd(res, hit, g_rgb, g_den, w, cfg, s)
    w1 = [t[:1] for t in w]
    _, _, res1 = k3._k3_launch(x, hit[:1].contiguous(), cond_lin[:1].contiguous(), w1, cfg, s, save=True)
    dx1, _, _ = k3.fused_obj_mlp_bwd(res1, hit[:1].contiguous(), g_rgb, g_den, w1, cfg, s)
    torch.cuda.synchronize()
    zero = not dcond[1].any() and all(not g[1].any() for g in grads)
    finite = all(bool(torch.isfinite(t).all()) for t in [dx, dcond, *grads])
    same = torch.equal(dx, dx1)
    print(f"K4 with an object no ray hits: its gradients and d cond_lin exactly zero: {zero}; dx "
          f"bitwise that of the other object alone: {same}; finite={finite}")
    if not (zero and same and finite):
        raise SystemExit("K4: an object that no ray hits got gradients, or changed dx")
    del w, x, hit, cond_lin, g_rgb, g_den, res, res1, dx, dx1, dcond, grads
    torch.cuda.empty_cache()
    result["by_share"] = by_share
    return result


# K1 and K2 at 128/128: the 8x128 object MLPs (F_in 63, the per-object
# route) and the 4x128 proposal MLP (F_in 60, waymo_fast.gin).
NARROW = ((dict(net_width=128), 63, "8x128"), (dict(net_depth=4, net_width=128), 60, "4x128"))


def narrow_inputs(cfg, f_in, f_c, b, s, gen, dev, w):
    """x [F, N], cond [B, F_c], its per-ray rows cond_lin, and cotangents."""
    import torch

    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    n = b * s
    x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
    cond = (2 * torch.rand((b, f_c), generator=gen) - 1).to(dev)
    cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
    g_rgb = torch.randn((3, n), generator=gen).to(dev)
    g_den = torch.randn((1, n), generator=gen).to(dev)
    return x, cond, cond_lin, g_rgb, g_den


def check_k1_object_width(dev, gen):
    """K1 at 128/128 against its plain version (NARROW at BWD_SHAPES), with
    and without saving residuals; timed at the step's shape. Returns the
    K1-128 entry of the kernels line: 8x128 saving, as the per-object step
    calls it, without save and the proposal MLP's beside it."""
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    f_c, out = 27, {}
    for shape, f_in, name in NARROW:
        cfg = MLPConfig(**shape)
        w = random_mlp(cfg, f_in, f_c, None, gen, dev)
        per_sample, per_ray, params = mlp_macs(cfg, f_in, f_c)
        for i, (b, s) in enumerate(BWD_SHAPES):
            n = b * s
            x, cond, cond_lin, _, _ = narrow_inputs(cfg, f_in, f_c, b, s, gen, dev, w)
            ref = k1.fused_nerf_mlp_reference(x, cond, w, cfg, s)
            errs, nums = {}, {}
            for save in (False, True):
                rgb, den, _ = k1._k1_launch(x, cond_lin, w, cfg, s, save=save)
                torch.cuda.synchronize()
                errs[save] = max_err((rgb, den), ref)
                finite = all(bool(torch.isfinite(t).all()) for t in (rgb, den))
                if not finite or errs[save] > TOL:
                    raise SystemExit(f"K1 at 128/128 ({name}, save={save}) disagrees with its plain "
                                     f"version: {errs[save]} > {TOL}")
                del rgb, den
            line = (f"K1-128 {name} fused_nerf_mlp_fwd N={n} (B={b}, S={s}): max_abs_err "
                    f"{errs[False]:.3e} without save, {errs[True]:.3e} with")
            if i == 0:
                plain_ms = time_ms(lambda: k1.fused_nerf_mlp_reference(x, cond, w, cfg, s), 3, 1)
                flops = 2.0 * (per_sample * n + per_ray * b)
                for save in (False, True):
                    ms = time_ms(lambda: k1._k1_launch(x, cond_lin, w, cfg, s, save=save), iters=10)
                    nbytes = k1_bytes(cfg, f_in, f_c, b, n, params, save)
                    bound_ms, bound_by = bound(flops, nbytes)
                    line += (f"; {'with' if save else 'without'} save kernel {ms:.3f} ms "
                             f"({flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s), bound "
                             f"{bound_ms:.3f} ms ({bound_by})")
                    nums[save] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by)
                line += f"; plain {plain_ms:.3f} ms"
                out[name] = dict(max_abs_err=max(errs.values()), plain_ms=plain_ms, **nums[True],
                                 no_save=nums[False])
            print(line)
            del x, cond, cond_lin, ref
            torch.cuda.empty_cache()
    return dict(out["8x128"], proposal_4x128=out["4x128"])


def check_k2_object_width(dev, gen):
    """K2 at 128/128 on what K1 saved, against the plain backward (NARROW at
    BWD_SHAPES), two calls bitwise equal, at 8x128 and the step's shape its
    Function against autograd of the plain forward; timed at the step's
    shape. Returns the K2-128 entry (8x128, the proposal MLP's beside it)."""
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    f_c, out = 27, {}
    for shape, f_in, name in NARROW:
        cfg = MLPConfig(**shape)
        w = random_mlp(cfg, f_in, f_c, None, gen, dev)
        per_sample, _, params = mlp_macs(cfg, f_in, f_c)
        for i, (b, s) in enumerate(BWD_SHAPES):
            n = b * s
            x, cond, cond_lin, g_rgb, g_den = narrow_inputs(cfg, f_in, f_c, b, s, gen, dev, w)
            _, _, res = k1._k1_launch(x, cond_lin, w, cfg, s, save=True)
            dx, dcond, grads = k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, s)
            again = k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, s)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in
                       zip([dx, dcond, *grads], [again[0], again[1], *again[2]]))
            print(f"K2-128 {name} N={n}: two calls on the same inputs bitwise equal: {same}")
            if not same:
                raise SystemExit("K2 at 128/128 is not bitwise reproducible")
            del again
            ref = k1.fused_nerf_mlp_bwd_reference(x, cond_lin, w, cfg, s, g_rgb, g_den)
            err = compare_grads(f"K2-128 {name} fused_nerf_mlp_bwd N={n} (B={b}, S={s})",
                                [dx, dcond, *grads], [ref[0], ref[1], *ref[2]])
            del ref, dx, dcond, grads
            if i == 0:
                if name == "8x128":
                    check_function(
                        f"K2-128 {name} through FusedNerfMlpFn vs autograd of the plain forward N={n}",
                        lambda x_, c_, *w_: k1.fused_nerf_mlp(x_, c_, w_, cfg, s),
                        lambda x_, c_, *w_: k1.fused_nerf_mlp_reference(x_, c_, w_, cfg, s),
                        [x, cond, *w], ("dx", "dcond"), g_rgb, g_den,
                    )
                ms = time_ms(lambda: k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, s), iters=10)
                plain_ms = time_ms(
                    lambda: k1.fused_nerf_mlp_bwd_reference(x, cond_lin, w, cfg, s, g_rgb, g_den), 3, 1
                )
                flops = 4.0 * per_sample * n  # the dX and dW products
                # Read: the residuals K1 saved, the cotangents, the weights;
                # written: dx, d cond_lin, the gradients (as check_k2).
                nbytes = k1_bytes(cfg, f_in, 0, 0, n, 0, True) - 4.0 * (f_in + 4) * n
                nbytes += 4.0 * (f_in * n + 4 * n + cfg.net_width_condition * b + 2 * params)
                bound_ms, bound_by = bound(flops, nbytes)
                print(f"K2-128 {name} N={n}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                      f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
                      f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)")
                out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
            del x, cond, cond_lin, g_rgb, g_den, res
            torch.cuda.empty_cache()
    return dict(out["8x128"], proposal_4x128=out["4x128"])


def gate_inputs(b, s, f_in, gen, dev, share=GATE_HIT):
    """Row-major features x [N, F] in [-1, 1], a per-ray 0/1 gate letting
    about `share` of the rays in, and a fill row."""
    import torch

    x = (2 * torch.rand((b * s, f_in), generator=gen) - 1).to(dev)
    gate = (torch.rand((b,), generator=gen) < share).float().to(dev)
    fill = (2 * torch.rand((f_in,), generator=gen) - 1).to(dev)
    return x, gate, fill


def check_k5_k6(dev, gen):
    """K5 and K6 against their plain versions at the object width, at every
    gate share of HIT_SHARES and both BWD_SHAPES, two K6 calls bitwise
    equal; at the step's shape and GATE_HIT, K6's Function against autograd
    of the plain forward and the times. Returns the K5 and K6 result
    entries."""
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    cfg, f_in, f_c = MLPConfig(net_width=128), 63, 27
    w = random_mlp(cfg, f_in, f_c, None, gen, dev)
    per_sample, per_ray, params = mlp_macs(cfg, f_in, f_c)
    k5 = k6 = None
    worst5 = worst6 = 0.0
    for i, (b, s) in enumerate(BWD_SHAPES):
        n = b * s
        for share in HIT_SHARES:
            x, gate, fill = gate_inputs(b, s, f_in, gen, dev, share)
            cond = (2 * torch.rand((b, f_c), generator=gen) - 1).to(dev)
            cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
            what = f"N={n} (B={b}, S={s}), {int(gate.sum())} of {b} rays gated in"
            out = k1.fused_nerf_mlp_gated(x, gate, fill, cond, w, cfg, s)
            torch.cuda.synchronize()
            ref = k1.fused_nerf_mlp_gated_reference(x, gate, fill, cond, w, cfg, s)
            err5 = max_err(out, ref)
            finite = all(bool(torch.isfinite(t).all()) for t in out)
            print(f"K5 fused_nerf_mlp_gated_fwd {what}: max_abs_err {err5:.3e} finite={finite}")
            if not finite or err5 > TOL:
                raise SystemExit(f"K5 disagrees with its plain version: {err5} > {TOL}")
            g_rgb = torch.randn((n, 3), generator=gen).to(dev)
            g_den = torch.randn((n, 1), generator=gen).to(dev)
            _, _, res = k1._k5_launch(x, gate, fill, cond_lin, w, cfg, s, save=True)
            got = k1.fused_nerf_mlp_gated_bwd(res, g_rgb, g_den, w, cfg, s)
            again = k1.fused_nerf_mlp_gated_bwd(res, g_rgb, g_den, w, cfg, s)
            torch.cuda.synchronize()
            flat = lambda r: [r[0], r[1], r[2], r[3], *r[4]]  # noqa: E731
            same = all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))
            print(f"K6 {what}: two calls on the same inputs bitwise equal: {same}")
            if not same:
                raise SystemExit("K6 is not bitwise reproducible")
            del again
            ref = k1.fused_nerf_mlp_gated_bwd_reference(x, gate, fill, cond_lin, w, cfg, s, g_rgb,
                                                        g_den)
            err6 = compare_grads(f"K6 fused_nerf_mlp_gated_bwd {what}", flat(got), flat(ref),
                                 names=("dx", "dgate", "dfill", "dcond_lin"))
            worst5, worst6 = max(worst5, err5), max(worst6, err6)
            del got, ref
            if i == 0 and share == GATE_HIT:
                check_function(
                    f"K6 through FusedNerfMlpGatedFn vs autograd of the plain forward N={n}",
                    lambda x_, g_, f_, c_, *w_: k1.fused_nerf_mlp_gated(x_, g_, f_, c_, w_, cfg, s),
                    lambda x_, g_, f_, c_, *w_: k1.fused_nerf_mlp_gated_reference(x_, g_, f_, c_, w_,
                                                                                  cfg, s),
                    [x, gate, fill, cond, *w], ("dx", "dgate", "dfill", "dcond"), g_rgb, g_den,
                )
                ms5 = time_ms(lambda: k1.fused_nerf_mlp_gated(x, gate, fill, cond, w, cfg, s), iters=10)
                plain5 = time_ms(
                    lambda: k1.fused_nerf_mlp_gated_reference(x, gate, fill, cond, w, cfg, s), 3, 1
                )
                flops = 2.0 * (per_sample * n + per_ray * b)
                nbytes = 2.0 * f_in * n + 4.0 * (b + f_in + f_c * b + params + 4 * n)
                bound5, by5 = bound(flops, nbytes)
                ms6 = time_ms(lambda: k1.fused_nerf_mlp_gated_bwd(res, g_rgb, g_den, w, cfg, s),
                              iters=10)
                plain6 = time_ms(
                    lambda: k1.fused_nerf_mlp_gated_bwd_reference(
                        x, gate, fill, cond_lin, w, cfg, s, g_rgb, g_den), 3, 1,
                )
                flops6 = 4.0 * per_sample * n
                nbytes6 = (2.0 * 2 * f_in * n + 4.0 * (f_in * n + 4 * n + n + b + 2 * f_in
                           + 2 * cfg.net_width_condition * b + 2 * params))
                bound6, by6 = bound(flops6, nbytes6)
                print(
                    f"K5 N={n}: kernel {ms5:.3f} ms ({flops / ms5 / 1e9:.1f} TFLOP/s), plain "
                    f"{plain5:.3f} ms, bound {bound5:.3f} ms ({by5}); K6: kernel {ms6:.3f} ms "
                    f"({flops6 / ms6 / 1e9:.1f} TFLOP/s), plain {plain6:.3f} ms, bound {bound6:.3f} ms "
                    f"({by6})"
                )
                k5 = dict(ms=ms5, plain_ms=plain5, bound_ms=bound5, bound_by=by5)
                k6 = dict(ms=ms6, plain_ms=plain6, bound_ms=bound6, bound_by=by6)
            del x, gate, fill, cond, cond_lin, g_rgb, g_den, res, out
            torch.cuda.empty_cache()
    return dict(max_abs_err=worst5, **k5), dict(max_abs_err=worst6, **k6)


def check_gated_stack(dev, gen):
    """The gated stacked object MLPs (the nn.vmap'd NerfMLP with the gate
    blended in the kernel) through forward and backward on row-major
    flagship features, against the same weights on the plain path. Returns
    the K5/K6 launch counts of the kernel run."""
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.models.mlp import NerfMLP
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    cfg, f_in, f_c, n_obj = MLPConfig(net_width=128), 63, 27, 2
    b, s = BWD_SHAPES[0]
    x = (2 * torch.rand((b, s, f_in), generator=gen) - 1).to(dev)
    vd = (2 * torch.rand((b, f_c), generator=gen) - 1).to(dev)
    gate = (torch.rand((n_obj, b, 1), generator=gen) < GATE_HIT).float().to(dev)
    fill = (2 * torch.rand((1, 1, f_in), generator=gen) - 1).to(dev)
    g_rgb = torch.randn((n_obj, b, s, 3), generator=gen).to(dev)
    g_den = torch.randn((n_obj, b, s, 1), generator=gen).to(dev)
    mlps = []
    for use_kernel in (True, False):
        m = NerfMLP(cfg, f_in, f_c, "bfloat16", use_kernel, n_obj, pallas_gate_in_kernel=True)
        if not mlps:
            m.reset_parameters(torch.Generator().manual_seed(3))
        else:
            m.load_state_dict(mlps[0].state_dict())
        mlps.append(m.to(dev))
    results = []
    for m in mlps:
        xi = x.detach().requires_grad_(True)
        if m.use_kernel:
            reset_launches()
        rgb, den = m(xi, vd, gate, fill, x_feature_major=False, out_feature_major=False)
        loss = (rgb * g_rgb).sum() + (den * g_den).sum()
        grads = torch.autograd.grad(loss, [xi, *m.parameters()])
        torch.cuda.synchronize()
        if m.use_kernel:
            launches = {"K5": k1.fused_nerf_mlp_gated.launches,
                        "K6": k1.fused_nerf_mlp_gated_bwd.launches}
        results.append((rgb.detach(), den.detach(), grads))
    (rk, dk, gk), (rp, dp, gp) = results
    err = max(float((rk - rp).abs().max()), float((dk - dp).abs().max()))
    worst = max(rel_err(a, c) for a, c in zip(gk, gp))
    print(f"gated stack N_obj={n_obj} N={b * s}: launches {launches} (expected {n_obj} each); "
          f"outputs vs plain path max_abs_err {err:.3e}, worst gradient rel L2 {worst:.3e} over "
          f"{len(gk)} leaves")
    if launches != {"K5": n_obj, "K6": n_obj}:
        raise SystemExit(f"the gated object MLPs did not go through K5/K6: {launches}")
    if err > TOL or worst > 5e-2:
        raise SystemExit("the gated object MLPs disagree with the plain path")
    del mlps, results, x, g_rgb, g_den
    torch.cuda.empty_cache()
    return launches


def check_slice(dev, card):
    import copy

    import numpy as np
    import torch

    from durf_tpu_torch.data.synthetic import example_ray_batch
    from durf_tpu_torch.entry import flagship_config, kernel_operating_point
    from durf_tpu_torch.models import MipNerf, construct_model, render_image
    from durf_tpu_torch.ops.kernels import fused_mlp as k1
    from durf_tpu_torch.ops.kernels import obj_mlp as k3
    from durf_tpu_torch.rays import camera_rays
    from durf_tpu_torch.train import make_render_fn

    config = kernel_operating_point(flagship_config())
    batch = example_ray_batch(batch_size=config.batch_size)
    model = construct_model(config.model, batch, dev, seed=0)
    render = make_render_fn(model, config, dev)
    size, chunk, frames = SLICE_SIZE, SLICE_CHUNK, (1, 2)  # frames: pose-table timesteps
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    rays = camera_rays(c2w, size, size, focal=size / 2, near=config.near, far=config.far)

    def frame(ts):
        return render_image(lambda r: render(r, batch["ext"], ts, 10.0), rays, chunk=chunk)

    frame(frames[0])  # warm-up
    torch.cuda.synchronize()
    k1.fused_nerf_mlp.launches = 0
    k3.fused_obj_mlp.launches = 0
    t0 = time.perf_counter()
    images = [frame(ts) for ts in frames]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K1": k1.fused_nerf_mlp.launches, "K3": k3.fused_obj_mlp.launches}
    n_chunks = len(frames) * -(-size * size // chunk)
    expect = config.model.num_levels * n_chunks
    print(f"slice: launches {launches} (expected {expect} each)")
    if launches != {"K1": expect, "K3": expect}:
        raise SystemExit(f"the render did not go through the kernels: {launches}")
    for img in images:
        for key, shape in (("rgb", (size, size, 3)), ("acc", (size, size)), ("depth", (size, size))):
            v = img[key]
            if v.shape != shape or not np.isfinite(v).all():
                raise SystemExit(f"slice output {key} is not finite of shape {shape}")
        for key in ("rgb", "acc"):
            lo, hi = float(img[key].min()), float(img[key].max())
            if lo < 0.0 or hi > 1.0 + 1e-5:
                raise SystemExit(f"slice {key} outside [0, 1]: [{lo}, {hi}]")
    hit_px = int((images[0]["acc"] > 0).sum())
    print(
        f"slice: frame rgb mean {float(images[0]['rgb'].mean()):.4f}, acc mean "
        f"{float(images[0]['acc'].mean()):.4f}, depth mean {float(images[0]['depth'].mean()):.3f}, "
        f"pixels with acc>0: {hit_px}"
    )

    # One chunk on the same weights through the plain versions on the card.
    plain_cfg = copy.deepcopy(config)
    plain_cfg.model.use_pallas_mlp = False
    init = batch["init"]
    plain = MipNerf(plain_cfg.model, init.shape[1], init.shape[0]).to(dev)
    plain.load_state_dict(model.state_dict())
    plain_render = make_render_fn(plain, plain_cfg, dev)
    first = rays.map(lambda r: r.reshape(-1, r.shape[-1])[:chunk])
    with_k = render(first, batch["ext"], frames[0], 10.0)
    with_p = plain_render(first, batch["ext"], frames[0], 10.0)
    err = float((with_k["rgb"] - with_p["rgb"]).abs().max())
    err_acc = float((with_k["acc"] - with_p["acc"]).abs().max())
    print(f"slice: chunk vs plain versions on the card: rgb max_abs_err {err:.3e}, acc {err_acc:.3e}")
    if err > TOL:
        raise SystemExit(f"slice chunk disagrees with the plain path: {err} > {TOL}")

    # The same chunk on the per-object route: K1 once per object per level.
    per_cfg = copy.deepcopy(config)
    per_cfg.model.fused_objects = False
    per_obj = MipNerf(per_cfg.model, init.shape[1], init.shape[0]).to(dev)
    per_obj.load_state_dict(model.state_dict())
    per_render = make_render_fn(per_obj, per_cfg, dev)
    reset_launches()
    with_o = per_render(first, batch["ext"], frames[0], 10.0)
    torch.cuda.synchronize()
    got = training_launches()
    expect_o = config.model.num_levels * (1 + init.shape[1])
    err_o = float((with_o["rgb"] - with_k["rgb"]).abs().max())
    print(f"slice: chunk on the per-object route: K1 launches {got['K1']} (expected {expect_o}), "
          f"K3 {got['K3']}; rgb vs the fused route max_abs_err {err_o:.3e}")
    if got["K1"] != expect_o or got["K3"] != 0 or err_o > TOL:
        raise SystemExit("the per-object render route disagrees with the fused route")

    n_rays = len(frames) * size * size
    samples = config.model.samples_per_ray()
    ms_chunk = 1e3 * dt / n_chunks
    print(
        f"slice: {len(frames)} frames {size}x{size}, {n_chunks} chunks of {chunk} rays in "
        f"{dt:.4f} s: {ms_chunk:.3f} ms/chunk, {n_rays / dt:.1f} rays/s, "
        f"{n_rays * samples / dt:.1f} ray-samples/s ({card})"
    )
    return launches, ms_chunk


def _counted():
    from durf_tpu_torch.ops.kernels import fused_mlp as k1
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    return {
        "K1": k1.fused_nerf_mlp,
        "K2": k1.fused_nerf_mlp_bwd,
        "K3": k3.fused_obj_mlp,
        "K4": k3.fused_obj_mlp_bwd,
        "K5": k1.fused_nerf_mlp_gated,
        "K6": k1.fused_nerf_mlp_gated_bwd,
    }


def training_launches():
    """Launch counts of K1-K4, the kernels of the training step."""
    return {k: fn.launches for k, fn in _counted().items() if k in ("K1", "K2", "K3", "K4")}


def reset_launches():
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "width_launches"):
            fn.width_launches.clear()


def width_launches():
    """K1's and K2's launches by (net_width, net_width_condition), as
    'W/Wc' keys: 256/128 runs the wide kernels, 128/128 the mask-free
    object kernels."""
    return {k: {f"{w}/{wc}": n for (w, wc), n in sorted(_counted()[k].width_launches.items())}
            for k in ("K1", "K2")}


def time_steps(step_fn, state, batch):
    """WARMUP_STEPS, then TIMED_STEPS on the host clock with the launch
    counts set to 0 just before. Returns (state, stats, seconds, launches,
    peak memory GiB)."""
    import torch

    for _ in range(WARMUP_STEPS):
        state, stats = step_fn(state, batch)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, stats = step_fn(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return state, stats, dt, training_launches(), torch.cuda.max_memory_allocated() / 2**30


def check_train(dev, card):
    """The training slice, the main path: the flagship step at batch
    TRAIN_BATCH through entry.train_entry with bench.py's compaction, then
    the same without compaction (the earlier main path), each WARMUP_STEPS then
    TIMED_STEPS on the host clock. Returns (main-path launches, ms)."""
    import math

    import torch

    from durf_tpu_torch.entry import train_entry
    from durf_tpu_torch.models.mipnerf import obj_capacity_k

    result = None
    for cap in (OBJ_CAPACITY, 0.0):
        step_fn, state, batch = train_entry(dev, batch_size=TRAIN_BATCH, obj_capacity=cap)
        state, stats, dt, launches, peak = time_steps(step_fn, state, batch)
        what = (f"compaction k={obj_capacity_k(TRAIN_BATCH, cap)}" if cap > 0 else
                "no compaction")
        expect = state.config.model.num_levels * TIMED_STEPS
        print(f"train ({what}): launches {launches} (expected {expect} each)")
        if any(v != expect for v in launches.values()):
            raise SystemExit(f"the training step did not go through the kernels: {launches}")
        bad = [k for k, v in stats.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
        if bad:
            raise SystemExit(f"training stats not finite: {bad}")
        if cap > 0 and float(stats["obj/overflow_rays"]) != 0.0:
            raise SystemExit(f"compaction overflowed: {float(stats['obj/overflow_rays'])} rays")
        samples = state.config.model.samples_per_ray()
        ms = 1e3 * dt / TIMED_STEPS
        rays_s = TIMED_STEPS * TRAIN_BATCH / dt
        print(
            f"train ({what}): batch {TRAIN_BATCH}, {TIMED_STEPS} steps in {dt:.4f} s: "
            f"{ms:.3f} ms/step, {rays_s:.1f} rays/s, {rays_s * samples:.1f} ray-samples/s "
            f"(ray-samples as bench.py:191-192, {samples} per ray); peak memory {peak:.2f} GiB; "
            f"loss {float(stats['train/loss']):.5f}, psnr {float(stats['train/psnr']):.3f}, "
            f"obj/hit_frac {float(stats['obj/hit_frac']):.4f} ({card})"
        )
        if not math.isfinite(ms):
            raise SystemExit("train: no time measured")
        if result is None:
            result = (launches, ms)
        del step_fn, state, batch, stats
        torch.cuda.empty_cache()
    return result


def grads_of(dev, batch_size, **kw):
    """One step's (loss, aux, raw gradients) of train_entry(**kw) at step 0
    with the launch counts set to 0 just before; returns them and the
    counts."""
    from durf_tpu_torch.entry import train_entry
    from durf_tpu_torch.train import make_grad_fn

    _, state, batch = train_entry(dev, batch_size=batch_size, **kw)
    grad_fn = make_grad_fn(state.model, state.config)
    reset_launches()
    loss, aux, grads = grad_fn(0, batch)
    import torch

    torch.cuda.synchronize()
    return loss, aux, grads, training_launches()


def compare_steps(what, a, b, loss_tol, grad_tol):
    """Loss within relative loss_tol and every gradient leaf within relative
    L2 grad_tol of the second step."""
    loss_rel = abs(float(a[0]) - float(b[0])) / abs(float(b[0]))
    worst = max(((rel_err(a[2][n], b[2][n]), n) for n in b[2]), key=lambda t: t[0])
    print(f"{what}: loss {float(a[0]):.7f} vs {float(b[0]):.7f} (rel {loss_rel:.3e}); worst "
          f"gradient leaf {worst[1]} rel L2 {worst[0]:.3e} over {len(b[2])} leaves")
    if loss_rel > loss_tol or worst[0] > grad_tol:
        raise SystemExit(f"{what}: the two steps disagree")


def check_compaction_exact(dev):
    """One step with and without compaction on the same weights and random
    stream agree to float32 summation order."""
    import torch

    comp = grads_of(dev, TRAIN_BATCH, obj_capacity=OBJ_CAPACITY)
    full = grads_of(dev, TRAIN_BATCH, obj_capacity=0.0)
    compare_steps(f"compacted vs uncompacted step (batch {TRAIN_BATCH})", comp, full,
                  EXACT_LOSS_TOL, EXACT_GRAD_TOL)
    del comp, full
    torch.cuda.empty_cache()


def check_per_object(dev, card):
    """The per-object route (fused_objects=False): one step against the
    fused route on the same weights and stream, K1/K2 per object; then
    timed, and the fused route's step beside it. Returns the launches of K1
    and K2 at 128/128 in its step."""
    import torch

    from durf_tpu_torch.entry import train_entry

    per = grads_of(dev, TRAIN_BATCH, fused_objects=False)
    fused = grads_of(dev, TRAIN_BATCH)
    launches = per[3]
    expect = 2 * (1 + 2)  # levels x (background + 2 objects)
    print(f"per-object route step: launches {launches} (K1, K2 expected {expect}, K3, K4 none)")
    if launches != {"K1": expect, "K2": expect, "K3": 0, "K4": 0}:
        raise SystemExit(f"the per-object route did not go through K1/K2: {launches}")
    compare_steps(f"per-object vs fused route step (batch {TRAIN_BATCH})", per, fused, 1e-2, 5e-2)
    del per, fused
    ms = {}
    for fused_objects in (False, True):
        step_fn, state, batch = train_entry(dev, batch_size=TRAIN_BATCH, fused_objects=fused_objects)
        state, stats, dt, _, _ = time_steps(step_fn, state, batch)
        ms[fused_objects] = 1e3 * dt / TIMED_STEPS
        del step_fn, state, batch, stats
        torch.cuda.empty_cache()
    print(f"per-object route: {ms[False]:.3f} ms/step at batch {TRAIN_BATCH} with compaction "
          f"({TRAIN_BATCH / ms[False] * 1e3:.1f} rays/s), fused route "
          f"{ms[True]:.3f} ms/step in the same phase ({card})")
    # The launches of the 128/128 builds: one per object and level (the
    # other two are the background MLP's).
    return {"K1-128": launches["K1"] - 2, "K2-128": launches["K2"] - 2}


def check_centering(dev):
    """One step with the object-centering prior on (centering_loss_mult
    0.1): finite loss and loss/centering_* stats."""
    import copy

    import torch

    from durf_tpu_torch.entry import train_entry
    from durf_tpu_torch.train import make_train_step

    _, state, batch = train_entry(dev, batch_size=TRAIN_BATCH)
    config = copy.deepcopy(state.config)
    config.centering_loss_mult = 0.1
    state.config = config
    state, stats = make_train_step(state.model, config, state.optimizer)(state, batch)
    keys = [k for k in stats if k.startswith("loss/centering")]
    vals = {k: float(stats[k]) for k in keys}
    print(f"centering step: loss {float(stats['train/loss']):.5f}, {vals}")
    if len(keys) != 2 or not all(map(math.isfinite, [float(stats["train/loss"]), *vals.values()])):
        raise SystemExit("the centering step is not finite")
    del state, batch, stats
    torch.cuda.empty_cache()


def check_descent(dev, what="descent", **kw):
    """DESCENT_STEPS steps of train_entry(**kw) on the fixed batch at a
    constant lr: the loss falls."""
    import torch

    from durf_tpu_torch.entry import train_entry

    step_fn, state, batch = train_entry(dev, batch_size=TRAIN_BATCH, constant_lr=5e-3, **kw)
    losses = []
    for _ in range(DESCENT_STEPS):
        state, stats = step_fn(state, batch)
        losses.append(stats["train/loss"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    print(f"{what}: {DESCENT_STEPS} steps at lr 5e-3: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{what}: the training step did not descend: {losses}")
    del step_fn, state, batch, stats
    torch.cuda.empty_cache()


def check_step_vs_plain(dev, what="step vs plain", **kw):
    """One step's loss and raw gradients of train_entry(**kw) on the kernel
    path against the same weights and random stream with
    use_pallas_mlp=False, at batch COMPARE_BATCH (the plain path keeps every
    fp32 activation for autograd)."""
    import copy

    import torch

    from durf_tpu_torch.entry import train_entry
    from durf_tpu_torch.models import MipNerf
    from durf_tpu_torch.train import make_grad_fn

    _, state, batch = train_entry(dev, batch_size=COMPARE_BATCH, **kw)
    config = state.config
    plain_cfg = copy.deepcopy(config)
    plain_cfg.model.use_pallas_mlp = False
    init = state.model.box_centers
    plain = MipNerf(plain_cfg.model, init.shape[1], init.shape[0]).to(dev)
    plain.load_state_dict(state.model.state_dict())
    loss_k, _, grads_k = make_grad_fn(state.model, config)(0, batch)
    loss_p, _, grads_p = make_grad_fn(plain, plain_cfg)(0, batch)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(((rel_err(grads_k[n], grads_p[n]), n) for n in grads_p), key=lambda t: t[0])
    print(
        f"{what} (batch {COMPARE_BATCH}): loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
        f"(rel {loss_rel:.3e}); worst gradient leaf {worst[1]} rel L2 {worst[0]:.3e} "
        f"over {len(grads_p)} leaves"
    )
    if loss_rel > 1e-2 or worst[0] > 5e-2:
        raise SystemExit(f"{what}: the kernel step disagrees with the plain step")
    del state, batch, plain, grads_k, grads_p
    torch.cuda.empty_cache()


def check_proposal(dev, card):
    """Proposal levels (bench.py --proposal, the switch configs/waymo_fast.gin
    turns on): level 0 runs the 4x128 proposal MLP on K1/K2 at 128/128, the
    final level the background MLP on K1/K2 at 256/128, both levels K3/K4.
    TIMED_STEPS steps at batch TRAIN_BATCH with compaction, timed beside the
    flagship compacted step; K1-K4 launching levels x steps = 20 times, K1
    and K2 split 10 + 10 between the widths; one step against the plain step
    (check_step_vs_plain's tolerances); one render chunk against the plain
    render; one step at proposal_samples PROPOSAL_SAMPLES; a descent.
    Returns the launches of K1 and K2 at 128/128 in the timed steps."""
    import copy

    import numpy as np
    import torch

    from durf_tpu_torch.data.synthetic import example_ray_batch
    from durf_tpu_torch.entry import (flagship_config, kernel_operating_point, train_entry,
                                      with_proposal)
    from durf_tpu_torch.models import MipNerf, construct_model
    from durf_tpu_torch.rays import camera_rays
    from durf_tpu_torch.train import make_render_fn

    ms, widths = {}, None
    for proposal in (True, False):
        what = "proposal step" if proposal else "flagship step"
        step_fn, state, batch = train_entry(dev, batch_size=TRAIN_BATCH, obj_capacity=OBJ_CAPACITY,
                                            proposal=proposal)
        state, stats, dt, launches, peak = time_steps(step_fn, state, batch)
        expect = state.config.model.num_levels * TIMED_STEPS
        if proposal:
            widths = width_launches()
            print(f"proposal: launches {launches} (expected {expect} each), K1/K2 by width {widths}")
            split = {"256/128": TIMED_STEPS, "128/128": TIMED_STEPS}
            if any(v != expect for v in launches.values()) or widths != {"K1": split, "K2": split}:
                raise SystemExit(f"the proposal step did not go through the kernels: {launches}, "
                                 f"{widths}")
            if "loss/interlevel" not in stats:
                raise SystemExit("the proposal step does not log loss/interlevel")
        bad = [k for k, v in stats.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
        if bad:
            raise SystemExit(f"{what}: stats not finite: {bad}")
        samples = state.config.model.samples_per_ray()
        ms[proposal] = 1e3 * dt / TIMED_STEPS
        rays_s = TIMED_STEPS * TRAIN_BATCH / dt
        inter = f", loss/interlevel {float(stats['loss/interlevel']):.3e}" if proposal else ""
        print(
            f"proposal phase, {what}: batch {TRAIN_BATCH}, {TIMED_STEPS} steps in {dt:.4f} s: "
            f"{ms[proposal]:.3f} ms/step, {rays_s:.1f} rays/s, {rays_s * samples:.1f} ray-samples/s "
            f"({samples} per ray); peak memory {peak:.2f} GiB; loss "
            f"{float(stats['train/loss']):.5f}{inter} ({card})"
        )
        del step_fn, state, batch, stats
        torch.cuda.empty_cache()
    print(f"proposal: {ms[True]:.3f} ms/step against the flagship step's {ms[False]:.3f} in the "
          f"same phase ({card})")

    check_step_vs_plain(dev, "proposal step vs plain", proposal=True)

    # One render chunk with the kernels against the plain render.
    config = with_proposal(kernel_operating_point(flagship_config()), True)
    host = example_ray_batch(batch_size=config.batch_size)
    model = construct_model(config.model, host, dev, seed=0)
    plain_cfg = copy.deepcopy(config)
    plain_cfg.model.use_pallas_mlp = False
    init = host["init"]
    plain = MipNerf(plain_cfg.model, init.shape[1], init.shape[0]).to(dev)
    plain.load_state_dict(model.state_dict())
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    rays = camera_rays(c2w, SLICE_SIZE, SLICE_SIZE, focal=SLICE_SIZE / 2, near=config.near,
                       far=config.far)
    chunk = rays.map(lambda r: r.reshape(-1, r.shape[-1])[:SLICE_CHUNK])
    render = make_render_fn(model, config, dev)
    render(chunk, host["ext"], 1, 10.0)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with_k = render(chunk, host["ext"], 1, 10.0)
    torch.cuda.synchronize()
    got, got_w = training_launches(), width_launches()
    with_p = make_render_fn(plain, plain_cfg, dev)(chunk, host["ext"], 1, 10.0)
    err = max(float((with_k[k] - with_p[k]).abs().max()) for k in ("rgb", "acc"))
    finite = all(bool(torch.isfinite(v).all()) for v in with_k.values())
    print(f"proposal render chunk ({SLICE_CHUNK} rays): launches {got}, K1 by width {got_w['K1']}; "
          f"rgb/acc vs the plain render max_abs_err {err:.3e}, finite={finite}")
    if got["K1"] != 2 or got["K3"] != 2 or got_w["K1"] != {"256/128": 1, "128/128": 1}:
        raise SystemExit(f"the proposal render did not go through the kernels: {got}, {got_w}")
    if not finite or err > TOL:
        raise SystemExit(f"the proposal render chunk disagrees with the plain render: {err} > {TOL}")
    del model, plain, with_k, with_p
    torch.cuda.empty_cache()

    # Fewer proposal samples than fine ones (mip-NeRF 360's split).
    step_fn, state, batch = train_entry(dev, batch_size=TRAIN_BATCH, proposal=True,
                                        proposal_samples=PROPOSAL_SAMPLES)
    state, stats = step_fn(state, batch)
    loss, inter = float(stats["train/loss"]), float(stats["loss/interlevel"])
    print(f"proposal step at proposal_samples {PROPOSAL_SAMPLES} "
          f"({state.config.model.samples_per_ray()} samples per ray): loss {loss:.5f}, "
          f"loss/interlevel {inter:.3e}")
    if not (math.isfinite(loss) and math.isfinite(inter)):
        raise SystemExit("the proposal step at proposal_samples 64 is not finite")
    del step_fn, state, batch, stats
    torch.cuda.empty_cache()

    check_descent(dev, "proposal descent", proposal=True)
    return {"K1-128": widths["K1"]["128/128"], "K2-128": widths["K2"]["128/128"]}


PHASES = ("kernels", "gated", "slice", "train", "exact", "per_object", "centering", "descent",
          "plain", "proposal")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU.")
    p.add_argument("--only", default=",".join(PHASES),
                   help=f"comma-separated phases to run (default all: {','.join(PHASES)}); "
                        "a partial run prints no result line")
    args = p.parse_args(argv)
    only = set(args.only.split(","))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from durf_tpu_torch.ops.kernels import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}")
    for name, (secs, log) in build.build_log.items():
        print(f"  nvcc {name}: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for name, counts in build.sass_counts(("fused_mlp", "fused_mlp_bwd", "obj_mlp", "obj_mlp_bwd",
                                            "fused_mlp_gated", "fused_mlp_gated_bwd")).items():
        print(f"  sass {name}: {counts}")
    # K1, K2, K5 and K6 at 128/128: the mask-free object kernels (TAG 1, 2, 5, 6).
    for name, fn in (("fused_mlp", "obj_mlp_fwd_kernelILi1E"),
                     ("fused_mlp_bwd", "obj_mlp_bwd_kernelILi2E"),
                     ("fused_mlp_gated", "obj_mlp_fwd_kernelILi5E"),
                     ("fused_mlp_gated_bwd", "obj_mlp_bwd_kernelILi6E")):
        counts = build.sass_counts((name,), function=fn)
        print(f"  sass {name}, kernels {fn}*: {counts.get(name, {})}")

    gen = torch.Generator().manual_seed(0)
    nums, launches = {}, {}
    if "kernels" in only:
        nums["K1"] = check_k1(dev, gen)
        nums["K2"] = check_k2(dev, gen)
        nums["K3"] = check_k3(dev, gen)
        nums["K4"] = check_k4(dev, gen)
        nums["K1-128"] = check_k1_object_width(dev, gen)
        nums["K2-128"] = check_k2_object_width(dev, gen)
        nums["K5"], nums["K6"] = check_k5_k6(dev, gen)
    if "gated" in only:
        launches.update(check_gated_stack(dev, gen))
    if "slice" in only:
        check_slice(dev, smi)
    if "train" in only:
        main_launches, _ = check_train(dev, smi)
        launches.update(main_launches)
    if "exact" in only:
        check_compaction_exact(dev)
    per_object = {}
    if "per_object" in only:
        per_object = check_per_object(dev, smi)
    if "centering" in only:
        check_centering(dev)
    if "descent" in only:
        check_descent(dev)
    if "plain" in only:
        check_step_vs_plain(dev)
    if "proposal" in only:
        launches.update(check_proposal(dev, smi))
    if only != set(PHASES):
        print(f"chip_smoke: partial run ({sorted(only)}), no result line")
        return 0

    meta = {
        "K1": ("K1 fused_nerf_mlp_fwd", "durf_tpu_torch/csrc/fused_mlp.cu",
               "durf_tpu/ops/pallas/fused_mlp.py:389"),
        "K2": ("K2 fused_nerf_mlp_bwd", "durf_tpu_torch/csrc/fused_mlp_bwd.cu",
               "durf_tpu/ops/pallas/fused_mlp.py:562"),
        "K3": ("K3 fused_obj_mlp_fwd", "durf_tpu_torch/csrc/obj_mlp.cu",
               "durf_tpu/ops/pallas/obj_mlp.py:193"),
        "K4": ("K4 fused_obj_mlp_bwd", "durf_tpu_torch/csrc/obj_mlp_bwd.cu",
               "durf_tpu/ops/pallas/obj_mlp.py:299"),
        "K5": ("K5 fused_nerf_mlp_gated_fwd", "durf_tpu_torch/csrc/fused_mlp_gated.cu",
               "durf_tpu/ops/pallas/fused_mlp.py:389"),
        "K6": ("K6 fused_nerf_mlp_gated_bwd", "durf_tpu_torch/csrc/fused_mlp_gated_bwd.cu",
               "durf_tpu/ops/pallas/fused_mlp.py:562"),
        "K1-128": ("K1 fused_nerf_mlp_fwd at 128/128 (per-object route, proposal MLP)",
                   "durf_tpu_torch/csrc/fused_mlp.cu", "durf_tpu/ops/pallas/fused_mlp.py:389"),
        "K2-128": ("K2 fused_nerf_mlp_bwd at 128/128 (per-object route, proposal MLP)",
                   "durf_tpu_torch/csrc/fused_mlp_bwd.cu", "durf_tpu/ops/pallas/fused_mlp.py:562"),
    }
    # K1-128 and K2-128: launches from the proposal step, and beside them
    # those of the per-object route's step.
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=site, launches=launches[k],
             library_ms=None, **nums[k],
             **({"per_object_launches": per_object[k]} if k in per_object else {}))
        for k, (name, src, site) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
