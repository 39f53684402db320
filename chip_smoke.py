#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one fails the run, with a non-zero exit, if it goes wrong):
  1. print the card's name and power limit;
  2. build the CUDA kernels from durf_tpu_torch/csrc/ with nvcc, all
     sources at once;
  3. K1 (fused background MLP forward) against its plain PyTorch version
     at the flagship width, at N = 8192 x 128 and at an N that is not a
     tile multiple, atol 2e-2 (bf16 operands, float32 sums in another
     order); times of the kernel and of the plain version, and the bound;
  4. K2 (its backward) against the plain backward at N = 4096 x 128 and
     1000 x 77 on random cotangents: every output (dx, d cond_lin, each
     weight and bias gradient) finite and within relative L2 2e-2; at
     4096 x 128 also the whole autograd Function (K1 then K2, with the
     per-ray condition product) against autograd of the plain forward;
  5. K3 (objects-in-grid MLP forward) like K1 at N_obj = 2, 4, 8;
  6. K4 (its backward) like K2 at N_obj = 2, 4, 8 (hit density 0.5), and
     its Function against autograd of the plain forward at N_obj = 2;
  7. the render slice: the flagship model at the kernel operating point
     renders two 128x128 frames through make_render_fn + render_image in
     chunks of 8192 rays; K1 and K3 must each launch levels x chunks = 8
     times; the images must be finite with rgb and acc in [0, 1]; one chunk
     is held against the same model on the plain versions (atol 2e-2);
  8. the training slice: entry.train_entry() (batch 4096, seed 0), 2
     warm-up then 10 timed steps; K1-K4 must each launch levels x steps =
     20 times and every stat be finite; ms per step, rays/s, ray-samples/s;
  9. descent: 20 steps at a constant lr of 5e-3, the last loss below the
     first;
 10. one step's loss and raw gradients on the kernel path against the
     plain path with the same weights and random stream (batch 1024): loss
     within relative 1e-2, every gradient leaf within relative L2 5e-2;
 11. a JSON line with every kernel's numbers (launches from the training
     slice), then the card's name and power limit, and as the last line
     {"ok": true, "device": {...}}.

Exits non-zero without printing a result when CUDA is not available, or
when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
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


def check_k1(dev, gen):
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
            plain_ms = time_ms(lambda: k1.fused_nerf_mlp_reference(x, cond, w, cfg, s), 3, 1)
            flops = 2.0 * (per_sample * n + per_ray * b)
            nbytes = 4.0 * (f_in * n + f_c * b + params + 4 * n)
            bound_ms, bound_by = bound(flops, nbytes)
            print(
                f"K1 N={n}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
                f"{per_sample * 2 / 1e6:.4f} MFLOP/sample)"
            )
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del x, cond, out, ref
    return result


def check_k3(dev, gen):
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    cfg, f_in, f_c = MLPConfig(net_width=128), 63, 27
    per_sample, _, params = mlp_macs(cfg, f_in, f_c)
    b, s = K3_RAYS, K3_SAMPLES
    n = b * s
    x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
    result = None
    for n_obj in K3_OBJECTS:
        w = random_mlp(cfg, f_in, f_c, n_obj, gen, dev)
        hit = (torch.rand((n_obj, b), generator=gen) < 0.5).float().to(dev)
        cond_lin = torch.randn((n_obj, b, cfg.net_width_condition), generator=gen)
        cond_lin = cond_lin.to(torch.bfloat16).float().to(dev)
        out = k3.fused_obj_mlp(x, hit, cond_lin, w, cfg, s)
        torch.cuda.synchronize()
        ref = k3.fused_obj_mlp_reference(x, hit, cond_lin, w, cfg, s)
        err = max_err(out, ref)
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        ms = time_ms(lambda: k3.fused_obj_mlp(x, hit, cond_lin, w, cfg, s), iters=10)
        plain_ms = time_ms(lambda: k3.fused_obj_mlp_reference(x, hit, cond_lin, w, cfg, s), 3, 1)
        flops = 2.0 * per_sample * n * n_obj
        nbytes = 4.0 * (f_in * n + n_obj * b * (1 + cfg.net_width_condition) + n_obj * params + 4 * n)
        bound_ms, bound_by = bound(flops, nbytes)
        print(
            f"K3 fused_obj_mlp_fwd N_obj={n_obj} N={n}: max_abs_err {err:.3e} finite={finite}; "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}; {per_sample * 2 / 1e6:.4f} MFLOP/sample/object)"
        )
        if not finite or err > TOL:
            raise SystemExit(f"K3 disagrees with its plain version at N_obj={n_obj}: {err} > {TOL}")
        if n_obj == K3_OBJECTS[0]:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del w, hit, cond_lin, out, ref
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
        torch.cuda.synchronize()
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
            nbytes = 4.0 * (2 * f_in * n + 2 * cfg.net_width_condition * b + 2 * params + 4 * n)
            bound_ms, bound_by = bound(flops, nbytes)
            print(
                f"K2 N={n}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})"
            )
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del x, cond, cond_lin, g_rgb, g_den, res
        torch.cuda.empty_cache()
    return result


def check_k4(dev, gen):
    import torch

    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    cfg, f_in, f_c = MLPConfig(net_width=128), 63, 27
    per_sample, _, params = mlp_macs(cfg, f_in, f_c)
    result = None
    cases = [(BWD_SHAPES[0], n_obj) for n_obj in K4_OBJECTS] + [(BWD_SHAPES[1], K4_OBJECTS[0])]
    for (b, s), n_obj in cases:
        n = b * s
        w = random_mlp(cfg, f_in, f_c, n_obj, gen, dev)
        x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
        hit = (torch.rand((n_obj, b), generator=gen) < 0.5).float().to(dev)
        cond_lin = torch.randn((n_obj, b, cfg.net_width_condition), generator=gen)
        cond_lin = cond_lin.to(torch.bfloat16).float().to(dev)
        g_rgb = torch.randn((3, n), generator=gen).to(dev)
        g_den = torch.randn((1, n), generator=gen).to(dev)
        _, _, res = k3._k3_launch(x, hit, cond_lin, w, cfg, s, save=True)
        dx, dcond, grads = k3.fused_obj_mlp_bwd(res, hit, g_rgb, g_den, w, cfg, s)
        torch.cuda.synchronize()
        ref = k3.fused_obj_mlp_bwd_reference(x, hit, cond_lin, w, cfg, s, g_rgb, g_den)
        what = f"K4 fused_obj_mlp_bwd N_obj={n_obj} N={n} (B={b}, S={s})"
        err = compare_grads(what, [dx, dcond, *grads], [ref[0], ref[1], *ref[2]])
        del ref, dx, dcond, grads
        if (b, s) == BWD_SHAPES[0] and n_obj == K4_OBJECTS[0]:
            check_function(
                f"K4 through FusedObjMlpFn vs autograd of the plain forward N_obj={n_obj} N={n}",
                lambda x_, c_, *w_: k3.fused_obj_mlp(x_, hit, c_, w_, cfg, s),
                lambda x_, c_, *w_: k3.fused_obj_mlp_reference(x_, hit, c_, w_, cfg, s),
                [x, cond_lin, *w], ("dx", "dcond_lin"), g_rgb, g_den,
            )
        if (b, s) == BWD_SHAPES[0]:
            ms = time_ms(lambda: k3.fused_obj_mlp_bwd(res, hit, g_rgb, g_den, w, cfg, s), iters=10)
            plain_ms = time_ms(
                lambda: k3.fused_obj_mlp_bwd_reference(x, hit, cond_lin, w, cfg, s, g_rgb, g_den),
                2, 1,
            )
            flops = 4.0 * per_sample * n * n_obj
            nbytes = 4.0 * (2 * f_in * n + n_obj * b * (1 + 2 * cfg.net_width_condition)
                            + 2 * n_obj * params + 4 * n)
            bound_ms, bound_by = bound(flops, nbytes)
            print(
                f"K4 N_obj={n_obj} N={n}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})"
            )
            if n_obj == K4_OBJECTS[0]:
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
        del w, x, hit, cond_lin, g_rgb, g_den, res
        torch.cuda.empty_cache()
    return result


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

    n_rays = len(frames) * size * size
    samples = config.model.samples_per_ray()
    ms_chunk = 1e3 * dt / n_chunks
    print(
        f"slice: {len(frames)} frames {size}x{size}, {n_chunks} chunks of {chunk} rays in "
        f"{dt:.4f} s: {ms_chunk:.3f} ms/chunk, {n_rays / dt:.1f} rays/s, "
        f"{n_rays * samples / dt:.1f} ray-samples/s ({card})"
    )
    return launches, ms_chunk


def training_launches():
    from durf_tpu_torch.ops.kernels import fused_mlp as k1
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    return {
        "K1": k1.fused_nerf_mlp.launches,
        "K2": k1.fused_nerf_mlp_bwd.launches,
        "K3": k3.fused_obj_mlp.launches,
        "K4": k3.fused_obj_mlp_bwd.launches,
    }


def reset_launches():
    from durf_tpu_torch.ops.kernels import fused_mlp as k1
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    for fn in (k1.fused_nerf_mlp, k1.fused_nerf_mlp_bwd, k3.fused_obj_mlp, k3.fused_obj_mlp_bwd):
        fn.launches = 0


def check_train(dev, card):
    """The training slice: the flagship step at batch TRAIN_BATCH through
    entry.train_entry, WARMUP_STEPS then TIMED_STEPS on the host clock."""
    import math

    import torch

    from durf_tpu_torch.entry import train_entry

    step_fn, state, batch = train_entry(dev, batch_size=TRAIN_BATCH)
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
    launches = training_launches()
    levels = state.config.model.num_levels
    expect = levels * TIMED_STEPS
    print(f"train: launches {launches} (expected {expect} each)")
    if any(v != expect for v in launches.values()):
        raise SystemExit(f"the training step did not go through the kernels: {launches}")
    bad = [k for k, v in stats.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    if bad:
        raise SystemExit(f"training stats not finite: {bad}")
    samples = state.config.model.samples_per_ray()
    ms = 1e3 * dt / TIMED_STEPS
    rays_s = TIMED_STEPS * TRAIN_BATCH / dt
    print(
        f"train: batch {TRAIN_BATCH}, {TIMED_STEPS} steps in {dt:.4f} s: {ms:.3f} ms/step, "
        f"{rays_s:.1f} rays/s, {rays_s * samples:.1f} ray-samples/s "
        f"(ray-samples as bench.py:191-192, {samples} per ray); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss {float(stats['train/loss']):.5f}, "
        f"psnr {float(stats['train/psnr']):.3f} ({card})"
    )
    if not math.isfinite(ms):
        raise SystemExit("train: no time measured")
    return launches, ms


def check_descent(dev):
    """DESCENT_STEPS steps on the fixed batch at a constant lr: the loss falls."""
    import torch

    from durf_tpu_torch.entry import train_entry

    step_fn, state, batch = train_entry(dev, batch_size=TRAIN_BATCH, constant_lr=5e-3)
    losses = []
    for _ in range(DESCENT_STEPS):
        state, stats = step_fn(state, batch)
        losses.append(stats["train/loss"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    print(f"descent: {DESCENT_STEPS} steps at lr 5e-3: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the training step did not descend: {losses}")


def check_step_vs_plain(dev):
    """One step's loss and raw gradients on the kernel path against the same
    weights and random stream with use_pallas_mlp=False, at batch
    COMPARE_BATCH (the plain path keeps every fp32 activation for autograd)."""
    import copy

    import torch

    from durf_tpu_torch.entry import train_entry
    from durf_tpu_torch.models import MipNerf
    from durf_tpu_torch.train import make_grad_fn

    _, state, batch = train_entry(dev, batch_size=COMPARE_BATCH)
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
        f"step vs plain (batch {COMPARE_BATCH}): loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
        f"(rel {loss_rel:.3e}); worst gradient leaf {worst[1]} rel L2 {worst[0]:.3e} "
        f"over {len(grads_p)} leaves"
    )
    if loss_rel > 1e-2 or worst[0] > 5e-2:
        raise SystemExit("the kernel step disagrees with the plain step")


def main() -> int:
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    nums = {
        "K1": check_k1(dev, gen),
        "K2": check_k2(dev, gen),
        "K3": check_k3(dev, gen),
        "K4": check_k4(dev, gen),
    }
    check_slice(dev, smi)
    launches, _ = check_train(dev, smi)
    check_descent(dev)
    check_step_vs_plain(dev)

    meta = {
        "K1": ("K1 fused_nerf_mlp_fwd", "durf_tpu_torch/csrc/fused_mlp.cu",
               "durf_tpu/ops/pallas/fused_mlp.py:389"),
        "K2": ("K2 fused_nerf_mlp_bwd", "durf_tpu_torch/csrc/fused_mlp_bwd.cu",
               "durf_tpu/ops/pallas/fused_mlp.py:562"),
        "K3": ("K3 fused_obj_mlp_fwd", "durf_tpu_torch/csrc/obj_mlp.cu",
               "durf_tpu/ops/pallas/obj_mlp.py:193"),
        "K4": ("K4 fused_obj_mlp_bwd", "durf_tpu_torch/csrc/obj_mlp_bwd.cu",
               "durf_tpu/ops/pallas/obj_mlp.py:299"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=site, launches=launches[k],
             library_ms=None, **nums[k])
        for k, (name, src, site) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
