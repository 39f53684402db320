#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one fails the run, with a non-zero exit, if it goes wrong):
  1. print the card's name and power limit;
  2. build the CUDA kernels from durf_tpu_torch/csrc/ with nvcc;
  3. K1 (fused background MLP) against its plain PyTorch version at the
     flagship width, at N = 8192 x 128 and at an N that is not a tile
     multiple, atol 2e-2 (bf16 operands, float32 sums in another order);
     times of the kernel and of the plain version, and the bound;
  4. K3 (objects-in-grid MLP) the same way at N_obj = 2, 4, 8;
  5. the slice: the flagship model at the kernel operating point renders
     two 128x128 frames through make_render_fn + render_image in chunks of
     8192 rays; K1 and K3 must each launch levels x chunks = 8 times; the
     images must be finite with rgb and acc in [0, 1]; one chunk is held
     against the same model on the plain versions (atol 2e-2 on rgb);
  6. a JSON line with every kernel's numbers, then the card's name and
     power limit, and as the last line {"ok": true, "device": {...}}.

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
    k1_num = check_k1(dev, gen)
    k3_num = check_k3(dev, gen)
    launches, _ = check_slice(dev, smi)

    kernels = [
        dict(
            name="K1 fused_nerf_mlp_fwd",
            route="cuda",
            source="durf_tpu_torch/csrc/fused_mlp.cu",
            replaces="durf_tpu/ops/pallas/fused_mlp.py:389",
            launches=launches["K1"],
            library_ms=None,
            **k1_num,
        ),
        dict(
            name="K3 fused_obj_mlp_fwd",
            route="cuda",
            source="durf_tpu_torch/csrc/obj_mlp.cu",
            replaces="durf_tpu/ops/pallas/obj_mlp.py:193",
            launches=launches["K3"],
            library_ms=None,
            **k3_num,
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
