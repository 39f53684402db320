#!/usr/bin/env python3
"""Time K1 and K2 at 128 / 128 (the fused MLP forward and backward at the
object and proposal MLPs' widths) and the per-object route that runs them,
on one NVIDIA GPU.

    python3 scripts/time_narrow_kernels.py [--root DIR] [--label NAME]

Imports durf_tpu_torch from DIR (default: this checkout), so that two trees
(a change and its parent unpacked beside it) can be timed in turns on one
card with the same inputs. For the 8x128 object MLP (F_in 63) and the 4x128
proposal MLP (F_in 60), at N = 4096 x 128 (the training step's shape), it
times the wrappers with CUDA events (median of 10 calls after 2 warm-ups):
K1 without saving residuals (a render), K1 saving them (a training step),
and K2 on what K1 saved. Then, under torch.profiler, each one's device time
per call by launch (K1: its kernel; K2: tile kernel, weight gradients,
reduction, per-ray sums, as profile.py splits them; "other" is the
wrappers' own device work, such as packing weights). Last, the per-object
route (fused_objects=False, K1/K2 once per object and level): the flagship
training step of entry.train_entry() at batch 4096 (host clock around 10
steps after 2 warm-ups, ending in a synchronize) and a render chunk of 8192
rays (5 chunks after 2). Prints one JSON line {"label", "device",
"power_limit", "ms": {...}, "device_ms": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from time_obj_kernels import device_split, time_ms

RAYS, SAMPLES, F_C = 4096, 128, 27
STEPS, CHUNKS, WARMUP = 10, 5, 2
K1_PARTS = (("kernel", "fused_nerf_mlp_fwd_kernel"), ("kernel", "obj_mlp_fwd_kernel"))
K2_PARTS = (("tile", "mlp_bwd_kernel<2"), ("dW", "dw_kernel<2"), ("reduce", "reduce_kernel<2"),
            ("ray_sums", "ray_sum_kernel<2"))


def host_ms(fn, calls: int) -> float:
    """Host-clock ms per call of fn() over `calls` calls after WARMUP, ending
    in a synchronize."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def per_object_route(dev) -> dict:
    """ms per training step and per render chunk on the per-object route."""
    import numpy as np

    from durf_tpu_torch.data.synthetic import example_ray_batch
    from durf_tpu_torch.entry import flagship_config, kernel_operating_point, train_entry
    from durf_tpu_torch.models import construct_model
    from durf_tpu_torch.rays import camera_rays
    from durf_tpu_torch.train import make_render_fn

    step_fn, state, batch = train_entry(dev, batch_size=RAYS, fused_objects=False)
    box = {"state": state}

    def step():
        box["state"], _ = step_fn(box["state"], batch)

    out = {"per_object_step": host_ms(step, STEPS)}
    del step_fn, state, batch, box
    config = kernel_operating_point(flagship_config())
    config.model.fused_objects = False
    batch = example_ray_batch(batch_size=config.batch_size)
    model = construct_model(config.model, batch, dev, seed=0)
    render = make_render_fn(model, config, dev)
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    rays = camera_rays(c2w, 128, 128, focal=64.0, near=config.near, far=config.far)
    first = rays.map(lambda r: r.reshape(-1, r.shape[-1])[:8192])
    out["per_object_chunk"] = host_ms(lambda: render(first, batch["ext"], 1, 10.0), CHUNKS)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="change")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_narrow_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.models.mlp import NerfMLP
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ms, split = {}, {}
    for name, cfg, f_in in (("8x128", MLPConfig(net_width=128), 63),
                            ("4x128", MLPConfig(net_depth=4, net_width=128), 60)):
        mlp = NerfMLP(cfg, f_in, F_C, "bfloat16")
        mlp.reset_parameters(gen)
        w = [t.detach().to(dev) for t in mlp.operands()]
        n = RAYS * SAMPLES
        x = (2 * torch.rand((f_in, n), generator=gen) - 1).to(dev)
        cond = (2 * torch.rand((RAYS, F_C), generator=gen) - 1).to(dev)
        cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
        g_rgb = torch.randn((3, n), generator=gen).to(dev)
        g_den = torch.randn((1, n), generator=gen).to(dev)
        _, _, res = k1._k1_launch(x, cond_lin, w, cfg, SAMPLES, save=True)
        cases = {
            "k1": (lambda: k1._k1_launch(x, cond_lin, w, cfg, SAMPLES, save=False), K1_PARTS),
            "k1_save": (lambda: k1._k1_launch(x, cond_lin, w, cfg, SAMPLES, save=True), K1_PARTS),
            "k2": (lambda: k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, SAMPLES), K2_PARTS),
        }
        for kind, (fn, parts) in cases.items():
            key = f"{kind}_{name}_{RAYS}x{SAMPLES}"
            ms[key] = time_ms(fn)
            split[key] = device_split(fn, parts)
        del cases, res, x, cond, cond_lin, g_rgb, g_den, w
        torch.cuda.empty_cache()
    ms.update(per_object_route(dev))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"label": args.label, "device": torch.cuda.get_device_name(0),
                      "power_limit": smi, "ms": ms, "device_ms": split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
