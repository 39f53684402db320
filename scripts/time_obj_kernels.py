#!/usr/bin/env python3
"""Time K3 and K4, the objects-in-grid MLP's forward and backward kernels,
at the hit shares that occur, on one NVIDIA GPU.

    python3 scripts/time_obj_kernels.py [--root DIR] [--label NAME]

Imports durf_tpu_torch from DIR (default: this checkout), so that two trees
(a change and its parent unpacked beside it) can be timed in turns on one
card with the same inputs. At the flagship object width (8x128, F_in 63,
head 128, N_obj 2) it times the wrappers with CUDA events (median of 10
calls after 2 warm-ups): K3 (no save) at N = 8192 x 128 and K4 at 4096 x
128, each at hit shares 1.0, 0.5 and 0.03 (a ray hits an object with that
probability), and both at the compacted training step's shape, N = 256 x
128 with the first 117 rays hitting (each object with probability 0.6).
Then, under torch.profiler, each case's device time per call by launch
(K3: its kernel and the host-side packing's device work; K4: tile kernel,
weight gradients, reduction, per-ray sums, as profile.py splits them).
Prints one JSON line {"label", "device", "power_limit", "ms": {...},
"device_ms": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHARES = (1.0, 0.5, 0.03)
K3_RAYS, K4_RAYS, SAMPLES, N_OBJ, F_IN, F_C = 8192, 4096, 128, 2, 63, 27
MAIN_RAYS, MAIN_HITTING = 256, 117


def time_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, parts, calls=3) -> dict:
    """Device ms per call of fn() by kernel group (the first key of `parts`
    a kernel's name contains), the rest under "other"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in parts}
    out["other"] = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))
        name = next((p for p, key in parts if key in evt.key), "other")
        out[name] += us / 1e3 / calls
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="change")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_obj_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.models.mlp import NerfMLP
    from durf_tpu_torch.ops.kernels import obj_mlp as k3

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    cfg = MLPConfig(net_width=128)
    mlp = NerfMLP(cfg, F_IN, F_C, "bfloat16", num_stack=N_OBJ)
    mlp.reset_parameters(gen)
    w = [t.detach().to(dev) for t in mlp.operands()]

    def inputs(b, hit):
        n = b * SAMPLES
        x = (2 * torch.rand((F_IN, n), generator=gen) - 1).to(dev)
        cond_lin = torch.randn((N_OBJ, b, cfg.net_width_condition), generator=gen)
        g_rgb = torch.randn((3, n), generator=gen).to(dev)
        g_den = torch.randn((1, n), generator=gen).to(dev)
        return x, hit.to(dev), cond_lin.to(torch.bfloat16).float().to(dev), g_rgb, g_den

    def share_hit(b, share):
        return (torch.rand((N_OBJ, b), generator=gen) < share).float()

    main_hit = torch.zeros((N_OBJ, MAIN_RAYS))
    main_hit[:, :MAIN_HITTING] = (torch.rand((N_OBJ, MAIN_HITTING), generator=gen) < 0.6).float()
    cases = [("k3", K3_RAYS, f"{s}", share_hit(K3_RAYS, s)) for s in SHARES]
    cases += [("k4", K4_RAYS, f"{s}", share_hit(K4_RAYS, s)) for s in SHARES]
    cases += [("k3", MAIN_RAYS, "main", main_hit), ("k4", MAIN_RAYS, "main", main_hit)]
    k3_parts = (("kernel", "obj_mlp_fwd_kernel"),)
    k4_parts = (("tile", "mlp_bwd_kernel<4"), ("dW", "dw_kernel<4"), ("reduce", "reduce_kernel<4"),
                ("ray_sums", "ray_sum_kernel<4"))
    out, split = {}, {}
    for kind, b, tag, hit in cases:
        x, hit, cond_lin, g_rgb, g_den = inputs(b, hit)
        if kind == "k3":
            fn = lambda: k3.fused_obj_mlp(x, hit, cond_lin, w, cfg, SAMPLES)  # noqa: E731
            parts = k3_parts
        else:
            _, _, res = k3._k3_launch(x, hit, cond_lin, w, cfg, SAMPLES, save=True)
            fn = lambda: k3.fused_obj_mlp_bwd(res, hit, g_rgb, g_den, w, cfg, SAMPLES)  # noqa: E731
            parts = k4_parts
        key = f"{kind}_{b}x{SAMPLES}_hit_{tag}"
        out[key] = time_ms(fn)
        split[key] = device_split(fn, parts)
        del fn, x, hit, cond_lin, g_rgb, g_den
        res = None
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"label": args.label, "device": torch.cuda.get_device_name(0),
                      "power_limit": smi, "ms": out, "device_ms": split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
