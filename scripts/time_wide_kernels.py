#!/usr/bin/env python3
"""Time K1 and K2 at the flagship widths (the 8x256 background MLP, F_in 60:
the wgmma + TMA kernels of csrc/mlp_wide.cuh) on one NVIDIA GPU, at the
first training cell's per-level shape (16384 rays x 128 samples).

    python3 scripts/time_wide_kernels.py [--root DIR] [--label NAME]

Imports durf_tpu_torch from DIR (default: this checkout), so that two trees
(a change and its parent unpacked beside it) can be timed in turns on one
card with the same inputs. It times the wrappers with CUDA events (median
of 10 calls after 2 warm-ups): K1 without saving residuals (a render), K1
saving them (a training step), and K2 on what K1 saved, without dx (the
training step's background MLP) and with it. Then, under torch.profiler,
each one's device time per call by launch (K1: its kernel; K2: tile kernel,
weight gradients, reduction, per-ray sums; "other" is the wrappers' own
device work). Last, a sha256 of K1's outputs with save and of K2's with dx
(dx, d cond_lin, every gradient): two trees give the same digest on these
inputs exactly when their outputs are bitwise equal. Also K2's dW products
against their bytes: the device bytes they must move (x_save, act and G,
each read once; 20.7 GB a level) over their device time, the bytes their
SMs take in from L2 (fused_mlp.dw_ingest_bytes: each tile's A and G boxes,
less the G a cluster's two CTAs share) and how many of K2's 2-CTA dW
clusters the card holds at once (cudaOccupancyMaxActiveClusters), both
null for a tree without the clusters. Prints one JSON
line {"label", "device", "power_limit", "ms": {...}, "device_ms": {...},
"dw": {...}, "digest": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

from time_obj_kernels import device_split, time_ms

RAYS, SAMPLES, F_IN, F_C = 16384, 128, 60, 27
K1_PARTS = (("kernel", "wide_mlp_fwd_kernel<1>"),)
K2_PARTS = (("tile", "mlp_bwd_kernel<2"), ("dW", "dw_kernel<2"), ("reduce", "reduce_kernel<2"),
            ("ray_sums", "ray_sum_kernel<2"))


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dw_account(k1, cfg, n: int, split: dict) -> dict:
    """K2's dW products at N = n: device GB a level (every input byte read
    once), GB/s by case, GB a level into the SMs and the clusters the card
    holds (null where the tree has no clusters)."""
    _, act_stride = k1.act_layout(cfg, n)
    device_bytes = 2.0 * (k1.x_cols(cfg, F_IN) * n + act_stride + sum(k1.g_widths(cfg)) * n)
    clustered = hasattr(k1, "k2_dw_max_clusters")
    return {"device_gb": device_bytes / 1e9,
            "gb_s": {k: device_bytes / v["dW"] / 1e6 for k, v in split.items() if "dW" in v},
            "sm_ingest_gb": k1.dw_ingest_bytes(cfg, F_IN, n)[0] / 1e9 if clustered else None,
            "max_active_clusters": k1.k2_dw_max_clusters() if clustered else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="change")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_wide_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.models.mlp import NerfMLP
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cfg = MLPConfig()
    mlp = NerfMLP(cfg, F_IN, F_C, "bfloat16")
    mlp.reset_parameters(gen)
    w = [t.detach().to(dev) for t in mlp.operands()]
    n = RAYS * SAMPLES
    x = (2 * torch.rand((F_IN, n), generator=gen) - 1).to(dev)
    cond = (2 * torch.rand((RAYS, F_C), generator=gen) - 1).to(dev)
    cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
    g_rgb = torch.randn((3, n), generator=gen).to(dev)
    g_den = torch.randn((1, n), generator=gen).to(dev)
    _, _, res = k1._k1_launch(x, cond_lin, w, cfg, SAMPLES, save=True)
    cases = {
        "k1": (lambda: k1._k1_launch(x, cond_lin, w, cfg, SAMPLES, save=False), K1_PARTS),
        "k1_save": (lambda: k1._k1_launch(x, cond_lin, w, cfg, SAMPLES, save=True), K1_PARTS),
        "k2": (lambda: k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, SAMPLES, need_dx=False),
               K2_PARTS),
        "k2_dx": (lambda: k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, SAMPLES), K2_PARTS),
    }
    rgb, den, _ = k1._k1_launch(x, cond_lin, w, cfg, SAMPLES, save=True)
    dx, dcond, grads = k1.fused_nerf_mlp_bwd(res, g_rgb, g_den, w, cfg, SAMPLES)
    digests = {"k1_save": digest([rgb, den]), "k2_dx": digest([dx, dcond, *grads])}
    del rgb, den, dx, dcond, grads
    ms, split = {}, {}
    for kind, (fn, parts) in cases.items():
        key = f"{kind}_{RAYS}x{SAMPLES}"
        ms[key] = time_ms(fn)
        split[key] = device_split(fn, parts)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"label": args.label, "device": torch.cuda.get_device_name(0),
                      "power_limit": smi, "ms": ms, "device_ms": split,
                      "dw": dw_account(k1, cfg, n, split), "digest": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
