#!/usr/bin/env python3
"""Time K5 and K6, the MLP with its input gated in the kernel (forward and
backward), on one NVIDIA GPU.

    python3 scripts/time_gated_kernels.py [--root DIR] [--label NAME]

Imports durf_tpu_torch from DIR (default: this checkout), so that two trees
(a change and its parent unpacked beside it) can be timed in turns on one
card with the same inputs. At the object MLPs' width (8x128, F_in 63, head
128), N = 4096 x 128 (the training step's shape), row-major features and a
per-ray 0/1 gate that lets 3% of the rays in (the flagship batch's hit
share), it times the wrappers with CUDA events (median of 10 calls after 2
warm-ups): K5 without saving residuals, K5 saving them (as the autograd
Function calls it), and K6 on what K5 saved. Then, under torch.profiler,
each one's device time per call by launch (K5: its kernel; K6: the tile
kernel, the weight gradients, their reduction, the per-ray sums and the d
fill sum; "other" is the wrappers' own device work, such as packing
weights). Prints one JSON line {"label", "device", "power_limit", "ms":
{...}, "device_ms": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from time_obj_kernels import device_split, time_ms

RAYS, SAMPLES, F_IN, F_C, GATE_HIT = 4096, 128, 63, 27, 0.03
K5_PARTS = (("kernel", "obj_mlp_fwd_kernel<5,"),)
K6_PARTS = (("tile", "mlp_bwd_kernel<6"), ("dW", "dw_kernel<6"), ("reduce", "reduce_kernel<6"),
            ("ray_sums", "ray_sum_kernel<6"), ("dfill_sum", "feature_sum_kernel<6"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="change")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_gated_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from durf_tpu_torch.configs import MLPConfig
    from durf_tpu_torch.models.mlp import NerfMLP
    from durf_tpu_torch.ops.kernels import fused_mlp as k1

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cfg, n, s = MLPConfig(net_width=128), RAYS * SAMPLES, SAMPLES
    mlp = NerfMLP(cfg, F_IN, F_C, "bfloat16")
    mlp.reset_parameters(gen)
    w = [t.detach().to(dev) for t in mlp.operands()]
    x = (2 * torch.rand((n, F_IN), generator=gen) - 1).to(dev)
    gate = (torch.rand((RAYS,), generator=gen) < GATE_HIT).float().to(dev)
    fill = (2 * torch.rand((F_IN,), generator=gen) - 1).to(dev)
    cond = (2 * torch.rand((RAYS, F_C), generator=gen) - 1).to(dev)
    cond_lin = k1.cond_linear(cond, w[k1.head0_index(cfg)], cfg).contiguous()
    g_rgb = torch.randn((n, 3), generator=gen).to(dev)
    g_den = torch.randn((n, 1), generator=gen).to(dev)
    _, _, res = k1._k5_launch(x, gate, fill, cond_lin, w, cfg, s, save=True)
    cases = {
        "k5": (lambda: k1._k5_launch(x, gate, fill, cond_lin, w, cfg, s, save=False), K5_PARTS),
        "k5_save": (lambda: k1._k5_launch(x, gate, fill, cond_lin, w, cfg, s, save=True), K5_PARTS),
        "k6": (lambda: k1.fused_nerf_mlp_gated_bwd(res, g_rgb, g_den, w, cfg, s), K6_PARTS),
    }
    ms, split = {}, {}
    for kind, (fn, parts) in cases.items():
        key = f"{kind}_8x128_{RAYS}x{SAMPLES}"
        ms[key] = time_ms(fn)
        split[key] = device_split(fn, parts)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"label": args.label, "device": torch.cuda.get_device_name(0),
                      "power_limit": smi, "ms": ms, "device_ms": split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
