"""Where the time of one render chunk, or of one training step, goes on the
card.

    python -m durf_tpu_torch.profile [--chunks 3] [--top 25]
    python -m durf_tpu_torch.profile --train [--steps 3] [--top 25]

Render mode renders 8192-ray chunks of the flagship model at the kernel
operating point (the chip_smoke.py slice: random weights from seed 0, a
128x128 camera at the origin). Train mode runs the flagship training step of
`entry.train_entry()` (batch 4096, seed 0) after two warm-up steps. Either
runs under torch.profiler, then prints the device-time table by kernel and
one JSON line: ms per unit (host clock, synchronized), device busy ms per
unit, the idle share, device ms per unit of each kernel (K1, K3; K2 and K4
in train mode) and of everything else, and the device operations (kernels,
copies) per unit. A unit is a chunk or a step.
"""

from __future__ import annotations

import argparse
import json
import time

# Kernel symbols of each hand-written kernel. K2 and K4 run four launches
# each (the tile kernel, the weight-gradient products, their reduction and
# the per-ray sums), instantiated with the tag 2 or 4.
GROUPS = (
    ("K1", ("fused_nerf_mlp_fwd_kernel",)),
    ("K3", ("fused_obj_mlp_fwd_kernel",)),
    ("K2", ("mlp_bwd_kernel<2,", "dw_kernel<2>", "reduce_kernel<2>", "ray_sum_kernel<2>")),
    ("K4", ("mlp_bwd_kernel<4,", "dw_kernel<4>", "reduce_kernel<4>", "ray_sum_kernel<4>")),
)


def _device_us(evt) -> float:
    """Device microseconds of a kernel or copy row; 0 for a CPU-op row,
    whose 'self' device time repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _render_unit(dev):
    import numpy as np

    from durf_tpu_torch.data.synthetic import example_ray_batch
    from durf_tpu_torch.entry import flagship_config, kernel_operating_point
    from durf_tpu_torch.models import construct_model
    from durf_tpu_torch.rays import camera_rays
    from durf_tpu_torch.train import make_render_fn

    config = kernel_operating_point(flagship_config())
    batch = example_ray_batch(batch_size=config.batch_size)
    model = construct_model(config.model, batch, dev, seed=0)
    render = make_render_fn(model, config, dev)
    size, chunk = 128, 8192
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    rays = camera_rays(c2w, size, size, focal=size / 2, near=config.near, far=config.far)
    first = rays.map(lambda r: r.reshape(-1, r.shape[-1])[:chunk])

    def one():
        render(first, batch["ext"], 1, 10.0)

    return one


def _train_unit(dev):
    from durf_tpu_torch.entry import train_entry

    step_fn, state, batch = train_entry(dev)
    box = {"state": state}

    def one():
        box["state"], _ = step_fn(box["state"], batch)

    return one


def main(argv=None) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from durf_tpu_torch.devices import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", action="store_true", help="profile the training step")
    p.add_argument("--chunks", type=int, default=3, help="render chunks profiled")
    p.add_argument("--steps", type=int, default=3, help="training steps profiled")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    one = _train_unit(dev) if args.train else _render_unit(dev)
    units = args.steps if args.train else args.chunks
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            one()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=args.top))

    names = ["K1", "K2", "K3", "K4"] if args.train else ["K1", "K3"]
    groups = {k: 0.0 for k in names + ["other"]}
    n_device = 0
    for evt in events:
        us = _device_us(evt)
        n_device += evt.count if us > 0 else 0
        group = next((g for g, keys in GROUPS if any(k in evt.key for k in keys)), "other")
        groups[group if group in groups else "other"] += us
    unit = "step" if args.train else "chunk"
    busy_ms = sum(groups.values()) / 1e3 / units
    wall_ms = 1e3 * wall / units
    print(
        json.dumps(
            {
                "device": torch.cuda.get_device_name(0),
                "mode": "train" if args.train else "render",
                f"ms_per_{unit}": wall_ms,
                f"device_busy_ms_per_{unit}": busy_ms,
                "idle_share": 1.0 - busy_ms / wall_ms,
                f"device_ops_per_{unit}": n_device / units,
                f"device_ms_per_{unit}": {k: v / 1e3 / units for k, v in groups.items()},
            }
        )
    )


if __name__ == "__main__":
    main()
