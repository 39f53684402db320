"""Where the time of one render chunk goes on the card.

    python -m durf_tpu_torch.profile [--chunks 3] [--top 25]

Renders 8192-ray chunks of the flagship model at the kernel operating point
(the chip_smoke.py slice: random weights from seed 0, a 128x128 camera at
the origin) under torch.profiler, then prints the device-time table by
kernel and one JSON line: ms per chunk (host clock, synchronized), device
busy ms per chunk, the idle share, and device ms per chunk of K1, K3 and
everything else, and the device operations (kernels, copies) per chunk.
"""

from __future__ import annotations

import argparse
import json
import time


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


def main(argv=None) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from durf_tpu_torch.data.synthetic import example_ray_batch
    from durf_tpu_torch.devices import resolve_device
    from durf_tpu_torch.entry import flagship_config, kernel_operating_point
    from durf_tpu_torch.models import construct_model
    from durf_tpu_torch.rays import camera_rays
    from durf_tpu_torch.train import make_render_fn

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chunks", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
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

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.chunks):
            one()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=args.top))

    groups = {"K1": 0.0, "K3": 0.0, "other": 0.0}
    n_device = 0
    for evt in events:
        us = _device_us(evt)
        n_device += evt.count if us > 0 else 0
        if "fused_nerf_mlp_fwd_kernel" in evt.key:
            groups["K1"] += us
        elif "fused_obj_mlp_fwd_kernel" in evt.key:
            groups["K3"] += us
        else:
            groups["other"] += us
    busy_ms = sum(groups.values()) / 1e3 / args.chunks
    wall_ms = 1e3 * wall / args.chunks
    print(
        json.dumps(
            {
                "device": torch.cuda.get_device_name(0),
                "ms_per_chunk": wall_ms,
                "device_busy_ms_per_chunk": busy_ms,
                "idle_share": 1.0 - busy_ms / wall_ms,
                "device_ops_per_chunk": n_device / args.chunks,
                "device_ms_per_chunk": {k: v / 1e3 / args.chunks for k, v in groups.items()},
            }
        )
    )


if __name__ == "__main__":
    main()
