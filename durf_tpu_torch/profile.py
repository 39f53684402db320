"""Where the time of one render chunk, or of one training step, goes on the
card.

    python -m durf_tpu_torch.profile [--chunks 3] [--top 25] [--no-fused_objects]
        [--proposal]
    python -m durf_tpu_torch.profile --train [--steps 3] [--top 25]
        [--obj_capacity 0.0625] [--no-fused_objects] [--proposal [--proposal_samples N]]
        [--grid_sampling] [--no-coord_major] [--no-diag_covariance] [--one_rank_group]

Render mode renders 8192-ray chunks of the flagship model at the kernel
operating point (the chip_smoke.py slice: random weights from seed 0, a
128x128 camera at the origin). Train mode runs the flagship training step of
`entry.train_entry()` (batch 4096, seed 0, bench.py's object-ray compaction
at --obj_capacity, 0 for none) after two warm-up steps. --no-fused_objects
takes the per-object route (K1/K2 once per object instead of K3/K4);
--proposal turns on proposal levels (bench.py --proposal: level 0 runs the
4x128 proposal MLP, K1/K2 at 128/128, with --proposal_samples samples when
positive). In train mode --grid_sampling samples level 0 from the occupancy
grid (bench.py --grid_sampling), --no-coord_major takes row-major samples
and --no-diag_covariance the full covariance (both on the per-object
route), and --one_rank_group takes the data-parallel group path of a
one-rank NCCL group that this process forms on localhost (parallel/).
Either runs under torch.profiler, which also switches on the program's
spans and counters (metrics.span, metrics.count), then prints the
device-time table by kernel, the host-time table by operation, and one JSON
line: ms per unit (host clock, synchronized, slowed by the profiler),
device busy ms per unit, device ms per unit of each hand-written kernel and
of everything else, K2's and K4's device ms split by their launches (tile
kernel, weight gradients, their reduction, the per-ray sums), K1's and K2's
launches and tile-kernel device ms per unit split by width (256/128 and
128/128, by the kernel each build launches), the share of (tile, object)
pairs K3 and K4 ran (the counter `k3.pairs_ran` over `k3.pairs`), the
device operations (kernels, copies), the host's synchronizations with the
card and the collectives per unit. A unit is a chunk or a step.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import time

# Kernel symbols of each hand-written kernel. K2, K4 and K6 run four
# launches each (the tile kernel, the weight-gradient products, their
# reduction and the per-ray sums; K6 a fifth, the d fill sum), instantiated
# with the tag 2, 4 or 6; K1 and K2 at the flagship widths run the wide_*
# kernels (csrc/mlp_wide.cuh), K3 and K4 at the object width the obj_mlp_*
# kernels (csrc/mlp_obj.cuh) and wide_dw_kernel<4, whose names contain the
# others'; K1, K2, K5 and K6 at 128 / 128 the same obj_mlp_* kernels with
# the tag 1, 2, 5 or 6 (their mask-free builds) and wide_dw_kernel<2 or <6.
GROUPS = (
    ("K1", ("fused_nerf_mlp_fwd_kernel", "wide_mlp_fwd_kernel<1>", "obj_mlp_fwd_kernel<1,")),
    ("K3", ("obj_mlp_fwd_kernel<3,",)),
    ("K5", ("fused_nerf_mlp_gated_fwd_kernel", "obj_mlp_fwd_kernel<5,")),
) + tuple(
    (f"K{t}", tuple(f"{k}<{t}" for k in ("mlp_bwd_kernel", "dw_kernel", "reduce_kernel",
                                          "ray_sum_kernel", "feature_sum_kernel")))
    for t in (2, 4, 6)
)


def group_of(kernel: str) -> str:
    """The hand-written kernel (K1-K6) a device kernel's name belongs to, or
    "other"."""
    return next((g for g, keys in GROUPS if any(k in kernel for k in keys)), "other")


# K2's and K4's device time by launch (their tile kernels' names end in
# mlp_bwd_kernel<T, their dW kernels' in dw_kernel<T).
PARTS = {
    k: (("tile", f"mlp_bwd_kernel<{t}"), ("dW", f"dw_kernel<{t}"),
        ("reduce", f"reduce_kernel<{t}"), ("ray_sums", f"ray_sum_kernel<{t}"))
    for k, t in (("K2", 2), ("K4", 4))
}
# K1's kernel and K2's tile kernel by width: the wide build (256 / 128) and
# the mask-free object build (128 / 128), told apart by kernel name and TAG.
WIDTHS = {
    "K1": (("256/128", "wide_mlp_fwd_kernel<1>"), ("128/128", "obj_mlp_fwd_kernel<1,")),
    "K2": (("256/128", "wide_mlp_bwd_kernel<2>"), ("128/128", "obj_mlp_bwd_kernel<2,")),
}


def _device_us(evt) -> float:
    """Device microseconds of a kernel or copy row; 0 for a CPU-op row,
    whose 'self' device time repeats the time of the kernels it launched,
    and for a span's copy on the device's timeline (metrics.span)."""
    from torch.autograd import DeviceType

    if (getattr(evt, "device_type", None) != DeviceType.CUDA
            or getattr(evt, "is_user_annotation", False)):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _render_unit(dev, fused_objects, proposal):
    import numpy as np

    from durf_tpu_torch.data.synthetic import example_ray_batch
    from durf_tpu_torch.entry import flagship_config, kernel_operating_point, with_proposal
    from durf_tpu_torch.models import construct_model
    from durf_tpu_torch.rays import camera_rays
    from durf_tpu_torch.train import make_render_fn

    config = with_proposal(kernel_operating_point(flagship_config()), proposal)
    config.model.fused_objects = fused_objects
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


def _train_unit(dev, **train_kw):
    from durf_tpu_torch.entry import train_entry

    step_fn, state, batch = train_entry(dev, **train_kw)
    box = {"state": state}

    def one():
        box["state"], _ = step_fn(box["state"], batch)

    return one


def main(argv=None) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from durf_tpu_torch import metrics
    from durf_tpu_torch.devices import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", action="store_true", help="profile the training step")
    p.add_argument("--chunks", type=int, default=3, help="render chunks profiled")
    p.add_argument("--steps", type=int, default=3, help="training steps profiled")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--obj_capacity", type=float, default=0.0625,
                   help="object-ray compaction fraction of the training step (0: off)")
    p.add_argument("--fused_objects", action=argparse.BooleanOptionalAction, default=True,
                   help="objects-in-grid kernels K3/K4 (--no-fused_objects: K1/K2 per object)")
    p.add_argument("--proposal", action="store_true",
                   help="proposal levels: the 4x128 proposal MLP on level 0 (bench.py --proposal)")
    p.add_argument("--proposal_samples", type=int, default=0,
                   help="samples per proposal level of the training step (0: num_samples)")
    p.add_argument("--grid_sampling", action="store_true",
                   help="occupancy-grid level-0 sampling in the training step")
    p.add_argument("--coord_major", action=argparse.BooleanOptionalAction, default=True,
                   help="coordinate-major samples in the training step (--no-coord_major: "
                        "row-major)")
    p.add_argument("--diag_covariance", action=argparse.BooleanOptionalAction, default=True,
                   help="diagonal covariance in the training step (--no-diag_covariance: full)")
    p.add_argument("--one_rank_group", action="store_true",
                   help="the training step's data-parallel group path, on a one-rank NCCL group")
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    group = None
    if args.one_rank_group:
        from durf_tpu_torch import parallel

        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(parallel.mesh.free_port()))
        group = parallel.init_group(dev)
        atexit.register(torch.distributed.destroy_process_group)
    if args.train:
        one = _train_unit(dev, obj_capacity=args.obj_capacity, fused_objects=args.fused_objects,
                          proposal=args.proposal, proposal_samples=args.proposal_samples,
                          grid_sampling=args.grid_sampling, coord_major=args.coord_major,
                          diag_covariance=args.diag_covariance, group=group)
    else:
        one = _render_unit(dev, args.fused_objects, args.proposal)
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
    counts = metrics.counters()
    ran, total = counts.get("k3.pairs_ran", 0), counts.get("k3.pairs", 0)
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=args.top))
    print(events.table(sort_by="self_cpu_time_total", row_limit=args.top))

    groups = {g: 0.0 for g, _ in GROUPS}
    groups["other"] = 0.0
    parts = {k: {p: 0.0 for p, _ in keys} for k, keys in PARTS.items()}
    by_width = {k: {w: [0, 0.0] for w, _ in keys} for k, keys in WIDTHS.items()}
    n_device = n_sync = n_collective = 0
    for evt in events:
        us = _device_us(evt)
        n_device += evt.count if us > 0 else 0
        if us == 0 and evt.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            n_sync += evt.count
        if us == 0 and evt.key.startswith("c10d::"):
            n_collective += evt.count
        groups[group_of(evt.key)] += us
        for k, keys in PARTS.items():
            part = next((p for p, key in keys if key in evt.key), None)
            if part is not None:
                parts[k][part] += us
        for k, keys in WIDTHS.items():
            width = next((w for w, key in keys if key in evt.key), None)
            if width is not None and us > 0:
                by_width[k][width][0] += evt.count
                by_width[k][width][1] += us
    unit = "step" if args.train else "chunk"
    busy_ms = sum(groups.values()) / 1e3 / units
    wall_ms = 1e3 * wall / units
    print(
        json.dumps(
            {
                "device": torch.cuda.get_device_name(0),
                "mode": "train" if args.train else "render",
                "obj_capacity": args.obj_capacity if args.train else 0.0,
                "fused_objects": args.fused_objects,
                "proposal": args.proposal,
                "proposal_samples": args.proposal_samples if args.proposal and args.train else 0,
                "grid_sampling": args.grid_sampling and args.train,
                "coord_major": args.coord_major or not args.train,
                "diag_covariance": args.diag_covariance or not args.train,
                f"ms_per_{unit}": wall_ms,
                f"device_busy_ms_per_{unit}": busy_ms,
                f"device_ops_per_{unit}": n_device / units,
                # Host waits for the card (copies from pageable memory, and
                # the synchronize that ends the timed window).
                f"host_syncs_per_{unit}": n_sync / units,
                "one_rank_group": args.one_rank_group,
                f"collectives_per_{unit}": n_collective / units,
                f"device_ms_per_{unit}": {k: v / 1e3 / units for k, v in groups.items()},
                **{
                    f"{k.lower()}_device_ms_per_{unit}": {p: v / 1e3 / units for p, v in ps.items()}
                    for k, ps in parts.items()
                },
                # K1's and K2's launches and tile-kernel device ms by width.
                f"k1_k2_by_width_per_{unit}": {
                    k: {w: {"launches": c / units, "device_ms": v / 1e3 / units}
                        for w, (c, v) in ws.items()}
                    for k, ws in by_width.items()
                },
                # The share of (128-sample tile, object) pairs that K3 and
                # K4 ran: the others no ray of the tile hits.
                "obj_pairs_ran": ran,
                "obj_pairs": total,
                "obj_pair_share": ran / total if total else None,
            }
        )
    )


if __name__ == "__main__":
    main()
