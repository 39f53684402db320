"""Benchmark: training-step ray-sample throughput on the card (the JAX
package's `bench.py`).

Runs the flagship dynamic scene-graph model (the reference waymo.gin
operating point: 2 levels x 128 samples, 8x256 background MLP + 2 object
MLPs, full loss stack + Adam) through `entry.train_entry`, and prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline"}, the ray-samples per
second per card. Under torchrun (WORLD_SIZE > 1) every rank runs its rows
of the global batch (parallel/) and the rate is the global batch's over
the world size, as bench.py divides by the mesh's chips.

    python -m durf_tpu_torch.bench [--batch_size 4096] [--steps 30] ...
    torchrun --nproc_per_node N -m durf_tpu_torch.bench ...

Runs on the card (cuda:LOCAL_RANK under torchrun) and raises without one;
`--device cpu` runs on the CPU when asked.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from durf_tpu_torch import metrics, parallel
from durf_tpu_torch.entry import train_entry

# bench.py's constant (bench.py:26): the repo's target of ray-samples per
# second per chip, not a measurement.
BASELINE_RAY_SAMPLES_PER_SEC = 5e6


def parse_args(argv=None) -> argparse.Namespace:
    """bench.py's flags (bench.py:29-112), and --device."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_size", type=int, default=4096, help="the global batch")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16",
                   help="MLP compute dtype; float32 for parity runs")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=True,
                   help="the hand-written MLP kernels (--no-pallas: the plain path)")
    p.add_argument("--grid_sampling", action="store_true",
                   help="occupancy-grid level-0 sampling")
    p.add_argument("--use_box_nearfar", action="store_true",
                   help="sample box-hitting rays inside the ray/box intersection")
    p.add_argument("--obj_capacity", type=float, default=0.0625,
                   help="object-ray compaction fraction (ModelConfig.obj_ray_capacity); "
                   "0 disables")
    p.add_argument("--remat", action="store_true",
                   help="recompute the plain MLP path in the backward")
    p.add_argument("--fused_objects", action=argparse.BooleanOptionalAction, default=True,
                   help="all objects in one kernel (K3/K4); --no-fused_objects for the "
                   "per-object route")
    p.add_argument("--proposal", action="store_true", help="proposal-MLP coarse levels")
    p.add_argument("--proposal_samples", type=int, default=0,
                   help="samples per proposal level (0 = num_samples); with --proposal")
    p.add_argument("--profile_dir", default=None,
                   help="trace the timed steps with torch.profiler into DIR/trace.json")
    p.add_argument("--recurrent_encode", action=argparse.BooleanOptionalAction, default=True,
                   help="double-angle IPE (--no-recurrent_encode: the direct form)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Time args.steps training steps after args.warmup, each fenced by a
    synchronize; returns the printed line's keys plus `total` (the global
    ray-samples per second) and `world`. Only rank 0 prints and traces.
    Under torchrun the ranks form (or join) the group themselves."""
    with parallel.joined(int(os.environ.get("WORLD_SIZE", "1")) > 1, args.device) as group:
        return _run(args, group)


def _run(args: argparse.Namespace, group) -> dict:
    device, world = group.device, group.size
    step_fn, state, batch = train_entry(
        device, batch_size=args.batch_size, obj_capacity=args.obj_capacity,
        fused_objects=args.fused_objects, proposal=args.proposal,
        proposal_samples=args.proposal_samples, grid_sampling=args.grid_sampling,
        remat=args.remat, use_box_nearfar=args.use_box_nearfar, dtype=args.dtype,
        pallas=args.pallas, recurrent_encode=args.recurrent_encode, group=group,
    )

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(args.warmup):
        state, _ = step_fn(state, batch)
    fence()
    rank0 = group.is_rank0
    trace = args.profile_dir and rank0
    profiler = metrics.start_profiler(args.profile_dir) if trace else None
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step_fn(state, batch)
    fence()
    dt = time.perf_counter() - t0
    if profiler is not None:
        metrics.stop_profiler(profiler, args.profile_dir)

    total = args.steps * args.batch_size * state.config.model.samples_per_ray() / dt
    per_chip = total / world
    line = {
        "metric": "train_ray_samples_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "ray-samples/s/chip",
        "vs_baseline": round(per_chip / BASELINE_RAY_SAMPLES_PER_SEC, 3),
    }
    if rank0:
        print(json.dumps(line), flush=True)
    return {**line, "total": total, "world": world}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
