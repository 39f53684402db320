"""Reduce a torch.profiler chrome trace of the traced window to what the
per-layer readers read: the device's kernels, copies and sets, the host's
synchronizations, the benchmark's own spans, and the kernel groups.

The kernel groups are the port's hand-written kernels by symbol (copied
from durf_tpu_torch/profile.py): K2, K4 and K6 each run a tile kernel, the
weight gradients, their reduction and the per-ray sums; K1 and K2 at
256 / 128 run the wide_* kernels, at 128 / 128 the obj_mlp_* kernels with
the tag 1 or 2; K3 and K4 the obj_mlp_* kernels with the tag 3 or 4.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from portbench import stats

GROUPS = (
    ("K1", ("fused_nerf_mlp_fwd_kernel", "wide_mlp_fwd_kernel<1>", "obj_mlp_fwd_kernel<1,")),
    ("K3", ("obj_mlp_fwd_kernel<3,",)),
    ("K5", ("fused_nerf_mlp_gated_fwd_kernel", "obj_mlp_fwd_kernel<5,")),
) + tuple(
    (f"K{t}", tuple(f"{k}<{t}" for k in ("mlp_bwd_kernel", "dw_kernel", "reduce_kernel",
                                          "ray_sum_kernel", "feature_sum_kernel")))
    for t in (2, 4, 6)
)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host calls that wait for the device: the synchronizations, and the
# synchronous copy.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
SPANS = ("portbench.draw", "portbench.step", "portbench.chunk", "portbench.sync", "portbench.view")


def group_of(kernel: str) -> str:
    """The hand-written kernel (K1-K6) a device kernel belongs to, or 'other'."""
    return next((g for g, keys in GROUPS if any(k in kernel for k in keys)), "other")


@dataclass
class Summary:
    """The traced window, seconds on the trace's clock."""

    units: int  # steps or views traced
    chunks: int  # render chunks traced (0 in training)
    window_s: float
    busy_s: float
    device_ops: int
    host_syncs: int
    group_s: dict  # K1..K6 and 'other' -> device seconds
    by_name: dict  # device op name -> seconds
    idle_gaps: list  # [(label, seconds)], longest first
    work: dict = field(default_factory=dict)  # the driver's counts for the readers
    untraced_unit_s: float = 0.0  # seconds a unit took in the untraced stretch before the trace


def _label(spans, t: float) -> str:
    """The innermost benchmark span open at time t, or 'outside'."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "outside"


def summarize(events, units: int, chunks: int = 0, work=None, untraced_unit_s: float = 0.0) -> Summary:
    """`events`: the chrome trace's event list. The window runs from the
    start of the first benchmark span to the end of the last (the final
    synchronize); synchronizations inside 'portbench.sync' spans are the
    benchmark's own and not counted. `untraced_unit_s`: a unit's time on
    the device's clock in the untraced stretch the harness runs first."""
    spans = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and e.get("name") in SPANS and e.get("cat") != "gpu_user_annotation"]
    if not spans:
        raise ValueError("the trace holds no benchmark span")
    lo, hi = min(s for _, s, _ in spans), max(e for _, _, e in spans)
    device, by_name, group_us = [], {}, {}
    n_ops = n_sync = 0
    own_syncs = [(s, e) for n, s, e in spans if n == "portbench.sync"]
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, ts, dur = e.get("cat"), e.get("name", ""), e.get("ts", 0.0), e.get("dur", 0.0)
        if cat in DEVICE_CATS:
            iv = stats.clip([(ts, ts + dur)], lo, hi)
            if not iv:
                continue
            us = iv[0][1] - iv[0][0]
            device.append(iv[0])
            n_ops += 1
            by_name[name] = by_name.get(name, 0.0) + us
            g = group_of(name) if cat == "kernel" else "other"
            group_us[g] = group_us.get(g, 0.0) + us
        elif cat == "cuda_runtime" and name in SYNC_CALLS and lo <= ts <= hi:
            if not any(s <= ts <= t for s, t in own_syncs):
                n_sync += 1
    merged = stats.union(device)
    busy = sum(e - s for s, e in merged)
    holes = sorted(stats.gaps(merged, lo, hi), key=lambda g: g[0] - g[1])
    groups = {g: group_us.get(g, 0.0) / 1e6 for g, _ in GROUPS}
    groups["other"] = group_us.get("other", 0.0) / 1e6
    return Summary(
        units=units, chunks=chunks, window_s=(hi - lo) / 1e6, busy_s=busy / 1e6, device_ops=n_ops,
        host_syncs=n_sync, group_s=groups,
        by_name={k: v / 1e6 for k, v in by_name.items()},
        idle_gaps=[(_label(spans, s), (e - s) / 1e6) for s, e in holes],
        work=dict(work or {}), untraced_unit_s=untraced_unit_s,
    )


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list, at most `width` letters."""
    return name.split("(")[0][:width]


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def breakdown(summary: Summary, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each labelled by the benchmark span the host was in."""
    ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short(k), v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary.idle_gaps[:top]]}
