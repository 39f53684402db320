"""The program's own spans (`durf.*`, durf_tpu_torch.metrics.span) and
counters (metrics.count) in the traced window, for the per-layer readers
that read them.

Each device kernel, copy and set of the window is attributed to the span
its launching runtime call lies innermost in, the two matched by the
trace's correlation id: the launches of the backward run on autograd's own
thread, inside the main thread's `durf.step.backward`, so the innermost
span is taken over every thread's spans (the latest opened of those open
at the call). The window, the clipping of device intervals to it and the
kernel groups are trace.summarize's, so a span's `eager_s` (outside K1-K6)
summed over every label is the summary's group_s['other'].

trace.Summary carries the benchmark's spans alone, and a reader is handed
only the Summary: `of(summary)` finds the events the summary was reduced
from in the frame of the harness's `run_cell`, which calls the readers, and
reduces them once. Without a trace there (a reader called elsewhere) or
without any program span in it (a program that has none), it gives None.

`python3 portbench/trace_layers.py` prints what `of` found in a run.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field

from portbench import stats, trace

PREFIX = "durf."
OUTSIDE = "outside"


@dataclass
class Layers:
    """The traced window by span: seconds on the trace's clock, counts."""

    eager_s: dict  # span -> device seconds outside K1-K6 launched innermost in it
    device_s: dict  # span -> device seconds of every kernel, copy and set
    syncs: dict  # span -> host waits for the device (the benchmark's own left out)
    idle_gaps: list  # [(innermost span, seconds)], longest first
    eager_ops: dict = field(default_factory=dict)  # (span, short op name) -> eager seconds
    counters: dict = field(default_factory=dict)  # metrics.counters() after the window


class Innermost:
    """The innermost of a set of host spans open at a time: of those that
    contain it, the latest opened (of two opened together, the shorter);
    'outside' where none does."""

    def __init__(self, spans):
        self.starts = sorted({t for _, s, e in spans for t in (s, e)})
        self.labels = []
        opened = sorted(spans, key=lambda x: x[1])
        live, j = [], 0
        # Between two consecutive bounds the open spans do not change.
        for a in self.starts:
            while j < len(opened) and opened[j][1] <= a:
                live.append(opened[j])
                j += 1
            live = [x for x in live if x[2] > a]
            best = max(live, key=lambda x: (x[1], -x[2]), default=None)
            self.labels.append(OUTSIDE if best is None else best[0])

    def __call__(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.labels[i] if i >= 0 else OUTSIDE


def host_spans(events) -> list:
    """(name, start, end) of every benchmark and program span on the host
    (their copies on the device's timeline left out)."""
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"
            and (e.get("name") in trace.SPANS or str(e.get("name", "")).startswith(PREFIX))]


def analyze(events) -> Layers:
    """The window's device time, syncs and idle gaps by innermost span."""
    spans = host_spans(events)
    bench = [x for x in spans if x[0] in trace.SPANS]
    if not bench:
        raise ValueError("the trace holds no benchmark span")
    lo, hi = min(s for _, s, _ in bench), max(e for _, _, e in bench)
    own_syncs = [(s, e) for n, s, e in bench if n == "portbench.sync"]
    inner = Innermost(spans)
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = e["ts"]
    eager, device, syncs, busy, ops = {}, {}, {}, [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, ts = e.get("cat"), e.get("name", ""), e.get("ts", 0.0)
        if cat in trace.DEVICE_CATS:
            iv = stats.clip([(ts, ts + e.get("dur", 0.0))], lo, hi)
            if not iv:
                continue
            busy.append(iv[0])
            us = iv[0][1] - iv[0][0]
            t = launch.get(e.get("args", {}).get("correlation"))
            label = OUTSIDE if t is None else inner(t)
            device[label] = device.get(label, 0.0) + us / 1e6
            if cat != "kernel" or trace.group_of(name) == "other":
                eager[label] = eager.get(label, 0.0) + us / 1e6
                key = (label, trace.short(name))
                ops[key] = ops.get(key, 0.0) + us / 1e6
        elif cat == "cuda_runtime" and name in trace.SYNC_CALLS and lo <= ts <= hi:
            if not any(s <= ts <= t for s, t in own_syncs):
                label = inner(ts)
                syncs[label] = syncs.get(label, 0) + 1
    holes = sorted(stats.gaps(stats.union(busy), lo, hi), key=lambda g: g[0] - g[1])
    return Layers(eager_s=eager, device_s=device, syncs=syncs,
                  idle_gaps=[(inner(s), (e - s) / 1e6) for s, e in holes], eager_ops=ops)


def _run_events():
    """The events of the traced window, from the frame of the harness's
    run_cell (the caller of every reader), or None."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and isinstance(f.f_locals.get("events"), list):
            return f.f_locals["events"]
        f = f.f_back
    return None


def _counters() -> dict:
    """The program's counters of the traced window ({} for a program
    without them)."""
    from durf_tpu_torch import metrics

    read = getattr(metrics, "counters", None)
    return read() if read is not None else {}


_last: tuple = (None, None)  # (summary, its Layers), for the readers after the first


def of(summary) -> Layers | None:
    """The Layers of the trace `summary` was reduced from, or None where
    the trace holds no program span or none is at hand."""
    global _last
    if _last[0] is not summary:
        events = _run_events()
        layers = None
        if events is not None and any(n.startswith(PREFIX) for n, _, _ in host_spans(events)):
            layers = analyze(events)
            layers.counters = _counters()
        _last = (summary, layers)
    return _last[1]


def ms_per(summary, kind: str, names, per: str = "units"):
    """Device ms per traced unit (`per` 'units') or chunk ('chunks') under
    the spans `names`: their eager ('eager') or whole ('device') time; None
    where the trace holds none of them."""
    layers, n = of(summary), getattr(summary, per)
    if layers is None or not n:
        return None
    got = getattr(layers, f"{kind}_s")
    if not any(x in got for x in names):
        return None
    return 1e3 * sum(got.get(x, 0.0) for x in names) / n


def last() -> dict | None:
    """What `of` last found, per traced unit, for the record: eager and
    whole device ms, host syncs and idle ms by span, the ten longest idle
    gaps (ms) with the span the host was in, the ten eager operations that
    took most time with their span, and the counters."""
    summary, layers = _last
    if layers is None:
        return None
    n = summary.units
    idle = {}
    for k, v in layers.idle_gaps:
        idle[k] = idle.get(k, 0.0) + 1e3 * v / n
    return {"units": n, "chunks": summary.chunks,
            "eager_ms_per_unit": {k: 1e3 * v / n for k, v in sorted(layers.eager_s.items())},
            "device_ms_per_unit": {k: 1e3 * v / n for k, v in sorted(layers.device_s.items())},
            "syncs_per_unit": {k: v / n for k, v in sorted(layers.syncs.items())},
            "idle_ms_per_unit": dict(sorted(idle.items())),
            "idle_gaps_ms": [[k, 1e3 * v] for k, v in layers.idle_gaps[:10]],
            "eager_ops_ms_per_unit": [[k, op, 1e3 * v / n] for (k, op), v in
                                      sorted(layers.eager_ops.items(), key=lambda kv: -kv[1])[:10]],
            "counters": layers.counters}
