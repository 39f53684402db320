"""One run of one cell: set-up, the measured window, the trace (with
--trace 1), the correctness comparison, and the result line.

The cell's mode names its driver (`modes/<mode>.py`), the end-to-end
metrics are read by `end_to_end/<metric>.py` and the per-layer metrics by
`layer_metrics/<metric>.py`, each found by the name BENCHMARK.json gives.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import cells, compare, trace

HERE = Path(__file__).resolve().parent
# Top-level modules the port must not load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "durf_tpu")


@dataclass
class Run:
    name: str
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    workload: dict
    config: dict
    chips: int = 1


@dataclass
class Window:
    """What the window measured, for the end-to-end readers."""

    setup_s: float
    window_s: float
    units: int
    rays_per_unit: int
    unit_ms: list = field(default_factory=list)


def process_start() -> float:
    """The wall-clock time this process started, from /proc (Linux)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start)


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(name: str, kind: str) -> list:
    """The manifest's `kind` metrics ('end_to_end' or 'per_layer') that cell
    `name` reports: those whose `workloads` list it, and those without the
    key whose `moves` the cell reports."""
    m = cells.manifest()
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    moved = {x["name"] for x in e2e}
    return [x for x in m["per_layer"]
            if name in x["workloads"] or ("workloads" not in x and x["moves"] in moved)]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    return torch.profiler.record_function(name)


def window(driver, run: Run, t_start: float, limit_units: int | None = None):
    """Drive units until `run.seconds` have passed on the host clock (or
    `limit_units` ran): (Window, unit times). Each unit's device time comes
    from CUDA events recorded at the unit boundaries, read after the
    closing synchronize."""
    cuda = run.device.type == "cuda"
    with span("portbench.sync"):
        sync(run.device)
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    marks = []
    mark = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else None
    if cuda:
        marks.append(mark())
        marks[-1].record()
    else:
        marks.append(time.perf_counter())
    i = 0
    with driver.loop():
        while time.perf_counter() - t0 < run.seconds and (limit_units is None or i < limit_units):
            with span("portbench.draw"):
                item = driver.draw(driver.done + i)
            with span(f"portbench.{driver.unit}"):
                driver.step(item)
            if cuda:
                marks.append(mark())
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
            i += 1
    with span("portbench.sync"):
        sync(run.device)
    elapsed = time.perf_counter() - t0
    if cuda:
        unit_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        unit_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    driver.done += i
    return Window(setup_s, elapsed, i, driver.rays_per_unit, unit_ms)


def traced_window(driver, run: Run, t_start: float):
    """The workload's `trace_units` units timed by CUDA events alone, then as
    many under torch.profiler: (untraced Window, traced Window, the trace's
    events). The profiler records every host operation and slows the host
    down, so the idle share and the MFU divide by the untraced units' time;
    the trace gives the device's busy time, operations and gaps."""
    from torch.profiler import ProfilerActivity, profile

    n = run.workload["trace_units"]
    plain = window(driver, run, t_start, n)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        win = window(driver, run, t_start, n)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace.load(path)
    finally:
        os.unlink(path)
    return plain, win, events


def run_cell(run: Run, t_start: float) -> dict:
    """One run; returns the result line's object (with `_detail`, the
    numbers not compared, which `main` prints to stderr)."""
    mode = importlib.import_module(f"portbench.modes.{run.workload['mode']}")
    driver = mode.Driver(run)
    for _ in range(run.workload.get("warmup_units", 0)):
        driver.step(driver.draw(driver.done))
        driver.done += 1
    summary = None
    if run.traced:
        plain, win, events = traced_window(driver, run, t_start)
        attempted = plain.units + win.units
    else:
        win = window(driver, run, t_start)
        attempted = win.units
    failed = driver.failed()
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    if run.traced:
        summary = trace.summarize(events, win.units, getattr(driver, "chunks_per_unit", 0) * win.units,
                                  driver.work(), untraced_unit_s=sum(plain.unit_ms) / 1e3 / plain.units)
    driver.release()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    ok, checks = compare.judge(numbers, run.workload["limits"])

    metrics = {}
    if run.traced:
        for m in metrics_of(run.name, "per_layer"):
            value = load_file(HERE / "layer_metrics" / f"{m['name']}.py").read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(run.name, "end_to_end"):
            value = load_file(HERE / "end_to_end" / f"{m['name']}.py").read(win)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
        "count": run.chips,
        "memory_peak_bytes": peak,
    }
    out = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = trace.breakdown(summary)
    out["checks"] = checks
    # The numbers this cell does not compare, for the record.
    out["_detail"] = {k: v for k, v in numbers.items() if k not in checks}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
              cell["workload"], cell["config"], cell["chips"])
    out = run_cell(run, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    detail = out.pop("_detail")
    if detail:
        print(f"detail: {json.dumps(detail)}", file=sys.stderr)
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
