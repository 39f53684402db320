"""Metrics / observability: a JSONL scalar log, PNG images, throughput
counters, torch.profiler traces (the JAX package's `metrics.py`), and the
program's spans and counters, which record only under a torch profiler.

`MetricsWriter` always writes `metrics.jsonl` (one JSON object per logged
step) and each image as a PNG under `images/`; it mirrors both to
TensorBoard through tensorboardX when that package is installed (it is
loaded by name, only then: the port does not depend on it).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from durf_tpu_torch.data.format import to_uint8, write_png


class MetricsWriter:
    """JSONL scalars + PNG images, mirrored to TensorBoard when available."""

    def __init__(self, log_dir: str, enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        if enable_tensorboard:
            try:
                tensorboard = importlib.import_module("tensorboardX")
            except ImportError:
                tensorboard = None
            if tensorboard is not None:
                self._tb = tensorboard.SummaryWriter(log_dir)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        clean = {k: float(np.asarray(v)) for k, v in values.items()}
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps({"step": step, **clean}) + "\n")
        self._jsonl.flush()

    def image(self, step: int, tag: str, image: np.ndarray) -> None:
        """image: [H, W, 3] float in [0, 1]; written to
        images/<tag with '/' as '_'>_<step>.png."""
        image = np.clip(np.asarray(image, np.float32), 0, 1)
        folder = os.path.join(self.log_dir, "images")
        os.makedirs(folder, exist_ok=True)
        write_png(os.path.join(folder, f"{tag.replace('/', '_')}_{step}.png"), to_uint8(image))
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class Throughput:
    """Steps/rays/ray-samples per second over print_every windows (host
    clock; the caller's logging reads the loss, which waits for the card)."""

    def __init__(self, batch_size: int, samples_per_ray: int):
        self.batch_size = batch_size
        self.samples_per_ray = samples_per_ray
        self.reset()

    def reset(self) -> None:
        self._t0 = time.time()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def report(self) -> Dict[str, float]:
        dt = max(time.time() - self._t0, 1e-9)
        steps_per_sec = self._steps / dt
        rays_per_sec = steps_per_sec * self.batch_size
        out = {
            "perf/steps_per_sec": steps_per_sec,
            "perf/rays_per_sec": rays_per_sec,
            "perf/ray_samples_per_sec": rays_per_sec * self.samples_per_ray,
        }
        self.reset()
        return out


# Spans and counters are on exactly while a torch profiler records (any of
# them: the benchmark's traced window, train --profile_dir, profile.py): off,
# a span is one call and a shared null context, with no dispatcher call.
_profiling = torch.autograd._profiler_enabled
_record = torch.profiler.record_function
_OFF = contextlib.nullcontext()
# name -> the values count() kept since the last counters().
_counts: Dict[str, list] = {}


def span(name: str):
    """A named range on the profiler's own clock, in the same Chrome trace as
    the kernels it launches (each kernel links to its launching runtime call
    by correlation id): `with metrics.span("durf.step"): ...`."""
    return _record(name) if _profiling() else _OFF


def count(name: str, value) -> None:
    """Add `value` to the counter `name` while a profiler records. `value`
    is a host int, a tensor the program has already computed (kept by
    reference), or a function of no argument returning either, called by
    counters(); nothing here launches a device operation or waits for one."""
    if _profiling():
        _counts.setdefault(name, []).append(value)


def counters() -> Dict[str, float]:
    """Every counter's sum since the last call, then cleared: the deferred
    values are evaluated and the device sums read back in one copy."""
    global _counts
    counts, _counts = _counts, {}
    out: Dict[str, float] = {}
    sums = {}
    for name, values in counts.items():
        values = [v() if callable(v) else v for v in values]
        out[name] = sum(v for v in values if not torch.is_tensor(v))
        tensors = [v.sum().double() for v in values if torch.is_tensor(v)]
        if tensors:
            sums[name] = torch.stack(tensors).sum()
    if sums:
        for name, v in zip(sums, torch.stack(list(sums.values())).tolist()):
            out[name] += v
    return out


def start_profiler(log_dir: str) -> torch.profiler.profile:
    """Start tracing the host and, when there is one, the card; returns the
    profiler to hand to stop_profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler: torch.profiler.profile, log_dir: str) -> str:
    """Stop a profiler from start_profiler and write its Chrome trace to
    `log_dir`/trace.json and the counters it switched on (counters()) to
    `log_dir`/counters.json; returns the trace's path."""
    profiler.stop()
    target = os.path.join(log_dir, "trace.json")
    profiler.export_chrome_trace(target)
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f)
    return target
