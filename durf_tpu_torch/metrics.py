"""Metrics / observability: a JSONL scalar log, PNG images, throughput
counters and torch.profiler traces (the JAX package's `metrics.py`).

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


@contextlib.contextmanager
def trace(name: str, enabled: bool = True):
    """A named range in torch.profiler traces (no-op when disabled)."""
    if enabled:
        with torch.profiler.record_function(name):
            yield
    else:
        yield


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
    `log_dir`/trace.json; returns that path."""
    profiler.stop()
    target = os.path.join(log_dir, "trace.json")
    profiler.export_chrome_trace(target)
    return target
