"""The program's spans and counters on the CPU (metrics.span, metrics.count,
metrics.counters): off, a span is one shared null context; under a torch
profiler a tiny training step, its batch draw and a tiny render view emit
every span of the port's table, nested as the table says; counting adds no
operation; the K3 pair counter reduces to obj_mlp.kept_pairs; and the
collectives of a torch.distributed group run under `durf.comm`.

The tiny flagship runs at the kernel operating point, on the kernels'
plain versions here.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from durf_tpu_torch import entry, metrics
from durf_tpu_torch import train as ttrain
from durf_tpu_torch.data import device_data
from durf_tpu_torch.data.synthetic import example_ray_batch
from durf_tpu_torch.models import construct_model
from durf_tpu_torch.ops.kernels import obj_mlp as k3
from durf_tpu_torch.parallel.mesh import ProcessGroup

LEVEL = ("durf.model.sample", "durf.model.objects", "durf.model.encode", "durf.model.mlp",
         "durf.model.composite")
# Every span of a step and the span it sits in (None: outermost of the
# program's), and how often a step of two levels opens it.
STEP = {
    "durf.step": (None, 1),
    "durf.step.forward": ("durf.step", 1),
    "durf.step.loss": ("durf.step", 1),
    "durf.step.backward": ("durf.step", 1),
    "durf.step.update": ("durf.step", 1),
    "durf.model.boxes": ("durf.step.forward", 1),
    **{s: ("durf.step.forward", 2) for s in LEVEL},
}
H, W, CHUNK = 6, 8, 32  # a view of two chunks, the second padded


@pytest.fixture
def tiny_step(monkeypatch):
    monkeypatch.setattr(entry, "flagship_config", functools.partial(entry.flagship_config,
                                                                    tiny=True))
    step_fn, state, batch = entry.train_entry("cpu", batch_size=64)
    state, _ = step_fn(state, batch)  # Adam's first step sets up its moments
    return step_fn, state, batch


def _spans(prof) -> list:
    """[(name, parent)] of the program's spans in a profile, in order; the
    parent is the innermost enclosing durf.* span, or None."""
    out = []
    for e in prof.events():
        if not e.name.startswith("durf."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("durf."):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _aten_ops(prof) -> int:
    return sum(e.name.startswith("aten::") for e in prof.events())


def test_span_is_one_shared_null_context_while_no_profiler_records():
    assert not torch.autograd._profiler_enabled()
    off = metrics.span("durf.step")
    assert isinstance(off, contextlib.nullcontext) and off is metrics.span("durf.render.slice")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(metrics.span("durf.step"), torch.profiler.record_function)
    assert metrics.span("durf.step") is off


def test_a_step_and_its_draw_emit_every_span_nested_as_the_table_says(tiny_step):
    step_fn, state, batch = tiny_step
    pools = {k: batch[k][None] for k in ("pixels", "depth", "sky")}
    pools.update(rays=batch["rays"].map(lambda r: r[None]), counts=[64], init=batch["init"],
                 target=batch["target"][None], ext=batch["ext"][None],
                 obj_ids=torch.arange(2, dtype=torch.int32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drawn = device_data.sample_batch(pools, 1, 7, 64)
        step_fn(state, drawn)
    spans = _spans(prof)
    assert spans[0] == ("durf.data.draw", None)
    step = spans[1:]
    assert {n: (p, sum(s == (n, p) for s in step)) for n, p in step} == STEP
    assert len(step) == sum(c for _, c in STEP.values())
    # A level's spans in the order of its work.
    levels = [n for n, _ in step if n in LEVEL]
    assert levels == list(LEVEL) * 2


def test_a_render_view_emits_every_span_nested_as_the_table_says():
    config = entry.kernel_operating_point(entry.flagship_config(tiny=True))
    batch = example_ray_batch(batch_size=H * W)
    render_chunk = ttrain.make_render_fn(construct_model(config.model, batch, "cpu"), config, "cpu")
    case = {"rays": batch["rays"].map(lambda r: np.asarray(r).reshape(H, W, -1)),
            "ext": batch["ext"], "ts": batch["ts"]}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ttrain.evaluate_image(render_chunk, case, 10.0, CHUNK)
    assert out["rgb"].shape == (H, W, 3)
    spans = _spans(prof)
    chunk = [("durf.render.slice", None), ("durf.render.upload", None),
             ("durf.render.forward", None), ("durf.model.boxes", "durf.render.forward"),
             *[(s, "durf.render.forward") for s in LEVEL] * 2]
    assert spans == chunk * 2 + [("durf.render.fetch", None)]


def test_counting_adds_no_operation_to_a_step(tiny_step, monkeypatch):
    step_fn, state, batch = tiny_step
    with profile(activities=[ProfilerActivity.CPU]) as on:
        state, _ = step_fn(state, batch)
    metrics.counters()
    monkeypatch.setattr(metrics, "count", lambda name, value: None)
    with profile(activities=[ProfilerActivity.CPU]) as off:
        step_fn(state, batch)
    assert _aten_ops(on) == _aten_ops(off) > 0


def test_the_pair_count_launches_nothing_and_reduces_to_kept_pairs():
    # 8 rays of 40 samples: tile 0 holds rays 0-3, tile 1 rays 3-6, tile 2
    # rays 6-7. Object 0 hits rays 0 and 7 (tiles 0 and 2), object 1 none.
    hit = torch.zeros((2, 8))
    hit[0, 0] = hit[0, 7] = 1.0
    n, s = 320, 40
    kept = k3.kept_pairs(hit, n, s)
    assert kept.tolist() == [[True, False], [False, False], [True, False]]
    first = hit[:1]
    assert metrics.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        k3.count_pairs(hit, n, s)
        k3.count_pairs(first, n, s)
    assert _aten_ops(prof) == 0
    counts = metrics.counters()
    assert counts == {"k3.pairs": 9, "k3.pairs_ran": 4.0}
    assert counts["k3.pairs_ran"] == 2 * int(kept.sum())
    assert metrics.counters() == {}
    k3.count_pairs(hit, n, s)  # no profiler: not counted
    assert metrics.counters() == {}


def test_collectives_run_under_the_comm_span(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        group = ProcessGroup(0, 1, torch.device("cpu"))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            total = group.all_sum(torch.ones(3))
            group.sum_flat([torch.ones(2), torch.zeros(1)])
        assert total.tolist() == [1.0, 1.0, 1.0]
        assert [n for n, _ in _spans(prof)] == ["durf.comm", "durf.comm"]
    finally:
        dist.destroy_process_group()
