"""The readers of the program's spans and counters (portbench/spans.py) on a
synthetic Chrome trace: device time attributed by correlation id to the
innermost span of the launching call, also across threads as the
backward's launches are; idle gaps and syncs labelled by the innermost
span; every reader the benchmark had gives the same value with and without
the program's spans in the trace; the new readers find the trace in the
harness's frame and read nothing from a program without spans."""

from pathlib import Path

import pytest

from portbench import harness, spans, trace

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "portbench" / "layer_metrics"
# The readers of the program's spans and counters, and the others.
NEW = sorted(p.stem for p in METRICS.glob("*.py") if "import spans" in p.read_text())
OLD = sorted(p.stem for p in METRICS.glob("*.py") if p.stem not in NEW)
K1 = "void durf::wide::wide_mlp_fwd_kernel<1>(float)"
K2 = "void durf::wide::wide_mlp_bwd_kernel<2>(float)"
MAIN, AUTOGRAD = 1, 2


def ev(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur, tid=MAIN):
    return ev("user_annotation", name, ts, dur, tid)


def launch(ts, corr, tid=MAIN, name="cudaLaunchKernel"):
    return ev("cuda_runtime", name, ts, 2, tid, corr)


def device(name, ts, dur, corr, cat="kernel"):
    return ev(cat, name, ts, dur, 0, corr)


# One step of 1000 us: the forward's sampling launches an eager kernel, the
# MLP launches K1, the backward's launches run on autograd's thread (K2
# and an eager kernel), the update a copy; a sync in the sampling, the
# benchmark's own at the end.
BENCH = [span("portbench.step", 0, 900), span("portbench.sync", 900, 100)]
PROGRAM = [
    span("durf.step", 10, 880),
    span("durf.step.forward", 20, 380),
    span("durf.model.sample", 30, 100),
    span("durf.model.mlp", 150, 100),
    span("durf.step.backward", 400, 300),
    span("durf.step.update", 700, 180),
]
# The profiler's copies of the spans on the device's timeline.
ANNOTATIONS = [dict(e, cat="gpu_user_annotation", tid=0) for e in PROGRAM]
WORK = [
    launch(40, 1), device("at::native::add", 60, 100, 1),
    ev("cuda_runtime", "cudaStreamSynchronize", 120, 5),
    launch(160, 2), device(K1, 170, 200, 2),
    launch(450, 3, AUTOGRAD), device(K2, 460, 150, 3),
    launch(460, 4, AUTOGRAD), device("at::native::mul", 610, 40, 4),
    launch(720, 5, name="cudaMemcpyAsync"), device("Memcpy HtoD", 730, 30, 5, "gpu_memcpy"),
    ev("cuda_runtime", "cudaStreamSynchronize", 950, 5),
]
EVENTS = BENCH + PROGRAM + ANNOTATIONS + WORK
WORK_COUNTS = {"flops": 1e12, "k1_bound_s": 50e-6, "k2_bound_s": 60e-6}


def summary(events):
    return trace.summarize(events, units=1, chunks=2, work=WORK_COUNTS, untraced_unit_s=1e-3)


def run_cell(events, s, names):
    """Stands in for harness.run_cell: the readers run in its frame."""
    return {n: harness.load_file(METRICS / f"{n}.py").read(s) for n in names}


def test_device_time_goes_to_the_innermost_span_of_its_launch_across_threads():
    layers = spans.analyze(EVENTS)
    assert layers.eager_s == pytest.approx({"durf.model.sample": 100e-6,
                                            "durf.step.backward": 40e-6,
                                            "durf.step.update": 30e-6})
    assert layers.device_s == pytest.approx({"durf.model.sample": 100e-6, "durf.model.mlp": 200e-6,
                                             "durf.step.backward": 190e-6,
                                             "durf.step.update": 30e-6})
    assert layers.eager_ops[("durf.step.backward", "at::native::mul")] == pytest.approx(40e-6)
    # The eager spans partition the summary's eager time.
    assert sum(layers.eager_s.values()) == pytest.approx(summary(EVENTS).group_s["other"])


def test_gaps_and_syncs_take_the_innermost_span():
    layers = spans.analyze(EVENTS)
    assert layers.syncs == {"durf.model.sample": 1}  # the closing one is the benchmark's
    gaps = [(k, round(v * 1e6)) for k, v in layers.idle_gaps]
    # Idle [0, 60], [160, 170], [370, 460], [650, 730], [760, 1000]: each
    # labelled by the span open where it starts; [0, 60] before the
    # program's step span, [370, 460] in the forward after its MLP closed.
    assert gaps == [("durf.step.update", 240), ("durf.step.forward", 90),
                    ("durf.step.backward", 80), ("portbench.step", 60),
                    ("durf.model.mlp", 10)]


def test_innermost_prefers_the_latest_opened_and_then_the_shorter():
    inner = spans.Innermost([("a", 0, 10), ("b", 2, 8), ("c", 2, 5), ("d", 6, 12)])
    assert [inner(t) for t in (-1, 1, 3, 5, 7, 9, 11, 12)] == [
        "outside", "a", "c", "b", "d", "d", "d", "outside"]


@pytest.mark.parametrize("name", OLD)
def test_every_earlier_reader_reads_the_same_with_the_programs_spans(name):
    with_spans, without = summary(EVENTS), summary(BENCH + WORK)
    reader = harness.load_file(METRICS / f"{name}.py")
    assert reader.read(with_spans) == reader.read(without)
    assert trace.breakdown(with_spans) == trace.breakdown(without)


def test_the_new_readers_find_the_trace_in_the_harness_frame(monkeypatch):
    from durf_tpu_torch import metrics

    monkeypatch.setattr(metrics, "counters", lambda: {"k3.pairs": 40, "k3.pairs_ran": 10.0})
    got = run_cell(EVENTS, summary(EVENTS), NEW)
    assert got["sample_eager_ms_per_step.train"] == pytest.approx(0.1)
    assert got["backward_eager_ms_per_step.train"] == pytest.approx(0.04)
    assert got["update_eager_ms_per_step.train"] == pytest.approx(0.03)
    assert got["sample_eager_ms_per_chunk.render"] == pytest.approx(0.05)  # two chunks
    assert got["k3_pair_share.train"] == pytest.approx(25.0)
    # Spans the step did not open read nothing.
    assert got["objects_eager_ms_per_step.train"] is None
    assert got["upload_device_ms_per_chunk.render"] is None
    assert spans.last()["eager_ms_per_unit"]["durf.step.update"] == pytest.approx(0.03)


def test_no_program_span_or_no_harness_frame_reads_nothing():
    """A program without spans (the benchmark's parent) and a reader called
    outside the harness give None; neither raises."""
    got = run_cell(BENCH + WORK, summary(BENCH + WORK), NEW)
    assert set(got.values()) == {None}
    reader = harness.load_file(METRICS / "sample_eager_ms_per_step.train.py")
    assert reader.read(summary(EVENTS)) is None
