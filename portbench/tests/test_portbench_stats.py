"""The 95th percentile, the spread, and the trace reduction on synthetic
timelines."""

import statistics

import pytest

from portbench import stats, trace


def test_percentile_interpolates_like_numpy():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_quartile_distance_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    merged = stats.union([(5, 7), (0, 2), (1, 3), (6, 8), (10, 11)])
    assert merged == [(0, 3), (5, 8), (10, 11)]
    assert stats.gaps(merged, 0, 12) == [(3, 5), (8, 10), (11, 12)]
    assert stats.clip([(0, 3), (5, 8)], 1, 6) == [(1, 3), (5, 6)]


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_synthetic_timeline():
    # Two steps on the host; on the device K1, K2's tile, an eager kernel
    # overlapping K1, a copy, and one kernel outside the window.
    events = [
        ev("user_annotation", "portbench.step", 0, 400),
        ev("user_annotation", "portbench.step", 400, 500),
        ev("user_annotation", "portbench.sync", 900, 100),
        ev("kernel", "void durf::wide::wide_mlp_fwd_kernel<1>(float)", 10, 100),
        ev("kernel", "at::native::add", 50, 100),
        ev("kernel", "void durf::wide::wide_mlp_bwd_kernel<2>(float)", 500, 200),
        ev("gpu_memcpy", "Memcpy DtoH", 800, 120),
        ev("kernel", "late", 2000, 10),
        ev("cuda_runtime", "cudaStreamSynchronize", 300, 5),
        ev("cuda_runtime", "cudaStreamSynchronize", 950, 5),  # the benchmark's own
        ev("cuda_runtime", "cudaLaunchKernel", 20, 5),
    ]
    s = trace.summarize(events, units=2, work={"flops": 1.0})
    assert s.window_s == pytest.approx(1000e-6)
    # Union: [10, 150] + [500, 700] + [800, 920] = 140 + 200 + 120 us.
    assert s.busy_s == pytest.approx(460e-6)
    assert s.device_ops == 4
    assert s.host_syncs == 1
    assert s.group_s["K1"] == pytest.approx(100e-6)
    assert s.group_s["K2"] == pytest.approx(200e-6)
    assert s.group_s["other"] == pytest.approx(220e-6)  # the eager kernel and the copy
    # The longest idle gap, [150, 500], opens while the host is in a step.
    assert s.idle_gaps[0] == ("portbench.step", pytest.approx(350e-6))
    # Then [700, 800] in the second step, [920, 1000] in the closing
    # synchronize, [0, 10] in the first step.
    assert [(k, round(v * 1e6)) for k, v in s.idle_gaps[1:]] == [
        ("portbench.step", 100), ("portbench.sync", 80), ("portbench.step", 10)]
    b = trace.breakdown(s, top=2)
    assert [k for k, _ in b["device_ops"]] == ["void durf::wide::wide_mlp_bwd_kernel<2>", "Memcpy DtoH"]


def test_groups_copied_from_the_port():
    assert trace.group_of("void durf::obj_mlp_fwd_kernel<3, 128>(x)") == "K3"
    assert trace.group_of("void durf::wide::wide_dw_kernel<2, false>(x)") == "K2"
    assert trace.group_of("void durf::wide_dw_kernel<4, true>(x)") == "K4"
    assert trace.group_of("void durf::obj_mlp_fwd_kernel<1, 128>(x)") == "K1"
    assert trace.group_of("at::native::vectorized_elementwise_kernel") == "other"


def test_idle_and_mfu_divide_by_the_untraced_units():
    """The profiler slows the host, so the idle share and the MFU take a
    unit's time from the untraced units run before the trace."""
    from pathlib import Path

    from portbench import harness

    metrics = Path(harness.__file__).resolve().parent / "layer_metrics"
    # 4 traced steps, 0.2 s busy in all; an untraced step took 0.08 s.
    s = trace.Summary(units=4, chunks=0, window_s=0.5, busy_s=0.2, device_ops=8, host_syncs=0,
                      group_s={}, by_name={}, idle_gaps=[], work={"flops": 989e12 * 0.02},
                      untraced_unit_s=0.08)
    idle = harness.load_file(metrics / "device_idle_share.train.py").read(s)
    assert idle == pytest.approx(100.0 * (1.0 - 0.05 / 0.08))
    assert harness.load_file(metrics / "train_mfu.py").read(s) == pytest.approx(25.0)
    # Nothing ran on the device: nothing to read.
    s.busy_s = 0.0
    assert harness.load_file(metrics / "device_idle_share.train.py").read(s) is None
    assert harness.load_file(metrics / "train_mfu.py").read(s) is None
