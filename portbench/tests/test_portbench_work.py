"""The work counts against hand counts at the flagship widths."""

import json
from pathlib import Path

import pytest

from portbench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["config"]["model"]


def test_mlp_macs_by_hand():
    m = model("flagship")
    # 8x256 trunk on 60 IPE features, the skip at layer 5 re-reading them,
    # density 256x1, bottleneck 256x256, head 256x128 (the 27 view
    # features once a ray), rgb 128x3.
    bg = 60 * 256 + 6 * 256 * 256 + (256 + 60) * 256 + 256 + 256 * 256 + 256 * 128 + 128 * 3
    assert bg == 588416
    assert work.mlp_macs(m["mlp"], 60, 27) == bg
    obj = 63 * 128 + 6 * 128 * 128 + (128 + 63) * 128 + 128 + 128 * 128 + 128 * 128 + 128 * 3
    assert work.mlp_macs(m["box_mlp"], 63, 27) == obj == 164096
    prop = model("waymo_fast")["proposal_mlp"]
    # 4x128 trunk: no layer re-reads the input (the skip would be layer 5).
    assert work.mlp_macs(prop, 60, 27) == 60 * 128 + 3 * 128 * 128 + 128 + 2 * 128 * 128 + 128 * 3


def test_flops_by_hand():
    m = model("flagship")
    rays, hits = 16384, [300.0, 170.0]
    fwd = 2 * (2 * 588416 * rays * 128) + 2 * (2 * 164096 * 128 * 470)
    assert work.forward_flops(m, rays, hits) == pytest.approx(fwd)
    assert work.train_flops(m, rays, hits) == pytest.approx(3 * fwd)
    # ~14.9 TFLOP a step, of which the background MLPs take nearly all.
    assert work.train_flops(m, rays, hits) == pytest.approx(14.9e12, rel=0.01)


def test_kernel_bounds_by_hand():
    m = model("flagship")
    n = 4096 * 128
    ops = 2 * 588416 * n
    bytes_k1 = 4 * 60 * n + 16 * n + 2 * (588416 + 27 * 128 + 4 * 256)
    assert work.k1_bound_s(m, 4096) == pytest.approx(2 * max(ops / 989e12, bytes_k1 / 3.35e12))
    # K2 at batch 4096: 1.248 ms a launch pair (PERF.md's bound), operations-bound.
    assert work.k2_bound_s(m, 4096) == pytest.approx(2 * 2 * ops / 989e12)
    assert work.k2_bound_s(m, 4096) * 1e3 == pytest.approx(2 * 1.248, rel=1e-3)
