"""The reference against the port's plain CPU path at a tiny size: with the
port's MLPs on its float32 plain route (no bf16 rounding) both sides
compute the same function, so every number compared is at round-off."""

import pytest

from portbench import cells, harness
from portbench.tests import tiny

CELLS = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port_in_float32(name):
    out = tiny.run(name, seconds=0.3, plain=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    for k, c in out["checks"].items():
        assert c["value"] <= 1e-5, (k, c)


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_reports_the_cells_metrics(name):
    out = tiny.run(name, seconds=0.3, traced=True, plain=True)
    wanted = {m["name"] for m in harness.metrics_of(name, "per_layer")}
    # On the CPU no device operation runs: the readers of device kernels
    # find nothing and leave their metric out.
    assert set(out["metrics"]) <= wanted
    assert out["device"]["window_s"] > 0
    assert list(out)[-2:] == ["checks", "_detail"]
