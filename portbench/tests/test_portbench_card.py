"""On a card: each cell runs once through the one command with a short
window and comes out correct, with its metrics. Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import cells, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", "7",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(name, "end_to_end")}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"


def test_run_refuses_without_a_card(monkeypatch, capsys):
    """Without a card a run prints no result and exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""
