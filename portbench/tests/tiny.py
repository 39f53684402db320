"""A tiny rehearsal of a cell on the CPU: the cell's files with the widths,
samples and batch cut down, and the port and the reference in float32."""

from __future__ import annotations

import copy
import time

import torch

from portbench import cells, harness


def tiny_run(name: str, seconds: float = 0.5, traced: bool = False, seed: int = 3,
             dtype: str = "float32", plain: bool = False, root=cells.ROOT) -> harness.Run:
    """The cell at a tiny size; `plain` runs the port's MLPs on its plain
    route in `dtype` (the kernels' CPU versions round to bf16); `root`
    holds the BENCHMARK.json that names the cell."""
    cell = cells.cell(name, root)
    w, c = copy.deepcopy(cell["workload"]), copy.deepcopy(cell["config"])
    m = c["config"]["model"]
    m.update(num_samples=8, max_deg_point=4, deg_view=2, compute_dtype=dtype)
    if plain:
        m["use_pallas_mlp"] = False
    m["mlp"].update(net_depth=2, net_width=16, net_width_condition=8)
    m["box_mlp"].update(net_depth=2, net_width=8, net_width_condition=8)
    m["proposal_mlp"].update(net_depth=2, net_width=8, net_width_condition=8)
    t = w["traffic"]
    if "batch" in t:
        t["batch"] = 256
    t.update(width=320, height=224, focal=280.0)
    w["trace_units"] = 2
    w["warmup_units"] = 1
    return harness.Run(name, seed, seconds, traced, torch.device("cpu"), w, c, cell["chips"])


def run(name: str, **kw) -> dict:
    return harness.run_cell(tiny_run(name, **kw), time.time())
