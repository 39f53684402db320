"""Find a cell's files by name: BENCHMARK.json at the root of the checkout
names the cell's configuration; `workloads/<cell>.json` holds its mode and
traffic; the configuration's file holds the configuration as it is run."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """{'name', 'chips', 'workload': the workload file, 'config': the
    configuration file} of the cell `name`."""
    entry = next((w for w in manifest(root)["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest(root)["configs"] if c["name"] == entry["config"])
    return {
        "name": name,
        "chips": entry["chips"],
        "workload": _load(root / HERE.name / "workloads" / f"{name}.json"),
        "config": _load(root / conf["file"]),
    }


def run_config(conf: dict, workload: dict) -> dict:
    """The configuration dict as the cell runs it: the configuration file's
    with the workload's batch size and, for a scene, the loader settings of
    the scene's data protocol."""
    c = copy.deepcopy(conf["config"])
    t = workload["traffic"]
    if "batch" in t:
        c["batch_size"] = t["batch"]
    c.update(t.get("loader", {}))
    return c


def program_config(c: dict):
    """The port's Config object of a configuration dict."""
    from durf_tpu_torch.configs import Config, MLPConfig, ModelConfig

    d = copy.deepcopy(c)
    m = d.pop("model")
    mlps = {k: MLPConfig(**m.pop(k)) for k in ("mlp", "box_mlp", "proposal_mlp")}
    for k in ("c2f_steps", "test_indices"):
        d[k] = tuple(d[k])
    return Config(**d, model=ModelConfig(**m, **mlps))
