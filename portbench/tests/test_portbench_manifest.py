"""BENCHMARK.json against the contract's characters and cross-references,
and the harness finding every cell's, metric's and configuration's files by
name, a new one included."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import cells, harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def names():
    m = MANIFEST
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[group]:
            yield entry["name"]
    for w in m["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in m["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


def test_units_lines_and_keys():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for text in ([w["why"] for w in m["workloads"]] + [c["why"] for c in m["configs"]]
                 + [c["source"] for c in m["configs"]] + [p["layer"] for p in m["per_layer"]]
                 + m["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len(json.dumps(m)) <= 64 * 1024
    assert all(w["chips"] == 1 for w in m["workloads"])
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])


def test_every_file_resolves():
    m = MANIFEST
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in m["workloads"]:
        cell = cells.cell(w["name"])
        assert cell["workload"]["mode"] in ("train", "render")
        assert (ROOT / "portbench" / "modes" / f"{cell['workload']['mode']}.py").is_file()
        e2e = harness.metrics_of(w["name"], "end_to_end")
        assert "setup_s" in [x["name"] for x in e2e] and len(e2e) >= 2
        assert harness.metrics_of(w["name"], "per_layer")
    for e in m["end_to_end"]:
        assert (ROOT / "portbench" / "end_to_end" / f"{e['name']}.py").is_file()
    moved = {e["name"]: set(e.get("workloads", [w["name"] for w in m["workloads"]]))
             for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert (ROOT / "portbench" / "layer_metrics" / f"{p['name']}.py").is_file()
        # Every cell a per-layer metric lists reports the metric it moves.
        assert set(p["workloads"]) <= moved[p["moves"]], p["name"]


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "workloads").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_workload_file_is_whole(path):
    """Every file in workloads/ names a mode with a driver, a traffic source
    with a file of its own, and limits; those in the manifest resolve."""
    w = json.loads(path.read_text())
    assert NAME.match(path.stem)
    assert (ROOT / "portbench" / "modes" / f"{w['mode']}.py").is_file()
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']['source']}.py").is_file()
    assert w["limits"] and all(v > 0 for v in w["limits"].values())
    assert w["trace_units"] >= 1
    if path.stem in {x["name"] for x in MANIFEST["workloads"]}:
        assert cells.cell(path.stem)["workload"] == w


def test_a_new_workload_file_is_found_by_name(tmp_path):
    (tmp_path / "portbench" / "workloads").mkdir(parents=True)
    (tmp_path / "portbench" / "configs").mkdir()
    shutil.copy(ROOT / "portbench" / "configs" / "flagship.json", tmp_path / "portbench" / "configs")
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "flagship.train-b2048", "config": "flagship",
                           "traffic": "waymo_scene-cars-b2048", "chips": 1, "why": "a cell added as files"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    w = json.loads((ROOT / "portbench" / "workloads" / "flagship.train-b16384.json").read_text())
    w["traffic"]["batch"] = 2048
    (tmp_path / "portbench" / "workloads" / "flagship.train-b2048.json").write_text(json.dumps(w))
    cell = cells.cell("flagship.train-b2048", root=tmp_path)
    assert cell["workload"]["traffic"]["batch"] == 2048
    assert cells.run_config(cell["config"], cell["workload"])["batch_size"] == 2048
    with pytest.raises(KeyError):
        cells.cell("flagship.train-b1", root=tmp_path)


def test_a_new_traffic_source_is_found_by_name(tmp_path, monkeypatch):
    """A source added as a file of traffic/ is found by the name a workload
    gives, and its scene is written and read through the common Scene."""
    from portbench import traffic

    pkg = tmp_path / "extra_sources"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "one_box.py").write_text(
        "def generate(t):\n"
        "    return {'timesteps': t['timesteps'], 'n_obj': 1}\n"
        "def write(raw, out_dir):\n"
        "    open(out_dir + '/scene.txt', 'w').write(str(raw['timesteps']))\n"
        "def reference_split(raw, c, split):\n"
        "    return {'split': split, 'timesteps': raw['timesteps']}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(traffic, "__path__", [*traffic.__path__, str(pkg)])
    scene = traffic.Scene({"source": "one_box", "timesteps": 4})
    assert (scene.timesteps, scene.n_obj) == (4, 1)
    assert (Path(scene.directory()) / "scene.txt").read_text() == "4"
    assert scene.split({}, "train") == {"split": "train", "timesteps": 4}
    scene.close()
    assert scene.dir is None
