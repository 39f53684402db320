"""The port's benchmark, bench.py, and the launch checks of its CLIs, on the
CPU: `python -m durf_tpu_torch.bench --device cpu` on the tiny flagship
prints bench.py's JSON line (its four keys, a positive rate, the rate per
rank the global rate over the world size), without --device cpu it needs
a card, and a torchrun launch (WORLD_SIZE > 1) of the training, eval or
render CLI without --multihost is refused. The bench's rate over two
ranks: tests/test_torch_parallel.py."""

import functools
import json

import pytest
import torch

from durf_tpu_torch import bench, entry
from durf_tpu_torch import eval as app_eval
from durf_tpu_torch import render as app_render
from durf_tpu_torch import train as ttrain


@pytest.fixture
def tiny_flagship(monkeypatch):
    monkeypatch.setattr(entry, "flagship_config", functools.partial(entry.flagship_config,
                                                                    tiny=True))


def test_bench_prints_its_json_line_on_cpu(tiny_flagship, capsys):
    result = bench.main(["--device", "cpu", "--batch_size", "64", "--steps", "2",
                         "--warmup", "1", "--obj_capacity", "0.0625"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "train_ray_samples_per_sec_per_chip"
    assert line["unit"] == "ray-samples/s/chip" and line["value"] > 0
    assert result["world"] == 1 and line["value"] == pytest.approx(result["total"], abs=0.05)
    assert line["vs_baseline"] == pytest.approx(line["value"] / 5e6, abs=1e-3)


def test_bench_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--steps", "1"])


@pytest.mark.parametrize("app", [ttrain, app_eval, app_render], ids=["train", "eval", "render"])
def test_world_size_without_multihost_raises(monkeypatch, app):
    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = ["--data_dir", "D", "--train_dir", "T", "--device", "cpu"]
    if app is app_render:
        argv += ["--out_dir", "O"]
    with pytest.raises(ValueError, match="WORLD_SIZE=2 .* --multihost is not"):
        app.main(argv)
