"""A run with its timed path broken underneath, at a tiny size on the CPU
(the harness's look for a card skipped), comes out not correct; the same
run unbroken comes out correct. One case for each fault a cell can have: a
step that returns its state unchanged; half of the batch left out, the mean
taken over the rest; an answer altered where it is produced. (One chip:
no exchange between chips to leave out.) And the control: the reference in
fp8 put in the program's place fails the cell's limits."""

import pytest

from portbench import cells, compare
from portbench.modes import render as render_mode
from portbench.modes import train as train_mode
from portbench.tests import tiny

TRAIN = [w["name"] for w in cells.manifest()["workloads"] if cells.cell(w["name"])["workload"]["mode"] == "train"]
RENDER = [w["name"] for w in cells.manifest()["workloads"] if cells.cell(w["name"])["workload"]["mode"] == "render"]


def test_sound_runs_are_correct():
    for name in TRAIN + RENDER:
        assert tiny.run(name, seconds=0.2, plain=True)["correct"], name


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, monkeypatch):
    from durf_tpu_torch import train as ptrain

    monkeypatch.setattr(ptrain.ScheduledAdam, "step", lambda self: None)
    out = tiny.run(name, seconds=0.2, plain=True)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name, monkeypatch):
    from durf_tpu_torch import train as ptrain

    real = ptrain.make_train_step

    def halved(*args, **kwargs):
        step = real(*args, **kwargs)

        def half_step(state, batch):
            n = batch["rays"].origins.shape[0] // 2
            cut = {k: v[:n] if k in ("pixels", "depth", "sky", "inst") else v for k, v in batch.items()}
            cut["rays"] = batch["rays"].map(lambda r: r[:n])
            return step(state, cut)

        return half_step

    monkeypatch.setattr(ptrain, "make_train_step", halved)
    assert not tiny.run(name, seconds=0.2, plain=True)["correct"]


@pytest.mark.parametrize("name", RENDER)
def test_an_answer_altered(name, monkeypatch):
    from durf_tpu_torch import train as ptrain

    real = ptrain.make_render_fn

    def altered(*args, **kwargs):
        render = real(*args, **kwargs)

        def chunk(*a):
            out = render(*a)
            out["rgb"] = out["rgb"].clone()
            out["rgb"][0] = 1.0 - out["rgb"][0]
            return out

        return chunk

    monkeypatch.setattr(ptrain, "make_render_fn", altered)
    assert not tiny.run(name, seconds=0.5, plain=True)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_fails(name):
    run = tiny.tiny_run(name, dtype="bfloat16")
    x = train_mode.Inputs(run)
    numbers = compare.train_numbers(x.reference(precision="fp8"), x.reference())
    assert not compare.judge(numbers, run.workload["limits"])[0], numbers


@pytest.mark.parametrize("name", RENDER)
def test_render_control_fails(name):
    run = tiny.tiny_run(name, dtype="bfloat16")
    x = render_mode.Inputs(run)
    numbers = compare.render_numbers(x.reference(0, precision="fp8"), x.reference(0))
    assert not compare.judge(numbers, run.workload["limits"])[0], numbers
