"""A configuration that trains the box poses, compared whole at a tiny size
on the CPU: configs/waymo_poseopt.gin's training (pose and yaw trained,
the box-surface prior at 10, noised boxes, box near/far, the BARF window
opening from 0 over 160k steps) on flagship.json's widths, in a cell that
starts at step 40000, where the window stands at alpha 2.5 of the tiny
model's 4 degrees. The cell is written to a temporary root, so the
manifest is not touched.

With the port's MLPs on their float32 plain route both sides compute the
same function, so every number is at round-off: the pose vectors' gaps
are sums of a few hundred rays' float32 terms in another order, 1e-8 or
less here; 1e-5 leaves room for another CPU's order and still lies four
orders under what the planted faults read."""

import json
import shutil

import pytest
import torch

from durf_tpu_torch import train as ptrain
from portbench import cells, compare
from portbench.modes import train as train_mode
from portbench.reference import step as ref_step
from portbench.tests import tiny

START = 40000
POSE_NUMBERS = ("pose_grad_gap", "pose_change_gap")
ROUND_OFF = 1e-5
LIMITS = {"loss_gap": 1e-3, "change_median_gap": 1e-3, **{k: 1e-3 for k in POSE_NUMBERS}}
# waymo_poseopt.gin's settings where they differ from flagship.json's.
POSEOPT = {"alpha_init": 6.0, "alpha_max_steps": 160000, "box_surface_loss_mult": 10.0,
           "pose_lr_ramp_steps": 0, "factor": 4, "spherify": True, "centering": True,
           "random_box": True, "save_every": 50000}
POSEOPT_MODEL = {"no_pose_opt": False, "no_yaw_opt": False, "use_box_nearfar": True}


def write_cell(root, name: str, model: dict, limits: dict) -> None:
    """Add configuration and cell `name` (flagship.json with POSEOPT and
    `model`; cell 1's traffic from START) to the benchmark under `root`."""
    (root / "portbench" / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "configs").mkdir(exist_ok=True)
    path = root / "BENCHMARK.json"
    m = json.loads(path.read_text()) if path.exists() else json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((cells.ROOT / "portbench" / "configs" / "flagship.json").read_text())
    conf["name"] = name
    conf["config"].update(POSEOPT)
    conf["config"]["model"].update(model)
    (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(conf))
    w = json.loads((cells.ROOT / "portbench" / "workloads" / "flagship.train-b16384.json").read_text())
    w["traffic"]["start_step"] = START
    w["limits"] = limits
    (root / "portbench" / "workloads" / f"{name}.train.json").write_text(json.dumps(w))
    m["configs"].append({"name": name, "source": "https://github.com/FelTris/durf",
                         "file": f"portbench/configs/{name}.json", "reduced": [], "why": "a test's"})
    m["workloads"].append({"name": f"{name}.train", "config": name, "traffic": "waymo_scene-from-40k",
                           "chips": 1, "why": "a test's"})
    path.write_text(json.dumps(m))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("poseroot")
    write_cell(r, "poseopt", POSEOPT_MODEL, LIMITS)
    frozen = {k: v for k, v in LIMITS.items() if k not in POSE_NUMBERS}
    write_cell(r, "posefrozen", {**POSEOPT_MODEL, "no_pose_opt": True, "no_yaw_opt": True}, frozen)
    yield r
    shutil.rmtree(r, ignore_errors=True)


@pytest.fixture(scope="module")
def trained(root):
    """The program's set-up on the pose cell: (driver, its first check
    batch and the reference's batch of the same step, the step and Adam's
    count it left), the driver released."""
    driver = train_mode.Driver(tiny.tiny_run("poseopt.train", plain=True, root=root))
    batches = driver.draw(START), driver.inputs.ref_batch(START)
    counts = driver.state.step, driver.state.optimizer.count
    driver.release()
    return driver, batches, counts


def test_the_reference_batch_holds_the_ports_instance_ids(trained):
    driver, (port, ref), _ = trained
    assert port["ts"] == ref["ts"]
    torch.testing.assert_close(ref["pixels"], port["pixels"], rtol=0, atol=0)
    torch.testing.assert_close(ref["inst"], port["inst"], rtol=0, atol=0)
    torch.testing.assert_close(ref["obj_ids"], port["obj_ids"], rtol=0, atol=0)
    pools = driver.inputs.read()["pools"]
    assert all("inst" in p for p in pools) and any(bool((p["inst"] > 0).any()) for p in pools)


def test_both_sides_start_at_the_cells_step(trained):
    driver, _, (step, count) = trained
    c = driver.inputs.c
    pc = cells.program_config(c)
    assert driver.inputs.start_step == START
    assert step == count == driver.done == START + train_mode.CHECK_STEPS
    alpha = ptrain.make_alpha_schedule(pc)(START + 1)
    assert alpha == ref_step.alpha_schedule(START + 1, c)
    assert 0.0 < alpha < c["model"]["max_deg_point"] and alpha != int(alpha)
    assert ptrain.make_lr_schedule(pc)(START + 1) == ref_step.lr_at(START + 1, c)
    assert ptrain.make_eps_schedule(pc)(START + 1) == ref_step.eps_at(START + 1, c)


def test_the_pose_is_compared_as_a_vector_at_round_off(trained):
    driver = trained[0]
    numbers = compare.train_numbers(driver.readings, driver.inputs.reference())
    for k in ("loss_gap", "grad_gap", "change_gap") + POSE_NUMBERS:
        assert numbers[k] <= ROUND_OFF, (k, numbers)


def test_a_reference_from_step_0_departs(trained):
    """The same weights and rows from step 0 instead: other draws, alpha,
    learning rate and count, and the numbers see it."""
    driver = trained[0]
    x = driver.inputs
    ref = x.reference()
    x.start_step = 0
    try:
        numbers = compare.train_numbers(driver.readings, x.reference())
    finally:
        x.start_step = START
    assert "pose_rows" in ref
    assert not compare.judge(numbers, LIMITS)[0], numbers


@pytest.mark.parametrize("fault", train_mode.FAULTS)
def test_pose_faults_fail_the_pose_numbers(trained, fault):
    x = trained[0].inputs
    numbers = compare.train_numbers(x.reference(fault=fault), x.reference())
    failed = [k for k in POSE_NUMBERS if numbers[k] > LIMITS[k]]
    assert failed, numbers
    if fault == "pose_frozen":
        # A state left unchanged: no gradient, no change.
        assert numbers["pose_grad_gap"] == numbers["pose_change_gap"] == 1.0


def test_the_pose_change_leaves_out_entries_moved_by_round_off():
    """Two rows, the second drawn twice: an entry whose first gradient is
    under POSE_MOVING of its row's largest is not compared, even where its
    change takes the other sign; one at that share is."""
    first = torch.tensor([[[1.0, -0.5, 0.02]], [[0.0, 0.0, 0.0]], [[-2.0, 0.01, 0.3]]])
    ref_change = torch.tensor([[[-1.0, 1.0, -1.0]], [[0.0, 0.0, 0.0]], [[1.0, -1.0, -1.0]]])
    prog_change = ref_change.clone()
    prog_change[2, 0, 1] = 1.0  # gradient 0.005 of the row's largest: left out
    rows = [0, 2, 2]
    keep = compare.pose_moving(first, rows)
    assert keep.tolist() == [[[True, True, True]], [[True, False, True]]]
    assert compare.vector_gap(prog_change, ref_change, rows, keep) == 0.0
    prog_change[0, 0, 2] = 1.0  # gradient 0.02 of its row's largest: compared
    assert compare.vector_gap(prog_change, ref_change, rows, keep) == pytest.approx(2 / 5**0.5)


def test_a_run_of_the_pose_cell_judges_the_pose_numbers(root):
    out = tiny.run("poseopt.train", seconds=0.2, plain=True, root=root)
    assert out["correct"], out["checks"]
    assert set(POSE_NUMBERS) <= set(out["checks"])


def test_a_frozen_pose_configuration_returns_no_pose_number(root):
    out = tiny.run("posefrozen.train", seconds=0.2, plain=True, root=root)
    assert out["correct"], out["checks"]
    assert not any(k.startswith("pose_") for k in list(out["checks"]) + list(out["_detail"])), out
