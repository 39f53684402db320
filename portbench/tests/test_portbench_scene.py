"""The waymo_scene source writes what the Waymo layout states: each box's
full extents, which the port's Waymo loader halves into the boxes the
model holds. Those are the boxes the scene renders, on both the port's
reading and the reference's."""

import numpy as np
import pytest

from portbench import cells, traffic
from portbench.tests import tiny
from portbench.traffic import waymo_scene

WORLD_SCALE = 5.0  # the loader's world scale (portbench/reference/scene.py)


@pytest.fixture(scope="module")
def scene():
    run = tiny.tiny_run("flagship.train-b16384")
    s = traffic.Scene(run.workload["traffic"])
    yield s, cells.run_config(run.config, run.workload)
    s.close()


def test_the_layout_holds_full_extents(scene):
    s, _ = scene
    for obj in range(s.n_obj):
        np.testing.assert_array_equal(s.raw["boxes"][f"1_{obj + 1}_ext"], 2.0 * waymo_scene.BOX_EXTENTS[obj])


def test_both_readings_hold_the_rendered_boxes(scene):
    from durf_tpu_torch.data import get_dataset

    s, c = scene
    want = np.stack([waymo_scene.BOX_EXTENTS] * s.timesteps) / WORLD_SCALE
    np.testing.assert_allclose(s.split(c, "train")["ext"], want, rtol=1e-6)
    ds = get_dataset("train", s.directory(), cells.program_config(c))
    port = np.stack([ds.scene.boxes_for("ext", t + 1) for t in range(s.timesteps)])
    np.testing.assert_allclose(port, want, rtol=1e-6)
