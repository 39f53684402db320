"""The port's trajectory-render app against the JAX package's, on the CPU,
with tests/test_torch_apps.py's scene and JAX checkpoint (each file builds
its own): frames within atol 1e-4 of the JAX app's for the interp, spiral
and npz paths; the GIF decoded by PIL (frame count, 80 ms, loop 0, every
channel within the palette's half step); box poses that move the objects.

Trajectory box poses: the JAX app passes them as `init_boxes`, which a
restored model ignores (durf_tpu/render.py:83-86 against
durf_tpu/models/mipnerf.py:130), so the port's moved frames are held
against the JAX model rendering params whose pose-table row carries the
same override (atol 1e-4), and the checkpoint's table must be bitwise
intact after the call, also when a frame raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from durf_tpu import train as jtrain
from durf_tpu.configs import Config as JConfig
from durf_tpu.configs import MLPConfig as JMLP
from durf_tpu.configs import ModelConfig as JModel
from durf_tpu.data import get_dataset as j_dataset
from durf_tpu.data import load_scene as j_load_scene
from durf_tpu.models import render_image as j_render_image
from durf_tpu.parallel import make_mesh
from durf_tpu.rays import camera_rays as j_camera_rays
from durf_tpu.render import render_trajectory as j_render_trajectory
from durf_tpu_torch import render as trender
from durf_tpu_torch.checkpoints import CheckpointManager
from durf_tpu_torch.data.format import GIF_HALF_STEP
from test_torch_apps import STEP, ckpt, quiet, scene_dir  # noqa: F401 (fixtures)
from test_torch_run_training import tiny_config


def _trajectory(scene_dir, tmp_path, port_dir=None):
    """An npz of the render split's first two cameras; with `port_dir`, box
    poses for frame 0 (the checkpoint's first pose-table row) and frame 1
    (the same boxes 0.15 across in x and y: 0.75 m in the world)."""
    sc = j_load_scene(scene_dir, tiny_config(JConfig, JModel, JMLP), "render")
    data = {"poses": sc.camtoworlds[:2]}
    moved = port_dir is not None
    if moved:
        row = CheckpointManager(port_dir).restore_raw()["model"]["box_centers"][0].numpy()
        data["box_poses"] = np.stack([row, row + np.array([0.15, 0.15, 0, 0, 0, 0], np.float32)])
    path = str(tmp_path / ("moved.npz" if moved else "still.npz"))
    np.savez(path, **data)
    return path, data


@pytest.mark.parametrize("path", ["interp", "spiral", "npz"])
def test_render_trajectory_matches_jax(scene_dir, ckpt, tmp_path, path):
    jax_dir, port_dir, _, _ = ckpt
    traj = _trajectory(scene_dir, tmp_path)[0] if path == "npz" else None
    kw = dict(path="spiral" if path == "npz" else path, n_views=2, trajectory=traj,
              log_fn=quiet)
    j_frames = j_render_trajectory(tiny_config(JConfig, JModel, JMLP), scene_dir, jax_dir,
                                   str(tmp_path / "jax"), **kw)
    t_frames = trender.render_trajectory(tiny_config(), scene_dir, port_dir,
                                         str(tmp_path / "port"), device="cpu", **kw)
    assert len(t_frames) == len(j_frames) == 2
    for a, b in zip(t_frames, j_frames):
        assert a.shape == (64, 80, 3)
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names[-1] == "trajectory.gif"

    gif = Image.open(tmp_path / "port" / "trajectory.gif")
    assert gif.n_frames == 2 and gif.info["duration"] == 80 and gif.info["loop"] == 0
    for k, frame in enumerate(t_frames):
        gif.seek(k)
        err = np.abs(np.asarray(gif.convert("RGB")).astype(np.float64)
                     - (frame * 255).astype(np.uint8)).max(axis=(0, 1))
        assert np.all(err <= np.asarray(GIF_HALF_STEP)), err


@pytest.fixture
def restored_model(monkeypatch):
    """Records the model render_trajectory restores."""
    seen = []
    real = trender.restore_for_eval

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[1])
        return out

    monkeypatch.setattr(trender, "restore_for_eval", spy)
    return seen


def test_box_poses_move_the_objects(scene_dir, ckpt, tmp_path, restored_model):
    jax_dir, port_dir, j_model, params = ckpt
    traj, data = _trajectory(scene_dir, tmp_path, port_dir)
    moved = trender.render_trajectory(tiny_config(), scene_dir, port_dir, str(tmp_path / "m"),
                                      trajectory=traj, log_fn=quiet, device="cpu")
    still = trender.render_trajectory(tiny_config(), scene_dir, port_dir, str(tmp_path / "s"),
                                      trajectory=_trajectory(scene_dir, tmp_path)[0],
                                      log_fn=quiet, device="cpu")
    checkpoint = CheckpointManager(port_dir).restore_raw()["model"]["box_centers"]
    assert torch.equal(restored_model[0].box_centers.detach(), checkpoint)

    # The JAX model on params whose row 0 carries each frame's boxes.
    j_cfg = tiny_config(JConfig, JModel, JMLP)
    j_render = jtrain.make_render_fn(j_model, j_cfg, make_mesh())
    case = next(j_dataset("render", scene_dir, j_cfg))
    sc = j_load_scene(scene_dir, j_cfg, "render")
    alpha = jnp.asarray(jtrain.make_alpha_schedule(j_cfg)(STEP), jnp.float32)
    for k in range(2):
        table = np.asarray(params["box_centers"]).copy()
        table[0] = data["box_poses"][k]
        p = {**params, "box_centers": jnp.asarray(table)}
        rays = j_camera_rays(data["poses"][k], int(sc.width[0]), int(sc.height[0]),
                             float(sc.focal[0]), sc.near, sc.far, use_ndc=not j_cfg.spherify)
        out = j_render_image(
            lambda r: j_render(p, r, case["init"], case["ext"], jnp.int32(0), alpha), rays,
            chunk=j_cfg.chunk)
        np.testing.assert_allclose(moved[k], np.clip(np.asarray(out["rgb"]), 0, 1), atol=1e-4,
                                   rtol=0)
    # Frame 0's boxes are the checkpoint's row 0; frame 1's moved visibly.
    np.testing.assert_allclose(moved[0], still[0], atol=1e-6, rtol=0)
    assert np.abs(moved[1] - still[1]).max() > 0.05


def test_a_failing_frame_puts_the_pose_table_back(scene_dir, ckpt, tmp_path, restored_model,
                                                   monkeypatch):
    traj, _ = _trajectory(scene_dir, tmp_path, ckpt[1])
    calls = []

    def write_then_fail(path, image):
        calls.append(path)
        if "frame_0001" in path:
            raise OSError("disk full")

    monkeypatch.setattr(trender, "write_png", write_then_fail)
    with pytest.raises(OSError, match="disk full"):
        trender.render_trajectory(tiny_config(), scene_dir, ckpt[1], str(tmp_path / "f"),
                                  trajectory=traj, log_fn=quiet, device="cpu")
    assert any("frame_0001" in c for c in calls)
    checkpoint = CheckpointManager(ckpt[1]).restore_raw()["model"]["box_centers"]
    assert torch.equal(restored_model[0].box_centers.detach(), checkpoint)


def test_the_jax_app_ignores_box_poses(scene_dir, ckpt, tmp_path):
    """The reference fault the port does not copy: the JAX app's frames with
    a trajectory's box poses are its frames without them (ROADMAP queue 3)."""
    jax_dir, port_dir, _, _ = ckpt
    cfg = tiny_config(JConfig, JModel, JMLP)
    moved = j_render_trajectory(cfg, scene_dir, jax_dir, str(tmp_path / "m"), log_fn=quiet,
                                trajectory=_trajectory(scene_dir, tmp_path, port_dir)[0])
    still = j_render_trajectory(cfg, scene_dir, jax_dir, str(tmp_path / "s"), log_fn=quiet,
                                trajectory=_trajectory(scene_dir, tmp_path)[0])
    for a, b in zip(moved, still):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
