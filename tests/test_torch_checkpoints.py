"""The port's checkpoint manager: the JAX manager's save / keep / latest /
force semantics, a bitwise restore of weights, Adam moments, count and
step, a resumed CPU run bitwise equal to an uninterrupted one, and a JAX
checkpoint imported by scripts/import_jax_checkpoint.py rendering a test
image as JAX does with the same weights (float32, atol 1e-4)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu import train as jtrain
from durf_tpu.checkpoints import CheckpointManager as JaxManager
from durf_tpu.configs import Config as JConfig
from durf_tpu.configs import MLPConfig as JMLP
from durf_tpu.configs import ModelConfig as JModel
from durf_tpu.data import get_dataset as j_dataset
from durf_tpu.models import construct_model as j_construct
from durf_tpu.parallel import make_mesh
from durf_tpu_torch.checkpoints import CheckpointManager
from durf_tpu_torch.data import get_dataset
from durf_tpu_torch.data.synthetic import example_ray_batch, generate_scene
from durf_tpu_torch.models import construct_model
from durf_tpu_torch.train import (
    batch_to,
    create_train_state,
    evaluate_image,
    make_optimizer,
    make_render_fn,
    make_train_step,
    run_training,
)
from test_torch_run_training import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_scene")
    generate_scene(str(d), timesteps=3, width=80, height=64, focal=70.0, factors=(4,))
    return str(d)


def _state(seed: int, steps: int = 0):
    """A tiny model's TrainState after `steps` steps on an example batch."""
    cfg = tiny_config()
    host = example_ray_batch(batch_size=32)
    model = construct_model(cfg.model, host, "cpu", seed=seed)
    opt = make_optimizer(cfg, model)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(model, cfg, opt)
    batch = batch_to(host, "cpu")
    for _ in range(steps):
        state, _ = step(state, batch)
    return state, step, batch


def _jax_state(v: float):
    return {"params": {"w": jnp.full((4, 4), v)}, "step": jnp.asarray(int(v))}


def _steps_on_disk(d):
    steps = [int(n) for n in os.listdir(d) if n.isdigit()]
    steps += [int(n[len("checkpoint_"):-3]) for n in os.listdir(d) if n.startswith("checkpoint_")]
    return sorted(steps)


@pytest.mark.parametrize(
    "ops",
    [
        [(1, False), (2, False), (3, False), (4, False)],  # keep prunes the oldest
        [(5, False), (3, False), (5, False), (6, False)],  # steps <= latest are skipped
        [(5, False), (3, True)],  # force saves off-schedule
        [(5, False), (5, True)],  # an existing step raises, forced or not
    ],
)
def test_manager_semantics_match_jax(tmp_path, ops):
    j = JaxManager(str(tmp_path / "jax"), keep=2, async_save=False)
    t = CheckpointManager(str(tmp_path / "port"), keep=2)
    state, _, _ = _state(0)
    assert j.latest_step is None and t.latest_step is None
    for step, force in ops:
        outcome = []
        for save in (lambda: j.save(step, _jax_state(step), force=force),
                     lambda: t.save(step, state, force=force)):
            try:
                save()
                outcome.append("ok")
            except Exception:  # noqa: BLE001 -- orbax and the port raise different types
                outcome.append("raised")
        assert outcome[0] == outcome[1], (step, force)
        assert _steps_on_disk(tmp_path / "jax") == _steps_on_disk(tmp_path / "port")
    if not ops[-1][1]:
        assert j.latest_step == t.latest_step
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "port"))
    j.close()


def test_restore_without_checkpoint_returns_the_state(tmp_path):
    t = CheckpointManager(str(tmp_path))
    state, _, _ = _state(0)
    assert t.restore(state) is state and state.step == 0
    with pytest.raises(FileNotFoundError):
        t.restore_raw()
    j = JaxManager(str(tmp_path / "jax"), async_save=False)
    with pytest.raises(FileNotFoundError):
        j.restore_raw()
    j.close()


def test_restore_is_bitwise(tmp_path):
    saved, step_a, batch = _state(0, steps=3)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    assert mgr.save(3, saved)
    raw = mgr.restore_raw()
    assert raw["step"] == 3 and raw["count"] == 3
    assert all(v.device.type == "cpu" for v in raw["model"].values())

    fresh, step_b, _ = _state(1)
    assert not torch.equal(fresh.model.box_centers, saved.model.box_centers) or not all(
        torch.equal(a, b) for a, b in zip(fresh.model.parameters(), saved.model.parameters()))
    restored = mgr.restore(fresh)
    assert restored is fresh and fresh.step == 3 and fresh.optimizer.count == 3
    for (k, a), b in zip(saved.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = saved.optimizer.opt.state_dict(), fresh.optimizer.opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, moments in sa["state"].items():
        for k, v in moments.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    # The next step from either is the same step.
    saved, stats_a = step_a(saved, batch)
    fresh, stats_b = step_b(fresh, batch)
    assert torch.equal(stats_a["train/loss"], stats_b["train/loss"])
    for a, b in zip(saved.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_resumed_run_is_bitwise_an_uninterrupted_one(scene_dir, tmp_path):
    """16 steps, then a resume to 24, against 24 steps in one run (device-
    resident batches on the CPU: each step's draws depend only on it)."""
    whole = run_training(tiny_config(), scene_dir, str(tmp_path / "whole"), device="cpu")
    parts = str(tmp_path / "parts")
    first = run_training(tiny_config(), scene_dir, parts, max_steps=16, device="cpu")
    assert first.step == 16 and CheckpointManager(parts).latest_step == 16
    logs = []
    second = run_training(tiny_config(), scene_dir, parts, device="cpu", log_fn=logs.append)
    assert any("resumed from the checkpoint of step 16" in line for line in logs)
    assert whole.step == second.step == 24
    assert whole.optimizer.count == second.optimizer.count == 24
    for (k, a), b in zip(whole.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = whole.optimizer.opt.state_dict()["state"], second.optimizer.opt.state_dict()["state"]
    assert all(torch.equal(v, sb[i][k]) for i, m in sa.items() for k, v in m.items())
    assert CheckpointManager(parts).all_steps() == [16, 24]


def _load_importer():
    spec = importlib.util.spec_from_file_location(
        "import_jax_checkpoint", os.path.join(REPO, "scripts", "import_jax_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_imported_jax_checkpoint_renders_like_jax(scene_dir, tmp_path):
    j_cfg = tiny_config(JConfig, JModel, JMLP)
    t_cfg = tiny_config()
    j_train = j_dataset("train", scene_dir, j_cfg)
    model, variables = j_construct(jax.random.key(3), j_train.peek(), j_cfg.model)
    tx = jtrain.make_optimizer(j_cfg)
    state = jtrain.create_train_state(j_cfg, variables, tx).replace(step=jnp.asarray(7, jnp.int32))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    mgr = JaxManager(jax_dir, async_save=False)
    mgr.save(7, state)
    mgr.wait()
    mgr.close()

    assert _load_importer().main(["--jax_dir", jax_dir, "--out_dir", port_dir]) == 0
    raw = CheckpointManager(port_dir).restore_raw()
    assert raw["step"] == 7 and raw["count"] == 7 and raw["optimizer"] is None

    t_train = get_dataset("train", scene_dir, t_cfg)
    t_model = construct_model(t_cfg.model, t_train.peek(), "cpu", seed=0)
    opt = make_optimizer(t_cfg, t_model)
    t_state = CheckpointManager(port_dir).restore(create_train_state(t_cfg, t_model, opt))
    assert t_state.step == 7 and opt.count == 7 and not opt.opt.state
    np.testing.assert_array_equal(t_model.box_centers.detach().numpy(),
                                  np.asarray(variables["params"]["box_centers"]))

    test_case = next(j_dataset("test", scene_dir, j_cfg))
    alpha = float(jtrain.make_alpha_schedule(j_cfg)(8))
    j_render = jtrain.make_render_fn(model, j_cfg, make_mesh())
    j_out = jtrain.evaluate_image(j_render, variables["params"], test_case, alpha, chunk=64)
    t_case = next(get_dataset("test", scene_dir, t_cfg))  # the same arrays, port Rays
    t_out = evaluate_image(make_render_fn(t_model, t_cfg, "cpu"), t_case, alpha, chunk=64)
    assert t_out["rgb"].shape == (16, 20, 3)
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(t_out[k], np.asarray(j_out[k]), atol=1e-4, rtol=0, err_msg=k)
