"""The port's training loop and CLI on a synthetic scene directory, on the
CPU, at tests/test_train.py's tiny config: the loss falls, metrics.jsonl
holds the JAX loop's keys, the sample-weight bars and eval images are
written, the CLI parses (and trains from a gin file), --multihost outside
torchrun raises;
one step on the scene's first host batch with weights bridged from JAX
gives JAX's loss (float32, randomized=False, rtol 1e-5); compute_ssim and
vis equal JAX's."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from durf_tpu import mathx as jmathx
from durf_tpu import train as jtrain
from durf_tpu import vis as jvis
from durf_tpu.configs import Config as JConfig
from durf_tpu.configs import MLPConfig as JMLP
from durf_tpu.configs import ModelConfig as JModel
from durf_tpu.data import get_dataset as j_dataset
from durf_tpu.models import construct_model as j_construct
from durf_tpu_torch import mathx, metrics, vis
from durf_tpu_torch import train as ttrain
from durf_tpu_torch.configs import Config, MLPConfig, ModelConfig
from durf_tpu_torch.data import get_dataset
from durf_tpu_torch.data.format import read_png
from durf_tpu_torch.data.synthetic import generate_scene
from durf_tpu_torch.models import MipNerf
from durf_tpu_torch.params import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_config(cls=Config, model_cls=ModelConfig, mlp_cls=MLPConfig, **kw):
    """tests/test_train.py's tiny training config, for either package."""
    cfg = cls(
        dataset_loader="carla_dyn", batching="timestep", batch_size=32, factor=4, spherify=True,
        centering=True, near=0.0, far=30.0, timesteps=3, max_steps=24, print_every=8,
        save_every=16, render_every=0, chunk=64, lr_init=5e-3, lr_final=5e-4,
        lr_delay_steps=0, grad_max_norm=1.0, grad_max_val=0.1, rand_bkgd=False, randomized=True,
        model=model_cls(
            num_samples=8, num_levels=2, max_deg_point=4, deg_view=2, num_objects=2,
            timesteps=3, density_noise=0.0, no_pose_opt=True, no_yaw_opt=True,
            mlp=mlp_cls(net_depth=2, net_width=16, net_width_condition=8),
            box_mlp=mlp_cls(net_depth=2, net_width=8, net_width_condition=8),
        ),
    )
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("run_scene")
    generate_scene(str(d), timesteps=3, width=80, height=64, focal=70.0, factors=(4,))
    return str(d)


@pytest.fixture(scope="module")
def run(scene_dir, tmp_path_factory):
    """One 24-step run logging every 8 steps and rendering every 12."""
    train_dir = str(tmp_path_factory.mktemp("run"))
    logs = []
    state = ttrain.run_training(tiny_config(render_every=12), scene_dir, train_dir,
                                log_fn=logs.append, device="cpu")
    lines = [json.loads(line) for line in open(os.path.join(train_dir, "metrics.jsonl"))]
    return state, train_dir, logs, lines


@pytest.fixture(scope="module")
def jax_step(scene_dir):
    """JAX's first step on the scene's first host batch (float32,
    randomized=False): (weights, stats)."""
    cfg = tiny_config(JConfig, JModel, JMLP, randomized=False)
    batch = j_dataset("train", scene_dir, cfg).peek()
    model, variables = j_construct(jax.random.key(0), batch, cfg.model)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.create_train_state(cfg, variables, tx)
    step = jax.jit(jtrain.make_train_step(model, cfg, tx, jax.random.key(1)))
    _, stats = step(state, batch)
    tree = jax.tree.map(np.asarray, variables["params"])
    return tree, {k: np.asarray(v) for k, v in stats.items()}


def test_training_runs_and_loss_falls(run):
    state, _, logs, _ = run
    assert state.step == 24 and state.optimizer.count == 24
    losses = [float(line.split("loss=")[1].split(" ")[0]) for line in logs if "loss=" in line]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert any(line.startswith("params being optimized") for line in logs)
    assert any(line.startswith("device-resident data") for line in logs)


def test_metrics_hold_the_jax_loops_keys(run, jax_step):
    _, _, _, lines = run
    _, j_stats = jax_step
    expect = {k for k in j_stats if not k.startswith("viz/")}
    expect |= {"perf/steps_per_sec", "perf/rays_per_sec", "perf/ray_samples_per_sec"}
    expect |= {"test/psnr", "test/ssim", "test/rays_per_sec"}
    got = set().union(*lines) - {"step"}
    assert got == expect
    assert [line["step"] for line in lines] == [8, 12, 16, 24, 24]
    evals = [line for line in lines if "test/psnr" in line]
    assert len(evals) == 2 and all(np.isfinite(e["test/psnr"]) and e["test/psnr"] > 5 for e in evals)
    assert all(0.0 < e["test/ssim"] <= 1.0 for e in evals)


def test_viz_bars_and_eval_images_are_written(run):
    _, train_dir, _, _ = run
    images = os.path.join(train_dir, "images")
    for step in (8, 16, 24):
        bars = read_png(os.path.join(images, f"train_nerf_weights_{step}.png"))
        assert bars.shape == (160, 480, 3) and bars.min() < 255  # some bar drawn
    for tag in ("pred_rgb", "target_rgb", "depth", "depth_mod", "depth_normals"):
        for step in (12, 24):
            assert read_png(os.path.join(images, f"test_{tag}_{step}.png")).shape == (16, 20, 3)
    assert sorted(n for n in os.listdir(train_dir) if n.endswith(".pt")) == [
        "checkpoint_16.pt", "checkpoint_24.pt"]


def test_host_prefetch_path(scene_dir, tmp_path):
    logs = []
    state = ttrain.run_training(
        tiny_config(max_steps=8, print_every=4, save_every=100, device_resident_data=False),
        scene_dir, str(tmp_path / "host"), log_fn=logs.append, device="cpu")
    assert state.step == 8
    assert not any("device-resident" in line for line in logs)
    assert os.path.exists(tmp_path / "host" / "checkpoint_8.pt")  # the final forced save


def test_main_parses_the_cli(monkeypatch, tmp_path):
    seen = {}

    def fake_run(config, data_dir, train_dir, max_steps=None, log_fn=print, device="cuda",
                 group=None):
        seen.update(config=config, data_dir=data_dir, train_dir=train_dir,
                    max_steps=max_steps, device=device, group=group)
        return "state"

    monkeypatch.setattr(ttrain, "run_training", fake_run)
    prof = str(tmp_path / "prof")
    out = ttrain.main([
        "--data_dir", "D", "--train_dir", "T",
        "--gin_file", os.path.join(REPO, "configs", "waymo_fast.gin"),
        "--gin_param", "Config.max_steps = 7", "--gin_param", "Config.print_every = 2",
        "--chunk", "128", "--render_every", "3", "--max_steps", "5", "--device", "cpu",
        "--profile_dir", prof,
    ])
    assert out == "state"
    cfg = seen["config"]
    assert (seen["data_dir"], seen["train_dir"], seen["max_steps"], seen["device"]) == (
        "D", "T", 5, "cpu")
    assert (seen["group"].rank, seen["group"].size) == (0, 1)  # one process without --multihost
    assert (cfg.dataset_loader, cfg.batch_size, cfg.max_steps, cfg.print_every) == (
        "waymo", 512, 7, 2)
    assert (cfg.chunk, cfg.render_every, cfg.random_box) == (128, 3, True)
    m = cfg.model
    assert m.use_proposal and m.use_box_nearfar and m.obj_ray_capacity == -1
    assert os.path.exists(os.path.join(prof, "trace.json"))


def test_main_trains_from_a_gin_file(scene_dir, tmp_path):
    """The CLI end to end on the CPU, with proposal levels, use_box_nearfar
    and auto-sized compaction from the gin file."""
    gin = tmp_path / "tiny.gin"
    cfg = tiny_config()
    lines = [
        f"Config.{k} = {getattr(cfg, k)!r}"
        for k in ("dataset_loader", "batching", "batch_size", "factor", "spherify", "centering",
                  "near", "far", "timesteps", "lr_delay_steps", "rand_bkgd", "random_box")
    ]
    lines += [
        "MipNerfModel.num_samples = 8", "MipNerfModel.max_deg_point = 4",
        "MipNerfModel.deg_view = 2", "MipNerfModel.timesteps = 3",
        "MipNerfModel.use_proposal = True", "MipNerfModel.use_box_nearfar = True",
        "MipNerfModel.obj_ray_capacity = -1",
        "MLP.net_depth = 2", "MLP.net_width = 16", "MLP.net_width_condition = 8",
        "BoxMLP.net_depth = 2", "BoxMLP.net_width = 8", "BoxMLP.net_width_condition = 8",
        "ProposalMLP.net_depth = 2", "ProposalMLP.net_width = 8",
        "ProposalMLP.net_width_condition = 8",
    ]
    gin.write_text("\n".join(lines) + "\n")
    train_dir = str(tmp_path / "cli")
    state = ttrain.main([
        "--data_dir", scene_dir, "--train_dir", train_dir, "--gin_file", str(gin),
        "--gin_param", "Config.print_every = 3", "--gin_param", "Config.save_every = 3",
        "--gin_param", "Config.checkpoint_keep = 1",
        "--render_every", "6", "--chunk", "64", "--max_steps", "6", "--device", "cpu",
    ])
    assert state.step == 6 and state.config.model.use_proposal
    assert 0.0 < state.config.model.obj_ray_capacity <= 1.0  # sized from the scene
    lines = [json.loads(line) for line in open(os.path.join(train_dir, "metrics.jsonl"))]
    assert {"loss/interlevel", "obj/hit_frac", "obj/overflow_rays", "test/psnr"} <= set().union(
        *lines)
    assert all(np.isfinite(v) for line in lines for v in line.values())
    assert [n for n in os.listdir(train_dir) if n.endswith(".pt")] == ["checkpoint_6.pt"]


def test_multihost_raises(monkeypatch):
    """--multihost outside a torchrun launch has no group to join (the
    data-parallel runs: tests/test_torch_parallel.py)."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node N"):
        ttrain.main(["--data_dir", "D", "--train_dir", "T", "--multihost", "--device", "cpu"])


def test_first_step_matches_jax(scene_dir, jax_step):
    tree, j_stats = jax_step
    cfg = tiny_config(randomized=False)
    batch = get_dataset("train", scene_dir, cfg).peek()
    init = batch["init"]
    model = MipNerf(cfg.model, init.shape[1], init.shape[0])
    model.load_state_dict(params_from_flax(tree))
    opt = ttrain.make_optimizer(cfg, model)
    step = ttrain.make_train_step(model, cfg, opt)
    _, stats = step(ttrain.create_train_state(cfg, model, opt), ttrain.batch_to(batch, "cpu"))
    assert set(stats) == set(j_stats)
    np.testing.assert_allclose(float(stats["train/loss"]), j_stats["train/loss"], rtol=1e-5)
    for k in ("train/psnr", "loss/rgb_1", "loss/depth_1", "loss/sky_1", "obj/hit_frac"):
        np.testing.assert_allclose(float(stats[k]), j_stats[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("shape", [(16, 20, 3), (2, 24, 18, 3)])
def test_compute_ssim_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=shape), 0, 1).astype(np.float32)
    j = np.asarray(jmathx.compute_ssim(a, b, max_val=1.0))
    t = mathx.compute_ssim(torch.from_numpy(a), torch.from_numpy(b), max_val=1.0).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
    jm = np.asarray(jmathx.compute_ssim(a, b, max_val=1.0, return_map=True))
    tm = mathx.compute_ssim(torch.from_numpy(a), torch.from_numpy(b), 1.0, return_map=True)
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-5, rtol=0)


def test_vis_matches_jax():
    rng = np.random.default_rng(0)
    t_vals = [np.sort(rng.uniform(0, 5, 9)) for _ in range(2)]
    weights = [rng.uniform(size=8) for _ in range(2)]
    assert np.array_equal(vis.render_weight_bars(t_vals, weights),
                          jvis.render_weight_bars(t_vals, weights))
    depth = rng.uniform(0.5, 9, (12, 10))
    depth[0, :3] = 0.0
    acc = rng.uniform(size=(12, 10))
    j, t = jvis.visualize_suite(depth, acc), vis.visualize_suite(depth, acc)
    assert sorted(j) == sorted(t)
    for k in j:
        assert np.array_equal(j[k], t[k]), k


def test_throughput_and_trace(tmp_path):
    meter = metrics.Throughput(batch_size=512, samples_per_ray=256)
    meter.tick(3)
    report = meter.report()
    assert report["perf/rays_per_sec"] == pytest.approx(512 * report["perf/steps_per_sec"])
    assert report["perf/ray_samples_per_sec"] == pytest.approx(256 * report["perf/rays_per_sec"])
    assert meter.report()["perf/steps_per_sec"] == 0.0  # the window restarts
    with metrics.span("durf.off"):  # no profiler records yet
        metrics.count("test.off", 1)
    profiler = metrics.start_profiler(str(tmp_path))
    with metrics.span("durf.step"):
        torch.ones(4).sum()
        metrics.count("test.on", 2)
        metrics.count("test.on", torch.ones(3))
    trace = json.load(open(metrics.stop_profiler(profiler, str(tmp_path))))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "durf.step" in names and "durf.off" not in names
    assert json.load(open(tmp_path / "counters.json")) == {"test.on": 5.0}
    assert metrics.counters() == {}  # stop_profiler read and cleared them
