"""The occupancy grid (durf_tpu_torch/ops/grid.py) against the JAX package's
durf_tpu/ops/grid.py, and the grid through the model, the training step,
checkpoints and the apps.

  * make_grid, the voxel indices, query and update: bitwise equal to JAX
    on the same inputs (update is a max, exact in any order);
  * ray_pdf: atol 1e-6 on bins and weights;
  * the model's grid-sampled level 0 (randomized, JAX's jitter handed in)
    and both levels' outputs, positions_c and grid_weights against JAX's on
    the same weights: float32 atol 1e-4 (depth and t_vals plus rtol 1e-5);
  * one training step with a grid against JAX's step: loss rtol 1e-5,
    every gradient leaf within relative L2 1e-4, the step's positions and
    weights as above, and the updated grid bitwise equal to JAX's update of
    the same grid with the port's positions and weights (a one-ulp
    difference in a position may move a sample across a voxel face, so the
    two steps' whole grids are not compared);
  * a checkpoint round trip with a grid, a JAX grid checkpoint imported by
    scripts/import_jax_checkpoint.py, and the eval, render and pose-eval
    apps on a grid run's checkpoint.
"""

import copy
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from durf_tpu import losses as jlosses
from durf_tpu import train as jtrain
from durf_tpu.checkpoints import CheckpointManager as JaxManager
from durf_tpu.data.synthetic import example_ray_batch as j_batch
from durf_tpu.models import construct_model as j_construct
from durf_tpu.ops import contract as j_contract
from durf_tpu.ops import grid as jgrid
from durf_tpu_torch import mathx as tmathx
from durf_tpu_torch import pose_eval as tpose
from durf_tpu_torch import render as trender
from durf_tpu_torch.checkpoints import CheckpointManager
from durf_tpu_torch.data.synthetic import example_ray_batch as t_batch
from durf_tpu_torch.data.synthetic import generate_scene
from durf_tpu_torch.entry import flagship_config
from durf_tpu_torch.eval import evaluate
from durf_tpu_torch.models import MipNerf, construct_model
from durf_tpu_torch.ops import contract as t_contract
from durf_tpu_torch.ops import grid as tgrid
from durf_tpu_torch.params import params_from_flax, params_to_flax
from durf_tpu_torch.train import (
    batch_to,
    create_train_state,
    make_grad_fn,
    make_optimizer,
    make_train_step,
    run_training,
)
from test_torch_run_training import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
B = 32
F32_EPS = float(np.finfo(np.float32).eps)


def _grid(seed=0, res=RES):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=(res, res, res)).astype(np.float32)


def _positions(shape=(40, 12), seed=1):
    """Contracted positions over and past [-2, 2]^3, with exact voxel faces
    and many samples per voxel."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2.3, 2.3, size=shape + (3,)).astype(np.float32)
    p[0, :4] = [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0], [0.0, 0.25, -0.25], [1.75, -1.0, 0.5]]
    p[1] = p[0, 3]  # one voxel hit twelve times
    return p


# ---- ops/grid.py ----


def test_make_grid_and_voxel_indices_match_jax():
    np.testing.assert_array_equal(tgrid.make_grid(RES).numpy(), np.asarray(jgrid.make_grid(RES)))
    assert tgrid.GRID_EXTENT == jgrid.GRID_EXTENT == 2.0
    p = _positions()
    np.testing.assert_array_equal(tgrid._voxel_indices(torch.from_numpy(p), RES).numpy(),
                                  np.asarray(jgrid._voxel_indices(jnp.asarray(p), RES)))


def test_query_matches_jax_bitwise():
    g, p = _grid(), _positions()
    t = tgrid.query(torch.from_numpy(g), torch.from_numpy(p))
    assert t.shape == p.shape[:-1]
    np.testing.assert_array_equal(t.numpy(), np.asarray(jgrid.query(jnp.asarray(g), jnp.asarray(p))))


@pytest.mark.parametrize("decay", [0.99, 0.995])
def test_update_matches_jax_bitwise(decay):
    g, p = _grid(2), _positions(seed=3)
    w = np.random.default_rng(4).uniform(0.0, 1.0, size=p.shape[:-1]).astype(np.float32)
    w[2] = 0.0  # zero evidence leaves the decayed grid
    t_in = torch.from_numpy(g)
    t = tgrid.update(t_in, torch.from_numpy(p), torch.from_numpy(w), decay)
    j = jgrid.update(jnp.asarray(g), jnp.asarray(p), jnp.asarray(w), decay)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert torch.equal(t_in, torch.from_numpy(g))  # a new tensor; the input is kept
    assert not torch.equal(t, t_in * decay)


def test_update_takes_no_gradient():
    p = torch.from_numpy(_positions()).requires_grad_(True)
    w = torch.ones(p.shape[:-1], requires_grad=True)
    assert not tgrid.update(torch.ones((RES,) * 3), p, w).requires_grad


def test_ray_pdf_matches_jax():
    rng = np.random.default_rng(5)
    origins = rng.normal(0.0, 0.5, size=(6, 3)).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    near, far = np.full((6, 1), 0.1, np.float32), np.full((6, 1), 3.0, np.float32)
    g = _grid(6)
    j = jgrid.ray_pdf(jnp.asarray(g), *(jnp.asarray(a) for a in (origins, dirs, near, far)), 24,
                      functools.partial(j_contract, threshold=0.1), 0.02)
    t = tgrid.ray_pdf(torch.from_numpy(g), *(torch.from_numpy(a) for a in (origins, dirs, near, far)),
                      24, functools.partial(t_contract, threshold=0.1), 0.02)
    for tv, jv in zip(t, j):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0.0)


# ---- the model's grid-sampled level 0 ----


def _configs(**model_kw):
    jcfg, tcfg = _flagship_config(tiny=True), flagship_config(tiny=True)
    for cfg in (jcfg, tcfg):
        cfg.model.grid_sampling = True
        cfg.model.grid_resolution = RES
        for k, v in model_kw.items():
            setattr(cfg.model, k, v)
    return jcfg, tcfg


def _jax_jitter(rng, n_levels, batch, n_samples):
    """The uniform draws of JAX's inverse-CDF sampler on each level: the
    model splits one level key off its rng per level
    (durf_tpu/models/mipnerf.py:212-213)."""
    draws = []
    for _ in range(n_levels):
        key, rng = jax.random.split(rng)
        s = 1.0 / (n_samples + 1)
        draws.append(np.asarray(jax.random.uniform(key, (batch, n_samples + 1), maxval=s - F32_EPS)))
    return draws


@pytest.fixture
def handed_jitter(monkeypatch):
    """Make the port's inverse-CDF sampler take the given draws in order."""
    queue = []
    real = tmathx.sorted_piecewise_constant_pdf

    def sampler(bins, weights, num_samples, randomized=False, generator=None, jitter=None):
        return real(bins, weights, num_samples, randomized, generator,
                    torch.from_numpy(np.array(queue.pop(0))) if randomized else jitter)

    monkeypatch.setattr(tmathx, "sorted_piecewise_constant_pdf", sampler)
    return queue


@pytest.mark.parametrize("coord_major", [True, False])
def test_grid_levels_match_jax(handed_jitter, coord_major):
    jcfg, tcfg = _configs(coord_major=coord_major)
    jb, tb = j_batch(batch_size=B), t_batch(batch_size=B)
    model, variables = j_construct(jax.random.key(0), jb, jcfg.model)
    g = _grid(7)
    rng = jax.random.key(9)
    j_out = model.apply(variables, rng=rng, rays=jb["rays"], init_boxes=jb["init"], ext=jb["ext"],
                        ts=jb["ts"], randomized=True, background="gray", alpha=10.0,
                        grid=jnp.asarray(g))
    handed_jitter.extend(_jax_jitter(rng, 2, B, tcfg.model.num_samples))
    t_model = MipNerf(tcfg.model, tb["init"].shape[1], tb["init"].shape[0])
    t_model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables["params"])))
    with torch.no_grad():
        t_out = t_model(tb["rays"].to("cpu"), ext=torch.from_numpy(tb["ext"]), ts=int(tb["ts"]),
                        alpha=10.0, randomized=True, grid=torch.from_numpy(g))
    assert not handed_jitter  # both levels drew
    for level in (0, 1):
        for key in ("rgb", "acc", "weights", "positions_c", "grid_weights", "depth", "t_vals"):
            tol = dict(atol=1e-4, rtol=1e-5 if key in ("depth", "t_vals") else 0.0)
            np.testing.assert_allclose(t_out[level][key].numpy(), np.asarray(j_out[level][key]),
                                       err_msg=f"level {level} {key}", **tol)
    # Box-hitting rays are no evidence for the world-frame grid.
    hit = t_out[-1]["dyn_mask"][:, 0] > 0
    assert bool(hit.any()) and float(t_out[-1]["grid_weights"][hit].abs().sum()) == 0.0
    assert t_out[0]["positions_c"].shape == (B, tcfg.model.num_samples, 3)


# ---- one training step ----


@functools.lru_cache(maxsize=None)
def _steps():
    jcfg, tcfg = _configs()
    for cfg in (jcfg, tcfg):
        cfg.randomized = False
        cfg.batch_size = B
    jb, tb = j_batch(batch_size=B), t_batch(batch_size=B)
    g0 = _grid(8)

    model, variables = j_construct(jax.random.key(0), jb, jcfg.model)
    tx = jtrain.make_optimizer(jcfg)
    state = jtrain.create_train_state(jcfg, variables, tx).replace(grid=jnp.asarray(g0))
    new_state, j_stats = jax.jit(jtrain.make_train_step(model, jcfg, tx, jax.random.key(1)))(
        state, jb)
    eps, alpha = jtrain.make_eps_schedule(jcfg)(1), jtrain.make_alpha_schedule(jcfg)(1)

    def apply(params):
        return model.apply({"params": params}, rng=jax.random.key(1), rays=jb["rays"],
                           init_boxes=jb["init"], ext=jb["ext"], ts=jb["ts"], randomized=False,
                           background=jcfg.background, alpha=alpha, grid=jnp.asarray(g0))

    def loss_fn(params):  # the loss of durf_tpu/train.py:202-236 at step 0
        ts = int(jb["ts"])
        prev = jax.lax.stop_gradient(params["box_centers"])[ts + 1 if ts == 0 else ts - 1]
        return jlosses.compute_losses(jcfg, apply(params), jb, prev, eps)[0]

    j_grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"]))
    j_last = apply(variables["params"])[-1]

    t_model = MipNerf(tcfg.model, tb["init"].shape[1], tb["init"].shape[0])
    t_model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables["params"])))
    batch = batch_to(tb, "cpu")
    _, t_aux, t_grads = make_grad_fn(copy.deepcopy(t_model), tcfg)(0, batch, torch.from_numpy(g0))
    opt = make_optimizer(tcfg, t_model)
    t_state = create_train_state(tcfg, t_model, opt)
    assert torch.equal(t_state.grid, torch.ones((RES,) * 3))
    t_state.grid = torch.from_numpy(g0.copy())
    t_state, t_stats = make_train_step(t_model, tcfg, opt)(t_state, batch)
    return dict(g0=g0, j_loss=float(j_stats["train/loss"]), j_grads=j_grads,
                j_positions=np.asarray(j_last["positions_c"]),
                j_weights=np.asarray(j_last["grid_weights"]),
                j_grid=np.asarray(new_state.grid), t_loss=float(t_stats["train/loss"]),
                t_grads=params_to_flax(t_grads), t_aux=t_aux, t_grid=t_state.grid,
                decay=tcfg.model.grid_decay)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_grid_step_loss_and_gradients_match_jax():
    s = _steps()
    np.testing.assert_allclose(s["t_loss"], s["j_loss"], rtol=1e-5)
    j_flat, t_flat = dict(_leaves(s["j_grads"])), dict(_leaves(s["t_grads"]))
    assert set(j_flat) == set(t_flat)
    for name, jg in j_flat.items():
        den = np.linalg.norm(jg)
        rel = np.linalg.norm(t_flat[name] - jg) / den if den > 0 else np.linalg.norm(t_flat[name])
        assert rel <= 1e-4, f"{name}: relative L2 {rel}"


def test_grid_step_updates_the_grid_as_jax_does():
    s = _steps()
    positions, weights = s["t_aux"]["grid_positions"], s["t_aux"]["grid_weights"]
    np.testing.assert_allclose(positions.numpy(), s["j_positions"], atol=1e-4, rtol=0.0)
    np.testing.assert_allclose(weights.numpy(), s["j_weights"], atol=1e-4, rtol=0.0)
    j_update = jgrid.update(jnp.asarray(s["g0"]), jnp.asarray(positions.numpy()),
                            jnp.asarray(weights.numpy()), s["decay"])
    np.testing.assert_array_equal(s["t_grid"].numpy(), np.asarray(j_update))
    assert s["t_grid"].shape == s["j_grid"].shape == (RES,) * 3
    assert float(s["t_grid"].min()) >= 0.0 and float(s["t_grid"].max()) <= 1.0


# ---- checkpoints and the apps ----


def _grid_state(steps=2):
    cfg = tiny_config()
    cfg.model.grid_sampling, cfg.model.grid_resolution = True, RES
    host = t_batch(batch_size=B)
    model = construct_model(cfg.model, host, "cpu", seed=0)
    opt = make_optimizer(cfg, model)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(model, cfg, opt)
    for _ in range(steps):
        state, _ = step(state, batch_to(host, "cpu"))
    return cfg, state


def test_checkpoint_round_trip_keeps_the_grid(tmp_path):
    cfg, state = _grid_state()
    assert not torch.equal(state.grid, torch.ones_like(state.grid))
    CheckpointManager(str(tmp_path)).save(state.step, state)
    fresh_cfg, fresh = _grid_state(steps=0)
    restored = CheckpointManager(str(tmp_path)).restore(fresh)
    assert restored.step == 2 and torch.equal(restored.grid, state.grid)
    # A model without the grid restores the same weights and carries none.
    plain_cfg = copy.deepcopy(fresh_cfg)
    plain_cfg.model.grid_sampling = False
    model = construct_model(plain_cfg.model, t_batch(batch_size=B), "cpu", seed=1)
    plain = CheckpointManager(str(tmp_path)).restore(
        create_train_state(plain_cfg, model, make_optimizer(plain_cfg, model)))
    assert plain.grid is None
    assert torch.equal(model.box_centers, state.model.box_centers)


def _load_importer():
    spec = importlib.util.spec_from_file_location(
        "import_jax_checkpoint", os.path.join(REPO, "scripts", "import_jax_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_import_of_a_jax_grid_checkpoint(tmp_path):
    jcfg, _ = _configs()
    jb = j_batch(batch_size=B)
    _, variables = j_construct(jax.random.key(3), jb, jcfg.model)
    tx = jtrain.make_optimizer(jcfg)
    g = _grid(10)
    state = jtrain.create_train_state(jcfg, variables, tx).replace(
        step=jnp.asarray(5, jnp.int32), grid=jnp.asarray(g))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    mgr = JaxManager(jax_dir, async_save=False)
    mgr.save(5, state)
    mgr.wait()
    mgr.close()
    assert _load_importer().main(["--jax_dir", jax_dir, "--out_dir", port_dir]) == 0
    raw = CheckpointManager(port_dir).restore_raw()
    np.testing.assert_array_equal(raw["grid"].numpy(), g)
    cfg, fresh = _grid_state(steps=0)
    cfg.model = flagship_config(tiny=True).model
    cfg.model.grid_sampling, cfg.model.grid_resolution = True, RES
    model = construct_model(cfg.model, t_batch(batch_size=B), "cpu")
    restored = CheckpointManager(port_dir).restore(
        create_train_state(cfg, model, make_optimizer(cfg, model)))
    assert restored.step == 5 and np.array_equal(restored.grid.numpy(), g)


def test_apps_restore_a_grid_run(tmp_path):
    """A short grid run of the training loop, then the eval, render and
    pose-eval apps on its checkpoint (they sample level 0 stratified, as
    the JAX apps do: make_render_fn passes no grid)."""
    scene = str(tmp_path / "scene")
    generate_scene(scene, timesteps=3, width=80, height=64, focal=70.0, factors=(4,))
    cfg = tiny_config(max_steps=4, save_every=4, print_every=2)
    cfg.model.grid_sampling, cfg.model.grid_resolution = True, RES
    train_dir = str(tmp_path / "run")
    quiet = lambda *a: None  # noqa: E731
    state = run_training(cfg, scene, train_dir, log_fn=quiet, device="cpu")
    raw = CheckpointManager(train_dir).restore_raw()
    assert raw["step"] == 4 and torch.equal(raw["grid"], state.grid)
    assert float(raw["grid"].min()) < 1.0

    metrics = evaluate(cfg, scene, train_dir, log_fn=quiet, device="cpu")
    assert metrics["step"] == 4 and np.isfinite(metrics["psnr"])
    frames = trender.render_trajectory(cfg, scene, train_dir, str(tmp_path / "frames"),
                                       path="spiral", n_views=2, save_gif=False, log_fn=quiet,
                                       device="cpu")
    assert len(frames) == 2 and all(np.isfinite(f).all() for f in frames)
    poses = tpose.evaluate_poses(cfg, scene, train_dir, log_fn=quiet)
    assert poses and all(np.isfinite(v).all() for v in poses.values() if isinstance(v, float))
