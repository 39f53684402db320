"""The port's eval and pose-eval apps and CLIs against the JAX package's,
on the CPU, at tests/test_train.py's tiny config on a 80x64 scene (AlexNet's
pools need more than the tiny apps test's 20x16).

One JAX checkpoint (random weights, a perturbed pose table) is saved by
Orbax and imported by scripts/import_jax_checkpoint.py; both packages' apps
then read the same weights. Tolerances (float32 renders, the same arrays in):
per-image PSNR within 1e-3 dB, SSIM within 1e-5, depth MSE, LPIPS and the
average error to rtol 1e-4; decoded PNGs within one 8-bit level; depth
TIFFs within 1e-4; pose errors within 1e-12 (the same float32 tables,
float64 arithmetic on both sides). The trajectory renderer's tests are in
tests/test_torch_render_app.py.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from durf_tpu import train as jtrain
from durf_tpu.checkpoints import CheckpointManager as JaxManager
from durf_tpu.configs import Config as JConfig
from durf_tpu.configs import MLPConfig as JMLP
from durf_tpu.configs import ModelConfig as JModel
from durf_tpu.data import get_dataset as j_dataset
from durf_tpu.eval import evaluate as j_evaluate
from durf_tpu.lpips import save_random_weights
from durf_tpu.models import construct_model as j_construct
from durf_tpu.pose_eval import evaluate_poses as j_evaluate_poses
from durf_tpu.pose_eval import pose_errors as j_pose_errors
from durf_tpu_torch import eval as teval
from durf_tpu_torch import pose_eval as tpose
from durf_tpu_torch import render as trender
from durf_tpu_torch.data.synthetic import generate_scene
from test_torch_run_training import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 7
quiet = lambda *_: None  # noqa: E731


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps_scene")
    generate_scene(str(d), timesteps=3, width=320, height=256, focal=280.0, factors=(4,))
    return str(d)


@pytest.fixture(scope="module")
def ckpt(scene_dir, tmp_path_factory):
    """(jax_dir, port_dir, JAX model, params): a JAX checkpoint at STEP with
    random weights and a pose table perturbed from its initialisation, and
    its import into the port's format."""
    j_cfg = tiny_config(JConfig, JModel, JMLP)
    model, variables = j_construct(
        jax.random.key(3), j_dataset("train", scene_dir, j_cfg).peek(), j_cfg.model)
    params = dict(variables["params"])
    table = np.asarray(params["box_centers"])
    noise = np.random.default_rng(5).normal(0.0, 0.02, table.shape).astype(np.float32)
    params["box_centers"] = jnp.asarray(table + noise)
    state = jtrain.create_train_state(j_cfg, {"params": params}, jtrain.make_optimizer(j_cfg))
    state = state.replace(step=jnp.asarray(STEP, jnp.int32))
    root = tmp_path_factory.mktemp("apps_ckpt")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    mgr = JaxManager(jax_dir, async_save=False)
    mgr.save(STEP, state)
    mgr.wait()
    mgr.close()
    spec = importlib.util.spec_from_file_location(
        "import_jax_checkpoint", os.path.join(REPO, "scripts", "import_jax_checkpoint.py"))
    importer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(importer)
    assert importer.main(["--jax_dir", jax_dir, "--out_dir", port_dir]) == 0
    return jax_dir, port_dir, model, params


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("apps_lpips") / "w.npz")
    save_random_weights(path)
    return path


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def test_evaluate_matches_jax(scene_dir, ckpt, lpips_npz, tmp_path):
    jax_dir, port_dir, _, _ = ckpt
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "port")
    j = j_evaluate(tiny_config(JConfig, JModel, JMLP), scene_dir, jax_dir, out_dir=j_out,
                   use_lpips=True, log_fn=quiet, lpips_weights=lpips_npz)
    t = teval.evaluate(tiny_config(), scene_dir, port_dir, out_dir=t_out, use_lpips=True,
                       log_fn=quiet, lpips_weights=lpips_npz, device="cpu")
    assert t["num_views"] == j["num_views"] == 2 and t["step"] == j["step"] == STEP
    assert set(t) == set(j) and t["eval_rays_per_sec"] > 0
    for tr, jr in zip(t["per_image"], j["per_image"]):
        assert set(tr) == set(jr) == {"index", "psnr", "ssim", "depth_mse", "lpips"}
        assert abs(tr["psnr"] - jr["psnr"]) < 1e-3
        assert abs(tr["ssim"] - jr["ssim"]) < 1e-5
        for k in ("depth_mse", "lpips"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, err_msg=k)
    assert abs(t["psnr"] - j["psnr"]) < 1e-3 and abs(t["ssim"] - j["ssim"]) < 1e-5
    for k in ("depth_mse", "lpips", "avg_error"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    assert t["lpips"] > 0 and np.isfinite(t["avg_error"])

    names = sorted(os.listdir(t_out))
    assert names == sorted(os.listdir(j_out)) and "depth_001.tiff" in names
    with open(os.path.join(t_out, "metrics.json")) as f:
        assert json.load(f)["per_image"] == t["per_image"]
    for i in range(2):
        for kind in ("pred", "gt", "depth"):
            a, b = _png(os.path.join(t_out, f"{kind}_{i:03d}.png")), _png(
                os.path.join(j_out, f"{kind}_{i:03d}.png"))
            assert a.shape == b.shape == (64, 80, 3)
            assert np.abs(a - b).max() <= (0 if kind == "gt" else 1), kind
        tiff = Image.open(os.path.join(t_out, f"depth_{i:03d}.tiff"))
        assert tiff.mode == "F"
        np.testing.assert_allclose(
            np.asarray(tiff), np.asarray(Image.open(os.path.join(j_out, f"depth_{i:03d}.tiff"))),
            atol=1e-4, rtol=0)


def test_eval_without_lpips_weights_skips_the_metric(scene_dir, ckpt, monkeypatch):
    monkeypatch.delenv("DURF_LPIPS_WEIGHTS", raising=False)
    logs = []
    t = teval.evaluate(tiny_config(), scene_dir, ckpt[1], use_lpips=True, log_fn=logs.append,
                       device="cpu")
    assert "lpips" not in t and "avg_error" not in t
    assert any("lpips requested but" in line for line in logs)


def test_restore_for_eval_without_a_checkpoint_raises(scene_dir, tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        teval.restore_for_eval(tiny_config(), scene_dir, str(tmp_path / "empty"), device="cpu")


def test_pose_errors_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(4, 3, 6)).astype(np.float32) for _ in range(2))
    t, j = tpose.pose_errors(a, b), j_pose_errors(a, b)
    assert set(t) == set(j)
    for k in t:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("random_box", [False, True])
def test_evaluate_poses_matches_jax(scene_dir, ckpt, random_box):
    jax_dir, port_dir, _, _ = ckpt
    j = j_evaluate_poses(tiny_config(JConfig, JModel, JMLP, random_box=random_box), scene_dir,
                         jax_dir, log_fn=quiet)
    t = tpose.evaluate_poses(tiny_config(random_box=random_box), scene_dir, port_dir,
                             log_fn=quiet)
    assert t["step"] == j["step"] == STEP
    for part in ("optimized_vs_gt", "init_vs_gt"):
        for k, v in j[part].items():
            np.testing.assert_allclose(t[part][k], v, rtol=0, atol=1e-12, err_msg=f"{part} {k}")
    assert t["optimized_vs_gt"]["mse_total"] > 0  # the perturbed table
    assert (t["init_vs_gt"]["mse_total"] > 0) == random_box
    assert len(t["optimized_vs_gt"]["per_timestep_mse"]) == 3


def _tiny_gin(tmp_path):
    """tiny_config as a gin file, for the CLIs."""
    cfg = tiny_config()
    lines = [f"Config.{k} = {getattr(cfg, k)!r}"
             for k in ("dataset_loader", "batching", "batch_size", "factor", "spherify",
                       "centering", "near", "far", "timesteps", "chunk", "rand_bkgd")]
    lines += [f"MipNerfModel.{k} = {getattr(cfg.model, k)!r}"
              for k in ("num_samples", "num_levels", "max_deg_point", "deg_view", "num_objects",
                        "timesteps", "density_noise", "no_pose_opt", "no_yaw_opt")]
    for scope, mlp in (("MLP", cfg.model.mlp), ("BoxMLP", cfg.model.box_mlp)):
        lines += [f"{scope}.{k} = {getattr(mlp, k)!r}"
                  for k in ("net_depth", "net_width", "net_width_condition")]
    path = tmp_path / "tiny.gin"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_clis_run_on_the_cpu(scene_dir, ckpt, lpips_npz, tmp_path):
    port_dir = ckpt[1]
    common = ["--data_dir", scene_dir, "--train_dir", port_dir, "--gin_file", _tiny_gin(tmp_path)]
    summary = teval.main(common + ["--out_dir", str(tmp_path / "e"), "--lpips",
                                   "--lpips_weights", lpips_npz, "--device", "cpu"], log_fn=quiet)
    library = teval.evaluate(tiny_config(), scene_dir, port_dir, use_lpips=True, log_fn=quiet,
                             lpips_weights=lpips_npz, device="cpu")
    assert summary["per_image"] == library["per_image"]
    assert os.path.exists(tmp_path / "e" / "metrics.json")

    frames = trender.main(common + ["--out_dir", str(tmp_path / "r"), "--path", "spherical",
                                    "--n_views", "2", "--device", "cpu"], log_fn=quiet)
    assert len(frames) == 2 and all(np.isfinite(f).all() for f in frames)
    assert os.path.exists(tmp_path / "r" / "trajectory.gif")

    report = tpose.main(common, log_fn=quiet)
    assert report["step"] == STEP and report["optimized_vs_gt"]["mse_total"] > 0
