"""The port stands alone and never carries on quietly on the CPU:
  * no file of durf_tpu_torch/ nor chip_smoke.py imports jax, flax,
    durf_tpu, PIL (images go through the port's own PNG codec) or
    tensorboardX (MetricsWriter loads it by name, only where it is
    installed);
  * the entry points (the eval and render apps and LPIPS too) raise when
    CUDA is asked for and there is no card;
  * a kernel wrapper takes its plain version only for CPU tensors, and its
    launch counter stays 0 there;
  * every path a ModelConfig selects builds and runs a forward: those the
    port refused until the occupancy grid, the row-major and
    full-covariance pipelines, remat_mlp and the kernels without view
    directions were ported, and those ported before them (compaction, the
    per-object kernel route, proposal levels);
  * the converters and the JPEG decoder import, and convert a CARLA
    capture and Waymo-shaped frames with JPEG images to scenes the loader
    reads, in a process where PIL, jax and durf_tpu cannot be imported.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from durf_tpu_torch.configs import MLPConfig, ModelConfig
from durf_tpu_torch.data.synthetic import example_ray_batch
from durf_tpu_torch.models.mipnerf import MipNerf, construct_model
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import obj_mlp as k3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "durf_tpu", "PIL", "tensorboardX")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "durf_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            roots |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return roots


def test_port_imports_nothing_of_jax_or_durf_tpu():
    files = _port_files()
    assert len(files) > 15 and any(f.endswith("chip_smoke.py") for f in files)
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_entry_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    from durf_tpu_torch.entry import entry, train_entry

    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        construct_model(ModelConfig(), example_ray_batch(batch_size=4))


def test_apps_raise_without_cuda(tmp_path):
    """The eval and render apps and the LPIPS metric default to the card and
    refuse before reading anything when there is none."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    from durf_tpu_torch.configs import Config
    from durf_tpu_torch.eval import _lpips_fn, evaluate
    from durf_tpu_torch.lpips import load_lpips
    from durf_tpu_torch.render import render_trajectory

    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(Config(), missing, missing)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_trajectory(Config(), missing, missing, missing)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_lpips(missing)
    with pytest.raises(RuntimeError, match="CUDA"):
        _lpips_fn(missing)
    assert not os.path.exists(missing)


def _k1_inputs():
    cfg = MLPConfig(net_depth=2, net_width=128, net_width_condition=128)
    rng = np.random.default_rng(0)
    dims = k1.layer_dims(cfg, 60) + [128, 128, 128 + 27, 128]
    outs = [1, 128, 128, 3]
    w = []
    for i, d in enumerate(dims):
        n = 128 if i < cfg.net_depth else outs[i - cfg.net_depth]
        w += [torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32) * 0.05),
              torch.zeros(n)]
    x = torch.from_numpy(rng.normal(size=(60, 4 * 8)).astype(np.float32))
    cond = torch.from_numpy(rng.normal(size=(4, 27)).astype(np.float32))
    return cfg, x, cond, w


def test_cpu_tensors_take_the_plain_version_uncounted():
    cfg, x, cond, w = _k1_inputs()
    before = k1.fused_nerf_mlp.launches
    rgb, den = k1.fused_nerf_mlp(x, cond, w, cfg, 8)
    ref = k1.fused_nerf_mlp_reference(x, cond, w, cfg, 8)
    assert k1.fused_nerf_mlp.launches == before == 0
    assert torch.equal(rgb, ref[0]) and torch.equal(den, ref[1])

    ws = [t[None].expand((2,) + t.shape).contiguous() for t in w]
    hit = torch.tensor([[1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 1.0, 0.0]])
    cond_lin = torch.zeros((2, 4, 128))
    before = k3.fused_obj_mlp.launches
    rgb, den = k3.fused_obj_mlp(x, hit, cond_lin, ws, cfg, 8)
    ref = k3.fused_obj_mlp_reference(x, hit, cond_lin, ws, cfg, 8)
    assert k3.fused_obj_mlp.launches == before == 0
    assert torch.equal(rgb, ref[0]) and torch.equal(den, ref[1])


def test_other_devices_raise_instead_of_falling_back():
    cfg, x, cond, w = _k1_inputs()
    meta = [t.to("meta") for t in w]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k1.fused_nerf_mlp(x.to("meta"), cond.to("meta"), meta, cfg, 8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k3.fused_obj_mlp(
            x.to("meta"), torch.ones((1, 4), device="meta"),
            torch.zeros((1, 4, 128), device="meta"), [t[None] for t in meta], cfg, 8,
        )


def _forward_runs(**fields):
    """Build a tiny model with the kernels on and `fields` set, and run an
    eval forward (with an occupancy grid) and a training step on the CPU."""
    cfg = ModelConfig(
        num_samples=4, max_deg_point=2, deg_view=1, use_pallas_mlp=True, grid_resolution=8,
        mlp=MLPConfig(net_depth=1, net_width=8, net_width_condition=8),
        box_mlp=MLPConfig(net_depth=1, net_width=8, net_width_condition=8), **fields,
    )
    batch = example_ray_batch(batch_size=4)
    model = construct_model(cfg, batch, device="cpu")
    grid = torch.rand((8, 8, 8), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(batch["rays"].to("cpu"), torch.from_numpy(batch["ext"]), 1, grid=grid)
    assert len(out) == cfg.num_levels and bool(torch.isfinite(out[-1]["rgb"]).all())
    assert ("positions_c" in out[-1]) == cfg.grid_sampling

    from durf_tpu_torch.configs import Config
    from durf_tpu_torch.train import batch_to, make_grad_fn

    loss, _, grads = make_grad_fn(model, Config(model=cfg))(0, batch_to(batch, "cpu"), grid)
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize(
    "field,value",
    [
        ("grid_sampling", True),
        ("use_viewdirs", False),
        ("diag_covariance", False),
        ("coord_major", False),
        ("remat_mlp", True),
    ],
)
def test_formerly_refused_paths_run(field, value):
    """The paths the port refused with NotImplementedError before they were
    ported run a forward and a training step."""
    _forward_runs(**{field: value})


@pytest.mark.parametrize(
    "field,value",
    [
        ("obj_ray_capacity", 0.25),
        ("obj_ray_capacity", -1.0),
        ("fused_objects", False),
        ("use_proposal", True),
    ],
)
def test_lifted_paths_are_supported(field, value):
    """Object-ray compaction (any capacity; <= 0 means off), the per-object
    route and proposal levels with the kernels on are ported."""
    _forward_runs(**{field: value})


def test_randomized_forward_raises():
    """The randomized (training) forward runs, draws from its generator
    (density noise, jitter, random background) and stays finite; the
    training step with the object-centering prior on runs too."""
    batch = example_ray_batch(batch_size=4)
    cfg = ModelConfig(
        num_samples=4, max_deg_point=2, deg_view=1, density_noise=1.0,
        mlp=MLPConfig(net_depth=1, net_width=8, net_width_condition=8),
        box_mlp=MLPConfig(net_depth=1, net_width=8, net_width_condition=8),
    )
    model = construct_model(cfg, batch, device="cpu")
    assert isinstance(model, MipNerf)
    args = (batch["rays"].to("cpu"), torch.from_numpy(batch["ext"]), 1)
    outs = [
        model(*args, randomized=True, background="random",
              generator=torch.Generator().manual_seed(seed))[-1]
        for seed in (0, 0, 1)
    ]
    assert all(bool(torch.isfinite(o["rgb"]).all()) for o in outs)
    assert torch.equal(outs[0]["rgb"], outs[1]["rgb"])  # one seed, one draw
    assert not torch.equal(outs[0]["t_vals"], outs[2]["t_vals"])

    from durf_tpu_torch.configs import Config
    from durf_tpu_torch.train import make_grad_fn

    from durf_tpu_torch.train import batch_to

    loss, aux, grads = make_grad_fn(model, Config(model=cfg, centering_loss_mult=0.1))(
        0, batch_to(batch, "cpu")
    )
    assert bool(torch.isfinite(loss)) and len(aux["centering"]) == cfg.num_levels
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


# A CARLA capture of 2 frames x 5 cameras written with the port's PNG
# writer, converted by the CLI; 3 Waymo-shaped frames whose camera images
# are a committed JPEG fixture, converted by convert_frames; both loaded.
_CONVERT_WITHOUT_PIL = textwrap.dedent("""
    import sys
    for name in ("PIL", "jax", "durf_tpu"):
        sys.modules[name] = None
    import os, types
    import numpy as np
    from durf_tpu_torch.configs import Config
    from durf_tpu_torch.data import format as fmt, jpeg, load_scene
    from durf_tpu_torch.tools import carla_capture, carla_postprocess, waymo_convert

    out = sys.argv[1]
    cap = os.path.join(out, "capture")
    os.makedirs(cap)
    h, w = 16, 20
    poses = {f"hwf_{c}": np.array([h, w, 18.0], np.float32) for c in range(5)}
    boxes = {}
    for t, frame in enumerate(["00000007", "00000009"]):
        for c in range(5):
            c2w = np.eye(4)
            c2w[:3, 3] = [0.1 * c, 1.5, 0.5 * t]
            poses[f"{frame}_{c}"] = c2w
            rgba = np.full((h, w, 4), 255, np.uint8)
            rgba[..., :3] = (np.arange(h * w * 3).reshape(h, w, 3) * (c + 3)) % 251
            fmt.write_png(os.path.join(cap, f"{frame}_rgb{c}.png"), rgba)
            code = np.full((h, w), 838860, np.int64)  # 50 m
            depth = np.stack([code % 256, code // 256 % 256, code // 65536, code * 0 + 255], -1)
            fmt.write_png(os.path.join(cap, f"{frame}_depth{c}.png"), depth.astype(np.uint8))
            sem = np.zeros((h, w, 4), np.uint8)
            sem[: h // 4, :, 0] = 13
            fmt.write_png(os.path.join(cap, f"{frame}_sem{c}.png"), sem)
            inst = np.zeros((h, w, 4), np.uint8)
            inst[h // 2:, : w // 2, 1] = 1
            fmt.write_png(os.path.join(cap, f"{frame}_inst{c}.png"), inst)
        center = np.eye(4, dtype=np.float32)
        center[:3, 3] = [2.0, 0.5, -5.0 - t]
        boxes[frame] = {42: {"center": center, "extent": np.array([2.0, 1.0, 0.8], np.float32)}}
    np.save(os.path.join(cap, "poses.npy"), poses, allow_pickle=True)
    np.save(os.path.join(cap, "bboxes.npy"), boxes, allow_pickle=True)
    carla = os.path.join(out, "carla")
    carla_postprocess.main(["--capture_dir", cap, "--out_dir", carla, "--factors", "2"])
    scene = load_scene(carla, Config(dataset_loader="carla_dyn", factor=2), "train")
    assert scene.n_examples == 10 and scene.images[0].shape == (8, 10, 3), scene.images[0].shape

    image = open(sys.argv[2], "rb").read()
    ih, iw = jpeg.decode_jpeg(image).shape[:2]
    ns = types.SimpleNamespace
    def frame(t):
        calibs = [ns(name=c, width=iw, height=ih, intrinsic=[30.0, 30.0, iw / 2, ih / 2],
                     extrinsic=ns(transform=list(np.eye(4).reshape(-1)))) for c in range(1, 6)]
        box = ns(center_x=8.0 + t, center_y=0.0, center_z=0.8, heading=0.1, length=4.0,
                 width=2.0, height=1.5)
        label = ns(id="a", box=box, metadata=ns(speed_x=3.0, speed_y=2.0), type=1,
                   TYPE_VEHICLE=1)
        pose = np.eye(4)
        pose[0, 3] = 3.0 * t
        return ns(pose=ns(transform=list(pose.reshape(-1))), laser_labels=[label],
                  images=[ns(name=c, image=image) for c in range(1, 6)],
                  context=ns(camera_calibrations=calibs))
    def depth_fn(f, factor, rig):
        return np.full((ih // factor, iw // factor), 10.0 + rig, np.float32)
    waymo = os.path.join(out, "waymo")
    waymo_convert.convert_frames([frame(t) for t in range(3)], waymo, factors=(2,),
                                 depth_fn=depth_fn)
    scene = load_scene(waymo, Config(dataset_loader="waymo", factor=2), "train")
    assert scene.n_examples == 13 and scene.images[0].shape == (ih // 2, iw // 2, 3)
    assert all(sys.modules.get(n) is None for n in ("PIL", "jax", "durf_tpu"))
    print("converted without PIL or jax")
""")


def test_converters_need_neither_pil_nor_jax(tmp_path):
    """The converters and the JPEG decoder run where PIL and jax cannot be
    imported, as on the card's machine."""
    jpg = os.path.join(REPO, "tests", "data", "jpeg", "q75_420.jpg")
    run = subprocess.run([sys.executable, "-c", _CONVERT_WITHOUT_PIL, str(tmp_path), jpg],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "converted without PIL or jax" in run.stdout
