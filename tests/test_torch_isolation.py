"""The port stands alone and never carries on quietly on the CPU:
  * no file of durf_tpu_torch/ nor chip_smoke.py imports jax, flax,
    durf_tpu, PIL (images go through the port's own PNG codec) or
    tensorboardX (MetricsWriter loads it by name, only where it is
    installed);
  * the entry points (the eval and render apps and LPIPS too) raise when
    CUDA is asked for and there is no card;
  * a kernel wrapper takes its plain version only for CPU tensors, and its
    launch counter stays 0 there;
  * configs that ask for unported paths raise NotImplementedError; the
    paths ported since (the randomized forward, compaction, the centering
    readout, the per-object kernel route, proposal levels) are accepted.
"""

import ast
import os

import numpy as np
import pytest
import torch

from durf_tpu_torch.configs import MLPConfig, ModelConfig
from durf_tpu_torch.data.synthetic import example_ray_batch
from durf_tpu_torch.models.mipnerf import MipNerf, check_supported, construct_model
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
def test_unported_paths_raise(field, value):
    cfg = ModelConfig(use_pallas_mlp=True, **{field: value})
    with pytest.raises(NotImplementedError):
        check_supported(cfg)


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
    check_supported(ModelConfig(use_pallas_mlp=True, **{field: value}))


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
