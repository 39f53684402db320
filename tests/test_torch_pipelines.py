"""The model's other pipelines against the JAX package's MipNerf on the same
weights (bridged by params_from_flax) and the same example ray batch, with
randomized=False: row-major samples (`coord_major=False`), the full
covariance (`diag_covariance=False`), the MLP kernels switched on without
view directions (the plain path, as in the JAX package) and, at the kernel
operating point, row-major samples through the MLP kernels (per-object
route; JAX's Pallas kernels in interpret mode, the port's plain versions on
the CPU). Also `remat_mlp` against no remat, and `train_entry` with each of
bench.py's flags.

Tolerances: float32 atol 1e-4 on rgb / acc / weights, depth and t_vals
atol 1e-4 plus rtol 1e-5 (fenceposts up to far = 40, where float32's
spacing is 4e-6); the kernel case atol 2e-2 (bf16 products,
test_torch_model.py's kernel tolerance). remat's gradients: bitwise.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from durf_tpu.data.synthetic import example_ray_batch as j_batch
from durf_tpu.models import construct_model as j_construct
from durf_tpu_torch import entry as tentry
from durf_tpu_torch.data.synthetic import example_ray_batch as t_batch
from durf_tpu_torch.entry import flagship_config
from durf_tpu_torch.models import MipNerf, construct_model
from durf_tpu_torch.ops.kernels import fused_mlp as k1
from durf_tpu_torch.ops.kernels import obj_mlp as k3
from durf_tpu_torch.params import params_from_flax
from durf_tpu_torch.train import batch_to, make_grad_fn

B = 64
KEYS = ("rgb", "depth", "acc", "weights", "t_vals")
CASES = {
    "row_major": dict(coord_major=False),
    "full_covariance": dict(diag_covariance=False),
    "no_viewdirs_kernels": dict(use_viewdirs=False, use_pallas_mlp=True),
    "row_major_kernels": dict(coord_major=False, compute_dtype="bfloat16", use_pallas_mlp=True,
                              recurrent_encode=True, fused_objects=True),
}


def _batch():
    """The example batch with both boxes on ray 0 (at distances 6 and 12):
    that ray hits two boxes and its background mask clamps."""
    jb, tb = j_batch(batch_size=B), t_batch(batch_size=B)
    d0 = tb["rays"].directions[0] / np.linalg.norm(tb["rays"].directions[0])
    init = tb["init"].copy()
    ts = int(tb["ts"])
    init[ts, 0, :3] = tb["rays"].origins[0] + 6.0 * d0
    init[ts, 1, :3] = tb["rays"].origins[0] + 12.0 * d0
    jb["init"], tb["init"] = init, init.copy()
    return jb, tb


def _port_model(model_cfg, tree, init):
    model = MipNerf(model_cfg, init.shape[1], init.shape[0])
    model.load_state_dict(params_from_flax(tree))
    return model.eval()


def _port_levels(model, tb):
    with torch.no_grad():
        return model(tb["rays"].to("cpu"), ext=torch.from_numpy(tb["ext"]), ts=int(tb["ts"]),
                     alpha=10.0)


@functools.lru_cache(maxsize=None)
def _run_case(name):
    jcfg, tcfg = _flagship_config(tiny=True), flagship_config(tiny=True)
    for cfg in (jcfg, tcfg):
        for field, value in CASES[name].items():
            setattr(cfg.model, field, value)
    jb, tb = _batch()
    model, variables = j_construct(jax.random.key(0), jb, jcfg.model)
    tree = jax.tree.map(np.asarray, variables["params"])
    j_out = model.apply(variables, rng=None, rays=jb["rays"], init_boxes=jb["init"], ext=jb["ext"],
                        ts=jb["ts"], randomized=False, background="gray", alpha=10.0)
    t_model = _port_model(tcfg.model, tree, tb["init"])
    return j_out, _port_levels(t_model, tb), (tree, tcfg, tb)


def _tol(name, key):
    if name == "row_major_kernels":
        return dict(atol=2e-2, rtol=0.0)
    if key in ("depth", "t_vals"):
        return dict(atol=1e-4, rtol=1e-5)
    return dict(atol=1e-4, rtol=0.0)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_levels_match_jax(name, level):
    j_out, t_out, _ = _run_case(name)
    assert len(t_out) == len(j_out) == 2
    for key in KEYS:
        np.testing.assert_allclose(t_out[level][key].numpy(), np.asarray(j_out[level][key]),
                                   err_msg=f"{name} level {level} {key}", **_tol(name, key))
    np.testing.assert_allclose(t_out[level]["obj_centroid"].numpy(),
                               np.asarray(j_out[level]["obj_centroid"]), atol=1e-4,
                               err_msg=f"{name} level {level} obj_centroid")
    assert t_out[level]["dyn_mask"][0, 0].item() == 2.0  # ray 0 hits both boxes


@pytest.mark.parametrize("name", ["row_major", "full_covariance"])
def test_layouts_agree_with_the_coordinate_major_pipeline(name):
    """The same weights give the same render on coordinate-major diagonal
    samples: the feature order, the diagonal and the full covariance's
    encodings agree (the JAX package's
    tests/test_model.py::test_coord_major_model_matches_row_major)."""
    _, t_out, (tree, tcfg, tb) = _run_case(name)
    cm_cfg = dataclasses.replace(tcfg.model, coord_major=True, diag_covariance=True)
    cm_out = _port_levels(_port_model(cm_cfg, tree, tb["init"]), tb)
    for level in (0, 1):
        for key in KEYS:
            np.testing.assert_allclose(t_out[level][key].numpy(), cm_out[level][key].numpy(),
                                       err_msg=f"level {level} {key}", **_tol(name, key))


def test_mlp_without_view_directions_takes_the_plain_path(monkeypatch):
    """use_pallas_mlp without use_viewdirs: no MLP has a condition, and the
    JAX package has no kernel for that (mlp.py:166 there), so no kernel
    wrapper is called, and the objects take the per-object route."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((k1, "fused_nerf_mlp"), (k1, "fused_nerf_mlp_gated"),
                      (k3, "fused_obj_mlp"), (k3, "obj_mlps_apply")):
        monkeypatch.setattr(mod, name, refuse)
    _run_case.cache_clear()
    try:
        j_out, t_out, _ = _run_case("no_viewdirs_kernels")
    finally:
        _run_case.cache_clear()
    np.testing.assert_allclose(t_out[-1]["rgb"].numpy(), np.asarray(j_out[-1]["rgb"]), atol=1e-4)


def _remat_grads(remat, config_kw):
    cfg = flagship_config(tiny=True)
    cfg.randomized = False
    for field, value in dict(config_kw, remat_mlp=remat).items():
        setattr(cfg.model, field, value)
    host = t_batch(batch_size=32)
    model = construct_model(cfg.model, host, "cpu")  # the same weights for either
    loss, _, grads = make_grad_fn(model, cfg)(0, batch_to(host, "cpu"))
    return loss, grads


@pytest.mark.parametrize("config_kw", [{}, dict(coord_major=False, compute_dtype="bfloat16")],
                         ids=["coordinate_major_fp32", "row_major_bf16"])
def test_remat_gradients_equal_those_without(config_kw):
    """remat_mlp recomputes the plain path in the backward: the loss and
    every gradient leaf are bitwise those without it."""
    loss_r, grads_r = _remat_grads(True, config_kw)
    loss_p, grads_p = _remat_grads(False, config_kw)
    assert torch.equal(loss_r, loss_p)
    assert grads_r.keys() == grads_p.keys()
    for name in grads_p:
        assert torch.equal(grads_r[name], grads_p[name]), name
    assert any(float(g.abs().sum()) > 0 for g in grads_p.values())


@pytest.mark.parametrize(
    "flags",
    [dict(grid_sampling=True), dict(remat=True, pallas=False), dict(use_box_nearfar=True),
     dict(recurrent_encode=False), dict(dtype="float32")],
    ids=["grid_sampling", "remat_no_pallas", "use_box_nearfar", "no_recurrent_encode", "float32"],
)
def test_train_entry_takes_the_bench_flags(flags, monkeypatch):
    """train_entry(device="cpu") on the tiny flagship builds and steps with
    each bench.py flag; the flags land in the config, and the grid flag
    gives the state a grid that the step updates."""
    monkeypatch.setattr(tentry, "flagship_config", functools.partial(flagship_config, tiny=True))
    step_fn, state, batch = tentry.train_entry("cpu", batch_size=32, **flags)
    m = state.config.model
    names = dict(grid_sampling="grid_sampling", remat="remat_mlp", pallas="use_pallas_mlp",
                 use_box_nearfar="use_box_nearfar", recurrent_encode="recurrent_encode",
                 dtype="compute_dtype")
    for flag, value in flags.items():
        assert getattr(m, names[flag]) == value, flag
    grid0 = None if state.grid is None else state.grid.clone()
    assert (grid0 is not None) == bool(flags.get("grid_sampling"))
    state, stats = step_fn(state, batch)
    assert state.step == 1
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in stats.values())
    if grid0 is not None:
        assert not torch.equal(state.grid, grid0) and float(state.grid.max()) <= 1.0


def test_train_entry_defaults_are_the_kernel_operating_point(monkeypatch):
    monkeypatch.setattr(tentry, "flagship_config", functools.partial(flagship_config, tiny=True))
    _, state, _ = tentry.train_entry("cpu", batch_size=8)
    m = state.config.model
    assert (m.compute_dtype, m.use_pallas_mlp, m.recurrent_encode) == ("bfloat16", True, True)
    assert not (m.grid_sampling or m.remat_mlp or m.use_box_nearfar) and state.grid is None
    assert m.coord_major and m.diag_covariance
