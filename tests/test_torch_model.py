"""The whole slice: the port's MipNerf with weights bridged from the JAX
package's MipNerf, on the same example ray batch, compared level by level.

(a) float32, no kernels: atol 1e-4 on rgb / acc / weights; depth and t_vals
    rtol 1e-4 plus atol 1e-3 (fenceposts up to far = 40; level-1 fenceposts
    follow the level-0 weights through the inverse CDF).
(b) dynamic, bf16 with the fused MLPs on (JAX: Pallas in interpret mode;
    port: the kernels' plain versions on the CPU), recurrent encode: atol
    2e-2 on every compared output; once with the objects-in-grid kernel
    ("kernels") and once on the per-object route ("per_object",
    fused_objects=False: K1 once per object on the blended input), which
    is also held to the fused route within the same tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from durf_tpu.data.synthetic import example_ray_batch as j_batch
from durf_tpu.models import construct_model as j_construct
from durf_tpu.rays import Rays as JRays
from durf_tpu.rays import camera_rays as j_camera_rays
from durf_tpu_torch.data.synthetic import example_ray_batch as t_batch
from durf_tpu_torch.entry import flagship_config
from durf_tpu_torch.models import MipNerf, render_image
from durf_tpu_torch.params import params_from_flax
from durf_tpu_torch.rays import Rays, camera_rays
from durf_tpu_torch.train import make_render_fn

B = 64
KEYS = ("rgb", "depth", "acc", "weights", "t_vals")


def _configs(case):
    jcfg, tcfg = _flagship_config(tiny=True), flagship_config(tiny=True)
    for cfg in (jcfg, tcfg):
        if case in ("kernels", "per_object"):
            cfg.model.compute_dtype = "bfloat16"
            cfg.model.use_pallas_mlp = True
            cfg.model.recurrent_encode = True
            cfg.model.fused_objects = case == "kernels"
        if case == "static":
            cfg.model.dynamics = False
    return jcfg, tcfg


def _batch():
    """The example batch with both boxes placed on ray 0 (at distances 6
    and 12), so that ray hits two boxes and its background mask clamps."""
    jb, tb = j_batch(batch_size=B), t_batch(batch_size=B)
    d0 = tb["rays"].directions[0] / np.linalg.norm(tb["rays"].directions[0])
    init = tb["init"].copy()
    ts = int(tb["ts"])
    init[ts, 0, :3] = tb["rays"].origins[0] + 6.0 * d0
    init[ts, 1, :3] = tb["rays"].origins[0] + 12.0 * d0
    jb["init"], tb["init"] = init, init.copy()
    return jb, tb


def _jax_apply(model, variables, rays, batch, dynamic):
    return model.apply(
        variables,
        rng=None,
        rays=rays,
        init_boxes=batch["init"] if dynamic else None,
        ext=batch["ext"] if dynamic else None,
        ts=batch["ts"] if dynamic else None,
        randomized=False,
        background="gray",
        alpha=10.0,
    )


def _port_model(tcfg, tree, tb, dynamic):
    init = tb["init"] if dynamic else None
    model = MipNerf(
        tcfg.model, 0 if init is None else init.shape[1], 0 if init is None else init.shape[0]
    )
    model.load_state_dict(params_from_flax(tree))
    return model.eval()


@functools.lru_cache(maxsize=None)
def _run_case(name):
    jcfg, tcfg = _configs(name)
    dynamic = name != "static"
    jb, tb = _batch()
    jb_model = dict(jb, init=jb["init"] if dynamic else None)
    model, variables = j_construct(jax.random.key(0), jb_model, jcfg.model)
    tree = jax.tree.map(np.asarray, variables["params"])
    j_out = _jax_apply(model, variables, jb["rays"], jb, dynamic)
    t_model = _port_model(tcfg, tree, tb, dynamic)
    with torch.no_grad():
        t_out = t_model(
            tb["rays"].to("cpu"),
            ext=torch.from_numpy(tb["ext"]) if dynamic else None,
            ts=int(tb["ts"]) if dynamic else None,
            alpha=10.0,
        )
    return name, j_out, t_out, (model, variables, t_model, tcfg, tb)


@pytest.fixture(scope="module", params=["static", "float32", "kernels", "per_object"])
def case(request):
    return _run_case(request.param)


def _tol(name, key):
    if name in ("kernels", "per_object"):
        return dict(atol=2e-2, rtol=0.0)
    if key in ("depth", "t_vals"):
        return dict(atol=1e-3, rtol=1e-4)
    return dict(atol=1e-4, rtol=0.0)


@pytest.mark.parametrize("level", [0, 1])
def test_levels_match_jax(case, level):
    name, j_out, t_out, _ = case
    assert len(t_out) == len(j_out) == 2
    for key in KEYS:
        np.testing.assert_allclose(
            t_out[level][key].numpy(), np.asarray(j_out[level][key]),
            err_msg=f"{name} level {level} {key}", **_tol(name, key),
        )


def test_scene_graph_outputs_match_jax(case):
    name, j_out, t_out, _ = case
    for key in ("dyn_mask", "z_out", "pose", "rot"):
        np.testing.assert_allclose(
            t_out[-1][key].detach().numpy(), np.asarray(j_out[-1][key]), atol=1e-5, rtol=1e-5
        )
    if name != "static":
        assert t_out[-1]["obj_hit_rays"].item() == float(j_out[-1]["obj_hit_rays"])
        assert t_out[-1]["dyn_mask"][0, 0].item() == 2.0  # ray 0 hits both boxes


def test_per_object_route_matches_fused_route():
    """The same bf16 weights through K1 per object and through K3 (their
    plain versions): every compared output within the kernels' atol 2e-2."""
    fused, per = _run_case("kernels")[2], _run_case("per_object")[2]
    for level in (0, 1):
        for key in KEYS:
            np.testing.assert_allclose(per[level][key].numpy(), fused[level][key].numpy(),
                                       atol=2e-2, rtol=0.0, err_msg=f"level {level} {key}")


def test_render_image_matches_jax():
    """A small image through make_render_fn + render_image (chunks of 32
    rays, the last one padded) against the JAX model on the same rays
    (dynamic, float32)."""
    _, _, _, (model, variables, t_model, tcfg, tb) = _run_case("float32")
    c2w = np.array([[1, 0, 0, 0.1], [0, 1, 0, 0.2], [0, 0, 1, 0.0]], np.float32)
    rays = camera_rays(c2w, 8, 6, 5.0, near=0.0, far=40.0)
    jrays = j_camera_rays(c2w, 8, 6, 5.0, near=0.0, far=40.0)
    render = make_render_fn(t_model, tcfg, device="cpu")
    img = render_image(lambda r: render(r, tb["ext"], int(tb["ts"]), 10.0), rays, chunk=32)
    flat = JRays(*(jnp.asarray(np.asarray(f).reshape(48, -1)) for f in (
        jrays.origins, jrays.directions, jrays.viewdirs, jrays.radii,
        jrays.lossmult, jrays.near, jrays.far,
    )))
    j_last = _jax_apply(model, variables, flat, dict(tb, init=tb["init"]), True)[-1]
    assert img["rgb"].shape == (6, 8, 3) and img["depth"].shape == (6, 8)
    np.testing.assert_allclose(img["rgb"].reshape(48, 3), np.asarray(j_last["rgb"]), atol=1e-4)
    np.testing.assert_allclose(img["acc"].reshape(48), np.asarray(j_last["acc"]), atol=1e-4)
    np.testing.assert_allclose(
        img["depth"].reshape(48), np.asarray(j_last["depth"]), atol=1e-3, rtol=1e-4
    )
