"""Weights, configs and host data between the JAX package and the port:
the flax -> port -> flax round trip is bit-exact, the port's own init has
the flax tree's layout, and the config parser, ray generation and example
batch give the same values as the JAX package's."""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from durf_tpu import configs as jconfigs
from durf_tpu.data.synthetic import example_ray_batch as j_batch
from durf_tpu.models import construct_model as j_construct
from durf_tpu.rays import camera_rays as j_camera_rays
from durf_tpu_torch import configs as tconfigs
from durf_tpu_torch.data.synthetic import example_ray_batch as t_batch
from durf_tpu_torch.entry import flagship_config
from durf_tpu_torch.models import MipNerf, construct_model
from durf_tpu_torch.params import params_from_flax, params_to_flax
from durf_tpu_torch.rays import camera_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flax_tree():
    cfg = _flagship_config(tiny=True)
    batch = j_batch(batch_size=8)
    _, variables = j_construct(jax.random.key(0), batch, cfg.model)
    return jax.tree.map(np.asarray, variables["params"])


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_flax_round_trip_is_bit_exact(flax_tree):
    cfg = flagship_config(tiny=True)
    init = flax_tree["box_centers"]
    model = MipNerf(cfg.model, init.shape[1], init.shape[0])
    model.load_state_dict(params_from_flax(flax_tree))  # strict: every leaf present
    back = _leaves(params_to_flax(model.state_dict()))
    orig = _leaves(flax_tree)
    assert back.keys() == orig.keys()
    for k in orig:
        assert back[k].dtype == orig[k].dtype and np.array_equal(back[k], orig[k]), k


def test_port_init_has_flax_layout(flax_tree):
    cfg = flagship_config(tiny=True)
    model = construct_model(cfg.model, t_batch(batch_size=8), device="cpu", seed=3)
    mine = _leaves(params_to_flax(model.state_dict()))
    orig = _leaves(flax_tree)
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in orig.items()}
    np.testing.assert_array_equal(mine["box_centers"], t_batch(batch_size=8)["init"])
    for k, v in mine.items():
        if k.endswith("bias"):
            assert not v.any(), k
        elif k.endswith("kernel"):
            fan_in, fan_out = v.shape[-2:]
            assert np.abs(v).max() <= np.sqrt(6.0 / (fan_in + fan_out)), k
            assert np.abs(v).std() > 0, k


@pytest.mark.parametrize(
    "gin", sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.gin")))
)
def test_load_config_matches_jax(gin):
    path = os.path.join(REPO, "configs", gin)
    bindings = ["MipNerfModel.compute_dtype = 'bfloat16'", "Config.chunk = 4096"]
    j = jconfigs.load_config([path], bindings)
    t = tconfigs.load_config([path], bindings)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_default_configs_match_jax():
    assert dataclasses.asdict(tconfigs.Config()) == dataclasses.asdict(jconfigs.Config())


def test_example_ray_batch_matches_jax():
    j, t = j_batch(batch_size=32, seed=5), t_batch(batch_size=32, seed=5)
    for field in ("origins", "directions", "viewdirs", "radii", "lossmult", "near", "far"):
        np.testing.assert_array_equal(getattr(t["rays"], field), np.asarray(getattr(j["rays"], field)))
    for key in ("pixels", "depth", "sky", "init", "ext", "ts"):
        np.testing.assert_array_equal(t[key], j[key])


@pytest.mark.parametrize("use_ndc", [False, True])
def test_camera_rays_match_jax(use_ndc):
    c2w = np.array([[0.9, 0.1, 0, 0.3], [-0.1, 0.9, 0.2, 0.1], [0, -0.2, 1, 1.5]], np.float32)
    j = j_camera_rays(c2w, 10, 7, 8.0, near=0.5, far=30.0, use_ndc=use_ndc)
    t = camera_rays(c2w, 10, 7, 8.0, near=0.5, far=30.0, use_ndc=use_ndc)
    for field in t._fields:
        np.testing.assert_array_equal(getattr(t, field), np.asarray(getattr(j, field)), field)
    assert t.to("cpu").origins.dtype == torch.float32
