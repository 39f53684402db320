"""The object-centering readout (obj_centroid, durf_tpu/models/mipnerf.py:
448-524) in the port against the JAX package's, on the same weights and
rays, float32 without kernels.

  * obj_centroid of every level in both centering modes, on a batch whose
    first rays hit the boxes, and on a batch that hits no box (the 'mean'
    denominator's epsilon and the 'midrange' all-empty guard give 0);
  * one training step with centering_loss_mult > 0 and the box poses
    optimised: the loss, the loss/centering stats and the gradient of the
    pose table.

Tolerances: centroids atol 1e-5 / rtol 1e-4 (float32; the midrange's
logsumexp reduces in another order); the step's loss rtol 1e-4 and the pose
gradient relative L2 1e-3 (float32 sums over the batch in another order).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from durf_tpu import losses as jlosses
from durf_tpu import train as jtrain
from durf_tpu.data.synthetic import example_ray_batch as j_batch
from durf_tpu.models import construct_model as j_construct
from durf_tpu.rays import Rays as JRays
from durf_tpu_torch.data.synthetic import example_ray_batch as t_batch
from durf_tpu_torch.entry import flagship_config
from durf_tpu_torch.models import MipNerf
from durf_tpu_torch.params import params_from_flax, params_to_flax
from durf_tpu_torch.rays import Rays
from durf_tpu_torch.train import batch_to, make_grad_fn

from test_torch_compaction import _configs, mixed_batch


@functools.lru_cache(maxsize=None)
def _centroids(mode, n_hit):
    leaves, init, ext, ts = mixed_batch(n_hit=n_hit)
    jcfg, tcfg = _configs(centering_mode=mode)
    jb = {"rays": JRays(**{k: jnp.asarray(v) for k, v in leaves.items()}),
          "init": jnp.asarray(init), "ext": jnp.asarray(ext), "ts": jnp.asarray(ts)}
    model, variables = j_construct(jax.random.key(0), jb, jcfg)
    j_out = jax.jit(lambda p: model.apply(
        {"params": p}, rng=None, rays=jb["rays"], init_boxes=jb["init"], ext=jb["ext"],
        ts=jb["ts"], randomized=False, background="gray", alpha=3.0))(variables["params"])
    t_model = MipNerf(tcfg, 2, 3)
    t_model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables["params"])))
    with torch.no_grad():
        t_out = t_model(Rays(**{k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}),
                        ext=torch.from_numpy(ext), ts=ts, alpha=3.0)
    return ([np.asarray(lv["obj_centroid"]) for lv in j_out],
            [lv["obj_centroid"].numpy() for lv in t_out])


@pytest.mark.parametrize("mode", ["mean", "midrange"])
def test_centroid_matches_jax(mode):
    j_c, t_c = _centroids(mode, 8)
    for level, (j, t) in enumerate(zip(j_c, t_c)):
        assert t.shape == (2, 3)
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-4, err_msg=f"level {level}")
    assert np.abs(t_c[-1]).max() > 0  # the boxes are occupied: a real readout


@pytest.mark.parametrize("mode", ["mean", "midrange"])
def test_centroid_of_an_all_empty_batch(mode):
    j_c, t_c = _centroids(mode, 0)
    for j, t in zip(j_c, t_c):
        np.testing.assert_array_equal(t, np.zeros((2, 3), np.float32))
        np.testing.assert_allclose(t, j, atol=1e-6)


B = 32


def _step_config(cfg):
    cfg.model.no_pose_opt = False
    cfg.model.no_yaw_opt = False
    cfg.centering_loss_mult = 0.5
    cfg.randomized = False
    cfg.batch_size = B
    return cfg


def _box_batch(batch):
    """Put box 0 on ray 0 and box 1 on ray 1 (at distance 6) at this
    batch's timestep, so both objects have hit rays."""
    ts = int(batch["ts"])
    init = np.array(batch["init"])
    for o in range(2):
        d = np.asarray(batch["rays"].directions[o])
        init[ts, o, :3] = np.asarray(batch["rays"].origins[o]) + 6.0 * d / np.linalg.norm(d)
    batch["init"] = init
    return batch


@functools.lru_cache(maxsize=None)
def _jax_step():
    cfg = _step_config(_flagship_config(tiny=True))
    batch = _box_batch(j_batch(batch_size=B))
    batch["init"] = jnp.asarray(batch["init"])
    model, variables = j_construct(jax.random.key(0), batch, cfg.model)
    eps = jtrain.make_eps_schedule(cfg)(1)
    alpha = jtrain.make_alpha_schedule(cfg)(1)

    def loss_fn(params):  # durf_tpu/train.py:202-236 at step 0
        out = model.apply(
            {"params": params}, rng=jax.random.key(1), rays=batch["rays"],
            init_boxes=batch["init"], ext=batch["ext"], ts=batch["ts"], randomized=False,
            background=cfg.background, alpha=alpha,
        )
        ts = int(batch["ts"])
        prev = jax.lax.stop_gradient(params["box_centers"])[ts + 1 if ts == 0 else ts - 1]
        total, aux = jlosses.compute_losses(cfg, out, batch, prev, eps)
        return total, aux["centering"]

    (loss, centering), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return (jax.tree.map(np.asarray, variables["params"]), float(loss),
            [float(c) for c in centering], np.asarray(grads["box_centers"]))


def test_centering_step_matches_jax():
    tree, j_loss, j_cent, j_pose_grad = _jax_step()
    cfg = _step_config(flagship_config(tiny=True))
    host = _box_batch(t_batch(batch_size=B))
    model = MipNerf(cfg.model, 2, host["init"].shape[0])
    model.load_state_dict(params_from_flax(tree))
    loss, aux, grads = make_grad_fn(copy.deepcopy(model), cfg)(0, batch_to(host, "cpu"))
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    np.testing.assert_allclose([float(c) for c in aux["centering"]], j_cent, rtol=1e-4, atol=1e-7)
    assert max(j_cent) > 0  # the prior is live (level 0 samples miss the small boxes)
    t_pose_grad = params_to_flax({"box_centers": grads["box_centers"]})["box_centers"]
    rel = np.linalg.norm(t_pose_grad - j_pose_grad) / np.linalg.norm(j_pose_grad)
    assert np.linalg.norm(j_pose_grad) > 0 and rel <= 1e-3, rel
