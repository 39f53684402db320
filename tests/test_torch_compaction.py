"""Object-ray compaction (ModelConfig.obj_ray_capacity) in the port against
the JAX package's, on the same weights (params_from_flax) and rays.

  * obj_capacity_k over a grid of batches and capacities;
  * the compacted forward (every level's rgb, depth, acc, weights and
    obj_centroid) and the gradients of every parameter, as
    tests/test_obj_compaction.py:79-133 holds the JAX package to its own
    uncompacted model: the port's compacted model against JAX's compacted
    model, and against the port's uncompacted one;
  * an overflowing batch (150 hit rays, k = 128): the same rays keep their
    object contribution on both sides, so the sort's tie order is lax.top_k's;
  * the compacted kernel paths (K3/K4 and the per-object route, their plain
    versions on the CPU) against the uncompacted ones;
  * obj/overflow_rays in the training stats, and warn_obj_overflow.

Tolerances: float32 atol 1e-5 / rtol 1e-5 on outputs against JAX (1e-3 on
depth: fenceposts reach far = 10), gradients relative L2 1e-4 per leaf;
compacted against uncompacted in the port: the same (gather and scatter
permute the rays; sums over them run in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.configs import ModelConfig as JModelConfig
from durf_tpu.models import construct_model as j_construct
from durf_tpu.models.mipnerf import obj_capacity_k as j_capacity_k
from durf_tpu.rays import Rays as JRays
from durf_tpu_torch.configs import Config, MLPConfig, ModelConfig
from durf_tpu_torch.models import MipNerf
from durf_tpu_torch.models.mipnerf import obj_capacity_k
from durf_tpu_torch.params import params_from_flax, params_to_flax
from durf_tpu_torch.rays import Rays

KEYS = ("rgb", "depth", "acc", "weights", "obj_centroid")


def _model_kw(**kw):
    base = dict(
        num_samples=8,
        num_levels=2,
        max_deg_point=3,
        deg_view=2,
        num_objects=2,
        timesteps=3,
        density_noise=0.0,
        contraction=False,
    )
    base.update(kw)
    return base


def _configs(**kw):
    small = dict(net_depth=2, net_width=16, net_width_condition=8)
    tiny = dict(net_depth=2, net_width=8, net_width_condition=8)
    j = JModelConfig(**_model_kw(**kw), mlp=JMLPConfig(**small), box_mlp=JMLPConfig(**tiny))
    t = ModelConfig(**_model_kw(**kw), mlp=MLPConfig(**small), box_mlp=MLPConfig(**tiny))
    return j, t


def mixed_batch(n_rays=160, n_hit=8):
    """Rays where only the first `n_hit` point at the boxes (z = -5), as
    tests/test_obj_compaction.py:37-61 builds them (numpy leaves)."""
    rng = np.random.default_rng(11)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.05
    dirs[:, 2] = 1.0
    dirs[:n_hit, 2] = -1.0
    ones = np.ones((n_rays, 1), np.float32)
    leaves = dict(
        origins=np.zeros((n_rays, 3), np.float32),
        directions=dirs,
        viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        radii=ones * 0.01,
        lossmult=ones,
        near=ones * 0.1,
        far=ones * 10.0,
    )
    init = np.zeros((3, 2, 6), np.float32)
    init[:, 0, :3] = [0.3, -0.2, -5.0]
    init[:, 1, :3] = [-0.4, 0.1, -5.5]
    return leaves, init, np.full((2, 3), 1.5, np.float32), 1


@pytest.mark.parametrize("batch", [1, 100, 128, 160, 4096, 5000])
def test_obj_capacity_k_matches_jax(batch):
    for cap in (-1.0, 0.0, 0.001, 0.01, 0.0625, 0.25, 0.8, 1.0, 1.5):
        assert obj_capacity_k(batch, cap) == j_capacity_k(batch, cap), (batch, cap)


def _jax_run(kw, n_hit, with_grads):
    """JAX's outputs per level (numpy) and, optionally, the gradients of
    sum over levels of sum(rgb^2), with its params."""
    leaves, init, ext, ts = mixed_batch(n_hit=n_hit)
    jcfg, _ = _configs(**kw)
    batch = {"rays": JRays(**{k: jnp.asarray(v) for k, v in leaves.items()}),
             "init": jnp.asarray(init), "ext": jnp.asarray(ext), "ts": jnp.asarray(ts)}
    model, variables = j_construct(jax.random.key(0), batch, jcfg)

    def apply(params):
        return model.apply({"params": params}, rng=None, rays=batch["rays"], init_boxes=batch["init"],
                           ext=batch["ext"], ts=batch["ts"], randomized=False, background="gray",
                           alpha=3.0)

    out = [{k: np.asarray(v) for k, v in lv.items()} for lv in jax.jit(apply)(variables["params"])]
    grads = None
    if with_grads:
        loss = lambda p: sum((lv["rgb"] ** 2).sum() for lv in apply(p))  # noqa: E731
        g = jax.jit(jax.grad(loss))(variables["params"])
        grads = jax.tree.map(np.asarray, g)
    return jax.tree.map(np.asarray, variables["params"]), out, grads


@functools.lru_cache(maxsize=None)
def _jax_cached(cap, n_hit, with_grads=False):
    return _jax_run(dict(obj_ray_capacity=cap), n_hit, with_grads)


def _port_run(tree, n_hit, with_grads=False, **kw):
    leaves, init, ext, ts = mixed_batch(n_hit=n_hit)
    _, tcfg = _configs(**kw)
    model = MipNerf(tcfg, 2, 3)
    model.load_state_dict(params_from_flax(tree))
    rays = Rays(**{k: torch.from_numpy(np.array(v)) for k, v in leaves.items()})
    out = model(rays, ext=torch.from_numpy(ext), ts=ts, alpha=3.0)
    grads = None
    if with_grads:
        sum((lv["rgb"] ** 2).sum() for lv in out).backward()
        grads = params_to_flax({n: p.grad for n, p in model.named_parameters()})
    return [{k: v.detach() for k, v in lv.items()} for lv in out], grads


def _assert_levels(t_out, j_out, keys=KEYS):
    for i, (tl, jl) in enumerate(zip(t_out, j_out)):
        for key in keys:
            tol = dict(atol=1e-3, rtol=1e-5) if key == "depth" else dict(atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(np.asarray(tl[key]), np.asarray(jl[key]),
                                       err_msg=f"level {i} {key}", **tol)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_grads(t_grads, j_grads, tol=1e-4):
    t_flat = dict(_leaves(t_grads))
    for name, jg in _leaves(j_grads):
        tg = t_flat[name]
        den = np.linalg.norm(jg)
        rel = np.linalg.norm(tg - jg) / den if den > 0 else np.linalg.norm(tg)
        assert rel <= tol, f"{name}: relative L2 {rel}"


def test_compacted_forward_and_gradients_match_jax():
    tree, j_out, j_grads = _jax_cached(0.8, 8, True)  # k = 128 < 160 rays
    t_out, t_grads = _port_run(tree, 8, True, obj_ray_capacity=0.8)
    _assert_levels(t_out, j_out)
    _assert_grads(t_grads, j_grads)
    assert t_out[-1]["obj_hit_rays"].item() == float(j_out[-1]["obj_hit_rays"]) == 8.0
    # ... and against the port's own uncompacted model on the same weights.
    full, full_grads = _port_run(tree, 8, True, obj_ray_capacity=0.0)
    _assert_levels(t_out, full)
    _assert_grads(t_grads, full_grads)


def test_overflow_keeps_the_same_rays_as_jax():
    """150 rays hit a box and k = 128: the compacted set is the first 128
    hit rays on both sides (lax.top_k takes the lower index among ties),
    so rays 128-149 lose their object contribution alike."""
    tree, j_out, _ = _jax_cached(0.8, 150)
    t_out, _ = _port_run(tree, 150, obj_ray_capacity=0.8)
    _assert_levels(t_out, j_out)
    full, _ = _port_run(tree, 150, obj_ray_capacity=0.0)
    rgb, rgb_full = t_out[-1]["rgb"], full[-1]["rgb"]
    np.testing.assert_allclose(rgb[:128].numpy(), rgb_full[:128].numpy(), atol=1e-5, rtol=1e-5)
    assert (rgb[128:150] - rgb_full[128:150]).abs().amax(dim=-1).min() > 0  # every one dropped
    np.testing.assert_array_equal(rgb[150:].numpy(), rgb_full[150:].numpy())


@pytest.mark.parametrize("fused_objects", [True, False])
def test_compaction_on_the_kernel_paths(fused_objects):
    """bf16 with the MLP kernels (K3/K4, or K1/K2 per object; their plain
    versions here): the compacted model equals the uncompacted one, values
    and gradients."""
    tree = _jax_cached(0.8, 8)[0]
    kw = dict(compute_dtype="bfloat16", use_pallas_mlp=True, fused_objects=fused_objects)
    comp, comp_grads = _port_run(tree, 8, True, obj_ray_capacity=0.8, **kw)
    full, full_grads = _port_run(tree, 8, True, obj_ray_capacity=0.0, **kw)
    _assert_levels(comp, full)
    _assert_grads(comp_grads, full_grads)


def test_overflow_stats_and_warning():
    from durf_tpu_torch.train import (create_train_state, make_optimizer, make_train_step,
                                      warn_obj_overflow)

    leaves, init, ext, ts = mixed_batch(n_rays=160, n_hit=150)
    rng = np.random.default_rng(0)
    batch = {
        "rays": Rays(**{k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}),
        "pixels": torch.from_numpy(rng.uniform(size=(160, 3)).astype(np.float32)),
        "depth": torch.zeros((160, 1)), "sky": torch.zeros((160, 1)),
        "init": torch.from_numpy(init), "target": torch.from_numpy(init[1]),
        "ext": torch.from_numpy(ext), "ts": ts,
    }
    stats = {}
    for cap in (0.8, 0.0):
        _, tcfg = _configs(obj_ray_capacity=cap)
        config = Config(model=tcfg, batch_size=160, randomized=False)
        model = MipNerf(tcfg, 2, 3)
        model.load_state_dict(params_from_flax(_jax_cached(0.8, 8)[0]))
        opt = make_optimizer(config, model)
        _, stats[cap] = make_train_step(model, config, opt)(create_train_state(config, model, opt), batch)
    assert float(stats[0.8]["obj/overflow_rays"]) == 150 - 128
    assert float(stats[0.8]["obj/hit_frac"]) == pytest.approx(150 / 160)
    assert "obj/overflow_rays" not in stats[0.0]
    lines = []
    assert not warn_obj_overflow({"train/loss": 1.0}, 100, lines.append)
    assert not warn_obj_overflow({"obj/overflow_rays": 0.0, "obj/hit_frac": 0.01}, 100, lines.append)
    assert warn_obj_overflow({k: float(v) for k, v in stats[0.8].items() if k.startswith("obj/")},
                             200, lines.append)
    assert len(lines) == 1 and "22 rays" in lines[0] and "step 200" in lines[0]
    assert "obj_ray_capacity" in lines[0]
