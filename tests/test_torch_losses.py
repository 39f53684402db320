"""The training slice's host-side math against the JAX package, in float32
on the CPU with the same numpy inputs on both sides:

  * every loss function and `compute_losses` with its gradient with respect
    to the level outputs (atol 1e-6 / rtol 1e-5: both sides are float32 with
    operations in another order);
  * the lr / eps / alpha schedules (rtol 1e-5: JAX evaluates them in
    float32, the port in float64 on the host);
  * three Adam steps against optax with the pose-LR machinery on (atol
    1e-6);
  * the randomized draws: JAX's own random numbers fed into the port's
    stratified jitter and inverse-CDF sampler (atol 1e-6 relative to the
    fencepost scale), and into the random background.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from durf_tpu import losses as jlosses
from durf_tpu import mathx as jmathx
from durf_tpu import ops as jops
from durf_tpu import train as jtrain
from durf_tpu.configs import Config as JConfig
from durf_tpu.rays import Rays as JRays
from durf_tpu_torch import losses as tlosses
from durf_tpu_torch import mathx as tmathx
from durf_tpu_torch import ops as tops
from durf_tpu_torch import train as ttrain
from durf_tpu_torch.configs import Config as TConfig
from durf_tpu_torch.rays import Rays as TRays

TOL = dict(atol=1e-6, rtol=1e-5)
B, S, N_OBJ = 12, 10, 2


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(t_val, j_val, **tol):
    np.testing.assert_allclose(
        t_val.detach().numpy(), np.asarray(j_val), **(tol or TOL)
    )


def _level_arrays(seed):
    rng = np.random.default_rng(seed)
    t_vals = np.sort(rng.uniform(0.5, 12.0, size=(B, S + 1)), axis=-1).astype(np.float32)
    weights = (rng.uniform(size=(B, S)) * 0.3).astype(np.float32)
    return {
        "rgb": rng.uniform(size=(B, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 10.0, size=(B,)).astype(np.float32),
        "weights": weights,
        "t_vals": t_vals,
        "t_mids": (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).astype(np.float32),
        "t_dists": (t_vals[:, 1:] - t_vals[:, :-1]).astype(np.float32),
        "pose": rng.normal(size=(N_OBJ, 3)).astype(np.float32),
        "rot": (rng.normal(size=(N_OBJ, 3)) * 0.3).astype(np.float32),
        "dyn_mask": rng.integers(0, 2, size=(B, 1)).astype(np.float32),
        "z_out": rng.uniform(0.0, 8.0, size=(B,)).astype(np.float32),
    }


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(B, 3)).astype(np.float32)
    ones = np.ones((B, 1), np.float32)
    rays = dict(
        origins=(rng.normal(size=(B, 3)) * 0.5).astype(np.float32), directions=dirs,
        viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True), radii=ones * 0.01,
        lossmult=(ones * rng.uniform(0.5, 1.5, size=(B, 1))).astype(np.float32),
        near=ones * 0.0, far=ones * 40.0,
    )
    depth = (rng.uniform(0, 8, size=(B, 1)) * (rng.uniform(size=(B, 1)) > 0.3)).astype(np.float32)
    return {
        "rays": rays,
        "pixels": rng.uniform(size=(B, 3)).astype(np.float32),
        "depth": depth,
        "sky": (0.975 * (rng.uniform(size=(B, 1)) > 0.6)).astype(np.float32),
        "target": rng.normal(size=(N_OBJ, 6)).astype(np.float32),
        "ext": (np.abs(rng.normal(size=(N_OBJ, 3))) * 2 + 1.0).astype(np.float32),
    }


def _j_batch(b):
    out = {k: jnp.asarray(v) for k, v in b.items() if k != "rays"}
    out["rays"] = JRays(**{k: jnp.asarray(v) for k, v in b["rays"].items()})
    return out


def _t_batch(b):
    out = {k: _t(v) for k, v in b.items() if k != "rays"}
    out["rays"] = TRays(**{k: _t(v) for k, v in b["rays"].items()})
    return out


@pytest.mark.parametrize("exact", [False, True])
def test_distortion_loss_matches_jax(exact):
    lv = _level_arrays(0)
    j = jlosses.distortion_loss(*(jnp.asarray(lv[k]) for k in ("weights", "t_mids", "t_dists")), exact)
    t = tlosses.distortion_loss(*(_t(lv[k]) for k in ("weights", "t_mids", "t_dists")), exact)
    _close(t, j)


def test_urf_depth_and_sky_losses_match_jax():
    lv, b = _level_arrays(1), _batch()
    gt = b["depth"][:, 0]
    mask = (gt > 0).astype(np.float32)
    args = (lv["weights"], lv["t_vals"][:, :-1], lv["depth"], gt, mask)
    j = jlosses.urf_depth_losses(*(jnp.asarray(a) for a in args), 0.7)
    t = tlosses.urf_depth_losses(*(_t(a) for a in args), 0.7)
    for tv, jv in zip(t, j):
        _close(tv, jv)
    sky = b["sky"][:, 0]
    sky_mask = (sky > 0).astype(np.float32)
    _close(
        tlosses.sky_loss(_t(lv["depth"]), _t(sky_mask), _t(sky)),
        jlosses.sky_loss(jnp.asarray(lv["depth"]), jnp.asarray(sky_mask), jnp.asarray(sky)),
    )


@pytest.mark.parametrize("with_inst", [False, True])
def test_box_surface_loss_matches_jax(with_inst):
    lv, b = _level_arrays(2), _batch()
    rng = np.random.default_rng(3)
    inst = rng.integers(0, 3, size=(B, 1)).astype(np.float32) if with_inst else None
    obj_ids = np.array([1.0, 2.0], np.float32) if with_inst else None
    margin = 3.0  # wide enough that many points are kept
    j = jlosses.box_surface_loss(
        _j_batch(b)["rays"], jnp.asarray(b["depth"][:, 0]), jnp.asarray(lv["pose"]),
        jnp.asarray(lv["rot"]), jnp.asarray(b["ext"]), margin,
        None if inst is None else jnp.asarray(inst), None if obj_ids is None else jnp.asarray(obj_ids),
    )
    t = tlosses.box_surface_loss(
        _t_batch(b)["rays"], _t(b["depth"][:, 0]), _t(lv["pose"]), _t(lv["rot"]), _t(b["ext"]),
        margin, None if inst is None else _t(inst), None if obj_ids is None else _t(obj_ids),
    )
    assert float(t) > 0
    _close(t, j)


def test_weight_l2_matches_jax():
    rng = np.random.default_rng(4)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    j = jlosses.weight_l2({str(i): jnp.asarray(a) for i, a in enumerate(leaves)})
    _close(tlosses.weight_l2([_t(a) for a in leaves]), j)


DIFF_KEYS = ("rgb", "depth", "weights", "t_mids", "t_dists", "pose", "rot")


@pytest.mark.parametrize("exact", [False, True])
def test_compute_losses_and_grads_match_jax(exact):
    fields = dict(
        box_loss_mult=0.5, box_surface_loss_mult=0.3, box_surface_margin=3.0, tv_loss_mult=0.01,
        distortion_loss_mult=1e-2, exact_distortion=exact, coarse_loss_mult=0.1,
    )
    jcfg, tcfg = JConfig(**fields), TConfig(**fields)
    levels = [_level_arrays(10), _level_arrays(11)]
    b = _batch()
    prev = np.random.default_rng(5).normal(size=(N_OBJ, 6)).astype(np.float32)
    jb, tb = _j_batch(b), _t_batch(b)

    def j_total(diff):
        lvs = [dict({k: jnp.asarray(v) for k, v in lv.items()}, **d) for lv, d in zip(levels, diff)]
        return jlosses.compute_losses(jcfg, lvs, jb, jnp.asarray(prev), 0.8)

    j_diff = [{k: jnp.asarray(lv[k]) for k in DIFF_KEYS} for lv in levels]
    (j_tot, j_aux), j_grads = jax.value_and_grad(j_total, has_aux=True)(j_diff)

    t_levels = [{k: _t(v).requires_grad_(k in DIFF_KEYS) for k, v in lv.items()} for lv in levels]
    t_tot, t_aux = tlosses.compute_losses(tcfg, t_levels, tb, _t(prev), 0.8)
    leaves = [lv[k] for lv in t_levels for k in DIFF_KEYS]
    t_grads = torch.autograd.grad(t_tot, leaves, allow_unused=True)
    t_grads = [torch.zeros_like(x) if g is None else g for g, x in zip(t_grads, leaves)]

    _close(t_tot, j_tot)
    for key, jv in j_aux.items():
        _close(t_aux[key], jv)
    flat_j = [j_grads[i][k] for i in range(2) for k in DIFF_KEYS]
    for name, tg, jg in zip([f"{i}/{k}" for i in range(2) for k in DIFF_KEYS], t_grads, flat_j):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), err_msg=name, **TOL)


def test_schedules_match_jax():
    fields = dict(lr_delay_steps=2500, lr_delay_mult=0.01, eps_delay_steps=300,
                  alpha_delay_steps=50, alpha_max_steps=4000, alpha_init=2.0, alpha_final=9.0)
    jcfg, tcfg = JConfig(**fields), TConfig(**fields)
    for make in ("make_lr_schedule", "make_eps_schedule", "make_alpha_schedule"):
        jf, tf = getattr(jtrain, make)(jcfg), getattr(ttrain, make)(tcfg)
        for step in (0, 1, 2, 49, 50, 51, 299, 1000, 2500, 3999, 4000, 4001, 123456, 10**6):
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-5, atol=1e-12,
                                       err_msg=f"{make}({step})")
    assert tmathx.mse_to_psnr(torch.tensor(0.01)).item() == pytest.approx(20.0, rel=1e-6)


ADAM_CASES = {
    "pose_mult_ramp": dict(pose_lr_mult=3.0, pose_lr_ramp_steps=2),
    "freeze_field": dict(pose_lr_mult=2.0, pose_lr_delay_steps=1, pose_lr_ramp_steps=1,
                         pose_lr_decay_steps=2, pose_freeze_field=True),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adam_steps_match_optax(case):
    fields = dict(lr_init=1e-2, lr_final=1e-3, max_steps=10, lr_delay_steps=0, **ADAM_CASES[case])
    jcfg, tcfg = JConfig(**fields), TConfig(**fields)
    rng = np.random.default_rng(6)
    init = {"box_centers": rng.normal(size=(2, 1, 6)), "w": rng.normal(size=(4, 4))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]

    tx = jtrain.make_optimizer(jcfg)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(j_params)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
    opt = ttrain.ScheduledAdam(tcfg, list(params.items()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in params.items():
            p.grad = _t(g[k])
        opt.step()
    moved = {k: float(np.abs(np.asarray(j_params[k]) - init[k]).max()) for k in init}
    assert moved["w"] > 0 and moved["box_centers"] > 0
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), atol=1e-6, err_msg=k)


def test_stratified_jitter_matches_jax_draws():
    rng = np.random.default_rng(8)
    b, s = 5, 16
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.3
    origins = (rng.normal(size=(b, 3)) * 0.5).astype(np.float32)
    radii = np.full((b, 1), 0.01, np.float32)
    near, far = np.full((b, 1), 0.5, np.float32), np.full((b, 1), 30.0, np.float32)
    key = jax.random.key(3)
    jt, (jm, jc) = jops.sample_along_rays(
        key, jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(radii), s,
        jnp.asarray(near), jnp.asarray(far), True, False, "cone", diag=True, cm=True,
    )
    t_rand = np.asarray(jax.random.uniform(key, [b, s + 1]))
    tt, (tm, tc) = tops.sample_along_rays(
        _t(origins), _t(dirs), _t(radii), s, _t(near), _t(far), False, "cone",
        randomized=True, t_rand=_t(t_rand),
    )
    _close(tt, jt, atol=1e-6 * 30, rtol=1e-6)
    _close(tm, jm, atol=1e-4, rtol=1e-6)
    _close(tc, jc, atol=1e-6, rtol=1e-4)
    # The generator path draws a fresh jitter inside each stratum.
    gen = torch.Generator().manual_seed(0)
    tg, _ = tops.sample_along_rays(_t(origins), _t(dirs), _t(radii), s, _t(near), _t(far),
                                   False, "cone", randomized=True, generator=gen)
    even = torch.linspace(0.5, 30.0, s + 1)
    assert not torch.equal(tg[0], even) and bool((tg[:, 1:] >= tg[:, :-1]).all())


def test_randomized_inverse_cdf_matches_jax_draws():
    rng = np.random.default_rng(9)
    bins = np.sort(rng.uniform(0, 10, size=(6, 17)).astype(np.float32), axis=-1)
    weights = rng.uniform(size=(6, 16)).astype(np.float32)
    weights[2] = 0.0
    n = 24
    key = jax.random.key(5)
    j = jmathx.sorted_piecewise_constant_pdf(key, jnp.asarray(bins), jnp.asarray(weights), n, True)
    s = 1.0 / n
    jitter = np.asarray(jax.random.uniform(key, (6, n), maxval=s - np.finfo(np.float32).eps))
    t = tmathx.sorted_piecewise_constant_pdf(_t(bins), _t(weights), n, True, jitter=_t(jitter))
    _close(t, j, atol=1e-6 * 10, rtol=1e-6)
    gen = torch.Generator().manual_seed(1)
    tg = tmathx.sorted_piecewise_constant_pdf(_t(bins), _t(weights), n, True, generator=gen)
    assert bool((tg[:, 1:] >= tg[:, :-1]).all()) and not torch.equal(tg, t)


def test_resample_honours_stop_level_grad():
    rng = np.random.default_rng(11)
    origins, dirs = _t(rng.normal(size=(3, 3))), _t(rng.normal(size=(3, 3)))
    radii = torch.full((3, 1), 0.01)
    t_vals = _t(np.sort(rng.uniform(1, 9, size=(3, 7)), axis=-1)).requires_grad_(True)
    weights = _t(rng.uniform(size=(3, 6))).requires_grad_(True)
    for stop in (True, False):
        new_t, _ = tops.resample_along_rays(origins, dirs, radii, t_vals, weights, "cone", 0.01,
                                           stop_grad=stop)
        assert new_t.requires_grad is (not stop)
    (g,) = torch.autograd.grad(new_t.sum(), [weights])
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_random_background_matches_jax_draw():
    rng = np.random.default_rng(10)
    b, s = 4, 9
    rgb = rng.uniform(size=(3, b, s)).astype(np.float32)
    density = (rng.uniform(size=(b, s)) * 3).astype(np.float32)
    t_vals = np.sort(rng.uniform(0.5, 20, size=(b, s + 1)).astype(np.float32), axis=-1)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    key = jax.random.key(2)
    j = jops.volumetric_rendering_cm(
        jnp.asarray(rgb), jnp.asarray(density), jnp.asarray(t_vals), jnp.asarray(dirs),
        "random", key=key,
    )
    bg = np.asarray(jax.random.uniform(key, (1, 3)))
    t = tops.volumetric_rendering_cm(_t(rgb), _t(density), _t(t_vals), _t(dirs), "random",
                                     bg_color=_t(bg))
    for tv, jv in zip(t, j):
        _close(tv, jv, atol=1e-5, rtol=1e-6)
    gen = torch.Generator().manual_seed(3)
    tg = tops.volumetric_rendering_cm(_t(rgb), _t(density), _t(t_vals), _t(dirs), "random",
                                      generator=gen)
    assert bool(torch.isfinite(tg[0]).all())
