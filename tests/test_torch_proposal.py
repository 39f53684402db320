"""Proposal levels (ModelConfig.use_proposal) in the port against the JAX
package, on the same numpy inputs and the same weights.

(a) `losses.interlevel_loss` on random histograms with Sf != Sp: value
    and w_prop gradient rtol 1e-5; zero for identical histograms and for a
    fine histogram that refines the proposal, positive when the proposal
    misses the fine mass, no gradient into the fine weights.
(b) The tiny flagship with proposal levels (a 2x16 / 8 ProposalMLP),
    weights bridged by params_from_flax, randomized=False, per level: in
    float32 without kernels atol 1e-4 (depth and t_vals rtol 1e-4 plus atol
    1e-3), in bf16 with the fused MLPs (JAX: Pallas in interpret mode;
    port: the kernels' plain versions) atol 2e-2; at proposal_samples 0
    and 12 (the final level keeps num_samples = 8).
(c) One training step at the kernel operating point: loss and
    loss/interlevel rtol 1e-3, every gradient leaf (the proposal MLP's
    included) within relative L2 5e-2 of JAX's, as test_torch_train_step.
(d) The proposal MLP's weights: bit-exact params round trip, drawn after
    every other leaf, in the optimizer's "fields" group.
(e) configs/waymo_fast.gin parses to the same model fields in both
    packages and builds in the port; the entry points take
    `proposal=True` on the CPU and raise without a card by default.
"""

import copy
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from durf_tpu import losses as jlosses
from durf_tpu import train as jtrain
from durf_tpu.configs import MLPConfig as JMLPConfig
from durf_tpu.configs import load_config as j_load_config
from durf_tpu.data.synthetic import example_ray_batch as j_batch
from durf_tpu.models import construct_model as j_construct
from durf_tpu_torch import losses as tlosses
from durf_tpu_torch.configs import MLPConfig
from durf_tpu_torch.configs import load_config as t_load_config
from durf_tpu_torch.data.synthetic import example_ray_batch as t_batch
from durf_tpu_torch.entry import flagship_config, kernel_operating_point, with_proposal
from durf_tpu_torch.models import MipNerf, construct_model
from durf_tpu_torch.params import params_from_flax, params_to_flax
from durf_tpu_torch.train import (
    batch_to,
    create_train_state,
    make_grad_fn,
    make_optimizer,
    make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
PROPOSAL = dict(net_depth=2, net_width=16, net_width_condition=8)
KEYS = ("rgb", "depth", "acc", "weights", "t_vals")


# ---- (a) interlevel_loss ----


def _hist(seed, b, s, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(lo, hi, (b, s + 1)), axis=-1).astype(np.float32)
    return t, rng.uniform(0, 1, (b, s)).astype(np.float32)


def _both(t_f, w_f, t_p, w_p):
    """(JAX value, JAX d w_prop, port value, port d w_prop)."""
    j_val, j_grad = jax.value_and_grad(
        lambda w: jlosses.interlevel_loss(jnp.asarray(t_f), jnp.asarray(w_f), jnp.asarray(t_p), w)
    )(jnp.asarray(w_p))
    w = torch.from_numpy(w_p).requires_grad_(True)
    t_val = tlosses.interlevel_loss(
        torch.from_numpy(t_f), torch.from_numpy(w_f), torch.from_numpy(t_p), w
    )
    t_val.backward()
    return float(j_val), np.asarray(j_grad), float(t_val.detach()), w.grad.numpy()


@pytest.mark.parametrize("sf,sp,scale", [(9, 6, 1.0), (6, 9, 1.0), (16, 24, 0.01), (128, 64, 0.1)])
def test_interlevel_matches_jax(sf, sp, scale):
    t_f, w_f = _hist(sf, 4, sf)
    t_p, w_p = _hist(100 + sp, 4, sp)
    w_p = (w_p * scale).astype(np.float32)  # small proposal mass: most bins penalised
    j_val, j_grad, t_val, t_grad = _both(t_f, w_f, t_p, w_p)
    assert j_val > 0.0
    np.testing.assert_allclose(t_val, j_val, rtol=1e-5)
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-5, atol=1e-7)


def test_interlevel_special_cases():
    """The JAX package's own cases: zero for identical histograms (to
    squared-ulp), zero when the fine histogram refines the proposal,
    positive when the proposal misses the fine mass; the fine weights get
    no gradient."""
    il = lambda *a: float(tlosses.interlevel_loss(*map(torch.from_numpy, a)))  # noqa: E731
    t, w = _hist(3, 2, 8)
    assert il(t, w, t, w) < 1e-12
    t_p = np.array([[0.0, 2.0, 4.0, 8.0]], np.float32)
    w_p = np.array([[0.5, 0.3, 0.2]], np.float32)
    t_f = np.array([[0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0]], np.float32)
    w_f = np.array([[0.25, 0.25, 0.1, 0.2, 0.1, 0.1]], np.float32)
    assert il(t_f, w_f, t_p, w_p) == 0.0
    t2 = np.array([[0.0, 1.0, 2.0]], np.float32)
    assert il(t2, np.array([[0.0, 1.0]], np.float32), t2, np.array([[1.0, 0.0]], np.float32)) > 0.1
    t_f, w_f = _hist(11, 2, 9)
    t_p, w_p = _hist(23, 2, 5)
    w_fine = torch.from_numpy(w_f).requires_grad_(True)
    w_prop = torch.from_numpy(w_p * 0.01).requires_grad_(True)
    tlosses.interlevel_loss(torch.from_numpy(t_f), w_fine, torch.from_numpy(t_p), w_prop).backward()
    assert w_fine.grad is None and float(w_prop.grad.abs().sum()) > 0.0


# ---- (b) per-level outputs ----


def _configs(case, proposal_samples):
    jcfg, tcfg = _flagship_config(tiny=True), flagship_config(tiny=True)
    for cfg, mlp in ((jcfg, JMLPConfig), (tcfg, MLPConfig)):
        cfg.model.use_proposal = True
        cfg.model.proposal_samples = proposal_samples
        cfg.model.proposal_mlp = mlp(**PROPOSAL)
        if case == "kernels":
            cfg.model.compute_dtype = "bfloat16"
            cfg.model.use_pallas_mlp = True
            cfg.model.recurrent_encode = True
            cfg.randomized = False
            cfg.batch_size = B
    return jcfg, tcfg


def _port_model(tcfg, tree, init):
    model = MipNerf(tcfg.model, init.shape[1], init.shape[0])
    model.load_state_dict(params_from_flax(tree))
    return model


@functools.lru_cache(maxsize=None)
def _levels(case, proposal_samples):
    jcfg, tcfg = _configs(case, proposal_samples)
    jb, tb = j_batch(batch_size=B), t_batch(batch_size=B)
    model, variables = j_construct(jax.random.key(0), jb, jcfg.model)
    tree = jax.tree.map(np.asarray, variables["params"])
    j_out = model.apply(
        variables, rng=None, rays=jb["rays"], init_boxes=jb["init"], ext=jb["ext"], ts=jb["ts"],
        randomized=False, background="gray", alpha=10.0,
    )
    t_model = _port_model(tcfg, tree, tb["init"]).eval()
    with torch.no_grad():
        t_out = t_model(tb["rays"].to("cpu"), ext=torch.from_numpy(tb["ext"]), ts=int(tb["ts"]),
                        alpha=10.0)
    return tree, j_out, t_out


@pytest.mark.parametrize("case", ["float32", "kernels"])
@pytest.mark.parametrize("proposal_samples", [0, 12])
def test_proposal_levels_match_jax(case, proposal_samples):
    tree, j_out, t_out = _levels(case, proposal_samples)
    assert "proposal_mlp" in tree and len(t_out) == len(j_out) == 2
    assert t_out[0]["weights"].shape == (B, proposal_samples or 8)
    assert t_out[1]["weights"].shape == (B, 8)
    for level in (0, 1):
        for key in KEYS:
            if case == "kernels":
                tol = dict(atol=2e-2, rtol=0.0)
            elif key in ("depth", "t_vals"):
                tol = dict(atol=1e-3, rtol=1e-4)
            else:
                tol = dict(atol=1e-4, rtol=0.0)
            np.testing.assert_allclose(
                t_out[level][key].numpy(), np.asarray(j_out[level][key]),
                err_msg=f"{case} level {level} {key}", **tol,
            )


def test_final_level_runs_the_background_mlp():
    """A changed background MLP leaves the proposal level's weights bitwise
    as they were and moves the final level (the port's counterpart of
    tests/test_proposal.py's check)."""
    tree, _, t_out = _levels("float32", 0)
    _, tcfg = _configs("float32", 0)
    init = t_batch(batch_size=B)["init"]
    model = _port_model(tcfg, tree, init).eval()
    with torch.no_grad():
        for p in model.background_mlp.parameters():
            p.add_(0.05)
    tb = t_batch(batch_size=B)
    with torch.no_grad():
        out = model(tb["rays"].to("cpu"), ext=torch.from_numpy(tb["ext"]), ts=int(tb["ts"]),
                    alpha=10.0)
    assert torch.equal(out[0]["weights"], t_out[0]["weights"])
    assert float((out[1]["rgb"] - t_out[1]["rgb"]).abs().max()) > 0.0


# ---- (c) one training step ----


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def step():
    jcfg, tcfg = _configs("kernels", 0)
    jb = j_batch(batch_size=B)
    model, variables = j_construct(jax.random.key(0), jb, jcfg.model)
    # A denser final level than the proposal's at initialisation, so the
    # interlevel loss is positive and reaches the proposal MLP.
    tree = jax.tree.map(np.array, variables["params"])
    tree["background_mlp"]["density_head"]["bias"] += 4.0
    eps = jtrain.make_eps_schedule(jcfg)(1)
    alpha = jtrain.make_alpha_schedule(jcfg)(1)

    def loss_fn(params):  # the loss of durf_tpu/train.py:202-236 at step 0
        out = model.apply(
            {"params": params}, rng=jax.random.key(1), rays=jb["rays"], init_boxes=jb["init"],
            ext=jb["ext"], ts=jb["ts"], randomized=False, background=jcfg.background, alpha=alpha,
        )
        ts = int(jb["ts"])
        prev = jax.lax.stop_gradient(params["box_centers"])[ts + 1 if ts == 0 else ts - 1]
        total, aux = jlosses.compute_losses(jcfg, out, jb, prev, eps)
        return total, aux["interlevel"]

    (j_loss, j_inter), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree)
    )
    tcfg = kernel_operating_point(tcfg)
    model_t = _port_model(tcfg, tree, t_batch(batch_size=B)["init"])
    batch = batch_to(t_batch(batch_size=B), "cpu")
    t_loss, t_aux, t_grads = make_grad_fn(copy.deepcopy(model_t), tcfg)(0, batch)
    opt = make_optimizer(tcfg, model_t)
    _, stats = make_train_step(model_t, tcfg, opt)(create_train_state(tcfg, model_t, opt), batch)
    return ((float(j_loss), float(j_inter), jax.tree.map(np.asarray, j_grads)),
            (float(t_loss), float(t_aux["interlevel"]), params_to_flax(t_grads), stats))


def test_step_loss_and_interlevel_match_jax(step):
    (j_loss, j_inter, _), (t_loss, t_inter, _, stats) = step
    assert j_inter > 0.0
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-3)
    np.testing.assert_allclose(t_inter, j_inter, rtol=1e-3)
    # The train step logs it (durf_tpu/train.py:312-313), from the same loss.
    np.testing.assert_allclose(float(stats["loss/interlevel"]), j_inter, rtol=1e-3)
    np.testing.assert_allclose(float(stats["train/loss"]), j_loss, rtol=1e-3)


def test_step_gradients_match_jax(step):
    (_, _, j_grads), (_, _, t_grads, _) = step
    j_flat, t_flat = dict(_leaves(j_grads)), dict(_leaves(t_grads))
    assert set(j_flat) == set(t_flat)
    prop = [n for n in j_flat if n.startswith("proposal_mlp/")]
    assert len(prop) == 2 * (PROPOSAL["net_depth"] + 4)  # trunk, density, bottleneck, head_0, rgb
    assert any(np.linalg.norm(j_flat[n]) > 0 for n in prop)
    for name, jg in j_flat.items():
        tg = t_flat[name]
        den = np.linalg.norm(jg)
        rel = np.linalg.norm(tg - jg) / den if den > 0 else np.linalg.norm(tg)
        assert rel <= 5e-2, f"{name}: relative L2 {rel}"


# ---- (d) the proposal MLP's weights ----


def test_proposal_params_round_trip_bit_exact():
    tree, _, _ = _levels("float32", 0)
    back = params_to_flax(params_from_flax(tree))
    assert set(back["proposal_mlp"]) == set(tree["proposal_mlp"])
    for name, leaf in _leaves(tree):
        got = dict(_leaves(back))[name]
        assert got.dtype == leaf.dtype and np.array_equal(got, leaf), name


def test_proposal_weights_draw_last_and_train_as_fields():
    """Turning proposal levels on leaves every other weight of a seed
    bitwise as it was; the proposal MLP's leaves go into the "fields" group
    of the optimizer."""
    host = t_batch(batch_size=B)
    base = kernel_operating_point(flagship_config(tiny=True))
    prop = with_proposal(copy.deepcopy(base), True)
    prop.model.proposal_mlp = MLPConfig(**PROPOSAL)
    m0 = construct_model(base.model, host, "cpu", seed=3)
    m1 = construct_model(prop.model, host, "cpu", seed=3)
    s0, s1 = m0.state_dict(), m1.state_dict()
    assert set(s1) - set(s0) == {k for k in s1 if k.startswith("proposal_mlp.")} != set()
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    param_groups = make_optimizer(prop, m1).opt.param_groups
    groups = {g["name"]: {id(p) for p in g["params"]} for g in param_groups}
    prop_ids = {id(p) for p in m1.proposal_mlp.parameters()}
    assert prop_ids <= groups["fields"] and not prop_ids & groups["pose"]


# ---- (e) configs/waymo_fast.gin and the entry points ----


def test_waymo_fast_gin_matches_and_is_supported():
    path = os.path.join(REPO, "configs", "waymo_fast.gin")
    jm, tm = j_load_config([path]).model, t_load_config([path]).model
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.use_proposal and tm.proposal_mlp.net_depth == 4 and tm.proposal_mlp.net_width == 128
    assert tm.samples_per_ray() == jm.samples_per_ray() == 256
    assert MipNerf(tm, 2, 5).use_proposal  # the port builds the preset's model


def test_entry_points_take_proposal_on_cpu():
    """train_entry and entry with proposal=True at the flagship widths on a
    few rays: the 4x128 proposal MLP on level 0, a finite step logging
    loss/interlevel, a finite render."""
    from durf_tpu_torch.entry import entry, train_entry

    step_fn, state, batch = train_entry("cpu", batch_size=8, proposal=True, proposal_samples=64)
    assert state.model.proposal_mlp.config.net_width == 128
    state, stats = step_fn(state, batch)
    assert state.step == 1 and float(stats["loss/interlevel"]) >= 0.0
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in stats.values())
    # The 64-sample proposal histogram padded to the final level's 128.
    assert stats["viz/weights_0"].shape == (128,) and stats["viz/t_vals_0"].shape == (129,)
    assert float(stats["viz/weights_0"][64:].abs().sum()) == 0.0
    forward, (rays, ext, ts) = entry("cpu", proposal=True)
    rgb, depth, acc = forward(rays.map(lambda r: r[:4]), ext, ts)
    assert rgb.shape == (4, 3) and bool(torch.isfinite(rgb).all())
    assert bool(torch.isfinite(depth).all() and torch.isfinite(acc).all())


def test_entry_points_with_proposal_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    from durf_tpu_torch.entry import entry, train_entry

    with pytest.raises(RuntimeError, match="CUDA"):
        entry(proposal=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry(proposal=True, proposal_samples=64)
