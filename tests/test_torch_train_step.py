"""One training step of the tiny flagship against the JAX package's, and a
short run that descends.

Both packages build the tiny flagship (`flagship_config(tiny=True)`) at the
kernel operating point (bf16, fused MLPs, recurrent encode), with
randomized=False so that neither draws random numbers, on the same example
batch and the same weights (bridged by params_from_flax). JAX runs its
Pallas kernels in interpret mode, the port its kernels' plain versions.

Tolerances: loss rtol 1e-3; the per-level loss, psnr, pose and schedule
stats rtol 1e-3 / atol 1e-5; the gradient statistics rtol 2e-2 (the port
rounds every MLP cotangent to bf16 as the TPU kernels do, JAX on the CPU
does not); every gradient leaf within relative L2 5e-2 of JAX's; every
parameter after the step within 2 lr(1) + 1e-6 of JAX's (Adam's first
update is ±lr per element, so a sign flip of a near-zero gradient moves an
element by 2 lr).
"""

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from durf_tpu import losses as jlosses
from durf_tpu import train as jtrain
from durf_tpu.data.synthetic import example_ray_batch as j_batch
from durf_tpu.models import construct_model as j_construct
from durf_tpu_torch.data.synthetic import example_ray_batch as t_batch
from durf_tpu_torch.entry import flagship_config, kernel_operating_point
from durf_tpu_torch.models import MipNerf, construct_model
from durf_tpu_torch.params import params_from_flax, params_to_flax
from durf_tpu_torch.train import (
    batch_to,
    create_train_state,
    make_grad_fn,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

B = 32


def _kernel_point(cfg):
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.use_pallas_mlp = True
    cfg.model.recurrent_encode = True
    cfg.randomized = False
    cfg.batch_size = B
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's step (stats, params after) and its raw gradients."""
    cfg = _kernel_point(_flagship_config(tiny=True))
    batch = j_batch(batch_size=B)
    model, variables = j_construct(jax.random.key(0), batch, cfg.model)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.create_train_state(cfg, variables, tx)
    step = jax.jit(jtrain.make_train_step(model, cfg, tx, jax.random.key(1)))
    new_state, stats = step(state, batch)

    eps = jtrain.make_eps_schedule(cfg)(1)
    alpha = jtrain.make_alpha_schedule(cfg)(1)

    def loss_fn(params):  # the loss of durf_tpu/train.py:202-236 at step 0
        out = model.apply(
            {"params": params}, rng=jax.random.key(1), rays=batch["rays"],
            init_boxes=batch["init"], ext=batch["ext"], ts=batch["ts"], randomized=False,
            background=cfg.background, alpha=alpha,
        )
        ts = int(batch["ts"])
        prev = jax.lax.stop_gradient(params["box_centers"])[ts + 1 if ts == 0 else ts - 1]
        return jlosses.compute_losses(cfg, out, batch, prev, eps)[0]

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (as_np(variables["params"]), {k: np.asarray(v) for k, v in stats.items()},
            as_np(new_state.params), as_np(grads))


def _port_model(tree):
    cfg = _kernel_point(kernel_operating_point(flagship_config(tiny=True)))
    init = t_batch(batch_size=B)["init"]
    model = MipNerf(cfg.model, init.shape[1], init.shape[0])
    model.load_state_dict(params_from_flax(tree))
    return cfg, model


@pytest.fixture(scope="module")
def steps():
    tree, j_stats, j_after, j_grads = _jax_step()
    batch = batch_to(t_batch(batch_size=B), "cpu")
    cfg, model = _port_model(tree)
    _, _, t_grads = make_grad_fn(copy.deepcopy(model), cfg)(0, batch)
    opt = make_optimizer(cfg, model)
    state, t_stats = make_train_step(model, cfg, opt)(create_train_state(cfg, model, opt), batch)
    t_after = params_to_flax(state.model.state_dict())
    return cfg, (j_stats, j_after, j_grads), (t_stats, t_after, params_to_flax(t_grads))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_step_loss_and_stats_match_jax(steps):
    _, (j_stats, _, _), (t_stats, _, _) = steps
    np.testing.assert_allclose(float(t_stats["train/loss"]), j_stats["train/loss"], rtol=1e-3)
    shared = sorted(set(j_stats) & set(t_stats))
    assert len(shared) >= 30 and {"loss/centering_0", "loss/centering_1"} <= set(shared)
    for key in shared:
        t_val = np.asarray(torch.as_tensor(t_stats[key]).detach().numpy())
        tol = dict(rtol=2e-2) if key.startswith("train/grad") else dict(rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(t_val, j_stats[key], err_msg=key, **tol)


def test_step_gradients_match_jax(steps):
    _, (_, _, j_grads), (_, _, t_grads) = steps
    j_flat, t_flat = dict(_leaves(j_grads)), dict(_leaves(t_grads))
    assert set(j_flat) == set(t_flat)
    for name, jg in j_flat.items():
        tg = t_flat[name]
        den = np.linalg.norm(jg)
        rel = np.linalg.norm(tg - jg) / den if den > 0 else np.linalg.norm(tg)
        assert rel <= 5e-2, f"{name}: relative L2 {rel}"


def test_step_parameters_match_jax(steps):
    cfg, (_, j_after, _), (_, t_after, _) = steps
    lr1 = make_lr_schedule(cfg)(1)
    for name, jp in _leaves(j_after):
        tp = dict(_leaves(t_after))[name]
        np.testing.assert_array_less(np.abs(tp - jp), 2 * lr1 + 1e-6, err_msg=name)


def test_tiny_flagship_descends_on_cpu():
    """20 randomized steps of the tiny flagship on a fixed batch at a
    constant lr of 5e-3: the loss falls (the CPU counterpart of
    chip_smoke.py's descent phase)."""
    cfg = kernel_operating_point(flagship_config(tiny=True))
    cfg.lr_init = cfg.lr_final = 5e-3
    cfg.lr_delay_steps = 0
    host = t_batch(batch_size=64)
    model = construct_model(cfg.model, host, "cpu")
    opt = make_optimizer(cfg, model)
    state, step_fn = create_train_state(cfg, model, opt), make_train_step(model, cfg, opt)
    batch = batch_to(host, "cpu")
    losses = []
    for _ in range(20):
        state, stats = step_fn(state, batch)
        losses.append(float(stats["train/loss"]))
    assert state.step == 20 and all(np.isfinite(losses))
    assert losses[-1] < 0.7 * losses[0], losses
