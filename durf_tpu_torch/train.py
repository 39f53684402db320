"""The training step and the eval forward (counterparts of the JAX
package's `train.py`).

The train step is eager PyTorch around the hand-written kernels: the
randomized forward (K1 and K3 through their autograd Functions), the loss
stack, `backward()` (K2 and K4), gradient hygiene (NaN scrub, value clip,
global-norm clip; reference train_boxpose.py:262-288) and Adam at the
log-lerp learning rate lr(count + 1). The schedules run on the host from the
step count. The step's randomness comes from a `torch.Generator` seeded
from (seed, step), where the JAX package folds the step into a key.

Not ported yet: the occupancy grid, checkpoints and the
training CLI, with `resolve_obj_capacity` (the auto-sizing of object-ray
compaction from scene statistics, which needs the scene data layer).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from durf_tpu_torch import mathx
from durf_tpu_torch.configs import Config
from durf_tpu_torch.devices import resolve_device
from durf_tpu_torch.losses import compute_losses, weight_l2
from durf_tpu_torch.models.mipnerf import MipNerf, obj_capacity_k
from durf_tpu_torch.rays import Rays

POSE_PARAM = "box_centers"


def make_lr_schedule(config: Config):
    return functools.partial(
        mathx.log_lerp_decay,
        v_init=config.lr_init,
        v_final=config.lr_final,
        max_steps=config.max_steps,
        delay_steps=config.lr_delay_steps,
        delay_mult=config.lr_delay_mult,
    )


def make_eps_schedule(config: Config):
    return functools.partial(
        mathx.log_lerp_decay,
        v_init=config.eps_init,
        v_final=config.eps_final,
        max_steps=config.eps_max_steps,
        delay_steps=config.eps_delay_steps,
        delay_mult=config.lr_delay_mult,
    )


def make_alpha_schedule(config: Config):
    return functools.partial(
        mathx.freq_alpha_schedule,
        alpha_init=config.alpha_init,
        alpha_final=config.alpha_final,
        delay_steps=config.alpha_delay_steps,
        max_steps=config.alpha_max_steps,
    )


def background_mode(config: Config) -> str:
    """The reference's two bools as a background mode: white wins, then
    random, else mid-gray (reference mip.py:321-326)."""
    if config.white_bkgd:
        return "white"
    return "random" if config.rand_bkgd else "gray"


class ScheduledAdam:
    """Adam with the log-lerp schedule and the pose-LR machinery of
    durf_tpu/train.py:82-156 as two parameter groups: the fields (every
    parameter but the pose table) and the pose table `box_centers`.

    optax scales Adam's update by lr(count + 1), then by pose_scale(count)
    on the pose leaves and by field_scale(count) on the others; each factor
    multiplies the update, so here each group's lr is their product at the
    update's count (torch.optim.Adam's own bias correction and moments are
    optax's: betas (0.9, 0.999), eps 1e-8).
    """

    def __init__(self, config: Config, named_params):
        self.config = config
        self.lr_fn = make_lr_schedule(config)
        fields = [p for n, p in named_params if n != POSE_PARAM]
        pose = [p for n, p in named_params if n == POSE_PARAM]
        groups = [{"params": fields, "name": "fields"}]
        if pose:
            groups.append({"params": pose, "name": "pose"})
        self.opt = torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def pose_scale(self, count: int) -> float:
        """pose_lr_mult gated by the delay, linear ramp and cosine decay
        (1-indexed like the schedules; durf_tpu/train.py:96-114)."""
        c = self.config
        delay, ramp, decay = c.pose_lr_delay_steps, max(c.pose_lr_ramp_steps, 1), c.pose_lr_decay_steps
        if not (c.pose_lr_mult != 1.0 or delay > 0 or decay > 0 or ramp > 1):
            return 1.0
        step = count + 1
        gate = min(max((step - delay) / ramp, 0.0), 1.0)
        if decay > 0:
            t = min(max((step - delay - ramp) / decay, 0.0), 1.0)
            gate = gate * 0.5 * (1.0 + math.cos(math.pi * t))
        return c.pose_lr_mult * gate

    def field_scale(self, count: int) -> float:
        """0 while the pose window is active under pose_freeze_field
        (durf_tpu/train.py:137-142), else 1."""
        c = self.config
        if not c.pose_freeze_field:
            return 1.0
        step = count + 1
        delay, ramp, decay = c.pose_lr_delay_steps, max(c.pose_lr_ramp_steps, 1), c.pose_lr_decay_steps
        active = step > delay
        if decay > 0:
            active = active and step <= delay + ramp + decay
        return 0.0 if active else 1.0

    def lrs(self, count: int) -> Dict[str, float]:
        lr = self.lr_fn(count + 1)
        return {"fields": lr * self.field_scale(count), "pose": lr * self.pose_scale(count)}

    def step(self) -> None:
        lrs = self.lrs(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lrs[group["name"]]
        self.opt.step()
        self.count += 1


def make_optimizer(config: Config, model: MipNerf) -> ScheduledAdam:
    return ScheduledAdam(config, list(model.named_parameters()))


@dataclass
class TrainState:
    step: int
    model: MipNerf
    optimizer: ScheduledAdam
    config: Config


def create_train_state(config: Config, model: MipNerf, optimizer: ScheduledAdam) -> TrainState:
    if config.model.grid_sampling:
        raise NotImplementedError("occupancy-grid sampling is not ported yet")
    return TrainState(step=0, model=model, optimizer=optimizer, config=config)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's random stream, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A host batch (numpy leaves, Rays) as float32 tensors on `device`;
    the timestep `ts` stays a python int."""
    out = {}
    for k, v in batch.items():
        if k == "ts":
            out[k] = int(v)
        elif isinstance(v, Rays):
            out[k] = v.to(device)
        elif v is not None:
            out[k] = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    return out


def make_grad_fn(model: MipNerf, config: Config, seed: int = 1):
    """fn(step, batch) -> (loss, aux, grads): the loss of the step's
    randomized forward and the raw gradient of every named parameter (zeros
    where the loss does not reach it), before any hygiene."""
    eps_fn, alpha_fn = make_eps_schedule(config), make_alpha_schedule(config)
    dynamic = config.model.dynamics and model.dynamic
    background = background_mode(config)

    def grad_fn(step: int, batch: Dict[str, Any]):
        device = batch["rays"].origins.device
        gen = step_generator(seed, step, device)
        eps, alpha = eps_fn(step + 1), alpha_fn(step + 1)
        model.train()
        for p in model.parameters():
            p.grad = None
        ts = batch.get("ts")
        out = model(
            batch["rays"], ext=batch.get("ext"), ts=ts, background=background, alpha=alpha,
            randomized=config.randomized, generator=gen,
        )
        if dynamic:
            # Previous-timestep pose for the TV loss, from the live table.
            table = model.box_centers.detach()
            prev_pose = table[ts + 1 if ts == 0 else ts - 1]
        else:
            prev_pose = torch.zeros((out[0]["pose"].shape[0], 6), device=device)
        total, aux = compute_losses(config, out, batch, prev_pose, eps)
        if config.weight_decay_mult > 0:
            total = total + config.weight_decay_mult * weight_l2(model.parameters())
        if dynamic:
            aux["obj_hit_rays"] = out[-1]["obj_hit_rays"]
        total.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()
        }
        return total.detach(), aux, grads

    return grad_fn


def make_train_step(model: MipNerf, config: Config, optimizer: ScheduledAdam, seed: int = 1):
    """fn(state, batch) -> (state, stats): one optimization step on a batch
    of device tensors (see batch_to). stats are 0-d tensors (arrays for the
    'viz/' keys) on the device; nothing here waits for the card."""
    grad_fn = make_grad_fn(model, config, seed)
    lr_fn = make_lr_schedule(config)
    eps_fn, alpha_fn = make_eps_schedule(config), make_alpha_schedule(config)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        step = state.step
        loss, aux, grads = grad_fn(step, batch)
        with torch.no_grad():
            # Gradient hygiene (reference train_boxpose.py:262-286): NaN and
            # +-Inf scrubbed to 0, value clip, global-norm clip.
            gs = [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in grads.values()]
            if config.grad_max_val > 0:
                gs = [torch.clamp(g, -config.grad_max_val, config.grad_max_val) for g in gs]
            grad_abs_max = torch.stack([g.abs().max() for g in gs]).max()
            grad_norm = torch.sqrt(sum((g**2).sum() for g in gs))
            if config.grad_max_norm > 0:
                mult = torch.clamp(config.grad_max_norm / (1e-7 + grad_norm), max=1.0)
                gs = [mult * g for g in gs]
            grad_norm_clipped = torch.sqrt(sum((g**2).sum() for g in gs))
            for p, g in zip(state.model.parameters(), gs):
                p.grad = g
        state.optimizer.step()
        state.step = step + 1

        psnrs = mathx.mse_to_psnr(aux["rgb"])
        stats = {
            "train/loss": loss,
            "train/psnr": psnrs[-1],
            "train/obj_psnr": torch.nan_to_num(
                mathx.mse_to_psnr(aux["obj_rgb"][-1]), nan=0.0, posinf=0.0
            ),
            "train/grad_norm": grad_norm,
            "train/grad_abs_max": grad_abs_max,
            "train/grad_norm_clipped": grad_norm_clipped,
            "schedule/lr": lr_fn(step + 1),
            "schedule/eps": eps_fn(step + 1),
            "schedule/alpha": alpha_fn(step + 1),
        }
        for i in range(config.model.num_levels):
            stats[f"train/psnr_level{i}"] = psnrs[i]
            for k in (
                "rgb", "depth", "near", "empty", "sky", "distortion", "tv", "centering", "obj_rgb",
            ):
                stats[f"loss/{k}_{i}"] = aux[k][i]
            stats[f"pose/offset_{i}"] = aux["offset"][i]
            stats[f"pose/offset_yaw_{i}"] = aux["offset_yaw"][i]
            stats[f"viz/t_vals_{i}"] = aux["viz_t_vals"][i]
            stats[f"viz/weights_{i}"] = aux["viz_weights"][i]
        stats["loss/box_surface"] = aux["box_surface"]
        if config.model.use_proposal:
            stats["loss/interlevel"] = aux["interlevel"]
        if "obj_hit_rays" in aux:
            # Compaction safety: rays over the obj_ray_capacity budget (> 0
            # means object content was dropped this batch).
            stats["obj/hit_frac"] = aux["obj_hit_rays"] / config.batch_size
            if config.model.obj_ray_capacity > 0.0:
                k = obj_capacity_k(config.batch_size, config.model.obj_ray_capacity)
                stats["obj/overflow_rays"] = torch.clamp(aux["obj_hit_rays"] - k, min=0.0)
        return state, stats

    return train_step


def warn_obj_overflow(host_stats: dict, step: int, log_fn=print) -> bool:
    """Print a warning when a step's obj/overflow_rays is positive: the
    rays over the compaction budget lost their object contribution
    (durf_tpu/train.py:481-500). Returns whether it warned."""
    over = host_stats.get("obj/overflow_rays", 0.0)
    if over and over > 0:
        log_fn(
            f"WARNING step {step}: obj_ray_capacity overflow — {over:.0f} rays "
            f"over budget lost their object contribution this batch "
            f"(hit_frac={host_stats.get('obj/hit_frac', float('nan')):.4f}); "
            f"raise ModelConfig.obj_ray_capacity"
        )
        return True
    return False


def make_render_fn(model: MipNerf, config: Config, device="cuda"):
    """fn(rays, ext, ts, alpha) -> last-level {'rgb', 'depth', 'acc'} for a
    chunk of rays, without gradients, on `device` (the card unless the
    caller asks for the CPU). Eval never composites a random background
    (reference train_boxpose.py:388)."""
    device = resolve_device(device)
    eval_background = "white" if config.white_bkgd else "gray"
    model = model.to(device).eval()

    def render_chunk(rays: Rays, ext, ts, alpha):
        rays = rays.to(device)
        ext_t = None if ext is None else torch.as_tensor(ext, dtype=torch.float32, device=device)
        with torch.inference_mode():
            out = model(
                rays, ext=ext_t, ts=ts, background=eval_background, alpha=alpha
            )[-1]
        return {"rgb": out["rgb"], "depth": out["depth"], "acc": out["acc"]}

    return render_chunk
