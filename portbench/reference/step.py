"""The plain reference of the training step and the eval render: the loss
stack, gradient hygiene and Adam with its schedules, frozen from the port's
`losses.py` and `train.py` (one process) in plain PyTorch.

A step: the randomized forward drawing from a generator seeded from (seed,
step) on the rays' device, as the port's step seeds its own; the per-level
loss stack (RGB, URF depth / near / empty, sky, distortion, pose TV,
centering, box surface, interlevel); backward; NaN scrub, value clip and
global-norm clip; Adam at the log-lerp learning rate with the pose group's
scale.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from portbench.reference.nerf import MipNerf, Rays, axis_angle_to_matrix

POSE_PARAM = "box_centers"


def log_lerp_decay(step, v_init, v_final, max_steps, delay_steps=0, delay_mult=1.0):
    step = float(step)
    if delay_steps > 0:
        ramp = min(max(step / delay_steps, 0.0), 1.0)
        rate = delay_mult + (1 - delay_mult) * math.sin(0.5 * math.pi * ramp)
    else:
        rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return rate * math.exp(math.log(v_init) * (1 - t) + math.log(v_final) * t)


def alpha_schedule(step, c):
    step = float(step)
    if step < c["alpha_delay_steps"]:
        return float(c["alpha_init"])
    if step < c["alpha_max_steps"]:
        return (step - c["alpha_delay_steps"]) / (c["alpha_max_steps"] - c["alpha_delay_steps"]) * c["alpha_final"]
    return float(c["alpha_final"])


def lr_at(step, c):
    return log_lerp_decay(step, c["lr_init"], c["lr_final"], c["max_steps"], c["lr_delay_steps"],
                          c["lr_delay_mult"])


def eps_at(step, c):
    return log_lerp_decay(step, c["eps_init"], c["eps_final"], c["eps_max_steps"], c["eps_delay_steps"],
                          c["lr_delay_mult"])


def background_mode(c) -> str:
    if c["white_bkgd"]:
        return "white"
    return "random" if c["rand_bkgd"] else "gray"


# --- losses -------------------------------------------------------------------

def distortion_loss(weights, t_mids, t_dists, exact):
    if exact:
        w_ij = weights[..., :, None] * weights[..., None, :]
        term1 = (w_ij * torch.abs(t_mids[..., :, None] - t_mids[..., None, :])).sum()
    else:
        w_cum = torch.cumsum(weights, dim=-1) - weights
        ws_cum = torch.cumsum(weights * t_mids, dim=-1) - weights * t_mids
        term1 = 2.0 * (weights * (t_mids * w_cum - ws_cum)).sum()
    return term1 + (1.0 / 3.0) * (weights**2 * t_dists).sum()


def interlevel_loss(t_fine, w_fine, t_prop, w_prop, eps=1e-6):
    t_fine, w_fine = t_fine.detach(), w_fine.detach()
    a, b = t_fine[:, :-1, None], t_fine[:, 1:, None]
    overlap = (t_prop[:, None, 1:] > a) & (t_prop[:, None, :-1] < b)
    outer = (overlap * w_prop[:, None, :]).sum(dim=-1)
    return (torch.clamp(w_fine - outer, min=0.0) ** 2 / (w_fine + eps)).mean()


def near_target(t0, gt_depth, depth_mask, eps):
    depth_t = gt_depth[..., None].expand(t0.shape)
    sigma = (eps / 3.0) ** 2
    mask_near = ((t0 > depth_t - eps) & (t0 < depth_t + eps)).to(t0.dtype) * depth_mask[..., None]
    dist = mask_near * (t0 - depth_t)
    distr = (1.0 / (sigma * math.sqrt(2 * math.pi))) * torch.exp(-(dist**2) / (2 * sigma**2))
    return mask_near, distr


def box_surface_loss(rays, gt_depth, pose, rot, ext, margin, inst=None, obj_ids=None):
    p = rays.origins + rays.directions * gt_depth[:, None]
    x = torch.einsum("oij,boj->boi", axis_angle_to_matrix(rot), p[:, None, :] - pose[None])
    q = torch.abs(x) - ext[None]
    sdf = torch.sqrt((torch.clamp(q, min=0.0) ** 2).sum(-1) + 1e-12) + torch.clamp(q.max(-1).values, max=0.0)
    keep = (gt_depth > 0.0)[:, None] & (torch.abs(sdf.detach()) < margin)
    if inst is not None and obj_ids is not None:
        keep = keep & (inst.reshape(-1, 1) == obj_ids[None, :])
    keep = keep.to(torch.float32)
    return ((keep * sdf**2).sum(0) / torch.clamp(keep.sum(0), min=1.0)).sum()


def _squeeze(t):
    return t.squeeze(-1) if t.dim() > 1 else t


def compute_losses(c, levels: List[Dict[str, Any]], batch, prev_pose, eps):
    """The total loss of a forward's levels (one process)."""
    m = c["model"]
    rays = batch["rays"]
    pixels = batch["pixels"][..., :3]
    gt_depth, gt_sky = _squeeze(batch["depth"]), _squeeze(batch["sky"])
    mask = torch.ones_like(rays.lossmult) if c["disable_multiscale_loss"] else rays.lossmult
    depth_valid = (gt_depth > 0.0).float()
    sky_valid = (gt_sky > 0.0).float()
    sky_valid = sky_valid - depth_valid * sky_valid
    rgb_count, sky_count = mask.sum(), sky_valid.sum()
    per: Dict[str, list] = {k: [] for k in ("rgb", "depth", "near", "empty", "sky", "distortion",
                                            "tv", "centering")}
    for lv in levels:
        weights, t0 = lv["weights"], lv["t_vals"][:, :-1]
        dyn_mask = lv["dyn_mask"]
        box_mask = (gt_depth < lv["z_out"]).float()
        depth_mask = depth_valid + c["box_loss_mult"] * dyn_mask.squeeze(-1) * box_mask
        mask_near, distr = near_target(t0, gt_depth, depth_mask, eps)
        denom = torch.clamp(depth_mask.sum(), min=1.0)
        mask_empty = (t0 > gt_depth[..., None] + eps).float() * depth_mask[..., None]
        distr = distr / distr.max() * mask_near
        per["near"].append(((mask_near * weights - distr) ** 2).sum() / denom)
        per["empty"].append(((mask_empty * weights) ** 2).sum() / denom)
        per["depth"].append((depth_mask * (lv["depth"] - gt_depth) ** 2).sum() / denom)
        sky_depth = sky_valid * (1.0 - 1.0 / torch.clamp(sky_valid * lv["depth"], min=1.0))
        per["sky"].append(((sky_valid * (sky_depth - gt_sky)) ** 2).sum() / torch.clamp(sky_count, min=1.0))
        per["tv"].append(((lv["pose"] - prev_pose[:, :3]) ** 2).sum())
        per["centering"].append((lv["obj_centroid"] ** 2).sum() if "obj_centroid" in lv
                                else lv["rgb"].new_zeros(()))
        per["distortion"].append(distortion_loss(weights, lv["t_mids"], lv["t_dists"], c["exact_distortion"]))
        rgb_weight = mask + c["box_loss_mult"] * dyn_mask * box_mask[..., None]
        per["rgb"].append((rgb_weight * (lv["rgb"] - pixels) ** 2).sum() / rgb_count)
    aux = {k: torch.stack(v) for k, v in per.items()}
    ext = batch.get("ext")
    if c["box_surface_loss_mult"] > 0.0 and ext is not None:
        surface = box_surface_loss(rays, gt_depth, levels[-1]["pose"], levels[-1]["rot"], ext,
                                   c["box_surface_margin"], batch.get("inst"), batch.get("obj_ids"))
    else:
        surface = levels[-1]["rgb"].new_zeros(())
    use_prop = m["use_proposal"] and len(levels) > 1
    if use_prop:
        f = levels[-1]
        interlevel = torch.stack([interlevel_loss(f["t_vals"], f["weights"], lv["t_vals"], lv["weights"])
                                  for lv in levels[:-1]]).sum()
    else:
        interlevel = surface.new_zeros(())

    def agg(vals, final_mult, coarse_mult, rgb_dependent=False):
        if use_prop and rgb_dependent:
            coarse_mult = 0.0
        return final_mult * vals[-1] + coarse_mult * vals[:-1].sum()

    total = agg(aux["rgb"], 1.0, c["coarse_loss_mult"], rgb_dependent=True)
    total = total + agg(aux["sky"], 10.0 * c["sky_loss_mult"], c["sky_loss_mult"])
    total = total + agg(aux["depth"], c["depth_loss_mult"], 0.1 * c["depth_loss_mult"])
    total = total + agg(aux["near"], c["near_loss_mult"], 0.1 * c["near_loss_mult"])
    total = total + agg(aux["empty"], c["empty_loss_mult"], 0.1 * c["empty_loss_mult"])
    total = total + agg(aux["tv"], c["tv_loss_mult"], 0.1 * c["tv_loss_mult"])
    total = total + agg(aux["centering"], c["centering_loss_mult"], 0.1 * c["centering_loss_mult"])
    total = total + agg(aux["distortion"], c["distortion_loss_mult"], c["distortion_loss_mult"])
    total = total + c["box_surface_loss_mult"] * surface
    return total + c["proposal_loss_mult"] * interlevel


# --- the step -----------------------------------------------------------------

class ScheduledAdam:
    """Adam (betas 0.9 / 0.999, eps 1e-8) in two groups, the fields and the
    pose table, each at lr(count + 1) times its group's scale; `count`
    starts at `start` (the schedules' step), the moments at zero."""

    def __init__(self, c, named_params, start: int = 0):
        self.c = c
        fields = [p for n, p in named_params if n != POSE_PARAM]
        pose = [p for n, p in named_params if n == POSE_PARAM]
        groups = [{"params": fields, "name": "fields"}]
        if pose:
            groups.append({"params": pose, "name": "pose"})
        self.opt = torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.count = start

    def _window(self, count):
        c = self.c
        return c["pose_lr_delay_steps"], max(c["pose_lr_ramp_steps"], 1), c["pose_lr_decay_steps"], count + 1

    def pose_scale(self, count):
        c = self.c
        delay, ramp, decay, step = self._window(count)
        if not (c["pose_lr_mult"] != 1.0 or delay > 0 or decay > 0 or ramp > 1):
            return 1.0
        gate = min(max((step - delay) / ramp, 0.0), 1.0)
        if decay > 0:
            gate *= 0.5 * (1.0 + math.cos(math.pi * min(max((step - delay - ramp) / decay, 0.0), 1.0)))
        return c["pose_lr_mult"] * gate

    def field_scale(self, count):
        if not self.c["pose_freeze_field"]:
            return 1.0
        delay, ramp, decay, step = self._window(count)
        active = step > delay and (decay <= 0 or step <= delay + ramp + decay)
        return 0.0 if active else 1.0

    def step(self):
        lr = lr_at(self.count + 1, self.c)
        scales = {"fields": self.field_scale(self.count), "pose": self.pose_scale(self.count)}
        for g in self.opt.param_groups:
            g["lr"] = lr * scales[g["name"]]
        self.opt.step()
        self.count += 1


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def train_step(model: MipNerf, opt: ScheduledAdam, c, batch, step: int, seed: int,
               precision="float32", remat=True, capacity=0.0):
    """One optimization step; returns (loss, {name: gradient as Adam gets
    it})."""
    m = c["model"]
    gen = step_generator(seed, step, batch["rays"].origins.device)
    eps, alpha = eps_at(step + 1, c), alpha_schedule(step + 1, c)
    model.train()
    for p in model.parameters():
        p.grad = None
    ts = batch.get("ts")
    levels = model(batch["rays"], ext=batch.get("ext"), ts=ts, background=background_mode(c),
                   alpha=alpha, randomized=c["randomized"], generator=gen, precision=precision,
                   remat=remat, capacity=capacity)
    dynamic = m["dynamics"] and model.dynamic
    if dynamic:
        table = model.box_centers.detach()
        prev_pose = table[ts + 1 if ts == 0 else ts - 1]
    else:
        prev_pose = torch.zeros((levels[0]["pose"].shape[0], 6), device=levels[0]["rgb"].device)
    total = compute_losses(c, levels, batch, prev_pose, eps)
    if c["weight_decay_mult"] > 0:
        params = list(model.parameters())
        total = total + c["weight_decay_mult"] * sum((p**2).sum() for p in params) / sum(
            p.numel() for p in params)
    total.backward()
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in model.parameters()]
        gs = [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in gs]
        if c["grad_max_val"] > 0:
            gs = [torch.clamp(g, -c["grad_max_val"], c["grad_max_val"]) for g in gs]
        if c["grad_max_norm"] > 0:
            norm = torch.sqrt(sum((g**2).sum() for g in gs))
            gs = [torch.clamp(c["grad_max_norm"] / (1e-7 + norm), max=1.0) * g for g in gs]
        for p, g in zip(model.parameters(), gs):
            p.grad = g
    opt.step()
    return float(total.detach()), dict(zip(names, gs))


def render_rays(model: MipNerf, c, rays: Rays, ext, ts, alpha, precision="float32", capacity=0.0):
    """The eval forward of a chunk: the last level's rgb, depth and acc."""
    model.eval()
    with torch.no_grad():
        out = model(rays, ext=ext, ts=ts, background="white" if c["white_bkgd"] else "gray",
                    alpha=alpha, precision=precision, capacity=capacity)[-1]
    return {"rgb": out["rgb"], "depth": out["depth"], "acc": out["acc"]}
