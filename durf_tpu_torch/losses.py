"""The training loss stack: RGB, URF depth/near/empty, sky, distortion, pose
TV, box surface and the proposal levels' interlevel loss.

Counterpart of the JAX package's `losses.py` (reference
train_boxpose.py:67-252), with the same documented departures: the
distortion regularizer defaults to the O(S) cumulative-sum form
(`exact=True` gives the reference's O(S^2) form), and the box boost of the
depth mask is computed per level.

Under a data-parallel group (`group`, parallel.Group) each rank returns
its contribution to the loss of the global batch, so that the sum over the
ranks is the one-process loss and the sum of the ranks' gradients its
gradient: ratio-of-sums losses divide by denominators summed over the
group (all of a step's in one all-reduce), batch means divide by the world
size, sums stay as they are, terms that do not depend on the batch count
on rank 0 alone, and the centering prior counts its global value once.
One process is the group of one rank, for which all of that is the
identity.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from durf_tpu_torch import ops
from durf_tpu_torch.parallel.group import Group


def weight_l2(params) -> torch.Tensor:
    """Mean squared parameter value over an iterable of tensors (reference
    train_boxpose.py:69-75)."""
    params = list(params)
    total = sum((p**2).sum() for p in params)
    return total / sum(p.numel() for p in params)


def distortion_loss(weights, t_mids, t_dists, exact: bool = False) -> torch.Tensor:
    """Mip-NeRF 360 distortion: E_{i,j}[w_i w_j |s_i - s_j|] + (1/3) Σ w² Δs.

    weights, t_mids (sorted ascending), t_dists: [B, S]. `exact` uses the
    O(S²) double sum (reference train_boxpose.py:146-153); otherwise the
    sorted identity Σ_ij w_i w_j |s_i−s_j| = 2 Σ_i w_i (s_i W_<i − C_<i).
    """
    if exact:
        w_ij = weights[..., :, None] * weights[..., None, :]
        s_ij = torch.abs(t_mids[..., :, None] - t_mids[..., None, :])
        term1 = (w_ij * s_ij).sum()
    else:
        w_cum = torch.cumsum(weights, dim=-1) - weights
        ws_cum = torch.cumsum(weights * t_mids, dim=-1) - weights * t_mids
        term1 = 2.0 * (weights * (t_mids * w_cum - ws_cum)).sum()
    term2 = (1.0 / 3.0) * (weights**2 * t_dists).sum()
    return term1 + term2


def interlevel_loss(t_fine, w_fine, t_prop, w_prop, eps: float = 1e-6) -> torch.Tensor:
    """Proposal distillation (durf_tpu/losses.py:58-102): the mean of
    clip(w_fine - outer, 0)^2 / (w_fine + eps), where `outer` is, for each
    fine interval, the proposal weight over every proposal interval that
    intersects it. The fine inputs are detached, so the loss trains the
    proposal toward the fine histogram, never the reverse.

    The overlap is a dense [B, Sf, Sp] mask, as in the reference; it is
    contracted with w_prop by a float32 product and sum (the reference's
    HIGHEST precision: no TF32, no bf16).

    t_fine: [B, Sf+1], w_fine: [B, Sf]; t_prop: [B, Sp+1], w_prop: [B, Sp].
    """
    t_fine, w_fine = t_fine.detach(), w_fine.detach()
    a, b = t_fine[:, :-1, None], t_fine[:, 1:, None]  # [B, Sf, 1]
    overlap = (t_prop[:, None, 1:] > a) & (t_prop[:, None, :-1] < b)  # [B, Sf, Sp]
    outer = (overlap * w_prop[:, None, :]).sum(dim=-1)
    return (torch.clamp(w_fine - outer, min=0.0) ** 2 / (w_fine + eps)).mean()


def near_target(t0_vals, gt_depth, depth_mask, eps):
    """The 'near' loss's target before its peak normalization: (mask_near,
    the samples within ±eps of the GT depth on valid-depth rays; a Gaussian
    of width eps/3 around the GT depth, 1/(sigma sqrt(2 pi)) where
    mask_near is 0). t0_vals: [B, S]; gt_depth, depth_mask: [B]."""
    depth_t = gt_depth[..., None].expand(t0_vals.shape)
    sigma = (eps / 3.0) ** 2
    mask_near = ((t0_vals > depth_t - eps) & (t0_vals < depth_t + eps)).to(t0_vals.dtype)
    mask_near = mask_near * depth_mask[..., None]
    dist = mask_near * (t0_vals - depth_t)
    distr = (1.0 / (sigma * math.sqrt(2 * math.pi))) * torch.exp(-(dist**2) / (2 * sigma**2))
    return mask_near, distr


def urf_depth_losses(weights, t0_vals, depth, gt_depth, depth_mask, eps):
    """URF LIDAR supervision (reference train_boxpose.py:155-175): depth
    MSE, 'near' (near_target over its peak) and 'empty' (weight beyond
    depth + eps), each normalized by the number of valid-depth rays.

    weights, t0_vals: [B, S]; depth, gt_depth, depth_mask: [B]; eps: float.
    Returns (depth_mse, near_loss, empty_loss).
    """
    target = near_target(t0_vals, gt_depth, depth_mask, eps)
    totals = (depth_mask.sum(), target[1].max())
    return _urf_losses(weights, t0_vals, depth, gt_depth, depth_mask, eps, target, totals)


def _urf_losses(weights, t0_vals, depth, gt_depth, depth_mask, eps, target, totals):
    """urf_depth_losses on near_target's `target` and `totals`, (the number
    of valid-depth rays, the target's peak): the batch's, or under a group
    the global batch's (compute_losses)."""
    mask_near, distr = target
    count, peak = totals
    denom = torch.clamp(count, min=1.0)
    mask_empty = (t0_vals > gt_depth[..., None] + eps).to(weights.dtype) * depth_mask[..., None]
    distr = distr / peak
    distr = distr * mask_near

    near_loss = ((mask_near * weights - distr) ** 2).sum() / denom
    empty_loss = ((mask_empty * weights) ** 2).sum() / denom
    depth_mse = (depth_mask * (depth - gt_depth) ** 2).sum() / denom
    return depth_mse, near_loss, empty_loss


def sky_loss(depth, sky_mask, gt_sky, count=None) -> torch.Tensor:
    """sky_depth = 1 - 1/max(depth, 1) on sky rays, regressed to the
    dataset's sky constant (reference train_boxpose.py:186-189), over the
    number of sky rays: this batch's by default, the global batch's from
    compute_losses."""
    denom = torch.clamp(sky_mask.sum() if count is None else count, min=1.0)
    sky_depth = sky_mask * (1.0 - (1.0 / torch.clamp(sky_mask * depth, min=1.0)))
    return ((sky_mask * (sky_depth - gt_sky)) ** 2).sum() / denom


def box_surface_loss(rays, gt_depth, pose, rot, ext, margin: float, inst=None, obj_ids=None,
                     group: Group = Group()):
    """Depth-point-to-box-surface pose prior (Config.box_surface_loss_mult;
    durf_tpu/losses.py:162-223): LIDAR points o + d * t_gt mapped into each
    object's frame at the optimized pose; points within `margin` of the box
    surface are regressed onto it by the squared box SDF. With `inst` [B, 1]
    and `obj_ids` [N_obj] only rays whose instance id matches the object
    are kept. Returns the mean squared SDF over kept points, summed over
    objects (under a group, over the global batch's kept points)."""
    p = rays.origins + rays.directions * gt_depth[:, None]  # [B, 3]
    rmat = ops.axis_angle_to_matrix(rot)  # [N_obj, 3, 3] world->object
    x = torch.einsum("oij,boj->boi", rmat, p[:, None, :] - pose[None, :, :])
    q = torch.abs(x) - ext[None]
    # The 1e-12 floor keeps the interior gradient 0 instead of 0/0.
    out_dist = torch.sqrt((torch.clamp(q, min=0.0) ** 2).sum(dim=-1) + 1e-12)
    sdf = out_dist + torch.clamp(q.max(dim=-1).values, max=0.0)  # [B, N_obj]
    keep = (gt_depth > 0.0)[:, None] & (torch.abs(sdf.detach()) < margin)
    if inst is not None and obj_ids is not None:
        keep = keep & (inst.reshape(-1, 1) == obj_ids[None, :])
    keep = keep.to(torch.float32)
    per_obj = (keep * sdf**2).sum(dim=0) / torch.clamp(group.all_sum(keep.sum(dim=0)), min=1.0)
    return per_obj.sum()


_PER_LEVEL = (
    "rgb", "obj_rgb", "depth", "near", "empty", "sky", "distortion", "tv", "centering",
    "offset", "offset_x", "offset_y", "offset_z", "offset_yaw",
)


def _squeeze(t):
    return t.squeeze(-1) if t.dim() > 1 else t


def compute_losses(
    config, levels: List[Dict[str, Any]], batch: Dict[str, Any], prev_pose, eps,
    group: Group = Group(),
):
    """The full per-level loss stack (durf_tpu/losses.py:226-419).

    Args:
      config: durf_tpu_torch.configs.Config.
      levels: the model's output list (MipNerf.forward).
      batch: 'rays' (Rays of tensors), 'pixels' [B, 3], 'depth' [B, 1],
        'sky' [B, 1], optionally 'target' [N_obj, 6], 'ext', 'inst',
        'obj_ids'.
      prev_pose: [N_obj, 6] pose of the adjacent timestep (pose TV).
      eps: the URF window half-width of this step.
      group: the data-parallel group (parallel.Group) whose rank holds this
        batch, one process by default; see the module docstring.

    Returns (total, aux): aux holds [num_levels] tensors per loss key, the
    box-surface and interlevel scalars and the first ray's sampling
    histogram (viz_t_vals, viz_weights). Under a group, total and aux are
    this rank's contributions: summed over the ranks they are the global
    batch's.
    """
    rays = batch["rays"]
    pixels = batch["pixels"][..., :3]
    gt_depth, gt_sky = _squeeze(batch["depth"]), _squeeze(batch["sky"])

    mask = rays.lossmult
    if config.disable_multiscale_loss:
        mask = torch.ones_like(mask)

    depth_valid = (gt_depth > 0.0).to(torch.float32)
    sky_valid = (gt_sky > 0.0).to(torch.float32)
    sky_valid = sky_valid - depth_valid * sky_valid  # LIDAR wins on overlap

    # Every level's masks and 'near' target first, so that the counts the
    # losses divide by and the targets' peaks are reduced over the group
    # in one all-reduce each.
    box_masks, depth_masks, targets = [], [], []
    for level in levels:
        box_mask = (gt_depth < level["z_out"]).to(torch.float32)
        depth_mask = depth_valid + config.box_loss_mult * level["dyn_mask"].squeeze(-1) * box_mask
        box_masks.append(box_mask)
        depth_masks.append(depth_mask)
        targets.append(near_target(level["t_vals"][:, :-1], gt_depth, depth_mask, eps))
    n = len(levels)
    counts = group.all_sum(torch.stack(
        [mask.sum(), sky_valid.sum()] + [m.sum() for m in depth_masks]
        + [lv["dyn_mask"].sum() for lv in levels]
    ))
    rgb_count, sky_count = counts[0], counts[1]
    depth_counts, dyn_counts = counts[2 : 2 + n], counts[2 + n :]
    peaks = group.all_max(torch.stack([distr.max() for _, distr in targets]))

    per_level: Dict[str, list] = {k: [] for k in _PER_LEVEL}
    for i, level in enumerate(levels):
        rgb, depth, weights = level["rgb"], level["depth"], level["weights"]
        t0_vals = level["t_vals"][:, :-1]
        dyn_mask = level["dyn_mask"]  # [B, 1]
        pose, rot = level["pose"], level["rot"]

        target = batch.get("target")
        if target is None:  # static scene: diagnostics against zero
            target = torch.zeros((pose.shape[0], 6), dtype=pose.dtype, device=pose.device)
        per_level["offset"].append(group.on_rank0(((pose - target[:, :3]) ** 2).sum()))
        per_level["offset_x"].append(group.on_rank0(((pose[:, 0] - target[:, 0]) ** 2).sum()))
        per_level["offset_y"].append(group.on_rank0(((pose[:, 1] - target[:, 1]) ** 2).sum()))
        per_level["offset_z"].append(group.on_rank0(((pose[:, 2] - target[:, 2]) ** 2).sum()))
        per_level["offset_yaw"].append(group.on_rank0(((rot - target[:, 3:]) ** 2).sum()))
        per_level["tv"].append(group.on_rank0(((pose - prev_pose[:, :3]) ** 2).sum()))
        if "obj_centroid" in level:
            # The global centroid on every rank (models/mipnerf.py), its
            # value counted once, its gradient from every rank's samples.
            per_level["centering"].append(group.once((level["obj_centroid"] ** 2).sum()))
        else:
            per_level["centering"].append(rgb.new_zeros(()))

        per_level["distortion"].append(
            distortion_loss(weights, level["t_mids"], level["t_dists"], config.exact_distortion)
        )
        d_mse, near_l, empty_l = _urf_losses(
            weights, t0_vals, depth, gt_depth, depth_masks[i], eps, targets[i],
            (depth_counts[i], peaks[i]),
        )
        per_level["depth"].append(d_mse)
        per_level["near"].append(near_l)
        per_level["empty"].append(empty_l)
        per_level["sky"].append(sky_loss(depth, sky_valid, gt_sky, sky_count))

        rgb_weight = mask + config.box_loss_mult * dyn_mask * box_masks[i][..., None]
        per_level["rgb"].append((rgb_weight * (rgb - pixels) ** 2).sum() / rgb_count)
        per_level["obj_rgb"].append(
            (dyn_mask * (rgb - pixels) ** 2).sum() / torch.clamp(dyn_counts[i], min=1e-8)
        )

    ext = batch.get("ext")
    if config.box_surface_loss_mult > 0.0 and ext is not None:
        surface = box_surface_loss(
            rays, gt_depth, levels[-1]["pose"], levels[-1]["rot"], ext,
            config.box_surface_margin, inst=batch.get("inst"), obj_ids=batch.get("obj_ids"),
            group=group,
        )
    else:
        surface = levels[-1]["rgb"].new_zeros(())

    aux = {k: torch.stack(v) for k, v in per_level.items()}
    aux["box_surface"] = surface
    s_max = max(lv["t_vals"].shape[-1] for lv in levels)
    # Levels with fewer samples: fenceposts edge-extended, weights zero-padded.
    aux["viz_t_vals"] = torch.stack([
        torch.cat([lv["t_vals"][0], lv["t_vals"][0, -1:].expand(s_max - lv["t_vals"].shape[-1])])
        for lv in levels
    ])
    aux["viz_weights"] = torch.stack([
        torch.nn.functional.pad(lv["weights"][0], (0, s_max - 1 - lv["weights"].shape[-1]))
        for lv in levels
    ])
    # Proposal levels carry no meaningful rgb: the rgb-dependent coarse
    # term is zeroed and the interlevel loss against the final level added;
    # the weight-histogram losses keep their coarse multipliers
    # (durf_tpu/losses.py:370-418).
    use_prop = config.model.use_proposal and len(levels) > 1
    if use_prop:
        final = levels[-1]
        aux["interlevel"] = torch.stack([
            interlevel_loss(final["t_vals"], final["weights"], lv["t_vals"], lv["weights"])
            for lv in levels[:-1]
        ]).sum() / group.size  # a batch mean over equal shards
    else:
        aux["interlevel"] = surface.new_zeros(())

    # Aggregation weights follow reference train_boxpose.py:211-220.
    def agg(vals, final_mult, coarse_mult, rgb_dependent=False):
        if use_prop and rgb_dependent:
            coarse_mult = 0.0
        return final_mult * vals[-1] + coarse_mult * vals[:-1].sum()

    total = agg(aux["rgb"], 1.0, config.coarse_loss_mult, rgb_dependent=True)
    total = total + agg(aux["sky"], 10.0 * config.sky_loss_mult, config.sky_loss_mult)
    total = total + agg(aux["depth"], config.depth_loss_mult, 0.1 * config.depth_loss_mult)
    total = total + agg(aux["near"], config.near_loss_mult, 0.1 * config.near_loss_mult)
    total = total + agg(aux["empty"], config.empty_loss_mult, 0.1 * config.empty_loss_mult)
    total = total + agg(aux["tv"], config.tv_loss_mult, 0.1 * config.tv_loss_mult)
    total = total + agg(
        aux["centering"], config.centering_loss_mult, 0.1 * config.centering_loss_mult
    )
    total = total + agg(aux["distortion"], config.distortion_loss_mult, config.distortion_loss_mult)
    total = total + config.box_surface_loss_mult * aux["box_surface"]
    total = total + config.proposal_loss_mult * aux["interlevel"]
    return total, aux
