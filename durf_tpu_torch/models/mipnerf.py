"""The dynamic scene-graph Mip-NeRF: a background field plus per-object
fields inside oriented boxes (reference obbpose_model.py:42-261).

Counterpart of the JAX package's `models/mipnerf.py`, eval and training
forward, on every pipeline its ModelConfig selects: coordinate-major
diagonal samples ([3, B, S] planes; `coord_major`, the default), row-major
ones ([B, S, 3]) with a diagonal or, without `diag_covariance`, a full
[B, S, 3, 3] covariance. Per level:
  stratified, occupancy-grid (level 0 with `grid_sampling` and a grid) or
  inverse-CDF samples -> conical-frustum Gaussians ->
  (dynamic) windowed IPE + object MLPs on the composite rays ->
  background mask, contraction, IPE, background MLP -> additive raw merge ->
  density noise -> activations -> compositing.
With proposal levels (`use_proposal`) every level but the last runs the
small `proposal_mlp` in place of the background MLP; the objects run on
every level. With `use_pallas_mlp` the background and proposal MLPs run
K1/K2, and the object MLPs run K3/K4 (`fused_objects` on coordinate-major
samples with view directions, all objects in one launch) or, on the
per-object route, K1/K2 once per object on the blended input
(ops/kernels/, forward and backward); without it, and for an MLP without
a view condition (as in the JAX package), the plain path in
`compute_dtype`, recomputed in the backward with `remat_mlp`. With
`obj_ray_capacity > 0` the object pipeline runs on the k rays of the batch
that hit a box first (object-ray compaction), and every dynamic level reads
out `obj_centroid`, the object-centering prior. A randomized (training) forward draws all its
randomness from one `torch.Generator`, threaded through the levels. With
`grid_sampling` each level also returns its contracted sample positions
and world-frame weights for the trainer's grid update. Under a torch
profiler the stages are spans (metrics.span): `durf.model.boxes` once, then
per level `durf.model.sample`, `objects`, `encode`, `mlp` and `composite`.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from durf_tpu_torch import mathx, metrics, ops
from durf_tpu_torch.configs import ModelConfig
from durf_tpu_torch.devices import resolve_device
from durf_tpu_torch.models.mlp import NerfMLP, get_activation
from durf_tpu_torch.ops import grid as gridops
from durf_tpu_torch.ops.kernels import obj_mlp as k3
from durf_tpu_torch.mathx import draw
from durf_tpu_torch.parallel.group import Group
from durf_tpu_torch.rays import Rays


def obj_capacity_k(batch: int, capacity: float) -> int:
    """Compacted ray count for ModelConfig.obj_ray_capacity
    (durf_tpu/models/mipnerf.py:38-47): ceil(capacity * batch) rounded up
    to a multiple of 128, at least 128, at most the batch; capacity <= 0
    (the -1 of auto-sizing included) disables compaction (k == batch)."""
    if capacity <= 0.0:
        return batch
    return min(batch, max(128, int(math.ceil(batch * capacity / 128)) * 128))


def encoding_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(background input, object input, view condition) feature counts."""
    ipe = 2 * 3 * (cfg.max_deg_point - cfg.min_deg_point)
    cond = 3 + 2 * 3 * cfg.deg_view if cfg.use_viewdirs else 0
    return ipe, 3 + ipe, cond


class MipNerf(nn.Module):
    """Mip-NeRF with an optional NSG-style scene graph of `num_objects`
    objects over `timesteps` box poses (the learnable `box_centers` table)."""

    def __init__(self, config: ModelConfig, num_objects: int = 0, timesteps: int = 0):
        super().__init__()
        self.config = config
        # The diagonal-covariance pipeline (exact for the power-of-two
        # axis-aligned IPE basis), and on it coordinate-major samples.
        self.diag = config.diag_covariance
        self.cm = self.diag and config.coord_major
        bg_in, obj_in, cond_dim = encoding_dims(config)
        mlp = functools.partial(NerfMLP, compute_dtype=config.compute_dtype,
                                use_kernel=config.use_pallas_mlp, remat=config.remat_mlp)
        self.background_mlp = mlp(config.mlp, bg_in, cond_dim)
        self.dynamic = config.dynamics and num_objects > 0
        if self.dynamic:
            # With fused_objects the kernel path bypasses this module for K3;
            # the per-object route runs it, K1 once per object.
            self.object_mlps = mlp(config.box_mlp, obj_in, cond_dim, num_stack=num_objects)
            self.box_centers = nn.Parameter(torch.zeros((timesteps, num_objects, 6)))
        # Proposal levels (durf_tpu/models/mipnerf.py:108-123): every level
        # but the last swaps the background MLP for this small one, whose
        # histogram only places the next level's samples (distilled by
        # losses.interlevel_loss).
        self.use_proposal = config.use_proposal and config.num_levels > 1
        if self.use_proposal:
            self.proposal_mlp = mlp(config.proposal_mlp, bg_in, cond_dim)

    def forward(
        self,
        rays: Rays,
        ext: torch.Tensor | None = None,
        ts=None,
        background: str = "gray",
        alpha=10.0,
        randomized: bool = False,
        generator=None,
        grid: torch.Tensor | None = None,
        group: Group = Group(),
    ) -> List[Dict[str, Any]]:
        """Render a batch of rays (tensors [B, ...]).

        Args:
          ext: [N_obj, 3] box half-extents (dynamic model).
          ts: the timestep of this batch (index into the pose table).
          background: 'white' | 'gray' | 'black' | 'random'.
          alpha: BARF frequency-annealing scalar.
          randomized: stratified jitter and density noise (training).
          generator: the source of every random draw (randomized, or the
            random background), on the rays' device: a torch.Generator, or
            under a group a parallel.RowShard.
          grid: an [R, R, R] occupancy grid (ops.grid); with grid_sampling it
            drives level 0's sampling PDF.
          group: the data-parallel group whose rank holds these rays, its
            rows of the global batch (parallel.Group; one process by
            default): compaction keeps the global batch's first k hit rays
            and the centering readout is the global batch's.

        Returns one dict per level: rgb [B,3], depth [B], acc [B],
        weights [B,S], t_vals [B,S+1], t_mids [B,S], t_dists [B,S],
        pose [N_obj,3], rot [N_obj,3], dyn_mask [B,1], z_out [B], and for the
        dynamic model obj_hit_rays (rays hitting any box) and obj_centroid
        [N_obj,3] (the object-centering readout); with grid_sampling
        positions_c [B,S,3] (the contracted sample positions) and
        grid_weights [B,S] (the weights, zero on box-hitting rays, whose
        samples are in an object's frame), both detached.
        """
        cfg = self.config
        dtype = self.background_mlp.compute_dtype
        origins, dirs = rays.origins, rays.directions
        batch = origins.shape[0]

        with metrics.span("durf.model.boxes"):
            if self.dynamic:
                if ext is None or ts is None:
                    raise ValueError("the dynamic model needs ext and ts")
                t = int(ts)
                box_pose = self.box_centers[t, :, :3]  # [N_obj, 3]
                box_rot = self.box_centers[t, :, 3:]
                if cfg.no_pose_opt:
                    box_pose = box_pose.detach()
                if cfg.no_yaw_opt:
                    box_rot = box_rot.detach()
                n_obj = box_pose.shape[0]
                box_mat = ops.axis_angle_to_matrix(box_rot)
                origins_o, dirs_o = ops.world_to_box_frames(
                    origins,
                    dirs,
                    box_pose.expand(batch, n_obj, 3),
                    box_mat.expand(batch, n_obj, 3, 3),
                )
                box_dims = ext.expand(batch, n_obj, 3)
                z_in, z_out, hit = ops.ray_box_intersection(origins_o, dirs_o, -box_dims, box_dims)
                hit = hit.detach()  # [B, N_obj]
                miss_all = (hit.sum(dim=-1) == 0).to(origins.dtype)  # [B]
                # Composite rays: object-frame rays where a box is hit (boxes are
                # assumed not to overlap along a ray), world rays elsewhere.
                origins_s = (origins_o * hit[..., None]).sum(dim=-2) + miss_all[..., None] * origins
                dirs_s = (dirs_o * hit[..., None]).sum(dim=-2) + miss_all[..., None] * dirs
                z_out_ret = (hit * z_out).sum(dim=-1)
                dyn_mask = hit.sum(dim=-1, keepdim=True)
            else:
                origins_s, dirs_s = origins, dirs
                z_out_ret = torch.zeros((batch,), dtype=origins.dtype, device=origins.device)
                dyn_mask = torch.zeros((batch, 1), dtype=origins.dtype, device=origins.device)
                box_pose = torch.zeros((1, 3), dtype=origins.dtype, device=origins.device)
                box_rot = torch.zeros((1, 3), dtype=origins.dtype, device=origins.device)

            near, far = rays.near, rays.far
            if self.dynamic and cfg.use_box_nearfar:
                m = cfg.box_nearfar_margin
                near = (hit * (z_in - m)).sum(-1, keepdim=True) + miss_all[..., None] * rays.near
                far = (hit * (z_out + m)).sum(-1, keepdim=True) + miss_all[..., None] * rays.far
                near = torch.maximum(near, rays.near).detach()
                far = torch.minimum(torch.maximum(far, near + 1e-3), rays.far).detach()

            viewdirs_enc = (
                ops.pos_enc(rays.viewdirs, 0, cfg.deg_view, append_identity=True)
                if cfg.use_viewdirs
                else None
            )

            if self.dynamic:
                anyhit = hit.sum(dim=-1) > 0  # [B]
                k_total = batch * group.size
                k = obj_capacity_k(k_total, cfg.obj_ray_capacity)
                if k < k_total:
                    # Exclusive prefix of the ranks' hit counts: this rank's
                    # j-th hit ray is the global batch's (prefix + j)-th, kept
                    # while that is below k, in min(B/n, k) slots.
                    counts = group.gather_rows(anyhit.sum().to(torch.float32)[None], group.size)
                    budget = k - counts[: group.rank].sum()
                    k = min(k, batch)

        ret: List[Dict[str, Any]] = []
        t_vals = weights = None
        for i_level in range(cfg.num_levels):
            n_level = cfg.level_samples(i_level)
            with metrics.span("durf.model.sample"):
                if i_level == 0 and cfg.grid_sampling and grid is not None:
                    t_vals, samples = self._grid_samples(
                        grid, origins, dirs, origins_s, dirs_s, rays.radii, near, far, dyn_mask,
                        n_level, randomized, generator,
                    )
                elif i_level == 0:
                    t_vals, samples = ops.sample_along_rays(
                        origins_s, dirs_s, rays.radii, n_level, near, far, cfg.lindisp,
                        cfg.ray_shape, randomized, generator, diag=self.diag, cm=self.cm,
                    )
                else:
                    t_vals, samples = ops.resample_along_rays(
                        origins_s,
                        dirs_s,
                        rays.radii,
                        t_vals,
                        weights,
                        cfg.ray_shape,
                        cfg.resample_padding,
                        num_samples=n_level,
                        randomized=randomized,
                        stop_grad=cfg.stop_level_grad,
                        generator=generator,
                        diag=self.diag,
                        cm=self.cm,
                    )
                # [3, B, S] planes (cm), else [B, S, 3] and [B, S, 3(, 3)]; the
                # raw mean is the composite rays' positions, before masking.
                mean, cov = samples
                raw_mean = mean
                if cfg.disable_integration:
                    cov = torch.zeros_like(cov)

            level_out: Dict[str, Any] = {}
            with metrics.span("durf.model.objects"):
                if self.dynamic:
                    if k < k_total:
                        obj_rgbs, obj_densities = self._compacted_objects(
                            mean, cov, viewdirs_enc, hit, anyhit, k, alpha, dtype, budget
                        )
                    else:
                        obj_rgbs, obj_densities = self._objects(
                            mean, cov, viewdirs_enc, hit, alpha, dtype
                        )
                    # The readout works on [3, B, S] planes.
                    planes = (lambda t: t) if self.cm else (lambda t: t.movedim(-1, 0))
                    level_out["obj_centroid"] = self._centroid(
                        planes(mean), planes(obj_densities), hit, ext, group
                    )
                    level_out["obj_hit_rays"] = anyhit.sum().to(torch.float32)
                    # The background sees the complement mask, clamped at 0: a ray
                    # hitting two boxes would otherwise flip the covariance
                    # negative (reference obbpose_model.py:205).
                    bkgd = torch.clamp(1.0 - hit.sum(dim=-1), min=0.0).detach()
                    if self.cm:
                        mask = bkgd[None, :, None]  # over [3, B, S]
                        mean, cov = mask * mean, mask * cov
                    else:
                        mask = bkgd[:, None, None]  # over [B, S, 3]
                        mean, cov = mask * mean, (mask if self.diag else mask[..., None]) * cov

            with metrics.span("durf.model.encode"):
                if cfg.contraction:
                    if self.diag:
                        mean, cov = ops.contract_gaussian_diag(
                            mean, cov, threshold=cfg.contract_threshold, dim=0 if self.cm else -1
                        )
                    else:
                        mean, cov = ops.contract_gaussian(
                            mean, cov, threshold=cfg.contract_threshold
                        )
                enc_kwargs = dict(safe=not cfg.fast_trig, recurrent=cfg.recurrent_encode)
                if self.cm:
                    samples_enc = ops.integrated_pos_enc_cm(
                        mean, cov, cfg.min_deg_point, cfg.max_deg_point, **enc_kwargs
                    )
                else:
                    samples_enc = ops.integrated_pos_enc(
                        (mean, cov), cfg.min_deg_point, cfg.max_deg_point, diag=self.diag,
                        **enc_kwargs,
                    )

            with metrics.span("durf.model.mlp"):
                proposal_level = self.use_proposal and i_level < cfg.num_levels - 1
                level_mlp = self.proposal_mlp if proposal_level else self.background_mlp
                raw_rgb, raw_density = level_mlp(
                    samples_enc, viewdirs_enc, x_feature_major=self.cm, out_feature_major=self.cm
                )
                if self.dynamic:
                    raw_rgb = raw_rgb + obj_rgbs
                    raw_density = raw_density + obj_densities
                if randomized and cfg.density_noise > 0:
                    raw_density = raw_density + cfg.density_noise * draw(
                        torch.randn, raw_density.shape, generator, dim=1 if self.cm else 0,
                        dtype=raw_density.dtype, device=raw_density.device,
                    )

            with metrics.span("durf.model.composite"):
                rgb = get_activation(cfg.rgb_activation)(raw_rgb)
                density = get_activation(cfg.density_activation)(raw_density + cfg.density_bias)
                if self.cm:
                    rendered = ops.volumetric_rendering_cm(
                        rgb, density[0], t_vals, dirs_s, background=background, generator=generator
                    )
                else:
                    rendered = ops.volumetric_rendering(
                        rgb, density, t_vals, dirs_s, background=background, generator=generator
                    )
                comp_rgb, depth, acc, weights, t_vals, t_mids, t_dists = rendered
                if cfg.grid_sampling:
                    # Box-hitting rays' samples are in an object's frame: only
                    # the world-frame ones are evidence for the world-frame grid
                    # (a zero weight leaves the non-negative grid unchanged).
                    level_out["positions_c"] = ops.contract(
                        raw_mean.movedim(0, -1) if self.cm else raw_mean,
                        threshold=cfg.contract_threshold,
                    ).detach()
                    grid_weights = weights * miss_all[:, None] if self.dynamic else weights
                    level_out["grid_weights"] = grid_weights.detach()
                ret.append(
                    dict(
                        **level_out,
                        rgb=comp_rgb,
                        depth=depth,
                        acc=acc,
                        weights=weights,
                        t_vals=t_vals,
                        t_mids=t_mids,
                        t_dists=t_dists,
                        pose=box_pose,
                        rot=box_rot,
                        dyn_mask=dyn_mask,
                        z_out=z_out_ret,
                    )
                )
        return ret

    def _compacted_objects(self, mean, cov, viewdirs_enc, hit, anyhit, k, alpha, dtype, budget):
        """Object-ray compaction (durf_tpu/models/mipnerf.py:394-446): the
        object pipeline on the k rays that come first when the rays hitting
        a box are sorted before the others, scattered back into zeros.
        Exact while the batch's hit count fits k (the other rays hit
        nothing); past it, the highest-indexed hit rays lose their object
        contribution. The sort is stable, so ties keep ray order, as
        lax.top_k puts the lower index first. `budget` (a 0-d tensor) is
        how many of this rank's hit rays fall among the global batch's
        first k (k itself in one process): the slots past it get a zero hit
        mask, so their rays lose their object contribution as in one
        process."""
        idx = torch.sort(anyhit.to(torch.int32), descending=True, stable=True).indices[:k]
        ax = 1 if self.cm else 0  # the ray axis of the samples and outputs
        slots = torch.arange(k, device=hit.device)
        hit_c = hit.index_select(0, idx) * (slots < budget).to(hit.dtype)[:, None]
        rgb_c, den_c = self._objects(
            mean.index_select(ax, idx),
            cov.index_select(ax, idx),
            None if viewdirs_enc is None else viewdirs_enc.index_select(0, idx),
            hit_c,
            alpha,
            dtype,
        )

        def full(t):
            # Out-of-place scatter into zeros, so autograd reaches the
            # compacted outputs.
            shape = list(t.shape)
            shape[ax] = mean.shape[ax]
            return t.new_zeros(shape).index_copy(ax, idx, t)

        return full(rgb_c), full(den_c)

    def _objects(self, mean, cov, viewdirs_enc, hit, alpha, dtype):
        """Hit-masked sum over the object MLPs: ([3, B, S], [1, B, S]) on
        coordinate-major samples, else ([B, S, 3], [B, S, 1]).

        One windowed encode of the composite-ray samples serves every
        object: for a 0/1 mask, windowed_ipe(hit*m, hit*cov) ==
        hit*windowed_ipe(m, cov) + (1-hit)*windowed_ipe(0, 0), so the masked
        input is a blend with the constant zero-sample encoding c0.

        With the kernels the objects run K3/K4 (`fused_objects`, on
        coordinate-major samples with view directions, as
        durf_tpu/models/mipnerf.py:314-319) or the per-object route: each
        object's blended input through K1/K2 (row-major samples too). The
        JAX package also takes the per-object route when the stacked weights
        would overflow its fused kernel's VMEM budget (fused_obj_vmem_ok);
        K3/K4 keep only one object's weight slices in shared memory at a
        time and put the weight gradients in device memory, so they have no
        such limit and the port takes the route only when asked.
        """
        cfg = self.config
        enc_kwargs = dict(
            min_deg=cfg.min_deg_point,
            max_deg=cfg.max_deg_point,
            alpha=alpha,
            safe=not cfg.fast_trig,
            recurrent=cfg.recurrent_encode,
        )
        gate = hit.T[..., None]  # [N_obj, B, 1]
        if self.cm:
            enc = ops.windowed_ipe_cm(mean, cov, **enc_kwargs)
            if cfg.use_pallas_mlp and cfg.fused_objects and viewdirs_enc is not None:
                return k3.obj_mlps_apply(
                    self.object_mlps.operands(), cfg.box_mlp, enc, viewdirs_enc, hit, dtype
                )
            zero = torch.zeros((3, 1, 1), dtype=mean.dtype, device=mean.device)
            c0 = ops.windowed_ipe_cm(zero, zero, **enc_kwargs)  # [F, 1, 1]
            obj_rgb, obj_density = self.object_mlps(enc, viewdirs_enc, gate, c0)
            hit_fm = hit.T[:, None, :, None]  # [N_obj, 1, B, 1] over [N_obj, C, B, S]
            return (hit_fm * obj_rgb).sum(dim=0), (hit_fm * obj_density).sum(dim=0)
        enc = ops.windowed_ipe((mean, cov), diag=self.diag, **enc_kwargs)
        zero = torch.zeros((1, 1, 3), dtype=mean.dtype, device=mean.device)
        zero_cov = zero if self.diag else torch.zeros((1, 1, 3, 3), dtype=mean.dtype, device=mean.device)
        c0 = ops.windowed_ipe((zero, zero_cov), diag=self.diag, **enc_kwargs)  # [1, 1, F]
        obj_rgb, obj_density = self.object_mlps(
            enc, viewdirs_enc, gate, c0, x_feature_major=False, out_feature_major=False
        )
        hit_rm = hit.T[..., None, None]  # [N_obj, B, 1, 1] over [N_obj, B, S, C]
        return (hit_rm * obj_rgb).sum(dim=0), (hit_rm * obj_density).sum(dim=0)

    def _grid_samples(self, grid, origins, dirs, origins_s, dirs_s, radii, near, far, dyn_mask,
                      n_level, randomized, generator):
        """Level 0's fenceposts drawn from the occupancy grid's PDF along
        each ray, and their Gaussians (durf_tpu/models/mipnerf.py:221-259).
        The grid lives in contracted world space, so it is probed along the
        world rays, not the composite ones, whose box-hitting rays are in an
        object's frame; those rays take a uniform PDF (the stratified
        sampling of [near, far])."""
        cfg = self.config
        contract_fn = functools.partial(ops.contract, threshold=cfg.contract_threshold)
        bins, occ = gridops.ray_pdf(
            grid, origins, dirs, near, far, cfg.grid_probes, contract_fn, cfg.grid_floor
        )
        if self.dynamic:
            occ = torch.where(dyn_mask > 0, torch.ones_like(occ), occ)
        t_vals = mathx.sorted_piecewise_constant_pdf(
            bins, occ, n_level + 1, randomized, generator
        ).detach()
        if self.cm:
            return t_vals, ops.cast_rays_cm(t_vals, origins_s, dirs_s, radii, cfg.ray_shape)
        return t_vals, ops.cast_rays(t_vals, origins_s, dirs_s, radii, cfg.ray_shape, self.diag)

    def _centroid(self, mean, obj_densities, hit, ext, group: Group):
        """The object-centering readout [N_obj, 3] (durf_tpu/models/
        mipnerf.py:448-524): per object, the centre of its occupied
        canonical samples. Box-hitting rays sample in the object frame, so
        their raw means are canonical coordinates; only in-slab samples (|x|
        <= ext) of the object's hit rays count. The weights are detached, so
        the centering loss moves the pose, never the field. 'mean': the
        density-weighted mean. 'midrange': the midpoint of a smooth max and
        min per axis over occupancy saturated at centering_tau, 0 for an
        object with no occupied sample in the batch.

        Under a group the readout is the global batch's: the ranks' partial
        sums (mean) or partial log-sum-exps (midrange) are gathered with
        this rank's own live (parallel.Group.gather_live), so every rank
        holds the global value and its gradient reaches this rank's
        samples exactly."""
        cfg = self.config
        x32 = mean.float()  # [3, B, S]
        n_obj = hit.shape[1]
        sigma = get_activation(cfg.density_activation)(obj_densities[0].float() + cfg.density_bias)
        in_slab = (x32.abs()[None] <= ext[:, :, None, None]).all(dim=1).float()  # [N_obj, B, S]
        mask = hit.T[:, :, None].float() * in_slab
        if cfg.centering_mode == "mean":
            w = sigma.detach()[None] * mask
            num = torch.einsum("obs,cbs->oc", w, x32)
            den = w.sum(dim=(1, 2))[:, None]
            sums = group.gather_live(torch.cat([num, den], dim=1)).sum(dim=0)
            return sums[:, :3] / (sums[:, 3:] + 1e-6)
        if cfg.centering_mode == "midrange":
            beta, tau = cfg.centering_beta, cfg.centering_tau
            w_occ = (torch.clamp(sigma, max=tau) / tau).detach()[None] * mask
            logw = torch.where(w_occ > 0.0, torch.log(torch.clamp(w_occ, min=1e-30)), -1e9)
            logw = logw.reshape(n_obj, 1, -1)
            xo = x32.reshape(1, 3, -1)
            hi = torch.logsumexp(beta * xo + logw, dim=-1)
            lo = torch.logsumexp(-beta * xo + logw, dim=-1)
            occ = w_occ.sum(dim=(1, 2))
            parts = group.gather_live(torch.cat([hi, lo, occ[:, None]], dim=1))
            hi = torch.logsumexp(parts[..., :3], dim=0)
            lo = torch.logsumexp(parts[..., 3:6], dim=0)
            occ = parts[..., 6].sum(dim=0)
            mid = (hi - lo) / (2.0 * beta)
            # An object with no occupied sample: every logw is -1e9 and mid
            # would be the midrange of all its canonical samples.
            occupied = occ > 0.0
            return torch.where(occupied[:, None], mid, torch.zeros_like(mid))
        raise ValueError(f"unknown centering_mode {cfg.centering_mode!r}")


def construct_model(config: ModelConfig, example_batch: dict, device="cuda", seed: int = 0):
    """Build the model on `device` with fresh weights drawn from `seed`:
    glorot-uniform kernels and zero biases from a CPU torch.Generator, and
    the pose table from example_batch['init'] (a [T, N_obj, 6] array, or
    None for the static model). The proposal MLP draws after every other
    leaf, so turning proposal levels on leaves the other weights of a seed
    as they were. Runs on the card unless the caller asks
    for the CPU. Returned in eval mode; the train step switches it to
    train mode."""
    device = resolve_device(device)
    init = example_batch.get("init")
    n_obj, timesteps = (0, 0) if init is None else (init.shape[1], init.shape[0])
    model = MipNerf(config, n_obj, timesteps)
    gen = torch.Generator().manual_seed(seed)
    model.background_mlp.reset_parameters(gen)
    if model.dynamic:
        model.object_mlps.reset_parameters(gen)
        with torch.no_grad():
            model.box_centers.copy_(torch.as_tensor(np.asarray(init, np.float32)))
    if model.use_proposal:
        model.proposal_mlp.reset_parameters(gen)
    return model.to(device).eval()


def render_image(render_fn, rays: Rays, chunk: int = 8192) -> Dict[str, np.ndarray]:
    """Render a full [H, W] image in chunks.

    Args:
      render_fn: fn(rays_chunk) -> dict with 'rgb' [N, 3], 'depth' [N],
        'acc' [N] tensors (see train.make_render_fn).
      rays: Rays whose leaves are [H, W, ...] (numpy or tensors).
      chunk: rays per call; the last chunk is padded to `chunk` by repeating
        its last ray, so every call sees one shape.

    Returns a dict of [H, W, ...] numpy arrays (rgb, depth, acc).
    """
    height, width = rays.origins.shape[:2]
    num_rays = height * width
    flat = rays.map(lambda r: torch.as_tensor(np.asarray(r) if not torch.is_tensor(r) else r)
                    .reshape(num_rays, r.shape[-1]))
    outs = []
    for i in range(0, num_rays, chunk):
        with metrics.span("durf.render.slice"):
            chunk_rays = flat.map(lambda r: r[i : i + chunk])
            pad = chunk - chunk_rays.origins.shape[0]
            if pad > 0:
                chunk_rays = chunk_rays.map(
                    lambda r: torch.cat([r, r[-1:].expand(pad, r.shape[-1])], dim=0)
                )
        out = render_fn(chunk_rays)
        if pad > 0:
            out = {k: v[: chunk - pad] for k, v in out.items()}
        outs.append(out)  # stays on the device; one transfer at the end
    with metrics.span("durf.render.fetch"):
        merged = {k: torch.cat([o[k] for o in outs], dim=0).cpu().numpy() for k in outs[0]}
    return {k: v.reshape((height, width) + v.shape[1:]) for k, v in merged.items()}
