"""The training step, the eval forward and the training loop with its CLI
(counterparts of the JAX package's `train.py`).

The train step is eager PyTorch around the hand-written kernels: the
randomized forward (K1 and K3 through their autograd Functions), the loss
stack, `backward()` (K2 and K4), gradient hygiene (NaN scrub, value clip,
global-norm clip; reference train_boxpose.py:262-288), Adam at the
log-lerp learning rate lr(count + 1) and, with `grid_sampling`, the
occupancy grid's update from the last level's samples and weights. The
schedules run on the host from the step count. The step's randomness comes
from a `torch.Generator` seeded from (seed, step), where the JAX package
folds the step into a key.

`run_training` is the loop: a scene directory's RayDataset, compaction
auto-sized from the scene (`resolve_obj_capacity`), batches drawn on the
card from device-resident pools (or the host prefetch thread), periodic
logging, checkpoints, eval renders with PSNR and SSIM, and resume from the
latest checkpoint.

Data-parallel training (`--multihost`, under torchrun): each rank trains
on its rows of every global batch on cuda:LOCAL_RANK (gloo ranks on the
CPU with --device cpu), the step's gradients summed over the ranks
(parallel/); rank 0 alone writes checkpoints, metrics and images, and
every rank restores.

CLI:
  python -m durf_tpu_torch.train --data_dir=... --train_dir=... \
      --gin_file=configs/waymo_fast.gin [--gin_param='Config.x = 1' ...] \
      [--device cpu]
  torchrun --nproc_per_node N -m durf_tpu_torch.train --multihost ...
"""

from __future__ import annotations

import argparse
import functools
import gc
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from durf_tpu_torch import mathx, metrics, parallel, vis
from durf_tpu_torch.checkpoints import CheckpointManager
from durf_tpu_torch.configs import Config, load_config
from durf_tpu_torch.data import device_data, get_dataset
from durf_tpu_torch.data.scene import max_hit_fraction
from durf_tpu_torch.losses import compute_losses, weight_l2
from durf_tpu_torch.models.mipnerf import MipNerf, construct_model, obj_capacity_k, render_image
from durf_tpu_torch.ops import grid as gridops
from durf_tpu_torch.rays import Rays

POSE_PARAM = "box_centers"
# Seeds of the training loop: the initial weights and each step's random
# stream, and the device-side batch draws (the JAX package's keys,
# durf_tpu/train.py:524, :555).
TRAIN_SEED, SAMPLE_SEED = 20200823, 20201473


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
    # The contracted-domain occupancy grid [R, R, R] on the model's device
    # (None unless config.model.grid_sampling).
    grid: Optional[torch.Tensor] = None


def create_train_state(config: Config, model: MipNerf, optimizer: ScheduledAdam) -> TrainState:
    grid = None
    if config.model.grid_sampling:
        device = next(model.parameters()).device
        grid = gridops.make_grid(config.model.grid_resolution, device=device)
    return TrainState(step=0, model=model, optimizer=optimizer, config=config, grid=grid)


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


def make_grad_fn(model: MipNerf, config: Config, seed: int = 1,
                 group: parallel.Group = parallel.Group()):
    """fn(step, batch, grid=None) -> (loss, aux, grads): the loss of the
    step's randomized forward (level 0 sampled from `grid` under
    grid_sampling) and the raw gradient of every named parameter (zeros
    where the loss does not reach it), before any hygiene. Under
    grid_sampling aux also holds the last level's grid_positions and
    grid_weights.

    Under a group of several ranks `batch` is this rank's rows of the
    global batch: loss and aux are the rank's contributions (summed over
    the ranks, the global batch's; reduce_stats), the random draws the
    global batch's rows (mathx.RowShard), and grads the raw gradient of the
    global loss, summed over the ranks in one all-reduce."""
    eps_fn, alpha_fn = make_eps_schedule(config), make_alpha_schedule(config)
    dynamic = config.model.dynamics and model.dynamic
    background = background_mode(config)

    def grad_fn(step: int, batch: Dict[str, Any], grid: Optional[torch.Tensor] = None):
        device = batch["rays"].origins.device
        gen = mathx.RowShard(step_generator(seed, step, device), group.rank, group.size)
        eps, alpha = eps_fn(step + 1), alpha_fn(step + 1)
        model.train()
        for p in model.parameters():
            p.grad = None
        ts = batch.get("ts")
        out = model(
            batch["rays"], ext=batch.get("ext"), ts=ts, background=background, alpha=alpha,
            randomized=config.randomized, generator=gen, grid=grid, group=group,
        )
        if dynamic:
            # Previous-timestep pose for the TV loss, from the live table.
            table = model.box_centers.detach()
            prev_pose = table[ts + 1 if ts == 0 else ts - 1]
        else:
            prev_pose = torch.zeros((out[0]["pose"].shape[0], 6), device=device)
        total, aux = compute_losses(config, out, batch, prev_pose, eps, group)
        if config.weight_decay_mult > 0:
            total = total + group.on_rank0(config.weight_decay_mult * weight_l2(model.parameters()))
        if dynamic:
            aux["obj_hit_rays"] = out[-1]["obj_hit_rays"]
        if config.model.grid_sampling:
            # Box-hitting rays carry zero weight (models/mipnerf.py).
            aux["grid_positions"] = out[-1]["positions_c"]
            aux["grid_weights"] = out[-1]["grid_weights"]
        total.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()
        }
        grads = dict(zip(grads, group.sum_flat(list(grads.values()))))
        return total.detach(), aux, grads

    return grad_fn


def make_train_step(model: MipNerf, config: Config, optimizer: ScheduledAdam, seed: int = 1,
                    group: parallel.Group = parallel.Group()):
    """fn(state, batch) -> (state, stats): one optimization step on a batch
    of device tensors (see batch_to). stats are 0-d tensors (arrays for the
    'viz/' keys) on the device; nothing here waits for the card.

    Under a group of several ranks `batch` is this rank's rows of the
    global batch and every rank applies the same gradient, summed over the
    ranks before the hygiene (as the JAX package scrubs and clips the
    global gradient); the occupancy grid's update is followed by an
    all-reduce MAX, which equals the update from the global batch. The
    stats are then this rank's: reduce_stats makes them the global
    batch's."""
    grad_fn = make_grad_fn(model, config, seed, group)
    lr_fn = make_lr_schedule(config)
    eps_fn, alpha_fn = make_eps_schedule(config), make_alpha_schedule(config)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        step = state.step
        loss, aux, grads = grad_fn(step, batch, state.grid)
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
        if config.model.grid_sampling:
            state.grid = gridops.update(
                state.grid, aux.pop("grid_positions"), aux.pop("grid_weights"),
                decay=config.model.grid_decay,
            )
            state.grid = group.all_max(state.grid)
        state.step = step + 1

        stats = {
            "train/loss": loss,
            "train/grad_norm": grad_norm,
            "train/grad_abs_max": grad_abs_max,
            "train/grad_norm_clipped": grad_norm_clipped,
            "schedule/lr": lr_fn(step + 1),
            "schedule/eps": eps_fn(step + 1),
            "schedule/alpha": alpha_fn(step + 1),
        }
        for i in range(config.model.num_levels):
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
            stats["obj/hit_frac"] = aux["obj_hit_rays"] / config.batch_size
        return state, _derive_stats(stats, config)

    return train_step


# Stats that are not sums over the batch: the gradient statistics and the
# first ray's histograms are the same on every rank (rank 0's, for the
# histograms), the rest are derived from sums by _derive_stats.
_NOT_SUMMED = ("viz/", "train/grad", "train/psnr", "train/obj_psnr", "obj/overflow_rays")


def _derive_stats(stats: Dict[str, Any], config: Config) -> Dict[str, Any]:
    """`stats` with the stats derived from sums: the PSNRs from the rgb
    losses and, from obj/hit_frac, the compaction safety
    obj/overflow_rays (rays over the obj_ray_capacity budget: > 0 means
    object content was dropped this batch)."""
    levels = config.model.num_levels
    psnrs = mathx.mse_to_psnr(torch.stack([stats[f"loss/rgb_{i}"] for i in range(levels)]))
    stats["train/psnr"] = psnrs[-1]
    stats["train/obj_psnr"] = torch.nan_to_num(
        mathx.mse_to_psnr(stats[f"loss/obj_rgb_{levels - 1}"]), nan=0.0, posinf=0.0
    )
    for i in range(levels):
        stats[f"train/psnr_level{i}"] = psnrs[i]
    if "obj/hit_frac" in stats and config.model.obj_ray_capacity > 0.0:
        hits = torch.round(stats["obj/hit_frac"] * config.batch_size)
        k = obj_capacity_k(config.batch_size, config.model.obj_ray_capacity)
        stats["obj/overflow_rays"] = torch.clamp(hits - k, min=0.0)
    return stats


def reduce_stats(stats: Dict[str, Any], config: Config, group: parallel.Group) -> Dict[str, Any]:
    """The global batch's stats from a rank's train-step stats: the sums
    over the batch summed over the group in one all-reduce, then the stats
    derived from them. A collective every rank calls; the stats
    themselves in one process."""
    keys = [k for k, v in stats.items() if torch.is_tensor(v) and not k.startswith(_NOT_SUMMED)]
    summed = group.all_sum(torch.stack([stats[k].float() for k in keys]))
    return _derive_stats({**stats, **dict(zip(keys, summed.unbind()))}, config)


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


def make_render_fn(model: MipNerf, config: Config, device="cuda",
                   group: Optional[parallel.Group] = None):
    """fn(rays, ext, ts, alpha) -> last-level {'rgb', 'depth', 'acc'} for a
    chunk of rays, without gradients, on `device` (the card unless the
    caller asks for the CPU; under a group, the group's device). Eval never
    composites a random background (reference train_boxpose.py:388).

    Under a group each rank renders its 1/n of every chunk and the chunk is
    gathered on every rank (durf_tpu/train.py:374-420): a collective, so
    every rank renders every chunk."""
    group = parallel.one_process(device) if group is None else group
    device = group.device
    eval_background = "white" if config.white_bkgd else "gray"
    model = model.to(device).eval()

    def render_chunk(rays: Rays, ext, ts, alpha):
        n = rays.origins.shape[0]
        if n % group.size != 0:
            raise ValueError(
                f"render chunk of {n} rays must divide process_count {group.size} "
                f"(pad the chunk size)"
            )
        rows = group.rows(n)
        rays = rays.map(lambda r: r[rows]).to(device)
        ext_t = None if ext is None else torch.as_tensor(ext, dtype=torch.float32, device=device)
        with torch.inference_mode():
            out = model(
                rays, ext=ext_t, ts=ts, background=eval_background, alpha=alpha, group=group
            )[-1]
        local = torch.cat([out["rgb"], out["depth"][:, None], out["acc"][:, None]], dim=1)
        full = group.gather_rows(local, n)
        return {"rgb": full[:, :3], "depth": full[:, 3], "acc": full[:, 4]}

    return render_chunk


def evaluate_image(render_chunk, test_case: dict, alpha: float, chunk: int) -> Dict[str, np.ndarray]:
    """Render one full test image (a host test batch: [H, W, ...] rays, ext,
    ts) through the chunked renderer of make_render_fn."""
    ext, ts = test_case.get("ext"), test_case.get("ts")
    ts = None if ts is None else int(ts)
    return render_image(lambda rays: render_chunk(rays, ext, ts, alpha), test_case["rays"], chunk)


def resolve_obj_capacity(config: Config, dataset, log_fn=print) -> float:
    """Size object-ray compaction from the scene (ModelConfig.obj_ray_capacity
    == -1, the flagship .gin files' setting; durf_tpu/train.py:445-478).

    capacity = margin * the largest over timesteps and pyramid factors of
    the share of rays hitting any box, with the box extents grown by the
    pose noise (Config.box_noise under random_box: joint pose optimization
    moves the boxes by up to that much). Returns 0.0 (compaction off) for a
    scene without objects and at most 1.0 (k == batch, the uncompacted
    path), so the auto mode never drops a ray at startup; warn_obj_overflow
    stays the loud guard if training drifts past the margin.
    """
    inflate = config.box_noise if config.random_box else 0.0
    frac = max(
        max_hit_fraction(s, use_off=config.random_box, inflate=inflate)
        for s in dataset.scenes.values()
    )
    if frac == 0.0:
        return 0.0
    cap = min(1.0, config.model.obj_capacity_margin * frac)
    k = obj_capacity_k(config.batch_size, cap)
    log_fn(
        f"obj_ray_capacity auto: max hit fraction {frac:.4f} "
        f"(extents +{inflate:.2f} m) * margin {config.model.obj_capacity_margin} "
        f"-> capacity {cap:.4f} (k={k} of batch {config.batch_size})"
    )
    return cap


def _host_stats(stats: Dict[str, Any]):
    """(scalars, viz arrays) of a step's stats on the host, with one copy
    from the device for all the scalar tensors."""
    viz = {k: v.detach().cpu().numpy() for k, v in stats.items() if k.startswith("viz/")}
    keys = [k for k, v in stats.items() if torch.is_tensor(v) and not k.startswith("viz/")]
    values = torch.stack([stats[k].detach().float() for k in keys]).cpu().tolist() if keys else []
    scalars = {k: float(v) for k, v in stats.items() if not torch.is_tensor(v)}
    scalars.update(zip(keys, values))
    return scalars, viz


def run_training(
    config: Config,
    data_dir: str,
    train_dir: str,
    max_steps: Optional[int] = None,
    log_fn=print,
    device="cuda",
    group: Optional[parallel.Group] = None,
) -> TrainState:
    """The training loop (durf_tpu/train.py:500-670), on the card unless the
    caller asks for the CPU. Resumes from the latest checkpoint in
    `train_dir`; returns the final state.

    Under a group every rank runs the loop on its rows of each global batch
    (on the group's device), loads the scene and restores; rank 0's state
    is broadcast after init and restore, and rank 0 alone logs and writes
    checkpoints, metrics and images (the JAX loop's is_host0)."""
    group = parallel.one_process(device) if group is None else group
    device, rank0 = group.device, group.is_rank0
    if not rank0:
        log_fn = lambda *args, **kwargs: None  # noqa: E731
    rows = group.rows(config.batch_size)  # the global batch must divide the world size
    parallel.build_kernels(group)
    max_steps = config.max_steps if max_steps is None else max_steps

    t0 = time.perf_counter()
    dataset = get_dataset("train", data_dir, config)
    test_dataset = get_dataset("test", data_dir, config)
    log_fn(
        f"scene: {dataset.size} train and {test_dataset.size} test images loaded in "
        f"{time.perf_counter() - t0:.3f} s"
    )

    if config.model.obj_ray_capacity < 0.0:
        config.model.obj_ray_capacity = resolve_obj_capacity(config, dataset, log_fn)

    example = dataset.peek()
    model = construct_model(config.model, example, device, seed=TRAIN_SEED)
    num_params = sum(p.numel() for p in model.parameters())
    log_fn(f"params being optimized: {num_params}")

    optimizer = make_optimizer(config, model)
    state = create_train_state(config, model, optimizer)
    ckpt = CheckpointManager(train_dir, keep=config.checkpoint_keep)
    state = parallel.replicate(ckpt.restore(state), group)
    init_step = state.step
    if init_step > 0:
        log_fn(f"resumed from the checkpoint of step {init_step} in {train_dir}")

    train_step = make_train_step(model, config, optimizer, seed=TRAIN_SEED, group=group)

    # Device-resident fast path: the pools go to the device once and each
    # step draws its batch there (data/device_data.py); under c2f every
    # pyramid level's pools stay resident. Host streaming otherwise.
    use_device_data = (
        config.device_resident_data
        and config.batching == "timestep"
        and device_data.pool_bytes(dataset) <= config.device_data_max_bytes
    )
    if use_device_data:
        t0 = time.perf_counter()
        pools = (
            device_data.build_pools_c2f(dataset, device)
            if config.use_c2f
            else [device_data.build_pools(dataset, device)]
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        c2f_steps = tuple(config.c2f_steps)
        log_fn(
            f"device-resident data: {device_data.pool_bytes(dataset) >> 20} MiB of pools "
            f"uploaded in {time.perf_counter() - t0:.3f} s"
        )

        def next_batch(step: int) -> Dict[str, Any]:
            return device_data.sample_batch_c2f(
                pools, step, c2f_steps, SAMPLE_SEED, config.batch_size, rows
            )
    else:
        # Every rank's prefetch thread draws the global batch from the
        # shared seed; each keeps its rows.
        def next_batch(step: int) -> Dict[str, Any]:
            return batch_to(parallel.shard_batch(next(dataset), config.batch_size, group), device)

    render_chunk = make_render_fn(model, config, device, group)
    alpha_fn = make_alpha_schedule(config)
    writer = metrics.MetricsWriter(train_dir) if rank0 else None
    throughput = metrics.Throughput(config.batch_size, config.model.samples_per_ray())

    # Periodic manual collection instead of ambient ones mid-step
    # (reference train_boxpose.py:416, 441-442).
    gc.disable()
    try:
        for step in range(init_step, max_steps):
            # The c2f schedule keys on the 1-indexed step number
            # (reference train_boxpose.py:421).
            dataset.set_step(step + 1)
            test_dataset.set_step(step + 1)
            state, stats = train_step(state, next_batch(step))
            throughput.tick()

            if (step + 1) % config.gc_every == 0:
                gc.collect()

            if (step + 1) % config.print_every == 0:
                stats = reduce_stats(stats, config, group)
            if (step + 1) % config.print_every == 0 and rank0:
                host_stats, viz = _host_stats(stats)
                host_stats.update(throughput.report())
                writer.scalars(step + 1, host_stats)
                if viz:
                    n_levels = config.model.num_levels
                    writer.image(
                        step + 1,
                        "train/nerf_weights",
                        vis.render_weight_bars(
                            [viz[f"viz/t_vals_{i}"] for i in range(n_levels)],
                            [viz[f"viz/weights_{i}"] for i in range(n_levels)],
                        ),
                    )
                log_fn(
                    f"step {step + 1}/{max_steps}: loss={host_stats['train/loss']:.4f} "
                    f"psnr={host_stats['train/psnr']:.2f} "
                    f"{host_stats['perf/rays_per_sec']:.0f} rays/s"
                )
                warn_obj_overflow(host_stats, step + 1, log_fn)

            if (step + 1) % config.save_every == 0 and rank0:
                ckpt.save(step + 1, state)

            if config.render_every > 0 and (step + 1) % config.render_every == 0:
                t0 = time.time()
                test_case = next(test_dataset)
                out = evaluate_image(
                    render_chunk, test_case, float(alpha_fn(step + 1)), chunk=config.chunk
                )
                if not rank0:
                    continue
                pixels = test_case["pixels"]
                psnr = float(mathx.mse_to_psnr(torch.tensor(((out["rgb"] - pixels) ** 2).mean())))
                ssim = float(
                    mathx.compute_ssim(
                        torch.from_numpy(np.asarray(out["rgb"], np.float32)),
                        torch.from_numpy(np.asarray(pixels, np.float32)),
                        max_val=1.0,
                    )
                )
                n_rays = int(np.prod(pixels.shape[:2]))
                writer.scalars(
                    step + 1,
                    {
                        "test/psnr": psnr,
                        "test/ssim": ssim,
                        "test/rays_per_sec": n_rays / (time.time() - t0),
                    },
                )
                writer.image(step + 1, "test/pred_rgb", out["rgb"])
                writer.image(step + 1, "test/target_rgb", pixels)
                for k, v in vis.visualize_suite(out["depth"], out["acc"]).items():
                    writer.image(step + 1, f"test/{k}", v)
                log_fn(f"eval step {step + 1}: psnr={psnr:.2f} ssim={ssim:.3f}")
                throughput.reset()  # eval time is not training time
    finally:
        gc.enable()
    if rank0:
        if max_steps % config.save_every != 0 and ckpt.latest_step != max_steps:
            ckpt.save(max_steps, state, force=True)
        ckpt.wait()
        writer.close()
    return state


def main(argv=None, log_fn=print) -> TrainState:
    """The training CLI (see the module docstring); returns the final state.
    `log_fn` receives the loop's log lines."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--gin_file", action="append", default=[])
    p.add_argument("--gin_param", action="append", default=[])
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--render_every", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; a --multihost rank takes cuda:LOCAL_RANK) or 'cpu'")
    p.add_argument(
        "--multihost",
        action="store_true",
        help="data-parallel training over the ranks torchrun starts (NCCL on the cards, "
        "gloo with --device cpu)",
    )
    p.add_argument(
        "--profile_dir",
        default=None,
        help="trace the run with torch.profiler and write trace.json here",
    )
    args = p.parse_args(argv)
    config = load_config(args.gin_file, args.gin_param)
    if args.chunk is not None:
        config.chunk = args.chunk
    if args.render_every is not None:
        config.render_every = args.render_every
    with parallel.joined(args.multihost, args.device) as group:
        trace = args.profile_dir and group.is_rank0
        profiler = metrics.start_profiler(args.profile_dir) if trace else None
        try:
            return run_training(
                config, args.data_dir, args.train_dir, max_steps=args.max_steps,
                log_fn=log_fn, device=args.device, group=group,
            )
        finally:
            if profiler is not None:
                metrics.stop_profiler(profiler, args.profile_dir)


if __name__ == "__main__":
    main()
