"""Entry points: the flagship eval forward, like the JAX package's
`__graft_entry__.entry()`, the flagship training step that bench.py
builds (bench.py:147-172), with every flag of bench.py's that shapes the
step (object-ray compaction, the object route, proposal levels, the
occupancy grid, remat, box near/far, the compute dtype, the kernels and
the recurrent encode), on one process or a rank of a data-parallel group,
and `dryrun_multichip`, the data-parallel run's contract
(__graft_entry__.py:101-195)."""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch

from durf_tpu_torch import parallel
from durf_tpu_torch.configs import Config, MLPConfig, ModelConfig
from durf_tpu_torch.data.synthetic import example_ray_batch
from durf_tpu_torch.devices import resolve_device
from durf_tpu_torch.models.mipnerf import construct_model
from durf_tpu_torch.train import (
    batch_to,
    create_train_state,
    make_optimizer,
    make_render_fn,
    make_train_step,
    reduce_stats,
)


def flagship_config(tiny: bool = False) -> Config:
    """The flagship operating point: the reference waymo.gin widths (2
    levels x 128 samples, 8x256 background MLP, two 8x128 object MLPs)."""
    if tiny:
        model = ModelConfig(
            num_samples=8,
            num_levels=2,
            max_deg_point=4,
            deg_view=2,
            num_objects=2,
            timesteps=5,
            density_noise=0.0,
            no_pose_opt=True,
            no_yaw_opt=True,
            mlp=MLPConfig(net_depth=2, net_width=16, net_width_condition=8),
            box_mlp=MLPConfig(net_depth=2, net_width=8, net_width_condition=8),
        )
    else:
        model = ModelConfig(
            num_samples=128,
            num_levels=2,
            max_deg_point=10,
            deg_view=4,
            num_objects=2,
            timesteps=5,
            density_noise=0.0,
            no_pose_opt=True,
            no_yaw_opt=True,
        )
    return Config(
        dataset_loader="waymo",
        batching="timestep",
        batch_size=512,
        near=0.0,
        far=40.0,
        rand_bkgd=False,
        randomized=True,
        grad_max_norm=1.0,
        grad_max_val=0.1,
        depth_loss_mult=1e-4,
        near_loss_mult=0.01,
        empty_loss_mult=1.0,
        sky_loss_mult=1.0,
        tv_loss_mult=0.0,
        eps_init=3.0,
        eps_final=0.2,
        eps_max_steps=200_000,
        alpha_init=10.0,
        alpha_final=10.0,
        alpha_max_steps=1,
        max_steps=200_000,
        model=model,
    )


def kernel_operating_point(config: Config) -> Config:
    """Switch a config to the kernel operating point (in place; returned):
    bf16 MLP compute, the fused MLP kernels (K1 background, K3 objects),
    recurrent encode, coordinate-major diagonal pipeline."""
    m = config.model
    m.compute_dtype = "bfloat16"
    m.use_pallas_mlp = True
    m.fused_objects = True
    m.recurrent_encode = True
    m.diag_covariance = True
    m.coord_major = True
    return config


def with_proposal(config: Config, proposal: bool, proposal_samples: int = 0) -> Config:
    """Turn proposal levels on or off (in place; returned), as bench.py's
    --proposal and --proposal_samples do (bench.py:159-160): level 0 runs
    the default 4x128 proposal MLP, with `proposal_samples` samples when
    positive."""
    config.model.use_proposal = proposal
    config.model.proposal_samples = proposal_samples
    return config


def entry(device="cuda", proposal: bool = False):
    """(forward, example_args): the flagship model at the kernel operating
    point with weights from seed 0, and a forward(rays, ext, ts) -> (rgb,
    depth, acc) of its last level through `train.make_render_fn`.
    `proposal` renders with proposal levels (the proposal MLP's weights
    drawn after the others). Runs on the card unless the caller asks for
    the CPU; raises when there is no card."""
    device = resolve_device(device)
    config = with_proposal(kernel_operating_point(flagship_config()), proposal)
    batch = example_ray_batch(batch_size=config.batch_size)
    model = construct_model(config.model, batch, device)
    render = make_render_fn(model, config, device)

    def forward(rays, ext, ts):
        out = render(rays, ext, ts, 10.0)
        return out["rgb"], out["depth"], out["acc"]

    example_args = (
        batch["rays"].to(device),
        torch.as_tensor(batch["ext"], device=device),
        int(batch["ts"]),
    )
    return forward, example_args


def train_entry(
    device="cuda",
    batch_size: int = 4096,
    constant_lr: float | None = None,
    obj_capacity: float = 0.0625,
    fused_objects: bool = True,
    proposal: bool = False,
    proposal_samples: int = 0,
    grid_sampling: bool = False,
    remat: bool = False,
    use_box_nearfar: bool = False,
    dtype: str = "bfloat16",
    pallas: bool = True,
    recurrent_encode: bool = True,
    coord_major: bool = True,
    diag_covariance: bool = True,
    group: Optional[parallel.Group] = None,
):
    """(step_fn, state, batch): the flagship training step at the kernel
    operating point (bf16, K1-K4, recurrent encode, coordinate-major
    diagonal pipeline), weights from seed 0, a synthetic `batch_size`-ray
    batch on the device and step_fn(state, batch) -> (state, stats). The
    step is randomized with a gray background and no density noise, as the
    flagship config sets.

    The other arguments are bench.py's flags (bench.py:29-112, 147-160):
    `obj_capacity` its object-ray compaction fraction (0 turns compaction
    off); `fused_objects=False` the per-object route (K1/K2 once per
    object); `proposal` and `proposal_samples` proposal levels (see
    with_proposal); `grid_sampling` occupancy-grid level-0 sampling (the
    state then carries the grid and each step updates it); `remat`
    recomputes the plain MLP path in the backward; `use_box_nearfar`
    samples box-hitting rays inside their box's span; `dtype` the MLP
    compute dtype; `pallas=False` the plain MLP path instead of the
    kernels; `recurrent_encode=False` the direct IPE. `coord_major=False`
    (row-major samples) and `diag_covariance=False` (the full covariance,
    row-major too) select the model's other pipelines, which bench.py has
    no flag for; on them the objects take the per-object route. `constant_lr`
    replaces the delayed log-lerp schedule by a constant rate (as
    __graft_entry__.py:142-144 does for a short run).
    Runs on the card unless the caller asks for the CPU; raises when there
    is no card. With a `group` the step is a rank's of the data-parallel
    step on the global `batch_size`-ray batch: `batch` holds the rank's
    rows, the state is rank 0's (broadcast) on the group's device, and the
    stats need train.reduce_stats."""
    group = parallel.one_process(device) if group is None else group
    device = group.device
    config = with_proposal(kernel_operating_point(flagship_config()), proposal, proposal_samples)
    config.batch_size = batch_size
    m = config.model
    m.obj_ray_capacity = obj_capacity
    m.fused_objects = fused_objects
    m.grid_sampling = grid_sampling
    m.remat_mlp = remat
    m.use_box_nearfar = use_box_nearfar
    m.compute_dtype = dtype
    m.use_pallas_mlp = pallas
    m.recurrent_encode = recurrent_encode
    m.coord_major = coord_major
    m.diag_covariance = diag_covariance
    if constant_lr is not None:
        config.lr_init = config.lr_final = constant_lr
        config.lr_delay_steps = 0
    host_batch = example_ray_batch(batch_size=batch_size)
    local = parallel.shard_batch(host_batch, batch_size, group)
    parallel.build_kernels(group)
    model = construct_model(config.model, host_batch, device)
    optimizer = make_optimizer(config, model)
    state = parallel.replicate(create_train_state(config, model, optimizer), group)
    step_fn = make_train_step(model, config, optimizer, group=group)
    return step_fn, state, batch_to(local, device)


def dryrun_config(n_ranks: int) -> Config:
    """dryrun_multichip's config (__graft_entry__.py:131-144): the tiny
    flagship at 32 rays a rank, compaction at capacity 0.5 once the batch
    exceeds k's floor of 128, and a constant lr of 5e-3 so that 20 steps on
    a fixed batch must descend."""
    config = flagship_config(tiny=True)
    config.batch_size = 32 * n_ranks
    if config.batch_size > 128:
        config.model.obj_ray_capacity = 0.5
    config.lr_init = config.lr_final = 5e-3
    config.lr_delay_steps = 0
    return config


DRYRUN_STEPS = 20


def dryrun_rank(group: parallel.Group) -> dict:
    """One rank of dryrun_multichip: DRYRUN_STEPS data-parallel steps that
    must descend, then one eval chunk rendered over the group and held
    against the same chunk rendered by this rank alone (rtol and atol
    1e-5). Returns the losses, the step and the chunk's checksum."""
    config = dryrun_config(group.size)
    batch = example_ray_batch(batch_size=config.batch_size)
    model = construct_model(config.model, batch, group.device)
    optimizer = make_optimizer(config, model)
    state = parallel.replicate(create_train_state(config, model, optimizer), group)
    train_step = make_train_step(model, config, optimizer, group=group)
    local = batch_to(parallel.shard_batch(batch, config.batch_size, group), group.device)
    losses = []
    for _ in range(DRYRUN_STEPS):
        state, stats = train_step(state, local)
        losses.append(float(reduce_stats(stats, config, group)["train/loss"]))
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"dryrun loss not finite: {losses}")
    if state.step != DRYRUN_STEPS:
        raise RuntimeError(f"dryrun ran {state.step} steps, not {DRYRUN_STEPS}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(
            f"data-parallel optimization failed to descend: {losses[0]:.4f} -> {losses[-1]:.4f}"
        )
    # Eval parity: the per-ray forward has no cross-ray reduction but the
    # compaction budget, so the chunk must not depend on how it was split.
    args = (batch["rays"], batch["ext"], int(batch["ts"]), 10.0)
    out_n = make_render_fn(model, config, group=group)(*args)
    out_1 = make_render_fn(copy.deepcopy(model), config, group.device)(*args)
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(
            out_n[k].cpu().numpy(), out_1[k].cpu().numpy(), rtol=1e-5, atol=1e-5,
            err_msg=f"eval '{k}' differs between {group.size} ranks and 1",
        )
    checksum = float(out_n["rgb"].double().sum())
    return {"losses": losses, "step": state.step, "checksum": checksum}


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The data-parallel contract (__graft_entry__.dryrun_multichip): spawn
    n_ranks ranks on localhost, each running dryrun_rank; prints the
    checksum line and returns rank 0's result. On the CPU the ranks join
    over gloo. On the card each rank takes its own card over NCCL where
    there are n_ranks of them; with fewer they share cuda:0 over gloo
    (NCCL refuses two ranks on one card)."""
    device = resolve_device(device)
    backend = None
    if device.type == "cuda" and torch.cuda.device_count() < n_ranks:
        device, backend = torch.device("cuda", 0), "gloo"
    result = parallel.spawn(dryrun_rank, n_ranks, device=device, backend=backend)[0]
    losses = result["losses"]
    print(
        f"dryrun_multichip({n_ranks}): {DRYRUN_STEPS} data-parallel train steps OK "
        f"(loss {losses[0]:.4f} -> {losses[-1]:.4f}), eval chunk checksum "
        f"{result['checksum']:.6f} matches the single-rank render"
    )
    return result
