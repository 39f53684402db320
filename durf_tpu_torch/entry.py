"""Entry points: the flagship eval forward, like the JAX package's
`__graft_entry__.entry()`, and the flagship training step that bench.py
builds (bench.py:147-172), with bench.py's object-ray compaction; each
optionally with proposal levels (bench.py --proposal, the switch that
configs/waymo_fast.gin turns on)."""

from __future__ import annotations

import torch

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
):
    """(step_fn, state, batch): the flagship training step at the kernel
    operating point (bf16, K1-K4, recurrent encode, coordinate-major
    diagonal pipeline), weights from seed 0, a synthetic `batch_size`-ray
    batch on the device and step_fn(state, batch) -> (state, stats). The
    step is randomized with a gray background and no density noise, as the
    flagship config sets. `obj_capacity` is bench.py's object-ray compaction
    fraction (bench.py:59-67; 0 turns compaction off); `fused_objects=False`
    takes the per-object route (K1/K2 once per object; `bench.py
    --no-fused_objects`). `proposal` and `proposal_samples` are bench.py's
    --proposal and --proposal_samples (see with_proposal). `constant_lr`
    replaces the delayed log-lerp schedule by a constant rate (as
    __graft_entry__.py:142-144 does for a short run).
    Runs on the card unless the caller asks for the CPU; raises when there
    is no card."""
    device = resolve_device(device)
    config = with_proposal(kernel_operating_point(flagship_config()), proposal, proposal_samples)
    config.batch_size = batch_size
    config.model.obj_ray_capacity = obj_capacity
    config.model.fused_objects = fused_objects
    if constant_lr is not None:
        config.lr_init = config.lr_final = constant_lr
        config.lr_delay_steps = 0
    host_batch = example_ray_batch(batch_size=batch_size)
    model = construct_model(config.model, host_batch, device)
    optimizer = make_optimizer(config, model)
    state = create_train_state(config, model, optimizer)
    step_fn = make_train_step(model, config, optimizer)
    return step_fn, state, batch_to(host_batch, device)
