"""Configuration: typed dataclasses plus a gin-compatible config-file parser.

The port's own copy of the JAX package's `configs` module (same class names,
field names and defaults, so the same .gin files parse onto either package).
The parser reads the reference's gin syntax (`Scope.field = literal`,
comments, tuples) without the gin dependency.
"""

from __future__ import annotations

import ast
import warnings
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass
class MLPConfig:
    """MLP hyperparameters (reference obbpose_model.py:293-303, 357-367)."""

    net_depth: int = 8  # layers in the trunk
    net_width: int = 256  # trunk width
    net_depth_condition: int = 1  # layers in the viewdir-conditioned head
    net_width_condition: int = 128  # head width
    net_activation: str = "relu"
    skip_layer: int = 4  # concat the input after every N trunk layers
    num_rgb_channels: int = 3
    num_density_channels: int = 1


@dataclass
class ModelConfig:
    """MipNerfModel hyperparameters (reference obbpose_model.py:42-66).

    The port implements the coordinate-major diagonal pipeline, eval and
    training forward; `models.mipnerf.check_supported` raises
    NotImplementedError for the fields whose paths are not ported yet
    (occupancy grid, row-major / full-covariance pipelines, remat_mlp, the
    kernels without use_viewdirs).
    """

    num_samples: int = 128  # samples per level
    num_levels: int = 2  # sampling levels (coarse, fine)
    resample_padding: float = 0.01  # histogram padding for level-2 resampling
    stop_level_grad: bool = True  # block gradients across levels
    use_viewdirs: bool = True
    lindisp: bool = False  # sample in disparity instead of depth
    ray_shape: str = "cone"  # 'cone' | 'cylinder'
    min_deg_point: int = 0
    max_deg_point: int = 10
    deg_view: int = 4
    num_objects: int = 2  # moving objects in the scene graph
    density_activation: str = "softplus"
    density_noise: float = 0.1  # stddev of raw-density regularization noise
    density_bias: float = -1.0
    rgb_activation: str = "sigmoid"
    rgb_padding: float = 0.001
    disable_integration: bool = False  # PE instead of IPE
    contraction: bool = True  # mip360 unbounded-scene contraction
    contract_threshold: float = 0.1  # reference uses 0.1 (paper: 1.0)
    dynamics: bool = True  # scene-graph object decomposition
    timesteps: int = 5
    no_pose_opt: bool = False  # stop-gradient on box translations
    no_yaw_opt: bool = False  # stop-gradient on box rotations
    # Sample box-hitting rays inside [z_in - margin, z_out + margin] instead
    # of the global near/far.
    use_box_nearfar: bool = False
    box_nearfar_margin: float = 5.0
    # Occupancy-grid level-0 sampling.
    grid_sampling: bool = False
    grid_resolution: int = 96
    grid_probes: int = 128
    grid_floor: float = 1e-2
    grid_decay: float = 0.995
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' MLP compute
    # Hand-written fused MLP kernels (the background MLP and the
    # objects-in-grid MLP; ops/kernels/).
    use_pallas_mlp: bool = False
    remat_mlp: bool = False  # recompute the MLP trunk in the backward
    # Objects-in-grid kernel: all object MLPs in one launch (needs
    # use_pallas_mlp, coord_major and dynamics).
    fused_objects: bool = True
    # Plain (unguarded) trig in the encodings instead of safe_sin.
    fast_trig: bool = False
    # Recurrence IPE: one exp/sin/cos per coordinate every 5 degrees, the
    # degrees between built by repeated squaring and double angles.
    recurrent_encode: bool = False
    diag_covariance: bool = True  # diagonal-covariance pipeline
    coord_major: bool = True  # [3, B, S] sample planes (diag only)
    obj_ray_capacity: float = 0.0  # object-ray compaction (0 = off)
    obj_capacity_margin: float = 2.0
    centering_mode: str = "midrange"
    centering_beta: float = 16.0
    centering_tau: float = 1.0
    # Proposal-MLP coarse levels (mip-NeRF 360).
    use_proposal: bool = False
    proposal_mlp: MLPConfig = field(
        default_factory=lambda: MLPConfig(net_depth=4, net_width=128)
    )
    proposal_samples: int = 0
    mlp: MLPConfig = field(default_factory=MLPConfig)
    box_mlp: MLPConfig = field(default_factory=lambda: MLPConfig(net_width=128))

    def level_samples(self, i_level: int) -> int:
        """Samples drawn at level i (proposal levels may differ)."""
        if (
            self.use_proposal
            and self.proposal_samples > 0
            and i_level < self.num_levels - 1
        ):
            return self.proposal_samples
        return self.num_samples

    def samples_per_ray(self) -> int:
        """Total MLP-evaluated samples per ray across all levels (the
        ray-samples throughput denominator)."""
        return sum(self.level_samples(i) for i in range(self.num_levels))

    def __post_init__(self):
        if self.recurrent_encode and not self.contraction and not self.fast_trig:
            warnings.warn(
                "recurrent_encode ignores the safe_sin range guard (its "
                "recurrence seeds call raw trig); with contraction=False the "
                "uncontracted 2^deg*x inputs are unbounded. Enable "
                "contraction, or disable recurrent_encode.",
                stacklevel=2,
            )


@dataclass
class Config:
    """Training/data configuration, field-compatible with reference
    internal/utils.py:89-144."""

    dataset_loader: str = "multicam"
    batching: str = "all_images"
    batch_size: int = 4096  # rays per optimization step (global)
    factor: int = 0
    spherify: bool = False
    centering: bool = False
    random_box: bool = False
    random_yaw: bool = False
    box_noise: float = 0.5
    yaw_noise: float = 5.0
    render_path: bool = False
    llffhold: int = 8
    timesteps: int = 5
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    eps_delay_steps: int = 0
    eps_init: float = 3.0
    eps_final: float = 0.2
    eps_max_steps: int = 1_000_000
    l2_reg: bool = False
    alpha_init: float = 0.0
    alpha_final: float = 10.0
    alpha_delay_steps: int = 0
    alpha_max_steps: int = 1_000_000
    psreg_init: float = 10e5
    psreg_final: float = 10e-1
    psreg_delay_steps: int = 5000
    psreg_delay_mult: float = 1.0
    tv_loss_mult: float = 0.0001
    depth_loss_mult: float = 0.0001
    near_loss_mult: float = 0.01
    empty_loss_mult: float = 1.0
    sky_loss_mult: float = 1.0
    distortion_loss_mult: float = 1e-6
    c2f_steps: Tuple[int, ...] = (5000, 10000, 15000)
    grad_max_norm: float = 0.0
    grad_max_val: float = 0.0
    max_steps: int = 1_000_000
    save_every: int = 100_000
    print_every: int = 100
    gc_every: int = 10_000
    test_render_interval: int = 1
    render_every: int = 5000
    chunk: int = 8192
    disable_multiscale_loss: bool = False
    randomized: bool = True
    near: float = 2.0
    far: float = 6.0
    coarse_loss_mult: float = 0.1
    proposal_loss_mult: float = 1.0
    box_loss_mult: float = 0.0
    centering_loss_mult: float = 0.0
    box_surface_loss_mult: float = 0.0
    box_surface_margin: float = 0.2
    weight_decay_mult: float = 0.0
    white_bkgd: bool = False
    rand_bkgd: bool = True
    test_indices: Tuple[int, ...] = ()
    device_resident_data: bool = True
    device_data_max_bytes: int = 4 << 30
    use_c2f: bool = False
    exact_distortion: bool = False
    pose_lr_mult: float = 1.0
    pose_lr_delay_steps: int = 0
    pose_lr_ramp_steps: int = 1000
    pose_lr_decay_steps: int = 0
    pose_freeze_field: bool = False
    checkpoint_keep: int = 100
    data_parallel_axis: str = "data"
    model: ModelConfig = field(default_factory=ModelConfig)


# Mapping of gin binding targets onto (object path inside Config).
_SCOPE_TO_PATH = {
    "Config": (),
    "MipNerfModel": ("model",),
    "MLP": ("model", "mlp"),
    "BoxMLP": ("model", "box_mlp"),
    "ProposalMLP": ("model", "proposal_mlp"),
}

# gin external_configurable names used by the reference configs.
_ACTIVATION_NAMES = {
    "flax.nn.relu": "relu",
    "flax.nn.sigmoid": "sigmoid",
    "flax.nn.softplus": "softplus",
    "@flax.nn.relu": "relu",
    "@flax.nn.sigmoid": "sigmoid",
    "@flax.nn.softplus": "softplus",
}


def _coerce(value: Any, current: Any) -> Any:
    """Coerce a parsed literal to the type of the existing dataclass field."""
    if isinstance(current, bool):
        return bool(value)
    if isinstance(current, int) and not isinstance(value, bool):
        if isinstance(value, float) and value != int(value):
            return value  # keep e.g. eps_final=0.2 on an int-hinted field
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(value)
    return value


def apply_binding(config: Config, scope: str, name: str, value: Any) -> None:
    """Apply one `Scope.name = value` binding onto the config tree."""
    if scope not in _SCOPE_TO_PATH:
        raise ValueError(f"unknown config scope {scope!r}")
    target = config
    for attr in _SCOPE_TO_PATH[scope]:
        target = getattr(target, attr)
    if not hasattr(target, name):
        raise ValueError(f"unknown config field {scope}.{name}")
    setattr(target, name, _coerce(value, getattr(target, name)))


def parse_gin_lines(config: Config, lines) -> Config:
    """Parse reference-style gin lines onto `config` (in place; returned)."""
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"cannot parse config line: {raw!r}")
        lhs, rhs = (s.strip() for s in line.split("=", 1))
        if "." not in lhs:
            raise ValueError(f"expected Scope.field on lhs: {raw!r}")
        scope, name = lhs.split(".", 1)
        if rhs in _ACTIVATION_NAMES:
            value: Any = _ACTIVATION_NAMES[rhs]
        else:
            value = ast.literal_eval(rhs)
        apply_binding(config, scope, name, value)
    return config


def load_config(gin_files=(), bindings=(), base: Config | None = None) -> Config:
    """Build a Config from gin files plus `Scope.field=value` override strings
    (reference utils.load_config, utils.py:162-165, without gin)."""
    config = base if base is not None else Config()
    for path in gin_files:
        with open(path) as f:
            parse_gin_lines(config, f.readlines())
    parse_gin_lines(config, bindings)
    return config

