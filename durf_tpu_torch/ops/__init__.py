"""Ray, frustum, encoding, sampling, rendering and box ops (coordinate-major
diagonal pipeline), plus the hand-written kernels under `ops.kernels`."""

from durf_tpu_torch.ops.boxes import (
    axis_angle_to_matrix,
    ray_box_intersection,
    rotate_vec,
    world_to_box_frames,
)
from durf_tpu_torch.ops.contraction import contract, contract_gaussian_diag
from durf_tpu_torch.ops.encoding import (
    integrated_pos_enc_cm,
    pos_enc,
    windowed_ipe_cm,
)
from durf_tpu_torch.ops.frustum import (
    cast_rays_cm,
    conical_frustum_to_gaussian,
    lift_gaussian_cm,
)
from durf_tpu_torch.ops.render import compute_weights, volumetric_rendering_cm
from durf_tpu_torch.ops.sampling import resample_along_rays, sample_along_rays

__all__ = [
    "axis_angle_to_matrix",
    "ray_box_intersection",
    "rotate_vec",
    "world_to_box_frames",
    "contract",
    "contract_gaussian_diag",
    "integrated_pos_enc_cm",
    "pos_enc",
    "windowed_ipe_cm",
    "cast_rays_cm",
    "conical_frustum_to_gaussian",
    "lift_gaussian_cm",
    "compute_weights",
    "volumetric_rendering_cm",
    "resample_along_rays",
    "sample_along_rays",
]
