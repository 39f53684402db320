"""Ray, frustum, encoding, sampling, rendering and box ops, row-major and
coordinate-major (every name the JAX package's `ops` exports), the
occupancy grid (`ops.grid`), plus the hand-written kernels under
`ops.kernels`."""

from durf_tpu_torch.ops.boxes import (
    axis_angle_to_matrix,
    ray_box_intersection,
    rotate_vec,
    world_to_box_frames,
)
from durf_tpu_torch.ops.contraction import contract, contract_gaussian, contract_gaussian_diag
from durf_tpu_torch.ops.encoding import (
    expected_sin,
    gaussian_fourier_enc,
    integrated_pos_enc,
    integrated_pos_enc_cm,
    pos_enc,
    windowed_ipe,
    windowed_ipe_cm,
    windowed_pos_enc,
)
from durf_tpu_torch.ops.frustum import (
    cast_rays,
    cast_rays_cm,
    conical_frustum_to_gaussian,
    cylinder_to_gaussian,
    lift_gaussian,
    lift_gaussian_cm,
)
from durf_tpu_torch.ops.render import (
    compute_weights,
    distance_from_depth,
    volumetric_density,
    volumetric_rendering,
    volumetric_rendering_cm,
)
from durf_tpu_torch.ops.sampling import resample_along_rays, sample_along_rays

__all__ = [
    "cast_rays",
    "conical_frustum_to_gaussian",
    "cylinder_to_gaussian",
    "lift_gaussian",
    "expected_sin",
    "integrated_pos_enc",
    "pos_enc",
    "windowed_ipe",
    "windowed_pos_enc",
    "resample_along_rays",
    "sample_along_rays",
    "volumetric_density",
    "volumetric_rendering",
    "contract",
    "contract_gaussian",
    "contract_gaussian_diag",
    "axis_angle_to_matrix",
    "ray_box_intersection",
    "rotate_vec",
    "world_to_box_frames",
    "cast_rays_cm",
    "lift_gaussian_cm",
    "integrated_pos_enc_cm",
    "windowed_ipe_cm",
    "volumetric_rendering_cm",
    "gaussian_fourier_enc",
    "compute_weights",
    "distance_from_depth",
]
