"""Data layer (host numpy, plus device-resident pools in torch): the on-disk
scene format with its PNG codec, the scene loader, the prefetching ray
batcher and the synthetic scene generator; the same arrays as the JAX
package's data layer for the same scene directory."""

from durf_tpu_torch.data.pipeline import RayDataset, get_dataset
from durf_tpu_torch.data.scene import DATASET_SPECS, Scene, load_scene

__all__ = ["RayDataset", "get_dataset", "Scene", "load_scene", "DATASET_SPECS"]
