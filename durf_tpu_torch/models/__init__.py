from durf_tpu_torch.models.mipnerf import MipNerf, construct_model, render_image
from durf_tpu_torch.models.mlp import NerfMLP, get_activation

__all__ = ["MipNerf", "construct_model", "render_image", "NerfMLP", "get_activation"]
