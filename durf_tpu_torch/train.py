"""The eval forward of a trained model (the render part of the JAX
package's `train.py`; the training step is not ported yet)."""

from __future__ import annotations

import torch

from durf_tpu_torch.configs import Config
from durf_tpu_torch.devices import resolve_device
from durf_tpu_torch.models.mipnerf import MipNerf
from durf_tpu_torch.rays import Rays


def make_render_fn(model: MipNerf, config: Config, device="cuda"):
    """fn(rays, ext, ts, alpha) -> last-level {'rgb', 'depth', 'acc'} for a
    chunk of rays, without gradients, on `device` (the card unless the
    caller asks for the CPU). Eval never composites a random background
    (reference train_boxpose.py:388)."""
    device = resolve_device(device)
    eval_background = "white" if config.white_bkgd else "gray"
    model = model.to(device).eval()

    def render_chunk(rays: Rays, ext, ts, alpha):
        rays = rays.to(device)
        ext_t = None if ext is None else torch.as_tensor(ext, dtype=torch.float32, device=device)
        with torch.inference_mode():
            out = model(
                rays, ext=ext_t, ts=ts, background=eval_background, alpha=alpha
            )[-1]
        return {"rgb": out["rgb"], "depth": out["depth"], "acc": out["acc"]}

    return render_chunk
