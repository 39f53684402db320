"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and there is no card, so that a
    run never carries on on the CPU by accident."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "durf_tpu_torch: CUDA was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    return device
