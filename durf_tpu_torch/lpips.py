"""AlexNet-LPIPS in PyTorch, loading LOCAL weights (the port's counterpart
of the JAX package's `lpips.py`).

The reference's eval notebook scores LPIPS through the `lpips` pip package
(notebooks/render_eval_durf.ipynb cell 5), which downloads torchvision
weights; a machine without network access cannot. This module computes the
metric from a weights file the user provides, in either layout the JAX
package reads:

  * a torch checkpoint of `lpips.LPIPS(net='alex').state_dict()`: keys
    `net.slice{k}.{i}.weight/bias` for the AlexNet convs and
    `lin{k}.model.1.weight` for the learned per-channel calibration; or
  * an .npz with keys `conv{k}_weight` [out,in,kh,kw], `conv{k}_bias`,
    `lin{k}` [C] (k = 0..4).

Metric (Zhang et al. 2018, "The Unreasonable Effectiveness of Deep
Features"): images in [0, 1] are affinely normalized, pushed through
AlexNet's five ReLU stages, each stage's features unit-normalized over
channels; LPIPS = sum over stages of the spatial mean of the calibrated
squared differences. The convolutions run in float32 with TF32 off in the
metric's own scope, so a score on the card is the CPU's score.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from durf_tpu_torch.devices import resolve_device

# torchvision alexnet.features conv specs feeding the five ReLU taps:
# (out_ch, in_ch, kernel, stride, padding), with 3x2-stride maxpools after
# taps 1, 2 and (never used by LPIPS) 5.
_CONVS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
_POOL_BEFORE = {1, 2}  # maxpool before convs 1 and 2
# original torchvision `features` indices of the five convs, as preserved in
# the lpips package's slice modules.
_SLICE_KEYS = ["slice1.0", "slice2.3", "slice3.6", "slice4.8", "slice5.10"]

# lpips ScalingLayer constants (inputs are first mapped [0,1] -> [-1,1]).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _load_state(path: str) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], List[np.ndarray]]:
    """-> ([(conv_w [o,i,kh,kw], conv_b [o])], [lin [C]])."""
    if path.endswith(".npz"):
        z = np.load(path)
        convs = [
            (np.asarray(z[f"conv{k}_weight"], np.float32), np.asarray(z[f"conv{k}_bias"], np.float32))
            for k in range(5)
        ]
        lins = [np.asarray(z[f"lin{k}"], np.float32).reshape(-1) for k in range(5)]
        return convs, lins
    sd = torch.load(path, map_location="cpu", weights_only=True)

    def get(key):
        return np.asarray(sd[key].detach().cpu().numpy(), np.float32)

    convs = [(get(f"net.{k}.weight"), get(f"net.{k}.bias")) for k in _SLICE_KEYS]
    lins = [get(f"lin{k}.model.1.weight").reshape(-1) for k in range(5)]
    return convs, lins


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x**2, dim=1, keepdim=True) + eps)


class LPIPS(nn.Module):
    """forward(img0, img1) -> the batch-mean LPIPS distance (0-d tensor);
    images [H, W, 3] or [N, H, W, 3] in [0, 1]."""

    def __init__(self, convs, lins):
        super().__init__()
        for k, ((w, b), lin) in enumerate(zip(convs, lins)):
            self.register_buffer(f"conv{k}_weight", torch.as_tensor(w, dtype=torch.float32))
            self.register_buffer(f"conv{k}_bias", torch.as_tensor(b, dtype=torch.float32))
            self.register_buffer(f"lin{k}", torch.as_tensor(lin, dtype=torch.float32))
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.from_numpy(_SCALE)[None, :, None, None])

    def _prep(self, im) -> torch.Tensor:
        im = torch.as_tensor(im, dtype=torch.float32, device=self.shift.device)
        if im.ndim == 3:
            im = im[None]
        im = im.permute(0, 3, 1, 2)  # NHWC -> NCHW
        return (im * 2.0 - 1.0 - self.shift) / self.scale

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[N, 3, H, W] in lpips-normalized space -> the five ReLU taps."""
        taps = []
        for k, (_, _, _, stride, pad) in enumerate(_CONVS):
            if k in _POOL_BEFORE:
                x = F.max_pool2d(x, kernel_size=3, stride=2)
            w, b = getattr(self, f"conv{k}_weight"), getattr(self, f"conv{k}_bias")
            x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
            taps.append(x)
        return taps

    def forward(self, img0, img1) -> torch.Tensor:
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False,
        ):
            f0 = self._features(self._prep(img0))
            f1 = self._features(self._prep(img1))
            total = torch.zeros((), device=self.shift.device)
            for k, (t0, t1) in enumerate(zip(f0, f1)):
                d = (_unit_normalize(t0) - _unit_normalize(t1)) ** 2
                lin = getattr(self, f"lin{k}")[None, :, None, None]
                total = total + torch.mean(torch.sum(lin * d, dim=1))
        return total


def load_lpips(path: str, device="cuda"):
    """Build `lpips(img0, img1) -> float` from a local weights file, on the
    card unless the caller asks for the CPU.

    img0/img1: [H, W, 3] (or [N, H, W, 3]) in [0, 1], numpy or tensors.
    Returns the batch-mean LPIPS distance. Raises FileNotFoundError /
    KeyError on a missing or foreign-format file; callers gate on that
    (durf_tpu_torch.eval).
    """
    device = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    net = LPIPS(*_load_state(path)).to(device)
    return lambda a, b: float(net(a, b))


def save_random_weights(path: str, seed: int = 0) -> None:
    """Write a VALID-format random .npz (test fixture: the loader/topology
    contract without the real calibration); the same file as the JAX
    package's for one seed."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k, (o, i, kern, _, _) in enumerate(_CONVS):
        out[f"conv{k}_weight"] = rng.normal(0, 0.05, (o, i, kern, kern)).astype(np.float32)
        out[f"conv{k}_bias"] = np.zeros(o, np.float32)
        out[f"lin{k}"] = rng.uniform(0, 1, (o,)).astype(np.float32)
    np.savez(path, **out)
