"""The cells' MLP weights, made on the device from --seed in one draw and
handed to both the program and the reference by parameter name:
glorot-uniform kernels (per stacked slice) and zero biases. The pose table
is not a weight the benchmark makes: each side takes it from its own
reading of the traffic."""

from __future__ import annotations

import math

import torch

from portbench.traffic import generator


def make(named_shapes, seed: int, device) -> dict:
    """{name: float32 tensor} for (name, shape) pairs."""
    sizes = [math.prod(s) for _, s in named_shapes]
    u = torch.rand(sum(sizes), generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for (name, shape), n in zip(named_shapes, sizes):
        chunk = u[at:at + n].reshape(shape)
        at += n
        if name.endswith(".kernel"):
            fan_in, fan_out = shape[-2:]
            out[name] = (2.0 * chunk - 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load(module: torch.nn.Module, weights: dict, keep=()) -> None:
    """Copy `weights` into the module's parameters by name; every parameter
    but those in `keep` (left as the module holds them) must be named, with
    its shape."""
    params = {n: p for n, p in module.named_parameters() if n not in keep}
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: shape {tuple(p.shape)} != {tuple(weights[name].shape)}")
            p.copy_(weights[name])
