"""Weights between the JAX package's flax parameter tree and the port.

The flax tree (as numpy arrays) has `background_mlp/<layer>/{kernel,bias}`,
`object_mlps/<layer>/{kernel,bias}` with every leaf stacked [N_obj, ...],
with proposal levels `proposal_mlp/<layer>/{kernel,bias}` (unstacked),
and the pose table `box_centers` [T, N_obj, 6]; layer names are trunk_i,
density_head, bottleneck, head_i and rgb_head. The port keeps the same
leaves under `<mlp>.layers.<layer>.{kernel,bias}` in its state dict, in the
same layout ([in, out] kernels), so both directions are plain copies and the
round trip is bit-exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_MLPS = ("background_mlp", "object_mlps", "proposal_mlp")


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> a MipNerf state dict (CPU float32
    tensors; load with `model.load_state_dict`)."""
    state = {}
    for mlp in _MLPS:
        for layer, leaves in tree.get(mlp, {}).items():
            for leaf in ("kernel", "bias"):
                state[f"{mlp}.layers.{layer}.{leaf}"] = torch.from_numpy(
                    np.array(leaves[leaf], dtype=np.float32)
                )
    if "box_centers" in tree:
        state["box_centers"] = torch.from_numpy(np.array(tree["box_centers"], dtype=np.float32))
    unknown = set(tree) - set(_MLPS) - {"box_centers"}
    if unknown:
        raise NotImplementedError(f"flax params not ported yet: {sorted(unknown)}")
    return state


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A MipNerf state dict -> the flax param tree with numpy leaves."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        arr = value.detach().cpu().numpy().copy()
        if key == "box_centers":
            tree["box_centers"] = arr
            continue
        mlp, _, layer, leaf = key.split(".")
        tree.setdefault(mlp, {}).setdefault(layer, {})[leaf] = arr
    return tree
