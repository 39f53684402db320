"""Checkpoint / resume with torch.save (the JAX package's Orbax manager,
durf_tpu/checkpoints.py, with the same semantics).

A checkpoint is one file, `<directory>/checkpoint_<step>.pt`, holding a
dict of CPU tensors and ints:
  step       the TrainState's step;
  model      the MipNerf state dict;
  optimizer  the torch.optim.Adam state dict inside ScheduledAdam, or None
             (an imported checkpoint: the moments start fresh);
  count      ScheduledAdam's update count (the schedules' clock);
  grid       the occupancy grid under grid_sampling, else None.
A save writes a temporary file and renames it into place, so a reader never
sees half a checkpoint; the newest `keep` are kept. Saves are synchronous:
`wait` has nothing to wait for and is there for the callers of the
asynchronous JAX manager.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def _to_cpu(tree):
    """Every tensor of a nested dict / list as a detached CPU copy."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """save(step, state), restore the latest into a TrainState, keep the
    newest `keep` checkpoints."""

    def __init__(self, directory: str, keep: int = 100):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.keep = keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}.pt")

    def all_steps(self) -> list:
        """Steps with a checkpoint on disk, ascending."""
        return sorted(int(m.group(1)) for n in os.listdir(self.directory)
                      if (m := _NAME.match(n)))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save a TrainState at `step` (see save_raw). Returns whether it saved."""
        payload = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.opt.state_dict(),
            "count": int(state.optimizer.count),
            "grid": state.grid,
        }
        return self.save_raw(step, payload, force)

    def save_raw(self, step: int, payload: Dict[str, Any], force: bool = False) -> bool:
        """Write a checkpoint dict (tensors copied to the CPU). As Orbax does,
        a step at or before the latest saved one is skipped unless `force`,
        and a step that already has a checkpoint raises. Prunes to the newest
        `keep`. Returns whether it saved."""
        latest = self.latest_step
        if not force and latest is not None and step <= latest:
            return False
        final = self.path(step)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint for step {step} already exists: {final}")
        tmp = final + ".tmp"
        torch.save(_to_cpu(payload), tmp)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.keep]:
            os.remove(self.path(old))
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint `step` (default the latest) into `state` in place:
        the model's weights, the optimizer's moments and count, the step and,
        where both the state and the checkpoint have one, the occupancy grid
        (on the state grid's device). Returns `state`, unchanged when there
        is no checkpoint (a fresh run)."""
        step = self.latest_step if step is None else step
        if step is None:
            return state
        payload = self.restore_raw(step)
        state.model.load_state_dict(payload["model"])
        if payload["optimizer"] is not None:
            state.optimizer.opt.load_state_dict(payload["optimizer"])
        state.optimizer.count = int(payload["count"])
        state.step = int(payload["step"])
        if state.grid is not None and payload.get("grid") is not None:
            state.grid = payload["grid"].to(state.grid.device)
        return state

    def restore_raw(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Checkpoint `step` (default the latest) as plain dicts of CPU
        tensors, without a state to load it into."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """No resources are held between calls."""
