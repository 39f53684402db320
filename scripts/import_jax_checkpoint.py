#!/usr/bin/env python3
"""Import a checkpoint of the JAX package into the PyTorch port's format.

    python scripts/import_jax_checkpoint.py --jax_dir RUN_DIR --out_dir PORT_DIR [--step N]

Reads the JAX checkpoint of step N (default the latest) with
`durf_tpu.checkpoints.CheckpointManager.restore_raw` (Orbax) and writes the
port's checkpoint of the same step into PORT_DIR
(`durf_tpu_torch.checkpoints`): the parameters, pose table included,
through `durf_tpu_torch.params.params_from_flax`, the step and, for a run
with grid sampling, the occupancy grid. The Adam
moments are not carried over: a run resumed from the imported checkpoint
starts Adam with fresh moments, its learning-rate schedule at the imported
step. Needs Orbax, so it runs where the JAX package runs; the port itself
then reads the result without JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from durf_tpu.checkpoints import CheckpointManager as JaxCheckpointManager  # noqa: E402
from durf_tpu_torch.checkpoints import CheckpointManager  # noqa: E402
from durf_tpu_torch.params import params_from_flax  # noqa: E402


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def import_checkpoint(jax_dir: str, out_dir: str, step: int | None = None) -> int:
    """Convert checkpoint `step` (default the latest) of `jax_dir` into a
    port checkpoint in `out_dir`. Returns the step written."""
    jax_mgr = JaxCheckpointManager(jax_dir, async_save=False)
    try:
        raw = jax_mgr.restore_raw(step)
    finally:
        jax_mgr.close()
    grid = raw.get("grid")
    saved_step = int(np.asarray(raw["step"]))
    payload = {
        "step": saved_step,
        "model": params_from_flax(_numpy_tree(raw["params"])),
        "optimizer": None,  # fresh Adam moments
        "count": saved_step,
        "grid": None if grid is None else torch.from_numpy(np.array(grid, dtype=np.float32)),
    }
    CheckpointManager(out_dir).save_raw(saved_step, payload, force=True)
    return saved_step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--jax_dir", required=True, help="train_dir of a JAX run")
    p.add_argument("--out_dir", required=True, help="train_dir of the port's run")
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    args = p.parse_args(argv)
    step = import_checkpoint(args.jax_dir, args.out_dir, args.step)
    print(f"imported step {step} of {args.jax_dir} into {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
