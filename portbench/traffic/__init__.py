"""The general traffic generator: a workload file's `traffic` parameters in,
the cell's inputs out.

`traffic.source` names the module of this package that makes a scene, found
by name: `<source>.py` gives `generate(t)`, the raw scene of the parameters
`t` (a dict with `timesteps` and `n_obj` among its arrays), `write(raw,
dir)`, the scene in the on-disk layout the port's loader reads, and
`reference_split(raw, c, split)`, the reference's own reading of one split
of it. A new source (another layout, another world) is a new file here.
What is common to every source is in this module: the seed's generators,
the slab test of rays against boxes, and the scene written once to disk.
"""

from __future__ import annotations

import importlib
import shutil
import tempfile

import torch

from portbench.reference.scene import RAY_KEYS  # noqa: F401  (the rays' fields, in order)

SEED_SALT = {"weights": 0x5EED0001, "traffic": 0x5EED0002}


def generator(seed: int, what: str, device) -> torch.Generator:
    """A device generator for one use of the run's seed."""
    return torch.Generator(device=device).manual_seed((seed ^ SEED_SALT[what]) % (1 << 63))


class Scene:
    """A cell's scene: made by its source from the traffic parameters,
    written to a directory under TMPDIR once for the program to load, and
    read by the reference from the raw arrays."""

    def __init__(self, t: dict):
        self.source = importlib.import_module(f"portbench.traffic.{t['source']}")
        self.raw = self.source.generate(t)
        self.timesteps, self.n_obj = self.raw["timesteps"], self.raw["n_obj"]
        self.dir = None

    def directory(self) -> str:
        if self.dir is None:
            self.dir = tempfile.mkdtemp(prefix="portbench_scene_")
            self.source.write(self.raw, self.dir)
        return self.dir

    def close(self) -> None:
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None

    def split(self, c: dict, name: str) -> dict:
        """The reference's reading of split `name` under configuration `c`."""
        return self.source.reference_split(self.raw, c, name)


def hit_matrix(rays: dict, init_row, ext) -> torch.Tensor:
    """[B, N_obj] 0/1: which of the rays hit which box (the slab test in each
    box's frame, boxes at their pose `init_row` [N_obj, 6])."""
    from portbench.reference.nerf import axis_angle_to_matrix, ray_box_intersection, world_to_box_frames

    o, d = rays["origins"], rays["directions"]
    n = init_row.shape[0]
    oo, dd = world_to_box_frames(o, d, init_row[:, :3].expand(o.shape[0], n, 3),
                                 axis_angle_to_matrix(init_row[:, 3:]).expand(o.shape[0], n, 3, 3))
    _, _, hit = ray_box_intersection(oo, dd, -ext.expand(o.shape[0], n, 3), ext.expand(o.shape[0], n, 3))
    return hit
