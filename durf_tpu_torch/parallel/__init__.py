"""Data-parallel training over GPUs (parallel/mesh.py)."""

from durf_tpu_torch.mathx import RowShard, draw
from durf_tpu_torch.parallel.group import Group, one_process
from durf_tpu_torch.parallel.mesh import (
    ProcessGroup,
    build_kernels,
    init_group,
    joined,
    replicate,
    shard_batch,
    spawn,
)

__all__ = [
    "Group",
    "ProcessGroup",
    "RowShard",
    "build_kernels",
    "draw",
    "init_group",
    "joined",
    "one_process",
    "replicate",
    "shard_batch",
    "spawn",
]
