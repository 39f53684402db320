"""The data-parallel group as the model, the losses and the training step
see it: this rank, the world size, the device, and the collectives a step
needs. `Group` itself is one process, rank 0 of 1, whose collectives are
the identity and call nothing of torch.distributed, so one process runs
the same code as every rank of a group; parallel.mesh.ProcessGroup runs
them over the process group of a torchrun launch."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from durf_tpu_torch.devices import resolve_device


@dataclass(frozen=True)
class Group:
    """The group as one rank sees it. It plays the JAX package's mesh
    (`make_mesh`), also for rendering (`eval_mesh`: the training group
    itself). Every collective below gives what the same call on one
    process holding the global batch gives."""

    rank: int = 0
    size: int = 1
    device: Optional[torch.device] = None

    @property
    def is_rank0(self) -> bool:
        """jax.process_index() == 0: the rank that writes checkpoints,
        metrics and images."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of n global rows."""
        if n % self.size != 0:
            raise ValueError(f"batch_size {n} must divide mesh size {self.size}")
        local = n // self.size
        return slice(self.rank * local, (self.rank + 1) * local)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the group (no gradient across ranks)."""
        return x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of x over the group (no gradient across
        ranks)."""
        return x

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The [n, ...] tensor whose rows `rows(n)` each rank holds."""
        return local

    def gather_live(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's x, detached, except this rank's
        slot, which is x itself. A function of the gathered values then has
        the global value on every rank, and its gradient on each rank is
        the exact gradient with respect to that rank's own x."""
        return x[None]

    def sum_flat(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor summed over the group, through one collective of
        their concatenation."""
        return list(tensors)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite the tensors in place with rank 0's."""

    def barrier(self) -> None:
        """Wait for every rank."""

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """x, a value every rank holds in full, counted once over the group:
        its value on rank 0 and 0 elsewhere, its gradient on every rank
        (for a global quantity whose gradient reaches each rank's own
        inputs, as gather_live gives)."""
        return x if self.is_rank0 else x - x.detach()

    def on_rank0(self, x: torch.Tensor) -> torch.Tensor:
        """x, a term that does not depend on the batch, counted once over
        the group in value and gradient: x on rank 0, x * 0 elsewhere."""
        return x if self.is_rank0 else x * 0.0


def one_process(device="cuda") -> Group:
    """The group of one process on `device` (the card unless the caller
    asks for the CPU)."""
    return Group(device=resolve_device(device))
