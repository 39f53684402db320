"""Data-parallel training over GPUs (the JAX package's `parallel/mesh.py`).

Rays are embarrassingly parallel. Each of n ranks (processes) holds a
replica of the model, the optimizer state and the occupancy grid, and rows
[r B/n, (r+1) B/n) of every global batch of B rays. One step on n ranks
computes what one process computes on the whole batch, up to the order of
float sums, where the JAX package runs one SPMD program over a mesh:

  * random draws: every rank draws the global tensor from the shared
    generator and keeps its own rows (mathx.RowShard, mathx.draw);
  * losses: denominators of ratio-of-sums losses are summed over the group
    first, batch means are divided by n, and terms that do not depend on
    the batch count once (losses.compute_losses);
  * object-ray compaction keeps the lowest-index k hit rays of the global
    batch, from an exclusive prefix of the ranks' hit counts
    (models/mipnerf.py);
  * gradients are summed in one flat all-reduce a step, then scrubbed and
    clipped (train.make_grad_fn, make_train_step); the occupancy grid's
    update is followed by an all-reduce MAX;
  * logged scalars are summed over the ranks at print time only
    (train.reduce_stats).

A process group comes from torchrun's environment (`init_group`): NCCL on
the cards, rank r on cuda:LOCAL_RANK, gloo on the CPU. Gloo takes CUDA
tensors for all_reduce and broadcast but not for all_gather, so every
gather here is an all-reduce SUM of a zero-filled buffer into which each
rank writes its own rows: exact, as x + 0 == x, and the same code runs
under NCCL and under gloo sharing one card. One process is the group of
one rank whose collectives are the identity (parallel.group.Group), so
it runs the same code as the ranks, and nothing of torch.distributed.

    torchrun --nproc_per_node N -m durf_tpu_torch.train --multihost ...
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing

from durf_tpu_torch.devices import resolve_device
from durf_tpu_torch.parallel.group import Group, one_process
from durf_tpu_torch.rays import Rays

# torchrun's environment (torch.distributed.run), read by init_group.
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


class ProcessGroup(Group):
    """The group over the default process group of torch.distributed
    (`init_group`), in which every collective is one call."""

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """An all-reduce SUM of a zero-filled buffer (no gradient)."""
        full = local.new_zeros((n,) + tuple(local.shape[1:]))
        full[self.rows(n)] = local.detach()
        dist.all_reduce(full, op=dist.ReduceOp.SUM)
        return full

    def gather_live(self, x: torch.Tensor) -> torch.Tensor:
        full = self.gather_rows(x[None], self.size)
        return torch.cat([full[: self.rank], x[None], full[self.rank + 1 :]])

    def sum_flat(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """One broadcast per dtype (tensors on the host travel through this
        rank's device)."""
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for group in by_dtype.values():
                flat = torch.cat([t.reshape(-1).to(self.device) for t in group])
                dist.broadcast(flat, src=0)
                for t, piece in zip(group, flat.split([t.numel() for t in group])):
                    t.copy_(piece.view_as(t))

    def barrier(self) -> None:
        dist.barrier()


def init_group(device="cuda", backend: Optional[str] = None) -> ProcessGroup:
    """Join the process group that torchrun's environment describes
    (jax.distributed.initialize for `--multihost`): RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT. On the card the rank runs on
    cuda:LOCAL_RANK (or the index `device` names) over NCCL, on the CPU
    over gloo; `backend` overrides (gloo lets ranks share one card). When
    this process has joined a group already, returns it."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"multi-process run without a process group to join: {', '.join(missing)} not "
            f"set; launch it with torchrun --nproc_per_node N -m ... --multihost"
        )
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            device_id=device if backend == "nccl" else None,
        )
    return ProcessGroup(dist.get_rank(), dist.get_world_size(), device)


@contextlib.contextmanager
def joined(multihost: bool, device="cuda") -> Iterator[Group]:
    """A CLI's group: under --multihost the group of init_group(device),
    left (destroyed) on exit when this call formed it; else one process on
    `device`. Refuses a
    torchrun launch (WORLD_SIZE > 1) without --multihost: the ranks would
    train n independent copies, each on the whole batch."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not multihost:
        raise ValueError(
            f"WORLD_SIZE={world} is set (a torchrun launch) but --multihost is not: the "
            f"{world} processes would train independent copies; pass --multihost"
        )
    if not multihost:
        yield one_process(device)
        return
    formed = not dist.is_initialized()
    group = init_group(device)
    try:
        yield group
    finally:
        if formed:
            dist.destroy_process_group()


def shard_batch(batch: Dict[str, Any], batch_size: int, group: Group) -> Dict[str, Any]:
    """This rank's part of a global batch (numpy arrays or tensors): a
    leaf whose leading dimension is the global batch size is per-ray and
    keeps the rank's rows; box tables, extents and `ts` stay whole. The
    global batch must divide the world size (the reference enforces the
    same, train_boxpose.py:332-333)."""
    rows = group.rows(batch_size)

    def place(x):
        if isinstance(x, Rays):
            return x.map(place)
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == batch_size:
            return x[rows]
        return x

    return {k: place(v) for k, v in batch.items()}


def replicate(state, group: Group):
    """Broadcast rank 0's training state to every rank, in place: the
    model's parameters and buffers (the pose table among them), the Adam
    moments, the step, the update count and the occupancy grid. Returns
    `state`."""
    model, opt = state.model, state.optimizer
    tensors = list(model.parameters()) + list(model.buffers())
    for p in model.parameters():
        tensors += [opt.opt.state[p][k] for k in sorted(opt.opt.state.get(p, {}))]
    if state.grid is not None:
        tensors.append(state.grid)
    clock = torch.tensor([state.step, opt.count], dtype=torch.int64)
    group.broadcast_(tensors + [clock])
    state.step, opt.count = (int(v) for v in clock)
    return state


def build_kernels(group: Group) -> None:
    """On the card, build the CUDA kernels of a group of several ranks on
    rank 0 while the others wait at a barrier, so that n ranks do not each
    run nvcc (they then find the libraries built). One process builds each
    kernel at its first launch."""
    if group.size == 1 or group.device.type != "cuda":
        return
    if group.is_rank0:
        from durf_tpu_torch.ops.kernels import build

        build.build_all()
    group.barrier()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, size, port, device, backend, out_dir, fn, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    group = init_group(device, backend)
    try:
        result = fn(group, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device="cpu", backend: Optional[str] = None,
          timeout: float = 600.0) -> list:
    """Run fn(group, *args) on `nprocs` new processes joined in one group
    on localhost, and return their results by rank. `fn` must be importable
    by name (the processes start from a fresh import) and its result
    picklable. On the card each rank takes cuda:rank unless `device` names
    one card (then share it over `backend='gloo'`). A rank that raises, or
    a run past `timeout` seconds, stops every rank and raises."""
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(nprocs, port, device, backend, out_dir, fn, args), nprocs=nprocs,
            join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} ran past {timeout} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
