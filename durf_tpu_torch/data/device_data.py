"""Device-resident ray pools: no host-to-device traffic per training step.

The per-timestep ray pools of a train RayDataset (rays, pixels, depth, sky,
~72 B a ray) are uploaded once; each step then draws its batch on the
device (the JAX package's `data/device_data.py`):

    ts  ~ U[0, T)                   on the host, from a CPU generator
    idx = floor(u * counts[ts])     u ~ U[0, 1)^B on the pools' device
    batch = pools[ts][idx]          a gather on the device

Both generators are seeded from (seed, step), so a resumed run draws the
same batches as an uninterrupted one. A data-parallel rank draws the global
batch's u and gathers only its rows (`rows`), so the ranks together draw
what one process draws. `ts` stays a Python int, as the model
indexes its pose table with one, and `counts` lives on the host, so a draw
waits for nothing on the device.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from durf_tpu_torch.rays import Rays


def build_pools(dataset, device, factor: int | None = None) -> Dict[str, Any]:
    """Padded per-timestep pools of a train RayDataset, as tensors on `device`.

    Args:
      factor: the resolution-pyramid level to pool (defaults to the finest,
        the only level outside c2f runs).

    Returns a dict with:
      rays: Rays of [T, Nmax, C]; pixels/depth/sky (+ inst): [T, Nmax, C];
      counts: list of T host ints, the valid rows per timestep (padding rows
      repeat row 0 and are never drawn, as idx < counts[ts]);
      init [T, N_obj, 6], target [T, N_obj, 6], ext [T, N_obj, 3] box
      tables and obj_ids [N_obj] for a scene with objects.
    """
    scene = dataset.scene
    pool = dataset._pools[dataset.factors[-1] if factor is None else factor]
    T = scene.total_timesteps
    counts = [int(p["pixels"].shape[0]) for p in pool.pools]
    n_max = max(counts)

    def pad(x):
        if x.shape[0] == n_max:
            return x
        filler = np.broadcast_to(x[:1], (n_max - x.shape[0],) + x.shape[1:])
        return np.concatenate([x, filler], axis=0)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    pools: Dict[str, Any] = {
        key: put(np.stack([pad(p[key]) for p in pool.pools]))
        for key in pool.pools[0]  # pixels/depth/sky (+ inst when usable)
    }
    pools["rays"] = Rays(*(put(np.stack([pad(x) for x in xs])) for xs in zip(*pool.ray_pools)))
    pools["counts"] = counts

    if len(scene.obj_ids) > 0:
        pools["init"] = put(scene.init_table(use_off=dataset.config.random_box))
        pools["target"] = put(np.stack([scene.boxes_for("center", t + 1) for t in range(T)]))
        pools["ext"] = put(np.stack([scene.boxes_for("ext", t + 1) for t in range(T)]))
        pools["obj_ids"] = put(scene.obj_ids.astype(np.int32))
    return pools


def build_pools_c2f(dataset, device) -> List[Dict[str, Any]]:
    """One pool set per pyramid factor, coarse -> fine (dataset.factors
    order). 'inst' rides the pools only when every level has usable masks
    (2D_boxes.npz is written at the base factor only), so every level's
    batches carry the same keys."""
    all_inst = all("inst" in dataset._pools[f].pools[0] for f in dataset.factors)
    pools = [build_pools(dataset, device, factor=f) for f in dataset.factors]
    if not all_inst:
        pools = [{k: v for k, v in p.items() if k != "inst"} for p in pools]
    return pools


def pool_bytes(dataset) -> int:
    """Approximate device bytes the pools would occupy (all pyramid levels:
    a c2f run keeps every factor's pool resident)."""
    floats_per_ray = 3 + 1 + 1 + 13  # pixels + depth + sky + rays leaves
    total = 0
    for pool in dataset._pools.values():
        t = len(pool.pools)
        n_max = max(p["pixels"].shape[0] for p in pool.pools)
        total += t * n_max * floats_per_ray * 4
    return total


def _seed(seed: int, step: int) -> int:
    return (seed << 32) + step


def draw_timestep(n_timesteps: int, seed: int, step: int) -> int:
    """The step's timestep, drawn on the host from (seed, step)."""
    gen = torch.Generator().manual_seed(_seed(seed, step))
    return int(torch.randint(n_timesteps, (), generator=gen))


def draw_indices(count: int, batch_size: int, seed: int, step: int, device) -> torch.Tensor:
    """batch_size row indices in [0, count) on `device`: floor(u * count) for
    u ~ U[0, 1) drawn in float64 by a generator on `device` seeded from
    (seed, step)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, step))
    u = torch.rand(batch_size, generator=gen, dtype=torch.float64, device=device)
    return torch.floor(u * count).long().clamp_(max=count - 1)


def gather_batch(pools: Dict[str, Any], ts: int, idx: torch.Tensor) -> Dict[str, Any]:
    """The batch of rows `idx` of timestep `ts` (0-based), shaped like the
    host pipeline's 'timestep' batches: rays [B, C], pixels [B, 3], depth
    [B, 1], sky [B, 1] (+ inst), ts (int), and the box tables init [T,
    N_obj, 6], target [N_obj, 6], ext [N_obj, 3], obj_ids."""

    def gather(x):
        return x[ts].index_select(0, idx)

    batch = {
        "pixels": gather(pools["pixels"]),
        "depth": gather(pools["depth"]),
        "sky": gather(pools["sky"]),
        "rays": pools["rays"].map(gather),
        "ts": ts,
    }
    if "inst" in pools:
        batch["inst"] = gather(pools["inst"])
    if "init" in pools:
        batch["init"] = pools["init"]
        batch["target"] = pools["target"][ts]
        batch["ext"] = pools["ext"][ts]
        batch["obj_ids"] = pools["obj_ids"]
    return batch


def sample_batch(pools: Dict[str, Any], step: int, seed: int, batch_size: int,
                 rows: slice | None = None) -> Dict[str, Any]:
    """Draw the batch of (0-based) training step `step` on the pools' device
    (see the module docstring); the same (seed, step) draws the same batch.
    `rows`: the rows of the `batch_size`-ray batch to gather (a
    data-parallel rank's; parallel.Group.rows), all by default."""
    ts = draw_timestep(len(pools["counts"]), seed, step)
    idx = draw_indices(pools["counts"][ts], batch_size, seed, step, pools["pixels"].device)
    if rows is not None:
        idx = idx[rows]
    return gather_batch(pools, ts, idx)


def c2f_factor_index(step: int, c2f_steps, n_factors: int) -> int:
    """The c2f level of a (1-indexed) step: the boundaries it has crossed,
    clamped (steps <= c2f_steps[i] select factors[i], then the last; as
    RayDataset._current_factor, reference c2f_obb_dataset.py:305-313)."""
    crossed = sum(step > b for b in c2f_steps[: max(n_factors - 1, 0)])
    return min(crossed, n_factors - 1)


def sample_batch_c2f(
    pools_by_factor: List[Dict[str, Any]], step: int, c2f_steps, seed: int, batch_size: int,
    rows: slice | None = None,
) -> Dict[str, Any]:
    """sample_batch from the pyramid level of the c2f schedule: the level of
    the 1-indexed step step + 1 (the JAX package's device step passes
    state.step + 1), the draw of the 0-based `step`."""
    level = c2f_factor_index(step + 1, c2f_steps, len(pools_by_factor))
    return sample_batch(pools_by_factor[level], step, seed, batch_size, rows)
