"""Ray batching + background prefetch feeding the training loop (host
numpy; the same batches as the JAX package's `data/pipeline.py` draws).

Batching modes of reference obbpose_dataset.py (all_images, single_image,
single_image_consecutive, timestep — :263-328) and the c2f
resolution-pyramid selection of c2f_obb_dataset.py:305-313, unified into one
class. The prefetch thread yields *host* numpy batches; `train.batch_to`
moves them onto the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List

import numpy as np

from durf_tpu_torch.data.scene import Scene, load_scene
from durf_tpu_torch.rays import Rays

# c2f pyramid: steps <= c2f_steps[i] select PYRAMID_FACTORS[i], then the last
# (reference c2f_obb_dataset.py:305-313 with keys '16'/'12'/'8'/'4').
PYRAMID_FACTORS = (16, 12, 8, 4)


def _flatten_rays(r: Rays) -> Rays:
    return r.map(lambda x: x.reshape(-1, x.shape[-1]))


def _concat_rays(rs: List[Rays]) -> Rays:
    return Rays(*(np.concatenate(xs, axis=0) for xs in zip(*rs)))


def _index_rays(r: Rays, idx) -> Rays:
    return r.map(lambda x: x[idx])


class _ProducerError:
    """Queue sentinel carrying a prefetch-thread exception to the consumer."""

    def __init__(self, cause: BaseException):
        self.cause = cause


class _TimestepPool:
    """All rays/pixels/depth/sky of one scene, pooled per timestep."""

    def __init__(self, scene: Scene):
        self.pools: List[Dict[str, np.ndarray]] = []
        self.ray_pools: List[Rays] = []
        use_inst = scene.inst_usable()
        for t in range(1, scene.total_timesteps + 1):
            sel = [i for i in range(scene.n_examples) if scene.timesteps[i] == t]
            if not sel:
                raise ValueError(
                    f"timestep {t} has no images in this split — a custom "
                    "test_indices selection removed an entire timestep"
                )
            pool = {
                "pixels": np.concatenate([scene.images[i].reshape(-1, 3) for i in sel]),
                "depth": np.concatenate([scene.depth[i].reshape(-1, 1) for i in sel]),
                "sky": np.concatenate([scene.sky[i].reshape(-1, 1) for i in sel]),
            }
            if use_inst:
                pool["inst"] = np.concatenate(
                    [scene.masks2d[i].reshape(-1, 1).astype(np.int32) for i in sel]
                )
            self.pools.append(pool)
            self.ray_pools.append(_concat_rays([_flatten_rays(scene.rays[i]) for i in sel]))


class RayDataset:
    """Iterable ray-batch source with a daemon prefetch thread.

    Train batches are dicts of numpy arrays:
      pixels [B,3], rays (Rays of [B,C]), depth [B,1], sky [B,1],
      init [T,N_obj,6], target/box/can [N_obj,6], ext [N_obj,3], ts () int32.
    Test batches carry whole images ([H,W,...] leaves) with the same keys.
    """

    def __init__(self, split: str, data_dir: str, config, prefetch: int = 3):
        self.split = split
        self.config = config
        self.batching = config.batching
        # The whole batch: one process trains on one card (the reference
        # splits it per host, obbpose_dataset.py:65).
        self.batch_size = config.batch_size
        self.c2f_steps = tuple(config.c2f_steps)
        self._rng = np.random.default_rng(20201473 if split == "train" else 0)

        # Resolution pyramid: the factors actually present on disk.
        self.scenes: Dict[int, Scene] = {}
        factors = list(PYRAMID_FACTORS) if getattr(config, "use_c2f", False) else [config.factor]
        for f in factors:
            self.scenes[f] = load_scene(data_dir, config, split, factor=f)
        self.factors = sorted(self.scenes, reverse=True)  # coarse -> fine
        self.scene = self.scenes[self.factors[-1]]  # finest

        self._pools = {f: _TimestepPool(s) for f, s in self.scenes.items()} if split == "train" else {}
        self._step = 0  # drives the c2f factor selection
        self._test_it = 0
        self._peeked: dict | None = None  # consumer-side slot filled by peek()
        self._dead: BaseException | None = None  # producer failure, sticky

        self._queue: queue.Queue = queue.Queue(prefetch)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- public API --------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._dead is not None:
            # The producer already died and delivered its one sentinel; every
            # later call (a retrying caller, a second consumer) must fail the
            # same way instead of blocking forever on the empty queue.
            raise RuntimeError(
                f"ray-batch producer thread died: {self._dead!r}"
            ) from self._dead
        if self._peeked is not None:
            batch, self._peeked = self._peeked, None
            return batch
        while True:
            batch = self._queue.get()
            if isinstance(batch, _ProducerError):
                # Re-raise a producer failure in the consumer thread instead
                # of hanging forever on an empty queue (the reference shares
                # this hang — obbpose_dataset.py:97-103 has no except either).
                self._dead = batch.cause
                raise RuntimeError(
                    f"ray-batch producer thread died: {batch.cause!r}"
                ) from batch.cause
            # Train split: discard batches the producer built before a c2f
            # factor boundary (the prefetch queue can hold up to `prefetch`
            # stale ones; train batches are i.i.d. so dropping them is free).
            # Test split keeps its sequential image cycle intact — a stale
            # factor there only means the render lags the boundary by a few
            # images, same as the reference's 3-deep prefetch.
            if self.split != "train" or batch.pop("_factor") == self._current_factor():
                batch.pop("_factor", None)
                return batch

    def peek(self) -> dict:
        """Copy of the next batch without consuming it.

        Blocks on the queue like __next__ (no busy-wait on Queue internals)
        and parks the batch so the next __next__ returns it.
        """
        self._peeked = next(self)
        return dict(self._peeked)

    def set_step(self, step: int) -> None:
        """Advance the c2f schedule (reference drives test_dataset.train_it
        from the train loop, train_boxpose.py:421)."""
        self._step = step

    @property
    def size(self) -> int:
        return self.scene.n_examples

    # -- internals ----------------------------------------------------------

    def _current_factor(self) -> int:
        if len(self.factors) == 1:
            return self.factors[0]
        for boundary, factor in zip(self.c2f_steps, self.factors):
            if self._step <= boundary:
                return factor
        return self.factors[-1]

    def _run(self) -> None:
        make = self._next_train if self.split == "train" else self._next_test
        while True:
            try:
                batch = make()
            except BaseException as e:  # deliver, then stop producing
                self._queue.put(_ProducerError(e))
                return
            self._queue.put(batch)

    def _box_batch(self, scene: Scene, ts0: int) -> dict:
        """Box-pose entries for a 0-based timestep (reference
        obbpose_dataset.py:302-320)."""
        if len(scene.obj_ids) == 0:
            return {}
        return {
            "init": scene.init_table(use_off=self.config.random_box),
            "target": scene.boxes_for("center", ts0 + 1),
            "box": scene.boxes_for("off", ts0 + 1),
            "can": scene.boxes_for("off", 1),
            "ext": scene.boxes_for("ext", ts0 + 1),
            # Model-object-index -> instance-mask-id mapping, for batches
            # that carry per-ray 'inst' ids (losses.box_surface_loss).
            "obj_ids": scene.obj_ids.astype(np.int32),
        }

    def _next_train(self) -> dict:
        factor = self._current_factor()
        scene = self.scenes[factor]
        pool = self._pools[factor]

        if self.batching == "timestep":
            ts0 = int(self._rng.integers(0, scene.total_timesteps))
            n = pool.pools[ts0]["pixels"].shape[0]
            idx = self._rng.integers(0, n, (self.batch_size,))
            batch = {k: v[idx] for k, v in pool.pools[ts0].items()}
            batch["rays"] = _index_rays(pool.ray_pools[ts0], idx)
            batch["ts"] = np.int32(ts0)
            batch["_factor"] = factor
            batch.update(self._box_batch(scene, ts0))
            return batch

        if self.batching == "all_images":
            total = sum(p["pixels"].shape[0] for p in pool.pools)
            idx = self._rng.integers(0, total, (self.batch_size,))
            rays = _concat_rays(pool.ray_pools)
            batch = {
                k: np.concatenate([p[k] for p in pool.pools])[idx]
                for k in pool.pools[0]
            }
            batch.update(
                rays=_index_rays(rays, idx), ts=np.int32(0), _factor=factor
            )
            batch.update(self._box_batch(scene, 0))
            return batch

        if self.batching in ("single_image", "single_image_consecutive"):
            i = int(self._rng.integers(0, scene.n_examples))
            flat = _flatten_rays(scene.rays[i])
            n = flat.origins.shape[0]
            if self.batching == "single_image":
                idx = self._rng.integers(0, n, (self.batch_size,))
            else:
                if n < self.batch_size:
                    raise ValueError(
                        f"single_image_consecutive needs >= batch_size "
                        f"({self.batch_size}) pixels per image, got {n}"
                    )
                # n == batch_size: only start 0 exists (integers(0, 0) raises).
                hi = n - self.batch_size
                start = int(self._rng.integers(0, hi)) if hi > 0 else 0
                idx = np.arange(start, start + self.batch_size)
            ts0 = int(scene.timesteps[i]) - 1
            batch = {
                "pixels": scene.images[i].reshape(-1, 3)[idx],
                "depth": scene.depth[i].reshape(-1, 1)[idx],
                "sky": scene.sky[i].reshape(-1, 1)[idx],
                "rays": _index_rays(flat, idx),
                "ts": np.int32(ts0),
                "_factor": factor,
            }
            if scene.inst_usable():
                batch["inst"] = (
                    scene.masks2d[i].reshape(-1, 1).astype(np.int32)[idx]
                )
            batch.update(self._box_batch(scene, ts0))
            return batch

        raise NotImplementedError(f"batching {self.batching!r}")

    def _next_test(self) -> dict:
        factor = self._current_factor()
        scene = self.scenes[factor]
        i = self._test_it % scene.n_examples
        self._test_it += 1
        ts0 = int(scene.timesteps[i]) - 1
        batch = {
            "pixels": scene.images[i],
            "depth": scene.depth[i][..., None],
            "sky": scene.sky[i][..., None],
            "rays": scene.rays[i],
            "ts": np.int32(ts0),
            "_factor": factor,
        }
        batch.update(self._box_batch(scene, ts0))
        return batch


def get_dataset(split: str, data_dir: str, config, prefetch: int = 3) -> RayDataset:
    """Factory mirroring reference obbpose_dataset.get_dataset (17-18)."""
    return RayDataset(split, data_dir, config, prefetch)
