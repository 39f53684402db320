"""In-memory synthetic ray batches (numpy; no disk IO)."""

from __future__ import annotations

import numpy as np

from durf_tpu_torch.rays import Rays


def example_ray_batch(
    batch_size: int = 512,
    n_obj: int = 2,
    timesteps: int = 5,
    near: float = 0.0,
    far: float = 40.0,
    seed: int = 0,
):
    """A batch of random rays plus plausible boxes, drawn from `seed` with
    numpy: the same values as the JAX package's `example_ray_batch`.

    Returns a dict of numpy arrays: rays (Rays), pixels, depth, sky, init
    [T, N_obj, 6] box poses, target/box/can, ext [N_obj, 3], ts (int32).
    """
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(batch_size, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.3
    ones = np.ones((batch_size, 1), np.float32)
    rays = Rays(
        origins=(rng.normal(size=(batch_size, 3)) * 0.1).astype(np.float32),
        directions=dirs,
        viewdirs=(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32),
        radii=ones * 0.01,
        lossmult=ones,
        near=ones * near,
        far=ones * far,
    )
    init = rng.normal(size=(timesteps, n_obj, 6)).astype(np.float32)
    init[..., :3] = init[..., :3] * 1.5 + np.array([0, 0, -4], np.float32)
    return {
        "rays": rays,
        "pixels": rng.uniform(size=(batch_size, 3)).astype(np.float32),
        "depth": (
            rng.uniform(0, 8, size=(batch_size, 1))
            * (rng.uniform(size=(batch_size, 1)) > 0.5)
        ).astype(np.float32),
        "sky": (0.975 * (rng.uniform(size=(batch_size, 1)) > 0.7)).astype(np.float32),
        "init": init,
        "target": init[1],
        "box": init[1],
        "can": init[0],
        "ext": (np.abs(rng.normal(size=(n_obj, 3))) * 0.3 + 0.3).astype(np.float32),
        "ts": np.int32(1),
    }
