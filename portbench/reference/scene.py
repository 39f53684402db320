"""The plain reference of the scene data path: a frozen copy, in numpy and
plain PyTorch, of how the port's loader turns a Waymo-layout scene into rays
(durf_tpu_torch/data/scene.py, rays.py), pools them per timestep
(data/pipeline.py, data/device_data.py) and draws a training batch, and of
how the training app sizes object-ray compaction from the scene. It works
from the raw arrays the benchmark wrote, never from the port's outputs.

Processing: poses recentred around the average camera with the world
scaled by 1/5; box poses mapped into that frame, rotations stored as the
rotation vector of the world->object rotation, the initial table noised by
`box_noise` under `random_box` (numpy's default_rng(20201473)); depth / 5,
sky masks set to 0.975; pinhole rays with radii from the x-neighbour
directions (no NDC: the Waymo presets spherify); each image's instance ids
kept when every image of the split has a mask of its size and one of them
names an object (the port's Scene.inst_usable). The Waymo split keeps
images 10 and 12 for test; the render split holds all of them.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

WORLD_SCALE = 5.0
CAMS_PER_TIMESTEP = 5
TEST_INDICES = (10, 12)
SKY_VALUE = 0.975
EXT_DIVISOR = 2.0
LOADER_SEED = 20201473


def _average_pose(poses):
    def normalize(x):
        return x / np.linalg.norm(x)

    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, center], 1)


def recenter_poses(poses):
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = np.concatenate([_average_pose(poses)[:3, :4], bottom], -2)
    poses_h = np.concatenate([poses[:, :3, :4], np.tile(bottom[None], [poses.shape[0], 1, 1])], -2)
    out = poses.copy()
    out[:, :3, :4] = (np.linalg.inv(c2w) @ poses_h)[:, :3, :4]
    return out, c2w


def process_boxes(raw, c2w, c, rng):
    """{'{ts}_{obj}_center' | '_off' | '_ext': 6-DoF pose or half extents}."""
    keys = [k for k in raw if k.endswith("_center")]
    mats = np.stack([raw[k] for k in keys])
    exts = np.stack([raw[k.replace("_center", "_ext")] for k in keys])
    noised = mats.copy()
    if c["random_box"]:
        noised[:, :3, 3] += rng.uniform(-c["box_noise"], c["box_noise"], size=(len(mats), 3))
    if c2w is not None:
        mats = np.linalg.inv(c2w) @ mats
        noised = np.linalg.inv(c2w) @ noised
    mats[:, :3, 3] /= WORLD_SCALE
    noised[:, :3, 3] /= WORLD_SCALE
    exts = exts / (WORLD_SCALE * EXT_DIVISOR)
    rotvec = Rotation.from_matrix(np.linalg.inv(mats[:, :3, :3])).as_rotvec()
    off_rotvec = rotvec.copy()
    if c["random_yaw"] and c["random_box"]:
        off_rotvec += rng.uniform(-c["yaw_noise"], c["yaw_noise"], size=rotvec.shape) * (np.pi / 180.0)
    out = {}
    for i, key in enumerate(keys):
        ts, obj, _ = key.split("_")
        out[f"{ts}_{obj}_center"] = np.concatenate([mats[i, :3, 3], rotvec[i]]).astype(np.float32)
        out[f"{ts}_{obj}_off"] = np.concatenate([noised[i, :3, 3], off_rotvec[i]]).astype(np.float32)
        out[f"{ts}_{obj}_ext"] = exts[i].astype(np.float32)
    return out


def camera_rays(c2w, width, height, focal, near, far):
    """Pinhole rays of one camera at pixel corners, radii from the
    x-neighbour directions: {field: [H, W, C] float32}."""
    x, y = np.meshgrid(np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32),
                       indexing="xy")
    pp = np.array([width * 0.5, height * 0.5], np.float32)
    cam = np.stack([(x - pp[0]) / focal, -(y - pp[1]) / focal, -np.ones_like(x)], axis=-1)
    directions = (cam[..., None, :] * c2w[:3, :3]).sum(axis=-1)
    origins = np.ascontiguousarray(np.broadcast_to(c2w[:3, -1], directions.shape))
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    dx = np.sqrt(np.sum((directions[:-1, :, :] - directions[1:, :, :]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1, :]], 0)
    radii = (dx * 2 / np.sqrt(12))[..., None]
    ones = np.ones_like(origins[..., :1])
    return {"origins": origins.astype(np.float32), "directions": directions.astype(np.float32),
            "viewdirs": viewdirs.astype(np.float32), "radii": radii.astype(np.float32),
            "lossmult": ones, "near": (ones * near).astype(np.float32),
            "far": (ones * far).astype(np.float32)}


RAY_KEYS = ("origins", "directions", "viewdirs", "radii", "lossmult", "near", "far")


def load(raw: dict, c: dict, split: str) -> dict:
    """One split of the raw scene: per image its rays, pixels, depth and sky
    ([H, W, C] numpy) and, where usable, its instance ids `inst` ([H, W, 1]
    int32), its 1-based timestep, and the box tables: `init` [T, N_obj, 6]
    (the noised poses under random_box), `ext` [T, N_obj, 3]."""
    f = c["factor"]
    poses = raw["poses_hwf"].astype(np.float32).copy()
    n = poses.shape[0]
    scale = 1.0 / max(f, 1)
    poses[:, :2, 4] = np.floor(poses[:, :2, 4] * scale)
    poses[:, 2, 4] = poses[:, 2, 4] * scale
    rng = np.random.default_rng(LOADER_SEED)
    c2w = None
    if c["centering"]:
        poses, c2w = recenter_poses(poses)
        poses[:, :3, 3] /= WORLD_SCALE
    boxes = process_boxes(raw["boxes"], c2w, c, rng)
    timesteps = np.repeat(np.arange(1, n // CAMS_PER_TIMESTEP + 1), CAMS_PER_TIMESTEP)
    total = int(timesteps[-1])
    i_test = np.asarray(c["test_indices"] or TEST_INDICES)
    i_train = np.asarray([i for i in range(n) if i not in i_test])
    idx = {"train": i_train, "test": i_test, "render": np.sort(np.concatenate([i_train, i_test]))}[split]
    n_obj = len({k.split("_")[1] for k in boxes if k.endswith("_center")})
    kind = "off" if c["random_box"] else "center"
    out = {"images": [], "timesteps": timesteps[idx], "total_timesteps": total,
           "init": np.stack([np.stack([boxes[f"{t}_{o}_{kind}"] for o in range(1, n_obj + 1)])
                             for t in range(1, total + 1)]),
           "ext": np.stack([np.stack([boxes[f"{t}_{o}_ext"] for o in range(1, n_obj + 1)])
                            for t in range(1, total + 1)])}
    masks = raw.get("inst")
    use_inst = (n_obj > 0 and masks is not None and len(masks) == n
                and all(masks[i].shape == raw["images"][i].shape[:2] for i in idx)
                and any(masks[i].any() for i in idx))
    for i in idx:
        d = raw["depth"][i].astype(np.float32).copy()
        d[d > 0.0] = d[d > 0.0] / WORLD_SCALE
        s = raw["sky"][i].astype(np.float32).copy()
        s[s > 0.0] = SKY_VALUE
        h, w, focal = poses[i, 0, 4], poses[i, 1, 4], poses[i, 2, 4]
        out["images"].append({
            "rays": camera_rays(poses[i, :3, :4], int(w), int(h), float(focal), c["near"], c["far"]),
            "pixels": raw["images"][i].astype(np.float32)[..., :3] / 255.0,
            "depth": d[..., None], "sky": s[..., None],
        })
        if use_inst:
            out["images"][-1]["inst"] = masks[i].astype(np.int32)[..., None]
    return out


def pools(split: dict, device) -> list:
    """Per timestep (0-based), the train rows of its images in order, as
    device tensors {field: [N_t, C]}; `inst` when the images carry it."""
    out = []
    for t in range(1, split["total_timesteps"] + 1):
        imgs = [im for im, ts in zip(split["images"], split["timesteps"]) if ts == t]
        rows = {k: np.concatenate([im["rays"][k].reshape(-1, im["rays"][k].shape[-1]) for im in imgs])
                for k in RAY_KEYS}
        for k in ("pixels", "depth", "sky", "inst"):
            if k in imgs[0]:
                rows[k] = np.concatenate([im[k].reshape(-1, im[k].shape[-1]) for im in imgs])
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in rows.items()})
    return out


def draw(n_timesteps: int, counts: list, batch: int, seed: int, step: int, device):
    """The (0-based timestep, row indices) of training step `step`: the
    timestep from a CPU generator, the rows floor(u * count) for float64 u
    from a device generator, both seeded from (seed, step)."""
    s = (seed << 32) + step
    ts = int(torch.randint(n_timesteps, (), generator=torch.Generator().manual_seed(s)))
    gen = torch.Generator(device=device).manual_seed(s)
    u = torch.rand(batch, generator=gen, dtype=torch.float64, device=device)
    return ts, torch.floor(u * counts[ts]).long().clamp_(max=counts[ts] - 1)


def max_hit_fraction(split: dict, c: dict) -> float:
    """The largest share over timesteps of the split's rays whose slab test
    hits a box grown by the pose noise (the training app's auto capacity)."""
    inflate = c["box_noise"] if c["random_box"] else 0.0
    fractions = []
    for t in range(split["total_timesteps"]):
        imgs = [im for im, ts in zip(split["images"], split["timesteps"]) if ts == t + 1]
        if not imgs:
            continue
        o = np.concatenate([im["rays"]["origins"].reshape(-1, 3) for im in imgs])
        d = np.concatenate([im["rays"]["directions"].reshape(-1, 3) for im in imgs])
        ext = split["ext"][t] + inflate
        anyhit = np.zeros(o.shape[0], bool)
        for j in range(split["init"].shape[1]):
            rot = rodrigues(split["init"][t, j, 3:])
            oo, dd = (o - split["init"][t, j, :3]) @ rot.T, d @ rot.T
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / dd
                t_lo, t_hi = (-ext[j] - oo) * inv, (ext[j] - oo) * inv
            t_near = np.max(np.minimum(t_lo, t_hi), axis=-1)
            t_far = np.min(np.maximum(t_lo, t_hi), axis=-1)
            with np.errstate(invalid="ignore"):
                anyhit |= (t_far > t_near) & (t_far > 0)
        fractions.append(float(anyhit.mean()))
    return max(fractions) if fractions else 0.0


def rodrigues(rotvec):
    x, y, z = rotvec
    skew = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float64)
    angle = np.linalg.norm(rotvec) + 1e-12
    return (np.eye(3) + (np.sin(angle) / angle) * skew
            + ((1 - np.cos(angle)) / angle**2) * (skew @ skew)).astype(np.float32)
