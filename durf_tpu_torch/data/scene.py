"""Scene loading: disk format -> processed, split, ray-generated Scene
(host numpy; the port's copy of the JAX package's `data/scene.py`, with the
same arrays for the same scene directory).

One implementation parameterized by a DatasetSpec covers the reference's
loader classes (Carla/Carla_Seq/Waymo in internal/obbpose_dataset.py:
203-2085). Processing:
  * pose recentering around the average camera + world scale 1/5
    (obbpose_dataset.py:431-437, 709-742);
  * box poses mapped into the recentered frame, rotations stored as the
    rotation vector of the *inverse* (world->object) box rotation
    (obbpose_dataset.py:453-457), optional noise injection for pose-opt
    experiments (:438-471);
  * LIDAR depth scaled by 1/5 (:582-583), sky masks set to the dataset's
    max-disparity constant (:596-599 CARLA 0.995, :1850-1853 Waymo 0.975);
  * per-camera pinhole rays with optional principal points, NDC when not
    spherified (:613-707).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from durf_tpu_torch.data import format as diskfmt
from durf_tpu_torch.rays import Rays, camera_rays


@dataclass(frozen=True)
class DatasetSpec:
    """Per-dataset-family constants."""

    name: str
    cams_per_timestep: int  # images per timestep (5-camera rig or 1)
    test_indices: Tuple[int, ...]  # hardcoded test split of the reference
    sky_value: float  # max-disparity constant written into sky masks
    ext_divisor: float  # 1: extents already half; 2: full extents on disk
    render_includes_test: bool  # render split = train+test (Waymo) or train
    obj_ids_from_masks: bool  # discover ids from 2D masks (CARLA) or keys


DATASET_SPECS: Dict[str, DatasetSpec] = {
    # reference dataset_dict registries (obbpose_dataset.py:2088-2092,
    # c2f_obb_dataset.py:1905-1908)
    "carla_dyn": DatasetSpec("carla_dyn", 5, (10, 11), 0.995, 1.0, False, True),
    "carla_seq": DatasetSpec("carla_seq", 1, (10, 11), 0.995, 1.0, False, True),
    "waymo": DatasetSpec("waymo", 5, (10, 12), 0.975, 2.0, True, False),
}

WORLD_SCALE = 5.0  # world divided by 5 everywhere (obbpose_dataset.py:437)


@dataclass
class Scene:
    """A processed split of one scene (all host-side numpy)."""

    spec: DatasetSpec
    split: str
    images: List[np.ndarray]  # [H, W, 3] each
    depth: List[np.ndarray]  # [H, W] metric depth / WORLD_SCALE
    sky: List[np.ndarray]  # [H, W] 0 or spec.sky_value
    masks2d: List[np.ndarray]  # [H, W] instance ids
    rays: List[Rays]  # per image, [H, W, C] leaves
    timesteps: np.ndarray  # [N] 1-based timestep of each image
    total_timesteps: int
    box_pose: Dict[str, np.ndarray]  # "{ts}_{obj}_{center|off|ext|rel}"
    obj_ids: np.ndarray  # nonzero instance ids
    camtoworlds: np.ndarray  # [N, 3, 4]
    focal: np.ndarray  # [N]
    height: np.ndarray  # [N]
    width: np.ndarray  # [N]
    near: float
    far: float

    @property
    def n_examples(self) -> int:
        return len(self.images)

    def boxes_for(self, kind: str, ts: int) -> np.ndarray:
        """Gather per-object box data of one kind at a 1-based timestep.

        kind in {'center', 'off', 'ext'}; returns [N_obj, 6] (or [N_obj, 3]
        for 'ext') in obj_ids order.
        """
        return np.stack([self.box_pose[f"{ts}_{c}_{kind}"] for c in self.obj_ids])

    def init_table(self, use_off: bool) -> np.ndarray:
        """[T, N_obj, 6] pose-table initialization (noised '_off' poses when
        use_off, else GT centers) — reference obbpose_dataset.py:302-316."""
        kind = "off" if use_off else "center"
        return np.stack([self.boxes_for(kind, t + 1) for t in range(self.total_timesteps)])

    def inst_usable(self) -> bool:
        """True when per-ray instance ids can be batched alongside pixels.

        The unsuffixed 2D_boxes.npz is written at the training factor
        (reference obbpose_dataset.py:524 loads the same single file), so
        pyramid levels loaded at other factors see a shape mismatch — those
        scenes batch without 'inst' and the box-surface prior falls back to
        its margin-only trim (losses.box_surface_loss)."""
        return (
            len(self.obj_ids) > 0
            and len(self.masks2d) == len(self.images)
            and all(
                m.shape == img.shape[:2]
                for m, img in zip(self.masks2d, self.images)
            )
            and any(m.any() for m in self.masks2d)
        )


def _rodrigues(rotvec: np.ndarray) -> np.ndarray:
    """Axis-angle [3] -> rotation matrix [3, 3] (numpy twin of
    ops.axis_angle_to_matrix, same eps)."""
    x, y, z = rotvec
    skew = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float64)
    angle = np.linalg.norm(rotvec) + 1e-12
    return (
        np.eye(3)
        + (np.sin(angle) / angle) * skew
        + ((1 - np.cos(angle)) / angle**2) * (skew @ skew)
    ).astype(np.float32)


def max_hit_fraction(scene: "Scene", use_off: bool, inflate: float = 0.0) -> float:
    """Worst-case (over timesteps) fraction of this split's rays whose
    slab test hits any box — the sizing input for object-ray compaction
    (ModelConfig.obj_ray_capacity auto mode, train.resolve_obj_capacity).

    Replicates the model's hit definition exactly (MipNerf.forward's
    world->box transform + infinite-ray slab test with z_out > 0 — NOT
    clipped to [near, far]), in host numpy against the same pose table the
    model initializes from (`use_off` mirrors Config.random_box). `inflate`
    grows each half-extent (meters, world/5 scale) to cover pose motion
    during joint pose optimization.
    """
    if len(scene.obj_ids) == 0:
        return 0.0
    init = scene.init_table(use_off)  # [T, N_obj, 6]
    fractions = []
    for t in range(scene.total_timesteps):
        img_idx = np.nonzero(scene.timesteps == t + 1)[0]
        if img_idx.size == 0:
            continue
        o = np.concatenate(
            [np.asarray(scene.rays[i].origins).reshape(-1, 3) for i in img_idx]
        )
        d = np.concatenate(
            [np.asarray(scene.rays[i].directions).reshape(-1, 3) for i in img_idx]
        )
        ext = scene.boxes_for("ext", t + 1) + inflate  # [N_obj, 3]
        anyhit = np.zeros(o.shape[0], bool)
        for j in range(init.shape[1]):
            rot = _rodrigues(init[t, j, 3:])  # world -> object
            oo = (o - init[t, j, :3]) @ rot.T
            dd = d @ rot.T
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / dd
                t_lo = (-ext[j] - oo) * inv
                t_hi = (ext[j] - oo) * inv
            # max/min propagate NaN (axis-parallel 0/0 rays) -> comparisons
            # False -> miss, matching ops.ray_box_intersection's select.
            t0 = np.minimum(t_lo, t_hi)
            t1 = np.maximum(t_lo, t_hi)
            t_near = np.max(t0, axis=-1)
            t_far = np.min(t1, axis=-1)
            with np.errstate(invalid="ignore"):
                anyhit |= (t_far > t_near) & (t_far > 0)
        fractions.append(float(anyhit.mean()))
    return max(fractions) if fractions else 0.0


def _average_pose(poses: np.ndarray) -> np.ndarray:
    """Average camera pose (reference obbpose_dataset.py:722-742)."""

    def normalize(x):
        return x / np.linalg.norm(x)

    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, center], 1)


def recenter_poses(poses: np.ndarray):
    """Recenter [N, 3, 5] poses around the average camera.

    Returns (recentered poses, the 4x4 average camtoworld used).
    """
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = np.concatenate([_average_pose(poses)[:3, :4], bottom], -2)
    bottom_n = np.tile(bottom[None], [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom_n], -2)
    recentered = np.linalg.inv(c2w) @ poses_h
    out = poses.copy()
    out[:, :3, :4] = recentered[:, :3, :4]
    return out, c2w


def _process_boxes(
    raw: Dict[str, np.ndarray],
    c2w: Optional[np.ndarray],
    spec: DatasetSpec,
    random_box: bool,
    random_yaw: bool,
    box_noise: float,
    yaw_noise: float,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """4x4 world box poses -> 6-DoF [x, y, z, rotvec] in the recentered frame.

    For every key "{ts}_{obj}": '_center' is the GT 6-DoF pose, '_off' the
    (optionally noise-corrupted) initialization, '_ext' the half extents.
    The stored rotvec is of the INVERSE box rotation (world->object), matching
    reference obbpose_dataset.py:456-457.
    """
    center_keys = [k for k in raw if k.endswith("_center")]
    if not center_keys:
        return {}
    mats = np.stack([raw[k] for k in center_keys])  # [K, 4, 4]
    exts = np.stack([raw[k.replace("_center", "_ext")] for k in center_keys])

    noised = mats.copy()
    if random_box:
        noised[:, :3, 3] += rng.uniform(-box_noise, box_noise, size=(len(mats), 3))

    if c2w is not None:
        mats = np.linalg.inv(c2w) @ mats
        noised = np.linalg.inv(c2w) @ noised
    mats[:, :3, 3] /= WORLD_SCALE
    noised[:, :3, 3] /= WORLD_SCALE
    exts = exts / (WORLD_SCALE * spec.ext_divisor)

    rotvec = Rotation.from_matrix(np.linalg.inv(mats[:, :3, :3])).as_rotvec()
    off_rotvec = rotvec.copy()
    if random_yaw and random_box:
        off_rotvec += rng.uniform(-yaw_noise, yaw_noise, size=rotvec.shape) * (np.pi / 180.0)

    out: Dict[str, np.ndarray] = {}
    canonical: Dict[str, np.ndarray] = {}
    for i, key in enumerate(center_keys):
        ts, obj, _ = key.split("_")
        out[f"{ts}_{obj}_center"] = np.concatenate([mats[i, :3, 3], rotvec[i]]).astype(np.float32)
        out[f"{ts}_{obj}_off"] = np.concatenate(
            [noised[i, :3, 3], off_rotvec[i]]
        ).astype(np.float32)
        out[f"{ts}_{obj}_ext"] = exts[i].astype(np.float32)
        # Relative pose vs the canonical (first-timestep) box frame.
        if ts == "1":
            canonical[obj] = mats[i]
            out[f"{ts}_{obj}_rel"] = np.eye(4, dtype=np.float32)
        elif obj in canonical:
            out[f"{ts}_{obj}_rel"] = (canonical[obj] @ np.linalg.inv(mats[i])).astype(np.float32)
    return out


def load_scene(
    data_dir: str,
    config,
    split: str,
    factor: Optional[int] = None,
    seed: int = 20201473,
) -> Scene:
    """Load + process one split of a scene directory.

    Args:
      data_dir: scene directory in the on-disk contract format.
      config: durf_tpu_torch.configs.Config (dataset_loader, factor, centering,
        random_box/yaw noise, near/far, spherify).
      split: 'train' | 'test' | 'render'.
      factor: overrides config.factor (used by the c2f resolution pyramid).
    """
    if config.dataset_loader not in DATASET_SPECS:
        raise ValueError(
            f"Config.dataset_loader = {config.dataset_loader!r} is not a known "
            f"dataset spec; set it (e.g. in your .gin file) to one of "
            f"{sorted(DATASET_SPECS)}. The default 'multicam' mirrors the "
            "reference's equally-unregistered default (utils.py:91) and must "
            "be overridden."
        )
    spec = DATASET_SPECS[config.dataset_loader]
    factor = config.factor if factor is None else factor

    images = diskfmt.load_image_dir(data_dir, factor)

    def optional(loader, default_fn):
        try:
            return loader()
        except FileNotFoundError:
            return default_fn()

    poses, _bounds, principal_points = diskfmt.load_poses_bounds(data_dir)
    # Per-factor npz naming: the base factor's files are unsuffixed, other
    # pyramid levels carry a _{factor} suffix (reference
    # c2f_obb_dataset.py:628-653 loads depth_images.npz + depth_images_8/12/16).
    suffix = "" if factor == config.factor else f"_{factor}"
    # Boxes / depth / sky / instance masks are optional: static scenes (e.g.
    # CARLA static captures) carry only images + poses.
    raw_boxes = optional(lambda: diskfmt.load_boxes_3d(data_dir), dict)
    depth = optional(
        lambda: diskfmt.load_npz_stack(data_dir, f"depth_images{suffix}.npz"),
        lambda: [np.zeros(img.shape[:2], np.float32) for img in images],
    )
    sky = optional(
        lambda: diskfmt.load_npz_stack(data_dir, f"sky_masks{suffix}.npz"),
        lambda: [np.zeros(img.shape[:2], np.float32) for img in images],
    )
    masks2d = optional(
        lambda: diskfmt.load_npz_stack(data_dir, "2D_boxes.npz"),
        lambda: [np.zeros(img.shape[:2], np.int32) for img in images],
    )
    n = len(images)
    if poses.shape[0] != n or len(depth) != n or len(sky) != n or len(masks2d) != n:
        raise RuntimeError(
            f"scene {data_dir}: images={n} poses={poses.shape[0]} depth={len(depth)} "
            f"sky={len(sky)} masks2d={len(masks2d)} must all match"
        )

    # Downsampling updates the hwf column (and principal points).
    scale = 1.0 / max(factor, 1)
    poses[:, :2, 4] = np.floor(poses[:, :2, 4] * scale)
    poses[:, 2, 4] = poses[:, 2, 4] * scale
    if principal_points is not None:
        principal_points = principal_points * scale

    rng = np.random.default_rng(seed)
    c2w = None
    if config.centering:
        poses, c2w = recenter_poses(poses)
        poses[:, :3, 3] /= WORLD_SCALE
    box_pose = _process_boxes(
        raw_boxes,
        c2w,
        spec,
        config.random_box,
        config.random_yaw,
        config.box_noise,
        config.yaw_noise,
        rng,
    )

    # 1-based timestep per image (spec.cams_per_timestep images each).
    timesteps = np.repeat(np.arange(1, n // spec.cams_per_timestep + 1), spec.cams_per_timestep)
    total_timesteps = int(timesteps[-1])

    # Splits: the reference hardcodes per-family test indices
    # (obbpose_dataset.py:549, 1806); Config.test_indices overrides them.
    i_test = np.asarray(config.test_indices or spec.test_indices)
    i_train = np.asarray([i for i in range(n) if i not in i_test])
    if split == "train":
        indices = i_train
    elif split == "test":
        indices = i_test
    elif split == "render":
        indices = np.sort(np.concatenate([i_train, i_test])) if spec.render_includes_test else i_train
    else:
        raise ValueError(f"unknown split {split!r}")

    images = [images[i] for i in indices]
    depth = [depth[i].astype(np.float32) for i in indices]
    sky = [sky[i].astype(np.float32) for i in indices]
    masks2d = [masks2d[i] for i in indices]
    poses = poses[indices]
    timesteps = timesteps[indices]
    if principal_points is not None:
        principal_points = principal_points[indices]

    # Metric depth scaled into the recentered world; sky set to the constant.
    for d in depth:
        d[d > 0.0] = d[d > 0.0] / WORLD_SCALE
    for s in sky:
        s[s > 0.0] = spec.sky_value

    # Object ids: from the 2D instance masks (CARLA) or the box-key structure.
    obj_ids = np.asarray([], np.int64)
    if spec.obj_ids_from_masks:
        ids: List[int] = []
        for m in masks2d:
            for u in np.unique(m):
                if u != 0 and u not in ids:
                    ids.append(int(u))
        obj_ids = np.asarray(ids)
    if obj_ids.size == 0:
        # Waymo path, or a pyramid level without instance masks: derive the
        # count from the box-key structure (reference obbpose_dataset.py:
        # 1828-1830).
        n_obj = len({k.split("_")[1] for k in box_pose if k.endswith("_center")})
        obj_ids = np.arange(1, n_obj + 1)

    camtoworlds = poses[:, :3, :4]
    focal = poses[:, 2, 4]
    height = poses[:, 0, 4]
    width = poses[:, 1, 4]

    rays = [
        camera_rays(
            camtoworlds[i],
            int(width[i]),
            int(height[i]),
            float(focal[i]),
            config.near,
            config.far,
            principal_point=None if principal_points is None else principal_points[i],
            use_ndc=not config.spherify,
        )
        for i in range(len(images))
    ]

    return Scene(
        spec=spec,
        split=split,
        images=images,
        depth=depth,
        sky=sky,
        masks2d=masks2d,
        rays=rays,
        timesteps=timesteps,
        total_timesteps=total_timesteps,
        box_pose=box_pose,
        obj_ids=obj_ids,
        camtoworlds=camtoworlds,
        focal=focal,
        height=height,
        width=width,
        near=config.near,
        far=config.far,
    )
