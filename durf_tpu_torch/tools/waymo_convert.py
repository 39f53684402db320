"""Waymo Open Dataset tfrecord -> scene-directory converter.

The port of durf_tpu.tools.waymo_convert, with the port's image codecs
(data/format.read_image: the frames' JPEG bytes, or PNG) and PIL-exact
resampling (data/resample.py) in place of PIL; it writes the same files:
  * per-timestep images from the 5 cameras in rig order (FRONT, FRONT_LEFT,
    SIDE_LEFT, FRONT_RIGHT, SIDE_RIGHT), reordered from the proto's camera
    ids;
  * camera-to-world poses: the reference basis sandwich
    trafo2 @ (frame.pose @ extrinsic) @ opengl2waymo -> 19-column
    poses_bounds.npy with principal points;
  * sparse per-pixel depth from the first- and second-return LIDAR range
    images projected through each camera, min-depth z-buffer at the image
    downsample factor;
  * 3D boxes: moving vehicles as per-timestep 4x4 centers through the SAME
    basis sandwich + (width, height, length) extents, matching the permuted
    box frame (ego motion is handled by using each frame's own vehicle
    pose);
  * 2D instance-id masks rasterized from the projected 3D boxes;
  * sky masks: pass --sky_masks with an off-the-shelf segmenter's output
    (npz, one [H/f, W/f] binary mask per image); without it a "no LIDAR
    return above the horizon" heuristic is used and a warning printed.

The geometry/selection core is pure numpy over proto-shaped objects, and
`convert_frames` is pure given a `depth_fn`. Only the tfrecord reading and
the LIDAR unprojection need `waymo-open-dataset` + `tensorflow`; that
import is gated and the CLI exits with instructions when they are absent.

Usage:
  python -m durf_tpu_torch.tools.waymo_convert --tfrecord seg.tfrecord \
      --out_dir scene/ --timesteps 5 --start_frame 0 --factors 4 \
      [--sky_masks sky_masks.npz]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from durf_tpu_torch.data import format as diskfmt
from durf_tpu_torch.data.resample import LANCZOS, NEAREST, resample

try:  # import-gated heavy deps; waymo_open_dataset first, so that an
    # installed tensorflow is not imported for nothing
    from waymo_open_dataset import dataset_pb2
    from waymo_open_dataset.utils import frame_utils
    import tensorflow as tf

    _WAYMO_AVAILABLE = True
except ImportError:  # pragma: no cover - deps not installed
    _WAYMO_AVAILABLE = False

# Proto camera ids in rig order: the reference exports
# [FRONT, FRONT_LEFT, SIDE_LEFT, FRONT_RIGHT, SIDE_RIGHT] = ids [1, 2, 4, 3, 5]
# reordered from the proto enum (FRONT=1, FRONT_LEFT=2, FRONT_RIGHT=3,
# SIDE_LEFT=4, SIDE_RIGHT=5) — waymo_labels.ipynb cell 13 `order`.
RIG_ORDER = (1, 2, 4, 3, 5)

# Waymo cameras look along +x with +z up; OpenGL cameras look along -z with
# +y up: right-multiplied camera-frame change (waymo_data.ipynb cell 4
# `opengl2waymo`).
OPENGL_TO_WAYMO_CAM = np.array(
    [
        [0, 0, -1, 0],
        [-1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
    ],
    np.float64,
)

# Left-multiplied WORLD basis change: Waymo's z-up world -> the y-up NeRF
# world the loaders expect, (x, y, z) -> (-x, z, y) (waymo_data.ipynb cell 4
# `trafo2`; the same matrix is applied to box poses in waymo_labels.ipynb
# cell 9).
WAYMO_WORLD_TO_NERF = np.array(
    [
        [-1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
    ],
    np.float64,
)


def camera_to_world_opengl(vehicle_to_world: np.ndarray, cam_extrinsic: np.ndarray) -> np.ndarray:
    """NeRF-world OpenGL-convention c2w from Waymo vehicle pose + extrinsic.

    The reference sandwich (waymo_data.ipynb cell 4):
      trafo2 @ (v2w @ c2v) @ opengl2waymo
    — camera frame remapped to OpenGL on the right, world remapped to the
    y-up NeRF world on the left.
    """
    c2w_waymo = np.asarray(vehicle_to_world, np.float64) @ np.asarray(cam_extrinsic, np.float64)
    return WAYMO_WORLD_TO_NERF @ c2w_waymo @ OPENGL_TO_WAYMO_CAM


def heading_to_rotation(heading: float) -> np.ndarray:
    """Yaw-about-z rotation matrix for a Waymo box heading (vehicle frame)."""
    c, s = np.cos(heading), np.sin(heading)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def box_pose_nerf(
    vehicle_to_world: np.ndarray, center_xyz: Sequence[float], heading: float
) -> np.ndarray:
    """4x4 box pose in the NeRF world through the reference basis sandwich.

    waymo_labels.ipynb cell 9: box pose (vehicle frame, yaw-only rotation)
    -> world via frame.pose -> the SAME trafo2/opengl2waymo sandwich as the
    cameras, so the box frame's axes become (-y_box, z_box, -x_box) — which
    is why extents are stored (width, height, length).
    """
    pose_v = np.eye(4)
    pose_v[:3, :3] = heading_to_rotation(heading)
    pose_v[:3, 3] = np.asarray(center_xyz, np.float64)
    pose_w = np.asarray(vehicle_to_world, np.float64) @ pose_v
    return WAYMO_WORLD_TO_NERF @ pose_w @ OPENGL_TO_WAYMO_CAM


def moving_vehicle_boxes(frame, speed_sq_threshold: float = 10.0) -> dict:
    """{track_id: (center_4x4_nerf_world, extent_whl)} for moving vehicles.

    Speed test: the reference keeps labels with |speed_x * speed_y| > 10
    (waymo_labels.ipynb cells 5/13 — a product that misses axis-aligned
    movers); we use speed_x^2 + speed_y^2 > threshold, the robust intent.
    Extents are (width, height, length) to match the sandwiched box frame
    (cell 9 `extent`).
    """
    vehicle_to_world = np.asarray(frame.pose.transform, np.float64).reshape(4, 4)
    out = {}
    for label in frame.laser_labels:
        if label.type != label.TYPE_VEHICLE:
            continue
        meta = label.metadata
        if meta.speed_x**2 + meta.speed_y**2 <= speed_sq_threshold:
            continue
        box = label.box
        center_w = box_pose_nerf(
            vehicle_to_world, (box.center_x, box.center_y, box.center_z), box.heading
        )
        extent = np.array([box.width, box.height, box.length], np.float32)
        out[label.id] = (center_w.astype(np.float32), extent)
    return out


def select_common_movers(movers: List[dict]) -> Dict[str, int]:
    """Dense 1-based renumbering of track ids present in EVERY frame.

    The reference gathers ids seen in ANY frame (waymo_labels.ipynb cell 5)
    and then writes only the frames where the label exists (cell 9), which
    leaves missing `{ts}_{id}_center` keys the loader trips on; requiring
    presence in every selected frame keeps the contract total.
    """
    if not movers:
        return {}
    common = sorted(set.intersection(*[set(m) for m in movers]))
    return {tid: i + 1 for i, tid in enumerate(common)}


def zbuffer_min_depth(
    cp_points: np.ndarray,
    dists: np.ndarray,
    cam_id: int,
    factor: int,
    height: int,
    width: int,
    depth: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Min-depth z-buffer of projected LIDAR returns for one camera.

    Args:
      cp_points: [N, 6] camera-projection rows — two (camera_id, x, y) slots
        per point (a return can project into two cameras; waymo_data.ipynb
        cell 6 scatters both).
      dists: [N] range of each return (meters).
      cam_id: proto camera id to select.
      factor: image downsample factor (pixel coords are full-res).
      height, width: output (downsampled) image size.
      depth: optional existing buffer to merge into (0 = no return), for
        accumulating dual returns.

    Returns:
      [height, width] float32 depth, 0 where no return landed.
    """
    zbuf = np.full((height, width), np.inf, np.float32)
    if depth is not None:
        prev = np.asarray(depth, np.float32)
        zbuf = np.where(prev > 0, prev, zbuf)
    cp_points = np.asarray(cp_points)
    dists = np.asarray(dists, np.float32)
    for slot in (0, 1):
        name = cp_points[:, 3 * slot]
        xs = cp_points[:, 3 * slot + 1] // factor
        ys = cp_points[:, 3 * slot + 2] // factor
        sel = (name == cam_id) & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
        np.minimum.at(zbuf, (ys[sel].astype(int), xs[sel].astype(int)), dists[sel])
    return np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)


def project_lidar_depth(frame, factor: int, rig_index: int):  # pragma: no cover
    """Sparse [H/f, W/f] min-depth image for one camera from the first- and
    second-return range images (waymo_data.ipynb cell 6)."""
    (range_images, camera_projections, _, range_image_top_pose) = (
        frame_utils.parse_range_image_and_camera_projection(frame)
    )
    cam_id = RIG_ORDER[rig_index]
    calib = next(c for c in frame.context.camera_calibrations if c.name == cam_id)
    h, w = calib.height // factor, calib.width // factor
    depth = None
    for ri_index in (0, 1):  # dual returns
        points, cp_points = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose, ri_index=ri_index
        )
        points = np.concatenate(points)
        cp = np.concatenate(cp_points)
        dist = np.linalg.norm(points, axis=-1)
        depth = zbuffer_min_depth(cp, dist, cam_id, factor, h, w, depth)
    return depth


def rasterize_box_masks(frame, rig_index: int, factor: int, id_map: dict) -> np.ndarray:
    """Integer instance-id mask from projected 3D box corners.

    The reference rasterizes the 2D `projected_lidar_labels` boxes
    (waymo_labels.ipynb cells 13-15); we project the 3D boxes through the
    camera calibration ourselves — same output contract (filled 2D AABB per
    mover, id from `id_map`), nearest box winning on overlap.
    """
    cam_id = RIG_ORDER[rig_index]
    calib = next(c for c in frame.context.camera_calibrations if c.name == cam_id)
    h, w = calib.height // factor, calib.width // factor
    mask = np.zeros((h, w), np.int32)
    zbuf = np.full((h, w), np.inf, np.float32)

    extrinsic = np.asarray(calib.extrinsic.transform, np.float64).reshape(4, 4)
    intrinsic = calib.intrinsic  # [f_u, f_v, c_u, c_v, k...]
    v2c = np.linalg.inv(extrinsic)

    for label in frame.laser_labels:
        if label.id not in id_map:
            continue
        box = label.box
        rot = heading_to_rotation(box.heading)
        half = np.array([box.length, box.width, box.height]) / 2
        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
        ) * half
        corners = (rot @ corners.T).T + np.array([box.center_x, box.center_y, box.center_z])
        cam_pts = (v2c[:3, :3] @ corners.T).T + v2c[:3, 3]
        front = cam_pts[:, 0] > 0.1  # waymo cam looks along +x
        if not front.any():
            continue
        u = intrinsic[0] * (-cam_pts[:, 1] / cam_pts[:, 0]) + intrinsic[2]
        v = intrinsic[1] * (-cam_pts[:, 2] / cam_pts[:, 0]) + intrinsic[3]
        u, v = u / factor, v / factor
        x0, x1 = int(max(np.floor(u.min()), 0)), int(min(np.ceil(u.max()), w))
        y0, y1 = int(max(np.floor(v.min()), 0)), int(min(np.ceil(v.max()), h))
        if x1 <= x0 or y1 <= y0:
            continue
        d = float(np.linalg.norm(cam_pts.mean(0)))
        region = zbuf[y0:y1, x0:x1]
        closer = d < region
        mask[y0:y1, x0:x1] = np.where(closer, id_map[label.id], mask[y0:y1, x0:x1])
        zbuf[y0:y1, x0:x1] = np.where(closer, d, region)
    return mask


def heuristic_sky_mask(depth: np.ndarray) -> np.ndarray:
    """Fallback sky mask: no LIDAR return above the horizon line.

    The reference uses off-the-shelf segmentation masks (SURVEY.md §1
    on-disk contract; obbpose_dataset.py:596-599 consumes them) — pass
    --sky_masks to supply those; this heuristic only approximates them.
    """
    h = depth.shape[0]
    sky = (depth == 0).astype(np.float32)
    sky[h // 2 :] = 0.0
    return sky


def load_sky_masks(path: str, n_expected: int) -> List[np.ndarray]:
    """Load an external segmenter's sky masks (reference sky_masks.npz
    contract: arr_0 = one [H/f, W/f] binary mask per image, rig order)."""
    # No allow_pickle: plain float mask arrays never need pickle, and pickle
    # deserialization of a user-supplied file would allow code execution.
    with np.load(path) as f:
        arr = f["arr_0"]
        masks = [np.asarray(m, np.float32) for m in arr]
    if len(masks) != n_expected:
        raise ValueError(
            f"--sky_masks has {len(masks)} masks but the conversion produces "
            f"{n_expected} images (timesteps x 5 cameras, rig order)"
        )
    return masks


def convert_frames(
    frames: Sequence,
    out_dir: str,
    factors: Sequence[int] | int = (4,),
    near: float = 0.1,
    far: float = 75.0,
    sky_masks: Optional[List[np.ndarray]] = None,
    depth_fn: Optional[Callable] = None,
) -> None:
    """Assemble + write the scene directory from parsed Frame protos.

    Pure given `depth_fn` (defaults to the waymo-deps LIDAR unprojection) —
    unit-tested end-to-end with synthetic proto-shaped frames.

    factors: pyramid levels to emit; the FIRST is the base factor and the
    rest get `_{factor}`-suffixed npz files + `images_{factor}` dirs — the
    c2f on-disk contract carla_postprocess already follows (reference
    c2f_obb_dataset.py:628-653). Pass the full (16, 12, 8, 4)-style pyramid
    for use_c2f runs. External --sky_masks arrive at the BASE factor and are
    nearest-resized to the coarser levels.
    """
    if isinstance(factors, int):
        factors = (factors,)
    depth_fn = project_lidar_depth if depth_fn is None else depth_fn
    base = factors[0]

    # Track ids present in every selected frame, renumbered densely from 1.
    movers = [moving_vehicle_boxes(f) for f in frames]
    id_map = select_common_movers(movers)

    per_factor = {f: dict(images=[], depths=[], skies=[], insts=[]) for f in factors}
    poses_hwf, bounds, pps = [], [], []
    boxes_3d: dict = {}
    n_img = 0
    for t, frame in enumerate(frames):
        v2w = np.asarray(frame.pose.transform, np.float64).reshape(4, 4)
        for tid, (center, extent) in movers[t].items():
            if tid in id_map:
                boxes_3d[f"{t + 1}_{id_map[tid]}_center"] = center
                boxes_3d[f"{t + 1}_{id_map[tid]}_ext"] = extent
        by_name = {im.name: im for im in frame.images}
        for rig_index, cam_id in enumerate(RIG_ORDER):
            calib = next(c for c in frame.context.camera_calibrations if c.name == cam_id)
            raw = diskfmt.read_image(by_name[cam_id].image)

            extrinsic = np.asarray(calib.extrinsic.transform, np.float64).reshape(4, 4)
            c2w = camera_to_world_opengl(v2w, extrinsic)
            # Full-res h/w/focal + principal point; the loader divides by its
            # own factor (waymo_data.ipynb cell 4 / cell 16 shape check).
            hwf = np.array([calib.height, calib.width, calib.intrinsic[0]], np.float32)
            poses_hwf.append(
                np.concatenate([c2w[:3, :4], hwf[:, None]], axis=1).astype(np.float32)
            )
            bounds.append([near, far])
            pps.append([calib.intrinsic[2], calib.intrinsic[3]])

            for f in factors:
                h, w = calib.height // f, calib.width // f
                img = resample(raw, (w, h), LANCZOS).astype(np.float32) / 255.0
                d = per_factor[f]
                d["images"].append(img)
                d["depths"].append(depth_fn(frame, f, rig_index))
                if sky_masks is None:
                    d["skies"].append(heuristic_sky_mask(d["depths"][-1]))
                else:
                    m = sky_masks[n_img]
                    if m.shape != (h, w):
                        m = resample(m.astype(np.float32), (w, h), NEAREST)
                    d["skies"].append(m)
                d["insts"].append(rasterize_box_masks(frame, rig_index, f, id_map))
            n_img += 1

    os.makedirs(out_dir, exist_ok=True)
    for f in factors:
        d = per_factor[f]
        diskfmt.save_scene(
            out_dir,
            d["images"],
            np.stack(poses_hwf),
            np.asarray(bounds, np.float32),
            boxes_3d,
            d["depths"],
            d["skies"],
            d["insts"],
            factor=f,
            principal_points=np.asarray(pps, np.float32),
            base_factor=base,
        )


def convert(  # pragma: no cover - requires waymo deps
    tfrecord: str,
    out_dir: str,
    timesteps: int = 5,
    start_frame: int = 0,
    frame_stride: int = 1,
    factors: Sequence[int] | int = (4,),
    near: float = 0.1,
    far: float = 75.0,
    sky_masks_path: Optional[str] = None,
):
    if not _WAYMO_AVAILABLE:
        raise ImportError(
            "waymo-open-dataset and tensorflow are required: "
            "pip install waymo-open-dataset-tf-2-11-0"
        )
    ds = tf.data.TFRecordDataset(tfrecord, compression_type="")
    frames = []
    for i, data in enumerate(ds):
        idx = i - start_frame
        if idx < 0 or idx % frame_stride:
            continue
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        frames.append(frame)
        if len(frames) >= timesteps:
            break

    sky = None
    if sky_masks_path is not None:
        sky = load_sky_masks(sky_masks_path, len(frames) * len(RIG_ORDER))
    else:
        print(
            "WARNING: no --sky_masks given; using the no-LIDAR-above-horizon "
            "heuristic. The reference pipeline uses segmentation masks — "
            "supply them for parity on real scenes."
        )
    convert_frames(frames, out_dir, factors=factors, near=near, far=far, sky_masks=sky)


def main(argv=None):  # pragma: no cover
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tfrecord", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--timesteps", type=int, default=5)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--frame_stride", type=int, default=1)
    p.add_argument(
        "--factors",
        type=int,
        nargs="+",
        default=[4],
        help="pyramid levels; first is the base factor (pass '16 12 8 4' "
        "for a use_c2f-ready scene — the carla_postprocess contract)",
    )
    p.add_argument(
        "--sky_masks",
        default=None,
        help="npz of per-image sky masks from an off-the-shelf segmenter "
        "(reference contract); omit to use the LIDAR-horizon heuristic",
    )
    args = p.parse_args(argv)
    if not _WAYMO_AVAILABLE:
        raise SystemExit(
            "waymo-open-dataset + tensorflow are not installed; "
            "run this converter in an environment with "
            "`pip install waymo-open-dataset-tf-2-11-0`."
        )
    convert(
        args.tfrecord,
        args.out_dir,
        timesteps=args.timesteps,
        start_frame=args.start_frame,
        frame_stride=args.frame_stride,
        factors=tuple(args.factors),
        sky_masks_path=args.sky_masks,
    )


if __name__ == "__main__":
    main()
