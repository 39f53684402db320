"""Synchronous CARLA capture: dynamic 5-camera rig + static-scene paths.

Replaces the reference's carla/ capture scripts with one tool:
  * --path dynamic  — carla/data_generation.py (731 LoC): traffic + an
    autopilot ego vehicle with a 5-camera Waymo-style rig x {RGB, depth,
    semantic, instance} sensors at fixed_delta 0.1 s;
  * --path static   — carla/static_data.py (688 LoC): a free front-camera
    sensor set driven along a spherical look-at path around the scene origin
    while a prop vehicle is randomly nudged each frame;
  * --path sphere   — carla/static_data_sphere.py (675 LoC): the same
    spherical path over a fully static scene (no prop motion);
  * --path yaw      — carla/static_data_yaw.py (560 LoC): the front sensor
    set fixed on a parked ego while a prop vehicle's yaw is randomly
    incremented from [0, 45) degrees each frame.

All modes write the intermediate capture contract consumed by
durf_tpu_torch.tools.carla_postprocess:
  poses.npy    {"{frame:08d}_{cam}": 4x4 NeRF-convention camera-to-world,
                "hwf_{cam}": [h, w, focal]}
  bboxes.npy   {frame: {vehicle_id: {"center": 4x4 world pose,
                                      "extent": [3] half extents}}}
  {frame:08d}_{kind}{cam}.png sensor images

The port of durf_tpu.tools.carla_capture. The pose math (spherical
sampling, look-at construction, Euler extraction) is module-level numpy and
scipy, tested against the JAX package's in tests/test_torch_tools.py. The
capture loops `capture` and `capture_static` are ported line for line and
have run nowhere: they need the `carla` PyPI wheel and a running simulator
(0.9.13+), and the import is gated.

Usage:
  python -m durf_tpu_torch.tools.carla_capture --out_dir capture/ --frames 5 \
      [--path dynamic|static|sphere|yaw] \
      [--host localhost --port 2000 --town Town03 --vehicles 30]
"""

from __future__ import annotations

import argparse
import os
import queue

import numpy as np

try:  # pragma: no cover - carla is not installed
    import carla

    _CARLA_AVAILABLE = True
except ImportError:  # pragma: no cover
    _CARLA_AVAILABLE = False

# 5-camera rig mimicking the Waymo layout (reference data_generation.py:
# 499-590): [x forward, y right, z up] offsets in the ego frame + yaw degrees.
RIG = [
    dict(pos=(1.6, 0.0, 1.6), yaw=0.0, fov=60.0, size=(1920, 1280)),  # FRONT
    dict(pos=(1.5, -0.4, 1.6), yaw=-45.0, fov=60.0, size=(1920, 1280)),  # FRONT_LEFT
    dict(pos=(1.0, -0.8, 1.6), yaw=-90.0, fov=75.0, size=(1920, 886)),  # SIDE_LEFT
    dict(pos=(1.5, 0.4, 1.6), yaw=45.0, fov=60.0, size=(1920, 1280)),  # FRONT_RIGHT
    dict(pos=(1.0, 0.8, 1.6), yaw=90.0, fov=75.0, size=(1920, 886)),  # SIDE_RIGHT
]
SENSOR_KINDS = {
    "rgb": "sensor.camera.rgb",
    "depth": "sensor.camera.depth",
    "sem": "sensor.camera.semantic_segmentation",
    "inst": "sensor.camera.instance_segmentation",
}

# CARLA's UE4 camera frame (x forward, y right, z up) -> OpenGL c2w
# (x right, y up, looking down -z): the same basis sandwich as the
# reference's carla2Nerf (data_generation.py:96-122).
_T1 = np.array([[0, 1, 0, 0], [0, 0, 1, 0], [-1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
_T2 = np.array([[0, 0, -1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)


def carla_to_nerf(mat: np.ndarray) -> np.ndarray:
    """UE4 camera transform matrix -> OpenGL-convention camera-to-world."""
    return _T1 @ np.asarray(mat, np.float64) @ _T2


def focal_from_fov(width: int, fov_deg: float) -> float:
    return width / (2.0 * np.tan(np.radians(fov_deg) / 2.0))


# ---------------------------------------------------------------------------
# Static-path pose math (pure numpy; reference carla/static_data.py:443-505).
# ---------------------------------------------------------------------------

# The static variants use a single front camera position with 4 sensor kinds
# at 480x320 / fov 50 (reference static_data.py:384-427).
STATIC_CAM = dict(pos=(1.544, -0.024, 2.116), yaw=0.0, fov=50.0, size=(480, 320))


def sample_spherical(npoints: int, radius: float = 10.0, seed: int = 0) -> np.ndarray:
    """[npoints, 3] points uniformly on a radius-`radius` sphere.

    Reproduces reference static_data.py:443-449 (np.random.seed(0), Gaussian
    directions normalized per column, scaled by 10) including its seeding, so
    a rebuild capture revisits the same camera stations.
    """
    rng = np.random.RandomState(seed)
    vec = rng.randn(3, npoints)
    vec /= np.linalg.norm(vec, axis=0)
    return (vec * radius).T


def lookat_c2w(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world matrix looking from `pos` at `target`.

    CARLA body convention (x forward, y right, z up), world z-up: columns are
    [forward, right, up] with right = z x forward (reference static_data.py
    `my_lookat`, :473-488). Deviation: the reference leaves right/up
    unnormalized (their norm is sin of the elevation angle — scipy's
    from_matrix silently re-orthogonalizes downstream, :510-512); we
    normalize so the returned matrix is a proper rigid transform. Degenerate
    straight-up/down views (forward ∥ z) are the caller's responsibility, as
    in the reference.
    """
    pos = np.asarray(pos, np.float64)
    target = np.asarray(target, np.float64)
    forward = target - pos
    forward = forward / np.linalg.norm(forward)
    right = np.cross([0.0, 0.0, 1.0], forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    m = np.zeros((4, 4))
    m[:3, 0] = forward
    m[:3, 1] = right
    m[:3, 2] = up
    m[:3, 3] = pos
    m[3, 3] = 1.0
    return m


def carla_euler_from_matrix(rot3: np.ndarray) -> tuple:
    """(roll, pitch, yaw) degrees for carla.Rotation from a rotation matrix.

    The reference feeds scipy's extrinsic-xyz Euler angles into
    carla.Rotation(roll=e[0], pitch=-e[1], yaw=e[2]) — CARLA's pitch axis is
    flipped relative to the right-handed convention (static_data.py:510-515).
    """
    from scipy.spatial.transform import Rotation as R

    e = R.from_matrix(np.asarray(rot3, np.float64)).as_euler("xyz", degrees=True)
    return float(e[0]), float(-e[1]), float(e[2])


def spherical_path(
    n_stations: int = 100, n_candidates: int = 200, radius: float = 10.0, seed: int = 0
) -> np.ndarray:
    """[n_stations, 4, 4] camera-to-world transforms on a look-at sphere.

    Reference static_data.py:490-502: sample `n_candidates` spherical points
    but keep the first `n_stations` (the sphere variant samples exactly 100,
    static_data_sphere.py:489-497 — pass n_candidates=n_stations for that).
    """
    stations = sample_spherical(n_candidates, radius=radius, seed=seed)[:n_stations]
    return np.stack([lookat_c2w(p, np.zeros(3)) for p in stations])


def yaw_schedule(n_frames: int, max_yaw: float = 45.0, seed: int = 0) -> np.ndarray:
    """[n_frames] random integer yaw increments in [0, max_yaw) degrees
    (reference static_data_yaw.py:397,507-510 draws from np.arange(0, 45))."""
    rng = np.random.RandomState(seed)
    choices = np.arange(0.0, max_yaw)
    return choices[rng.randint(0, len(choices), size=n_frames)]


def prop_nudges(n_frames: int, max_step: int = 4, seed: int = 0) -> np.ndarray:
    """[n_frames, 3] random single-axis translations of 0..max_step-1 meters
    (reference static_data.py:518-525 nudges the prop vehicle each frame)."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n_frames, 3))
    axes = rng.randint(0, 3, size=n_frames)
    steps = rng.randint(0, max_step, size=n_frames)
    out[np.arange(n_frames), axes] = steps
    return out


def capture(  # pragma: no cover - requires a CARLA server; not run anywhere
    out_dir: str,
    frames: int = 5,
    host: str = "localhost",
    port: int = 2000,
    town: str | None = None,
    vehicles: int = 30,
    steps_between_frames: int = 10,
    speed_threshold: float = 1.0,
    max_distance: float = 75.0,
):
    if not _CARLA_AVAILABLE:
        raise ImportError("the carla package is required (pip install carla==0.9.13)")
    os.makedirs(out_dir, exist_ok=True)
    client = carla.Client(host, port)
    client.set_timeout(10.0)
    world = client.load_world(town) if town else client.get_world()

    settings = world.get_settings()
    settings.synchronous_mode = True
    settings.fixed_delta_seconds = 0.1  # reference data_generation.py:301-304
    world.apply_settings(settings)
    tm = client.get_trafficmanager()
    tm.set_synchronous_mode(True)

    bp_lib = world.get_blueprint_library()
    spawn_points = world.get_map().get_spawn_points()

    actors, sensors = [], []
    try:
        # Traffic + ego.
        for i in range(vehicles):
            bp = np.random.choice(bp_lib.filter("vehicle.*"))
            npc = world.try_spawn_actor(bp, spawn_points[i % len(spawn_points)])
            if npc is not None:
                npc.set_autopilot(True, tm.get_port())
                actors.append(npc)
        ego = world.spawn_actor(bp_lib.find("vehicle.tesla.model3"), spawn_points[-1])
        ego.set_autopilot(True, tm.get_port())
        actors.append(ego)

        # Rig: 5 positions x 4 sensor kinds.
        q: queue.Queue = queue.Queue()
        for cam, spec in enumerate(RIG):
            for kind, bp_name in SENSOR_KINDS.items():
                bp = bp_lib.find(bp_name)
                bp.set_attribute("image_size_x", str(spec["size"][0]))
                bp.set_attribute("image_size_y", str(spec["size"][1]))
                bp.set_attribute("fov", str(spec["fov"]))
                tf = carla.Transform(
                    carla.Location(x=spec["pos"][0], y=spec["pos"][1], z=spec["pos"][2]),
                    carla.Rotation(yaw=spec["yaw"]),
                )
                sensor = world.spawn_actor(bp, tf, attach_to=ego)
                sensor.listen(
                    lambda data, c=cam, k=kind, s=sensor: q.put((data.frame, c, k, data, s))
                )
                sensors.append(sensor)

        poses: dict = {}
        for cam, spec in enumerate(RIG):
            poses[f"hwf_{cam}"] = np.array(
                [spec["size"][1], spec["size"][0], focal_from_fov(spec["size"][0], spec["fov"])],
                np.float32,
            )
        bboxes: dict = {}

        for t in range(frames):
            for _ in range(steps_between_frames):
                world.tick()
                while not q.empty():
                    q.get_nowait()
            frame_id = world.tick()
            # Drain exactly one image per sensor for this tick.
            got = 0
            while got < len(sensors):
                fid, cam, kind, data, sensor = q.get(timeout=10.0)
                if fid != frame_id:
                    continue
                data.save_to_disk(os.path.join(out_dir, f"{frame_id:08d}_{kind}{cam}.png"))
                if kind == "rgb":
                    poses[f"{frame_id:08d}_{cam}"] = carla_to_nerf(
                        sensor.get_transform().get_matrix()
                    )
                got += 1

            # Moving vehicles near the ego (reference :614-685).
            frame_boxes = {}
            for npc in world.get_actors().filter("*vehicle*"):
                if npc.id == ego.id:
                    continue
                v = npc.get_velocity()
                speed = abs(v.x) + abs(v.y) + abs(v.z)
                dist = npc.get_transform().location.distance(ego.get_transform().location)
                if speed > speed_threshold and dist < max_distance:
                    bb = npc.bounding_box
                    center = np.asarray(
                        npc.get_transform().get_matrix(), np.float64
                    ) @ np.asarray(
                        carla.Transform(bb.location, bb.rotation).get_matrix(), np.float64
                    )
                    frame_boxes[npc.id] = {
                        "center": center.astype(np.float32),
                        "extent": np.array(
                            [bb.extent.x, bb.extent.y, bb.extent.z], np.float32
                        ),
                    }
            bboxes[f"{frame_id:08d}"] = frame_boxes

        np.save(os.path.join(out_dir, "poses.npy"), poses, allow_pickle=True)
        np.save(os.path.join(out_dir, "bboxes.npy"), bboxes, allow_pickle=True)
    finally:
        for s in sensors:
            s.stop()
            s.destroy()
        for a in actors:
            a.destroy()
        settings.synchronous_mode = False
        world.apply_settings(settings)


def capture_static(  # pragma: no cover - requires a CARLA server; not run anywhere
    out_dir: str,
    mode: str = "sphere",
    frames: int = 100,
    host: str = "localhost",
    port: int = 2000,
    town: str | None = None,
    radius: float = 10.0,
    seed: int = 0,
):
    """Static-scene capture paths (reference carla/static_data{,_sphere,_yaw}.py).

    mode='static': spherical look-at path + a prop vehicle nudged along a
      random axis each frame (static_data.py:518-525);
    mode='sphere': spherical look-at path over an untouched scene
      (static_data_sphere.py);
    mode='yaw': sensors fixed on a parked ego; a prop vehicle's yaw is bumped
      by a random increment each frame (static_data_yaw.py:507-510).
    """
    if not _CARLA_AVAILABLE:
        raise ImportError("the carla package is required (pip install carla==0.9.13)")
    if mode not in ("static", "sphere", "yaw"):
        raise ValueError(f"unknown static capture mode {mode!r}")
    os.makedirs(out_dir, exist_ok=True)
    client = carla.Client(host, port)
    client.set_timeout(10.0)
    world = client.load_world(town) if town else client.get_world()

    settings = world.get_settings()
    settings.synchronous_mode = True
    # Reference tick rates: 0.05 s for the spherical paths
    # (static_data.py:318), 0.25 s for the yaw variant (static_data_yaw.py:289).
    settings.fixed_delta_seconds = 0.25 if mode == "yaw" else 0.05
    world.apply_settings(settings)

    bp_lib = world.get_blueprint_library()
    spawn_points = world.get_map().get_spawn_points()
    spec = STATIC_CAM

    actors, sensors = [], []
    try:
        ego = world.spawn_actor(bp_lib.find("vehicle.tesla.model3"), spawn_points[0])
        actors.append(ego)
        # Prop vehicle (the subject being observed / perturbed).
        prop_tf = spawn_points[0]
        prop_tf.location += carla.Location(x=20.0)
        prop = world.spawn_actor(
            np.random.choice(bp_lib.filter("vehicle.bmw.*") or bp_lib.filter("vehicle.*")),
            prop_tf,
        )
        prop.set_enable_gravity(False)
        actors.append(prop)
        for _ in range(10):
            world.tick()

        # One camera position x 4 sensor kinds (reference static_data.py:
        # 384-427). yaw mode: attached to the parked ego; spherical modes:
        # free world-frame sensors repositioned each frame.
        q: queue.Queue = queue.Queue()
        parent = ego if mode == "yaw" else None
        for kind, bp_name in SENSOR_KINDS.items():
            bp = bp_lib.find(bp_name)
            bp.set_attribute("image_size_x", str(spec["size"][0]))
            bp.set_attribute("image_size_y", str(spec["size"][1]))
            bp.set_attribute("fov", str(spec["fov"]))
            tf = carla.Transform(
                carla.Location(x=spec["pos"][0], y=spec["pos"][1], z=spec["pos"][2]),
                carla.Rotation(yaw=spec["yaw"]),
            )
            sensor = world.spawn_actor(bp, tf, attach_to=parent)
            sensor.listen(lambda data, k=kind, s=None: q.put((data.frame, 0, k, data)))
            sensors.append(sensor)

        poses: dict = {
            "hwf_0": np.array(
                [spec["size"][1], spec["size"][0], focal_from_fov(spec["size"][0], spec["fov"])],
                np.float32,
            )
        }
        bboxes: dict = {}
        path = spherical_path(
            frames, n_candidates=max(2 * frames, frames), radius=radius, seed=seed
        )
        yaws = yaw_schedule(frames, seed=seed)
        nudges = prop_nudges(frames, seed=seed)

        for t in range(frames):
            if mode in ("static", "sphere"):
                c2w = path[t]
                roll, pitch, yaw = carla_euler_from_matrix(c2w[:3, :3])
                carla_t = carla.Transform(
                    carla.Location(x=c2w[0, 3], y=c2w[1, 3], z=c2w[2, 3]),
                    carla.Rotation(roll=roll, pitch=pitch, yaw=yaw),
                )
                for s in sensors:
                    s.set_transform(carla_t)
            if mode == "static":
                loc = prop.get_transform().location
                prop.set_location(
                    loc + carla.Location(x=nudges[t, 0], y=nudges[t, 1], z=nudges[t, 2])
                )
            elif mode == "yaw":
                tf = prop.get_transform()
                tf.rotation.yaw += yaws[t]
                prop.set_transform(tf)

            frame_id = world.tick()
            got = 0
            while got < len(sensors):
                fid, cam, kind, data = q.get(timeout=10.0)
                if fid != frame_id:
                    continue
                data.save_to_disk(os.path.join(out_dir, f"{frame_id:08d}_{kind}{cam}.png"))
                got += 1
            poses[f"{frame_id:08d}_0"] = carla_to_nerf(
                sensors[0].get_transform().get_matrix()
            )

            # Visible vehicles in front of the camera (reference
            # static_data.py:560-625 visibility gate, simplified to the
            # forward-ray dot test; the box pose contract matches `capture`).
            frame_boxes = {}
            cam_tf = sensors[0].get_transform()
            fwd = cam_tf.get_forward_vector()
            for npc in world.get_actors().filter("*vehicle*"):
                if npc.id == ego.id:
                    continue
                ray = npc.get_transform().location - cam_tf.location
                if fwd.dot(ray) <= 1.0:
                    continue
                bb = npc.bounding_box
                center = np.asarray(
                    npc.get_transform().get_matrix(), np.float64
                ) @ np.asarray(
                    carla.Transform(bb.location, bb.rotation).get_matrix(), np.float64
                )
                frame_boxes[npc.id] = {
                    "center": center.astype(np.float32),
                    "extent": np.array([bb.extent.x, bb.extent.y, bb.extent.z], np.float32),
                }
            bboxes[f"{frame_id:08d}"] = frame_boxes

        np.save(os.path.join(out_dir, "poses.npy"), poses, allow_pickle=True)
        np.save(os.path.join(out_dir, "bboxes.npy"), bboxes, allow_pickle=True)
    finally:
        for s in sensors:
            s.stop()
            s.destroy()
        for a in actors:
            a.destroy()
        settings.synchronous_mode = False
        world.apply_settings(settings)


def main(argv=None):  # pragma: no cover
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--path", default="dynamic", choices=["dynamic", "static", "sphere", "yaw"])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=2000)
    p.add_argument("--town", default=None)
    p.add_argument("--vehicles", type=int, default=30)
    p.add_argument("--radius", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not _CARLA_AVAILABLE:
        raise SystemExit("the carla package is not installed (pip install carla==0.9.13)")
    if args.path == "dynamic":
        capture(
            args.out_dir,
            frames=args.frames,
            host=args.host,
            port=args.port,
            town=args.town,
            vehicles=args.vehicles,
        )
    else:
        capture_static(
            args.out_dir,
            mode=args.path,
            frames=args.frames,
            host=args.host,
            port=args.port,
            town=args.town,
            radius=args.radius,
            seed=args.seed,
        )


if __name__ == "__main__":
    main()
