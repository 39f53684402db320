"""The port's converters (durf_tpu_torch/tools/) against the JAX package's on
the same inputs, and the public names they brought along.

Both converters write a scene directory; every .npy and .npz file must be
bitwise the JAX converter's, every image within 1 of 255 of it (the JPEG
decoder and the resampling are PIL's arithmetic; the maximum is printed).
Then each package loads its own directory and the two scenes are held to
tests/test_torch_data.py's bitwise scene comparison.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from durf_tpu.tools import carla_capture as jcap
from durf_tpu.tools import carla_postprocess as jcpp
from durf_tpu.tools import waymo_convert as jwc
from durf_tpu_torch.tools import carla_capture as tcap
from durf_tpu_torch.tools import carla_postprocess as tcpp
from durf_tpu_torch.tools import waymo_convert as twc
from tests.test_tools import capture_dir  # noqa: F401  (the CARLA capture fixture)
from tests.test_torch_data import _assert_scenes_equal, _configs
from tests.test_waymo_convert import make_frame

IMAGE_TOL = 1


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _assert_equal_arrays(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == object:
        for x, y in zip(a, b):
            _assert_equal_arrays(np.asarray(x), np.asarray(y), what)
    else:
        assert np.array_equal(a, b), what


def assert_same_scene_dirs(j_dir, t_dir):
    """Same files; npy / npz bitwise; PNG images within IMAGE_TOL."""
    names = _files(j_dir)
    assert names == _files(t_dir) and names
    worst = 0
    for name in names:
        a, b = os.path.join(j_dir, name), os.path.join(t_dir, name)
        if name.endswith(".png"):
            x = np.asarray(Image.open(a)).astype(np.int64)
            y = np.asarray(Image.open(b)).astype(np.int64)
            assert x.shape == y.shape, name
            worst = max(worst, int(np.abs(x - y).max()))
        elif name.endswith(".npz"):
            with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
                assert sorted(x.files) == sorted(y.files) == ["arr_0"], name
                _assert_equal_arrays(x["arr_0"], y["arr_0"], name)
        else:
            x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            if x.dtype == object:  # 3D_boxes.npy: a dict of arrays
                x, y = x.item(), y.item()
                assert sorted(x) == sorted(y), name
                for k in x:
                    _assert_equal_arrays(np.asarray(x[k]), np.asarray(y[k]), f"{name} {k}")
            else:
                _assert_equal_arrays(x, y, name)
    print(f"{len(names)} files; images' largest |d| {worst} of 255")
    assert worst <= IMAGE_TOL


# ---------------------------------------------------------------------------
# CARLA.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factors", [(4,), (2, 4)])
def test_carla_postprocess_writes_the_jax_files(capture_dir, tmp_path, factors):  # noqa: F811
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcpp.convert(capture_dir, j_dir, factors=factors, near=0.1, far=1000.0)
    argv = ["--capture_dir", capture_dir, "--out_dir", t_dir, "--factors"]
    tcpp.main(argv + [str(f) for f in factors])
    assert_same_scene_dirs(j_dir, t_dir)


def test_carla_scene_loads_like_jax(capture_dir, tmp_path):  # noqa: F811
    """The port's load_scene of the port-converted directory against the
    JAX package's of its own. tests/test_tools.py's capture masks object 3
    while its boxes are renumbered to 1; here the masks carry id 1, so that
    the loaders' object tables hold."""
    import shutil

    from durf_tpu.data import scene as jscene
    from durf_tpu_torch.data import scene as tscene

    capture = str(tmp_path / "ids_1")
    shutil.copytree(capture_dir, capture)
    for name in os.listdir(capture):
        if "_inst" in name:
            inst = np.asarray(Image.open(os.path.join(capture, name))).copy()
            inst[..., 1] = np.where(inst[..., 1] > 0, 1, 0)
            Image.fromarray(inst).save(os.path.join(capture, name))
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcpp.convert(capture, j_dir, factors=(4,))
    tcpp.convert(capture, t_dir, factors=(4,))
    for split in ("train", "render"):
        j_cfg, t_cfg = _configs(dataset_loader="carla_dyn")
        t_scene = tscene.load_scene(t_dir, t_cfg, split)
        _assert_scenes_equal(jscene.load_scene(j_dir, j_cfg, split), t_scene)
        assert t_scene.n_examples == 10 and list(t_scene.obj_ids) == [1]


def test_carla_helpers_match_jax():
    depth = np.random.default_rng(0).integers(0, 256, (6, 7, 4)).astype(np.uint8)
    assert np.array_equal(tcpp.decode_depth(depth, 200.0), jcpp.decode_depth(depth, 200.0))
    assert np.array_equal(tcpp.sky_mask_from_semantic(depth), jcpp.sky_mask_from_semantic(depth))
    assert np.array_equal(tcpp.instance_ids(depth), jcpp.instance_ids(depth))
    d = tcpp.decode_depth(depth)
    d[::2, ::3] = 0
    assert np.array_equal(tcpp._min_pool_depth(d, 2), jcpp._min_pool_depth(d, 2))


# ---------------------------------------------------------------------------
# Waymo.
# ---------------------------------------------------------------------------


def stub_depth(frame, factor, rig_index):
    h = frame.context.camera_calibrations[0].height // factor
    w = frame.context.camera_calibrations[0].width // factor
    d = np.zeros((h, w), np.float32)
    d[h // 2:, :] = 10.0 + rig_index
    return d


def textured_frames(fmt, n=3, hw=(32, 48)):
    """tests/test_waymo_convert.py's frames, each camera image a random
    texture encoded by PIL as PNG or JPEG."""
    rng = np.random.default_rng(5)
    frames = [make_frame(t, img_hw=hw) for t in range(n)]
    for frame in frames:
        for im in frame.images:
            img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG"
                                                          else {}))
            im.image = buf.getvalue()
    return frames


@pytest.mark.parametrize("fmt,sky", [("PNG", False), ("JPEG", False), ("JPEG", True)])
def test_waymo_convert_frames_writes_the_jax_files(tmp_path, fmt, sky):
    frames = textured_frames(fmt)
    masks = None
    if sky:  # an external segmenter's masks at the base factor, resized to level 8
        rng = np.random.default_rng(6)
        masks = [(rng.uniform(size=(8, 12)) > 0.5).astype(np.float32) for _ in range(15)]
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    for mod, out in ((jwc, j_dir), (twc, t_dir)):
        mod.convert_frames(frames, out, factors=(4, 8), near=0.1, far=75.0, sky_masks=masks,
                           depth_fn=stub_depth)
    assert_same_scene_dirs(j_dir, t_dir)

    from durf_tpu.data import scene as jscene
    from durf_tpu_torch.data import scene as tscene

    for split in ("train", "test"):
        j_cfg, t_cfg = _configs(dataset_loader="waymo")
        t_scene = tscene.load_scene(t_dir, t_cfg, split)
        _assert_scenes_equal(jscene.load_scene(j_dir, j_cfg, split), t_scene)
        assert t_scene.images[0].shape == (8, 12, 3) and t_scene.total_timesteps == 3


def test_waymo_geometry_core_matches_jax():
    frame = make_frame(2)
    movers_j, movers_t = jwc.moving_vehicle_boxes(frame), twc.moving_vehicle_boxes(frame)
    assert sorted(movers_j) == sorted(movers_t)
    for k in movers_j:
        for a, b in zip(movers_j[k], movers_t[k]):
            assert np.array_equal(a, b)
    id_map = twc.select_common_movers([movers_t])
    assert id_map == jwc.select_common_movers([movers_j])
    for rig in range(5):
        assert np.array_equal(twc.rasterize_box_masks(frame, rig, 2, id_map),
                              jwc.rasterize_box_masks(frame, rig, 2, id_map))
    rng = np.random.default_rng(0)
    cp = np.concatenate([rng.integers(1, 6, (50, 1)), rng.integers(0, 96, (50, 2)),
                         rng.integers(1, 6, (50, 1)), rng.integers(0, 96, (50, 2))], 1)
    dists = rng.uniform(1, 50, 50)
    z_t = twc.zbuffer_min_depth(cp, dists, 1, 4, 8, 12)
    assert np.array_equal(z_t, jwc.zbuffer_min_depth(cp, dists, 1, 4, 8, 12))
    assert np.array_equal(twc.heuristic_sky_mask(z_t), jwc.heuristic_sky_mask(z_t))
    assert np.array_equal(twc.camera_to_world_opengl(np.eye(4), np.eye(4)),
                          jwc.camera_to_world_opengl(np.eye(4), np.eye(4)))
    assert twc.RIG_ORDER == jwc.RIG_ORDER


def test_waymo_cli_without_tensorflow_exits_like_jax(monkeypatch, capsys):
    """Without waymo-open-dataset and tensorflow both CLIs exit with the
    install instructions before reading anything."""
    argv = ["--tfrecord", "missing.tfrecord", "--out_dir", "unused"]
    for mod in (jwc, twc):
        monkeypatch.setattr(mod, "_WAYMO_AVAILABLE", False)
        with pytest.raises(SystemExit, match="waymo-open-dataset"):
            mod.main(argv)
        with pytest.raises(ImportError, match="waymo-open-dataset"):
            mod.convert("missing.tfrecord", "unused")
    assert not os.path.exists("unused")


# ---------------------------------------------------------------------------
# CARLA capture helpers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("helper", ["sample_spherical", "lookat_c2w", "carla_euler_from_matrix",
                                    "spherical_path", "yaw_schedule", "prop_nudges",
                                    "carla_to_nerf", "focal_from_fov"])
def test_carla_capture_helpers_match_jax(helper):
    from scipy.spatial.transform import Rotation as R

    args = {
        "sample_spherical": (16, 7.0, 3),
        "lookat_c2w": (np.array([3.0, -4.0, 2.0]), np.array([0.5, 0.2, -0.1])),
        "carla_euler_from_matrix": (R.from_euler("xyz", [10, -25, 140], degrees=True).as_matrix(),),
        "spherical_path": (8, 20, 5.0, 1),
        "yaw_schedule": (32, 30.0, 2),
        "prop_nudges": (32, 3, 4),
        "carla_to_nerf": (R.random(random_state=0).as_matrix() @ np.eye(3),),
        "focal_from_fov": (1920, 60.0),
    }[helper]
    if helper == "carla_to_nerf":
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = args[0], [1.0, -2.0, 0.5]
        args = (m,)
    got, ref = getattr(tcap, helper)(*args), getattr(jcap, helper)(*args)
    assert np.array_equal(np.asarray(got), np.asarray(ref))
    assert tcap.RIG == jcap.RIG and tcap.STATIC_CAM == jcap.STATIC_CAM
    assert tcap.SENSOR_KINDS == jcap.SENSOR_KINDS


def test_carla_capture_without_carla_raises():
    assert not tcap._CARLA_AVAILABLE
    with pytest.raises(ImportError, match="carla"):
        tcap.capture("unused")
    with pytest.raises(SystemExit, match="carla"):
        tcap.main(["--out_dir", "unused"])


# ---------------------------------------------------------------------------
# The remaining public names.
# ---------------------------------------------------------------------------


def test_srgb_conversions_match_jax():
    from durf_tpu import mathx as jm
    from durf_tpu_torch import mathx as tm

    x = np.linspace(0.0, 1.0, 1001, dtype=np.float32)
    for name in ("linear_to_srgb", "srgb_to_linear"):
        got = getattr(tm, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jm, name)(jnp.asarray(x))), atol=1e-6)


def test_box_helpers_match_jax():
    from durf_tpu.ops import boxes as jb
    from durf_tpu_torch.ops import boxes as tb

    rng = np.random.default_rng(0)
    p = rng.normal(size=(5, 2, 3)).astype(np.float32)
    yaw = rng.uniform(-3, 3, (5, 2)).astype(np.float32)
    pos = rng.normal(size=(5, 2, 3)).astype(np.float32)
    rot = np.array(jb.axis_angle_to_matrix(jnp.asarray(rng.normal(size=(5, 2, 3)),
                                                        jnp.float32)))
    ext = rng.uniform(0.5, 4, (5, 2, 3)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (tb.rotate_yaw(t(p), t(yaw)), jb.rotate_yaw(p, yaw)),
        (tb.box_to_world_frames(t(p), t(pos), t(rot)), jb.box_to_world_frames(p, pos, rot)),
        (tb.scale_to_unit_box(t(p), t(ext)), jb.scale_to_unit_box(p, ext)),
        (tb.scale_to_unit_box(t(p), t(ext), inverse=True),
         jb.scale_to_unit_box(p, ext, inverse=True)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_config_to_dict_matches_jax():
    from durf_tpu import configs as jc
    from durf_tpu_torch import configs as tc

    assert tc.config_to_dict(tc.Config()) == jc.config_to_dict(jc.Config())
    gin = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                       "waymo_fast.gin")
    assert (tc.config_to_dict(tc.load_config([gin]))
            == jc.config_to_dict(jc.load_config([gin])))
