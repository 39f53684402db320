"""The port's scene data layer against the JAX package's, on the same scene
directories: the generator's files, the PNG codec (against PIL), scene
loading, compaction sizing, host batches in every batching mode, the
producer's failure, the device-resident pools and their gather.

Everything here is numpy on the host (the pools on CPU tensors), so the
comparisons are bitwise.
"""

import os
import shutil
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from durf_tpu import train as jtrain
from durf_tpu.configs import Config as JConfig
from durf_tpu.data import device_data as jdd
from durf_tpu.data import pipeline as jpipe
from durf_tpu.data import scene as jscene
from durf_tpu.data.synthetic import generate_scene as j_generate
from durf_tpu.parallel import make_mesh
from durf_tpu_torch import train as ttrain
from durf_tpu_torch.configs import Config as TConfig
from durf_tpu_torch.data import device_data as tdd
from durf_tpu_torch.data import format as tfmt
from durf_tpu_torch.data import pipeline as tpipe
from durf_tpu_torch.data import scene as tscene
from durf_tpu_torch.data.synthetic import generate_scene as t_generate
from durf_tpu_torch.data.synthetic import main as t_synthetic_main
from durf_tpu_torch.rays import Rays

SCENE = dict(timesteps=3, width=80, height=64, focal=70.0)  # 20x16 images at factor 4
C2F_SCENE = dict(timesteps=3, width=160, height=128, focal=140.0, factors=(4, 8, 12, 16))


def _config(cls, **kw):
    cfg = cls(
        dataset_loader="carla_dyn", batching="timestep", batch_size=32, factor=4,
        spherify=True, centering=True, near=0.0, far=40.0, timesteps=3,
    )
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _configs(**kw):
    return _config(JConfig, **kw), _config(TConfig, **kw)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX-written scene, port-written scene, port-written 4-factor scene,
    the port scene with 19-column poses): directories."""
    root = tmp_path_factory.mktemp("torch_data")
    j_dir, t_dir, c2f_dir = str(root / "jax"), str(root / "port"), str(root / "c2f")
    j_generate(j_dir, **SCENE)
    t_generate(t_dir, **SCENE)
    t_synthetic_main(["--out", c2f_dir, "--timesteps", "3", "--width", "160", "--height", "128",
                      "--focal", "140", "--factors", "4", "8", "12", "16"])
    pp_dir = str(root / "port19")
    shutil.copytree(t_dir, pp_dir)
    arr = np.load(os.path.join(pp_dir, "poses_bounds.npy"))
    pp = np.stack([arr[:, 9] * 0.5 + 3.0, arr[:, 4] * 0.5 - 2.0], -1)  # (cx, cy) at full res
    np.save(os.path.join(pp_dir, "poses_bounds.npy"), np.concatenate([arr, pp], -1))
    return j_dir, t_dir, c2f_dir, pp_dir


# -- the generator's files ---------------------------------------------------


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, n), d) for r, _, ns in os.walk(d) for n in ns)


@pytest.mark.parametrize("kind", ["images_4", "poses_bounds.npy", "3D_boxes.npy",
                                  "depth_images.npz", "sky_masks.npz", "2D_boxes.npz"])
def test_generate_scene_writes_the_jax_files(scenes, kind):
    j_dir, t_dir, _, _ = scenes
    assert _files(j_dir) == _files(t_dir)
    jp, tp = os.path.join(j_dir, kind), os.path.join(t_dir, kind)
    if kind == "images_4":
        names = sorted(os.listdir(jp))
        assert len(names) == 15
        for n in names:
            a = np.asarray(Image.open(os.path.join(jp, n)))
            b = np.asarray(Image.open(os.path.join(tp, n)))
            assert a.shape == (16, 20, 3) and np.array_equal(a, b), n
            assert np.array_equal(tfmt.read_png(os.path.join(jp, n)), a), n
    elif kind == "3D_boxes.npy":
        a = np.load(jp, allow_pickle=True).item()
        b = np.load(tp, allow_pickle=True).item()
        assert sorted(a) == sorted(b) and len(a) == 12
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    elif kind.endswith(".npy"):
        a, b = np.load(jp), np.load(tp)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        a, b = np.load(jp)["arr_0"], np.load(tp)["arr_0"]
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the PNG codec -----------------------------------------------------------

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(img, filters, interlace=0, depth=8, color=None):
    """A PNG of uint8 `img` [H, W, C] whose row r is written with filter
    filters[r] (hand-made scanlines; no imaging package involved)."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    left = np.concatenate([np.zeros((h, 1, c), np.int32), x[:, :-1]], 1)
    up = np.concatenate([np.zeros((1, w, c), np.int32), x[:-1]], 0)
    upleft = np.concatenate([np.zeros((h, 1, c), np.int32), up[:, :-1]], 1)
    preds = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    rows = []
    for r, f in enumerate(filters):
        pred = preds[f] if f == 0 else preds[f][r]
        rows.append(bytes([f]) + ((x[r] - pred) & 0xFF).astype(np.uint8).tobytes())
    color = _COLOR[c] if color is None else color
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    return (tfmt.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _smooth_image(rng, h, w, c):
    # Gradients plus noise: every predictor sees varied left / up / up-left.
    base = rng.integers(0, 256, (1, 1, c)) + 7 * np.arange(w)[None, :, None] \
        + 11 * np.arange(h)[:, None, None]
    return ((base + rng.integers(0, 40, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_read_png_undoes_every_row_filter_like_pil(tmp_path, mode, filt):
    rng = np.random.default_rng(MODES[mode] * 10 + (5 if filt == "mixed" else filt))
    for w in (1, 2, 7, 33):
        img = _smooth_image(rng, 9, w, MODES[mode])
        filters = rng.integers(0, 5, 9) if filt == "mixed" else [filt] * 9
        f = tmp_path / f"{mode}_{filt}_{w}.png"
        f.write_bytes(_filtered_png(img, filters))
        expect = img[..., 0] if mode == "L" else img
        pil = np.asarray(Image.open(f))
        got = tfmt.read_png(str(f))
        assert np.array_equal(pil, expect)
        assert got.dtype == np.uint8 and got.shape == pil.shape and np.array_equal(got, pil)


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 12), w=st.integers(1, 12), mode=st.sampled_from(list(MODES)),
       seed=st.integers(0, 2**31 - 1))
def test_read_png_random_images_and_filters(tmp_path_factory, h, w, mode, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, MODES[mode])).astype(np.uint8)
    f = tmp_path_factory.mktemp("hyp") / "x.png"
    f.write_bytes(_filtered_png(img, rng.integers(0, 5, h)))
    assert np.array_equal(tfmt.read_png(str(f)), np.asarray(Image.open(f)))


@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_reads_what_pil_writes_and_pil_reads_write_png(tmp_path, mode):
    img = _smooth_image(np.random.default_rng(1), 37, 23, MODES[mode])
    img = img[..., 0] if mode == "L" else img
    Image.fromarray(img, mode).save(tmp_path / "pil.png")  # PIL's adaptive filters
    assert np.array_equal(tfmt.read_png(str(tmp_path / "pil.png")), img)
    tfmt.write_png(str(tmp_path / "port.png"), img)
    back = Image.open(tmp_path / "port.png")
    assert back.mode == mode and np.array_equal(np.asarray(back), img)


@pytest.mark.parametrize("kind", ["jpeg", "16-bit", "palette", "interlaced", "truncated"])
def test_read_png_refuses_what_it_does_not_read(tmp_path, kind):
    img = _smooth_image(np.random.default_rng(2), 8, 8, 3)
    f = tmp_path / f"{kind}.png"
    if kind == "jpeg":
        f = tmp_path / "img.jpg"
        Image.fromarray(img).save(f, "JPEG")
    elif kind == "16-bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(f)
        assert Image.open(f).mode.startswith("I")
    elif kind == "palette":
        Image.fromarray(img).convert("P").save(f)
    elif kind == "interlaced":
        f.write_bytes(_filtered_png(img, [0] * 8, interlace=1))
    else:
        f.write_bytes(_filtered_png(img, [0] * 8)[:-20])
    with pytest.raises(ValueError, match=str(f.name)):
        tfmt.read_png(str(f))


def test_load_image_dir_and_natsorted_match_jax(scenes):
    j_dir, _, _, _ = scenes
    from durf_tpu.data import format as jfmt

    names = ["img10.png", "img2.png", "IMG1.png", "a", "img2b.png"]
    assert tfmt.natsorted(names) == jfmt.natsorted(names)
    a, b = jfmt.load_image_dir(j_dir, 4), tfmt.load_image_dir(j_dir, 4)
    assert len(a) == len(b) == 15
    assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(FileNotFoundError):
        tfmt.load_image_dir(j_dir, 8)


def test_load_image_dir_repeats_gray_and_drops_alpha(tmp_path):
    img = _smooth_image(np.random.default_rng(3), 6, 5, 4)
    os.makedirs(tmp_path / "images_2")
    tfmt.write_png(str(tmp_path / "images_2" / "a.png"), img[..., 0])
    tfmt.write_png(str(tmp_path / "images_2" / "b.png"), img)
    gray, rgba = tfmt.load_image_dir(str(tmp_path), 2)
    assert gray.shape == rgba.shape == (6, 5, 3) and gray.dtype == np.float32
    assert np.array_equal(gray, np.repeat(img[..., :1], 3, -1) / np.float32(255.0))
    assert np.array_equal(rgba, img[..., :3] / np.float32(255.0))


# -- scene loading -----------------------------------------------------------


def _assert_scenes_equal(j, t):
    assert (j.spec.name, j.split, j.total_timesteps, j.near, j.far) == (
        t.spec.name, t.split, t.total_timesteps, t.near, t.far)
    for name in ("timesteps", "obj_ids", "camtoworlds", "focal", "height", "width"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("images", "depth", "sky", "masks2d"):
        xs, ys = getattr(j, name), getattr(t, name)
        assert len(xs) == len(ys) > 0
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(xs, ys)), name
    assert len(j.rays) == len(t.rays)
    for rj, rt in zip(j.rays, t.rays):
        for field in Rays._fields:
            a, b = getattr(rj, field), getattr(rt, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert sorted(j.box_pose) == sorted(t.box_pose)
    assert not t.box_pose or any(k.endswith("_off") for k in t.box_pose)
    for k in j.box_pose:
        assert np.array_equal(j.box_pose[k], t.box_pose[k]), k
    if len(t.obj_ids):
        for use_off in (False, True):
            assert np.array_equal(j.init_table(use_off), t.init_table(use_off))
    assert j.inst_usable() == t.inst_usable()


@pytest.mark.parametrize(
    "loader,split,noise",
    [
        ("carla_dyn", "train", False),
        ("carla_dyn", "test", False),
        ("carla_dyn", "render", False),
        ("carla_dyn", "train", True),
        ("waymo", "train", False),
        ("waymo", "test", False),
        ("waymo", "render", True),
    ],
)
def test_load_scene_is_bit_equal(scenes, loader, split, noise):
    """carla_dyn on the 17-column scene, waymo on the 19-column one; noise
    turns random_box and random_yaw on (the '_off' poses)."""
    _, t_dir, _, pp_dir = scenes
    data = pp_dir if loader == "waymo" else t_dir
    kw = dict(dataset_loader=loader, random_box=noise, random_yaw=noise)
    j_cfg, t_cfg = _configs(**kw)
    j, t = jscene.load_scene(data, j_cfg, split), tscene.load_scene(data, t_cfg, split)
    _assert_scenes_equal(j, t)
    if noise:
        key = "2_1"
        assert not np.array_equal(t.box_pose[f"{key}_off"], t.box_pose[f"{key}_center"])


def test_load_scene_static_and_unknown_loader(scenes, tmp_path):
    static = str(tmp_path / "static")
    t_generate(static, num_objects=0, **SCENE)
    j_cfg, t_cfg = _configs()
    static_scene = tscene.load_scene(static, t_cfg, "train")
    _assert_scenes_equal(jscene.load_scene(static, j_cfg, "train"), static_scene)
    assert not static_scene.box_pose and len(static_scene.obj_ids) == 0
    with pytest.raises(ValueError, match="dataset_loader"):
        tscene.load_scene(static, _config(TConfig, dataset_loader="multicam"), "train")


@pytest.mark.parametrize("use_off,inflate", [(False, 0.0), (True, 0.0), (True, 0.5)])
def test_max_hit_fraction_is_equal(scenes, use_off, inflate):
    _, t_dir, _, _ = scenes
    j_cfg, t_cfg = _configs(random_box=True)
    j = jscene.max_hit_fraction(jscene.load_scene(t_dir, j_cfg, "train"), use_off, inflate)
    t = tscene.max_hit_fraction(tscene.load_scene(t_dir, t_cfg, "train"), use_off, inflate)
    assert j == t and 0.0 < t < 1.0


@pytest.mark.parametrize("random_box", [False, True])
def test_resolve_obj_capacity_is_equal(scenes, random_box):
    _, t_dir, c2f_dir, _ = scenes
    for data, c2f in ((t_dir, False), (c2f_dir, True)):
        j_cfg, t_cfg = _configs(random_box=random_box, use_c2f=c2f)
        j_ds, t_ds = jpipe.RayDataset("train", data, j_cfg), tpipe.RayDataset("train", data, t_cfg)
        j_logs, t_logs = [], []
        j = jtrain.resolve_obj_capacity(j_cfg, j_ds, j_logs.append)
        t = ttrain.resolve_obj_capacity(t_cfg, t_ds, t_logs.append)
        assert j == t and 0.0 < t <= 1.0 and j_logs == t_logs


# -- host batches ------------------------------------------------------------


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "rays":
            for field in Rays._fields:
                x, y = getattr(a[k], field), getattr(b[k], field)
                assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize(
    "batching", ["timestep", "all_images", "single_image", "single_image_consecutive"]
)
def test_host_batches_are_bit_equal(scenes, batching):
    _, t_dir, _, _ = scenes
    j_cfg, t_cfg = _configs(batching=batching)
    j_ds, t_ds = jpipe.get_dataset("train", t_dir, j_cfg), tpipe.get_dataset("train", t_dir, t_cfg)
    assert j_ds.size == t_ds.size == 13
    _assert_batches_equal(j_ds.peek(), t_ds.peek())
    for _ in range(4):
        _assert_batches_equal(next(j_ds), next(t_ds))
    j_test, t_test = jpipe.get_dataset("test", t_dir, j_cfg), tpipe.get_dataset("test", t_dir, t_cfg)
    for _ in range(3):  # wraps around the 2 test images
        _assert_batches_equal(next(j_test), next(t_test))


def test_c2f_batches_and_factor_switch_are_bit_equal(scenes, monkeypatch):
    """The c2f schedule on the 4-factor scene: batches drawn step by step
    across every factor boundary. The prefetch threads are held off (their
    look-ahead depends on timing), so the draws run in the test's order."""
    _, _, c2f_dir, _ = scenes
    monkeypatch.setattr(jpipe.RayDataset, "_run", lambda self: None)
    monkeypatch.setattr(tpipe.RayDataset, "_run", lambda self: None)
    j_cfg, t_cfg = _configs(use_c2f=True, c2f_steps=(2, 4, 6))
    j_ds, t_ds = jpipe.RayDataset("train", c2f_dir, j_cfg), tpipe.RayDataset("train", c2f_dir, t_cfg)
    assert j_ds.factors == t_ds.factors == [16, 12, 8, 4]
    seen = []
    for step in range(1, 9):
        j_ds.set_step(step)
        t_ds.set_step(step)
        a, b = j_ds._next_train(), t_ds._next_train()
        _assert_batches_equal(a, b)
        seen.append(b["_factor"])
    assert seen == [16, 16, 12, 12, 8, 8, 4, 4]


def test_producer_failure_propagates_like_jax(scenes):
    _, t_dir, _, _ = scenes
    j_cfg, t_cfg = _configs(batching="no_such_mode")
    errors = []
    for mod, cfg in ((jpipe, j_cfg), (tpipe, t_cfg)):
        ds = mod.RayDataset("train", t_dir, cfg)
        caught = []
        for _ in range(2):  # the first failure, then the sticky one
            with pytest.raises(RuntimeError, match="producer thread died") as info:
                next(ds)
            caught.append((type(info.value.__cause__), str(info.value)))
        errors.append(caught)
    assert errors[0] == errors[1] and errors[1][0][0] is NotImplementedError


# -- device-resident pools ---------------------------------------------------


def _assert_pools_equal(j, t):
    assert sorted(j) == sorted(t)
    assert list(np.asarray(j["counts"])) == t["counts"]
    for k in j:
        if k == "counts":
            continue
        if k == "rays":
            for field in Rays._fields:
                assert np.array_equal(np.asarray(getattr(j[k], field)),
                                      getattr(t[k], field).numpy()), field
        else:
            assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k


@pytest.fixture(scope="module")
def pools(scenes):
    _, t_dir, _, _ = scenes
    j_cfg, t_cfg = _configs(random_box=True)
    j_ds, t_ds = jpipe.RayDataset("train", t_dir, j_cfg), tpipe.RayDataset("train", t_dir, t_cfg)
    return jdd.build_pools(j_ds, make_mesh()), tdd.build_pools(t_ds, "cpu"), t_ds


def test_build_pools_is_equal(scenes, pools):
    j, t, t_ds = pools
    _assert_pools_equal(j, t)
    # 5 images of 20x16 a timestep; timestep 3 lost the 2 test images.
    assert "inst" in t and t["pixels"].shape == (3, 1600, 3) and t["counts"] == [1600, 1600, 960]
    assert tdd.pool_bytes(t_ds) == 3 * 1600 * 18 * 4


def test_build_pools_c2f_is_equal(scenes):
    _, _, c2f_dir, _ = scenes
    j_cfg, t_cfg = _configs(use_c2f=True)
    j_ds, t_ds = jpipe.RayDataset("train", c2f_dir, j_cfg), tpipe.RayDataset("train", c2f_dir, t_cfg)
    j, t = jdd.build_pools_c2f(j_ds, make_mesh()), tdd.build_pools_c2f(t_ds, "cpu")
    assert len(j) == len(t) == 4 and all("inst" not in p for p in t)
    for a, b in zip(j, t):
        _assert_pools_equal(a, b)
    assert jdd.pool_bytes(j_ds) == tdd.pool_bytes(t_ds)
    for step in range(0, 30, 3):
        c2f = tuple(j_cfg.c2f_steps)
        assert tdd.c2f_factor_index(step, (5, 10, 20), 4) == int(
            jdd.c2f_factor_index(step, (5, 10, 20), 4))
        assert tdd.c2f_factor_index(step, c2f, 1) == int(jdd.c2f_factor_index(step, c2f, 1)) == 0
    # The device step of 0-based step s draws from the level of step s + 1,
    # as the JAX package's device step passes state.step + 1.
    for step in (0, 3, 4, 5, 9, 10, 19, 20, 25):
        level = int(jdd.c2f_factor_index(step + 1, (5, 10, 20), 4))
        got = tdd.sample_batch_c2f(t, step, (5, 10, 20), 11, 32)
        want = tdd.sample_batch(t[level], step, 11, 32)
        assert torch.equal(got["pixels"], want["pixels"]), step
        assert got["rays"].origins.shape == (32, 3)


@pytest.mark.parametrize("seed", [0, 7])
def test_gather_equals_jax_sample_batch(pools, seed):
    """JAX's sample_batch on a key, and the port's gather at the (ts, idx)
    that key draws."""
    j, t, _ = pools
    key = jax.random.key(seed)
    got_j = jdd.sample_batch(j, key, 64)
    ts_key, idx_key = jax.random.split(key)
    ts = int(jax.random.randint(ts_key, (), 0, 3))
    idx = np.array(jax.random.randint(idx_key, (64,), 0, int(j["counts"][ts])))
    got_t = tdd.gather_batch(t, ts, torch.from_numpy(idx).long())
    assert sorted(got_j) == sorted(got_t) and got_t["ts"] == int(got_j["ts"])
    for k, v in got_t.items():
        if k == "ts":
            continue
        if k == "rays":
            for field in Rays._fields:
                assert np.array_equal(np.asarray(getattr(got_j[k], field)),
                                      getattr(v, field).numpy()), field
        else:
            assert np.array_equal(np.asarray(got_j[k]), v.numpy()), k


def test_sample_batch_draws_in_range_and_repeat(pools):
    _, t, _ = pools
    seen_ts = set()
    for step in range(12):
        a = tdd.sample_batch(t, step, 20201473, 256)
        b = tdd.sample_batch(t, step, 20201473, 256)
        assert isinstance(a["ts"], int) and 0 <= a["ts"] < 3
        seen_ts.add(a["ts"])
        assert a["ts"] == b["ts"] and torch.equal(a["pixels"], b["pixels"])
        idx = tdd.draw_indices(t["counts"][a["ts"]], 256, 20201473, step, "cpu")
        assert int(idx.min()) >= 0 and int(idx.max()) < t["counts"][a["ts"]]
        assert torch.equal(a["pixels"], t["pixels"][a["ts"]][idx])
    assert seen_ts == {0, 1, 2}
    one, two = tdd.sample_batch(t, 3, 20201473, 256), tdd.sample_batch(t, 4, 20201473, 256)
    assert not torch.equal(one["rays"].origins, two["rays"].origins)
    # An index draw on a count of 1 is all zeros; draws cover the range.
    assert int(tdd.draw_indices(1, 64, 0, 0, "cpu").max()) == 0
    many = tdd.draw_indices(5, 4096, 0, 0, "cpu")
    assert set(many.tolist()) == {0, 1, 2, 3, 4}
