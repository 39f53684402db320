"""The port's JPEG decoder (durf_tpu_torch/data/jpeg.py) against PIL's bundled
libjpeg-turbo, and the JPEG path of the scene loader against the JAX one.

Tolerance: every decoded sample within 1 of 255 of PIL's (the chroma
upsampling and colour conversion are integer arithmetic copied from
libjpeg, so the share of bitwise samples is printed too), and bitwise where
no chroma is upsampled (4:4:4, RGB and gray files).
"""

import hashlib
import io
import os
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from durf_tpu_torch.data import format as tfmt
from durf_tpu_torch.data import jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
NAMES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
LARGE = "waymo_1920x1280_q90_420.jpg"
TOL = 1
BITWISE = ("q85_444.jpg", "rgb_444.jpg", "gray.jpg", "progressive_gray.jpg")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as fh:
        return fh.read()


def _compare(got, ref, what):
    assert got.dtype == np.uint8 and got.shape == ref.shape, (what, got.shape, ref.shape)
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    share = float((diff == 0).mean())
    print(f"{what}: max |d| {int(diff.max())}, bitwise share {share:.6f}")
    assert diff.max() <= TOL, what
    return share


def test_fixture_kinds_and_size():
    """Every kind the generator writes is there, the folder stays small."""
    assert len(NAMES) == 12 and LARGE in NAMES
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 1.5e6


@pytest.mark.parametrize("name", NAMES)
def test_fixture_matches_pil(name):
    """Each fixture against PIL's live decode, and PIL's committed decode
    (the card's yardstick) against the live one."""
    data = _read(name)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    got = jpeg.decode_jpeg(data, name)
    share = _compare(got, ref, name)
    if name in BITWISE:
        assert share == 1.0
    with np.load(os.path.join(FIXTURES, "pil_decodes.npz")) as saved:
        if name == LARGE:
            assert str(saved[name + ".sha256"]) == hashlib.sha256(ref.tobytes()).hexdigest()
        else:
            assert np.array_equal(saved[name], ref)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (3, 2), (4, 5), (9, 17), (17, 9)])
def test_tiny_and_partial_mcus_match_pil(hw, subsampling, progressive):
    """Images one to a few pixels wide: chroma planes of 1 or 2 samples take
    libjpeg's replicating upsamplers, partial MCUs on both edges."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, subsampling=subsampling,
                              progressive=progressive)
    data = buf.getvalue()
    _compare(jpeg.decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data))), f"{hw}")


def _jpeg_dir(root, names):
    d = os.path.join(root, "images_4")
    os.makedirs(d)
    for i, name in enumerate(names):
        shutil.copy(os.path.join(FIXTURES, name), os.path.join(d, f"img_{i:04d}.jpg"))
    return d


def test_load_image_dir_reads_jpeg_like_jax(tmp_path):
    """A scene folder of .jpg images loads as the JAX loader (PIL) loads it."""
    from durf_tpu.data import format as jfmt

    names = ["q75_420.jpg", "q85_444.jpg", "progressive_420.jpg", "rgb_444.jpg"]
    _jpeg_dir(str(tmp_path), names)
    got, ref = tfmt.load_image_dir(str(tmp_path), 4), jfmt.load_image_dir(str(tmp_path), 4)
    assert len(got) == len(ref) == len(names)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        assert np.abs(g - r).max() <= TOL / 255.0 + 1e-7


def _patched(data: bytes, marker: int, precision: int = 8) -> bytes:
    """`data` with its SOF0 marker replaced by `marker` and the frame's
    sample precision by `precision`."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("kind", ["arithmetic", "lossless", "cmyk", "12-bit", "truncated",
                                  "corrupt", "unrefined", "not-a-jpeg"])
def test_refused_kinds_raise_naming_the_file(tmp_path, kind):
    base = _read("q75_420.jpg")
    if kind == "arithmetic":
        data, match = _patched(base, 0xC9), "arithmetic"
    elif kind == "lossless":
        data, match = _patched(base, 0xC3), "lossless"
    elif kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(buf, format="JPEG")
        data, match = buf.getvalue(), "CMYK"
    elif kind == "12-bit":
        data, match = _patched(base, 0xC1, precision=12), "12-bit"
    elif kind == "truncated":
        data, match = base[: len(base) // 2], "truncated"
    elif kind == "corrupt":
        sos = base.index(b"\xff\xda")
        data, match = base[: sos + 20] + b"\xff" * 3 + b"\x00" * 40 + base[-2:], "corrupt"
    elif kind == "unrefined":  # a progressive file cut after its first scan
        prog = _read("progressive_420.jpg")
        second = prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)
        data, match = prog[:second] + b"\xff\xd9", "unrefined"
    else:
        data, match = b"GIF89a" + base[2:], "neither a PNG nor a JPEG"
    f = tmp_path / f"{kind}.jpg"
    f.write_bytes(data)
    with pytest.raises(ValueError, match=f"{re.escape(f.name)}.*{match}"):
        tfmt.read_image(str(f))
    d = tmp_path / "scene" / "images_4"
    d.mkdir(parents=True)
    shutil.copy(f, d / "img_0000.jpg")
    with pytest.raises(ValueError, match=re.escape(str(d / "img_0000.jpg"))):
        tfmt.load_image_dir(str(tmp_path / "scene"), 4)


def test_read_image_on_png_and_jpeg_bytes_and_files(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (13, 21, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    assert np.array_equal(tfmt.read_image(buf.getvalue()), img)
    assert np.array_equal(tfmt.read_png(buf.getvalue()), img)
    (tmp_path / "x.png").write_bytes(buf.getvalue())
    assert np.array_equal(tfmt.read_image(str(tmp_path / "x.png")), img)
    data = _read("gray.jpg")
    from_file = tfmt.read_image(os.path.join(FIXTURES, "gray.jpg"))
    assert np.array_equal(tfmt.read_image(data), from_file)
    assert np.array_equal(from_file, jpeg.decode_jpeg(data))
    with pytest.raises(ValueError, match="<bytes>: not a PNG file"):
        tfmt.read_png(data)
