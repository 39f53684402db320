#!/usr/bin/env python3
"""Write the JPEG fixtures of tests/data/jpeg/ and PIL's decodes of them.

    python3 scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

PIL (with its bundled libjpeg-turbo) encodes small images in every kind the
port's decoder (durf_tpu_torch/data/jpeg.py) reads: 4:2:0 at quality 75 and
95, 4:2:2, 4:4:4, gray, a restart interval, progressive, optimized Huffman
tables, RGB without a colour transform (keep_rgb) and a 4:4:0 file (a 4:2:2
file whose luma sampling factors and size are swapped: the same entropy-coded
blocks, laid out as 8x16 MCUs). The odd sizes leave every MCU edge partial.
One 1920x1280 4:2:0 image at quality 90, Waymo's camera size, is a
synthetic-scene render upscaled.

PIL's decodes go into `pil_decodes.npz` beside them: the array of each small
fixture under its file name, and for the large one the sha256 of the decoded
bytes under `<name>.sha256`. The card's machine has no PIL, so these are its
yardstick (chip_smoke.py's tools phase).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import os
import sys

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from durf_tpu_torch.data import synthetic  # noqa: E402

LARGE = "waymo_1920x1280_q90_420.jpg"


def texture(width: int, height: int, seed: int, channels: int = 3) -> np.ndarray:
    """Smooth colour ramps, a checker and noise: edges, gradients and
    chroma detail for every upsampling filter."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    ramps = np.stack([x / width, y / height, (x + y) / (width + height)], -1)
    checker = ((x // 5 + y // 4) % 2)[..., None] * np.array([0.3, -0.2, 0.25])
    img = 255 * np.clip(ramps + checker + rng.normal(0, 0.06, ramps.shape), 0, 1)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def jpeg_bytes(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def as_440(data: bytes, width: int, height: int) -> bytes:
    """A 4:2:2 baseline file's luma sampling 2x1 rewritten to 1x2 and its
    size to (width, height): the same 4-block MCUs read as 8x16 pixels."""
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[sof + 5:sof + 9] = height.to_bytes(2, "big") + width.to_bytes(2, "big")
    assert out[sof + 11] == 0x21, "luma is not 2x1"
    out[sof + 11] = 0x12
    return bytes(out)


def small_fixtures():
    """(file name, JPEG bytes) of every small fixture."""
    rgb = texture(37, 23, 0)
    yield "q75_420.jpg", jpeg_bytes(rgb, quality=75, subsampling=2)
    yield "q95_420.jpg", jpeg_bytes(texture(41, 29, 1), quality=95, subsampling=2)
    yield "q85_422.jpg", jpeg_bytes(texture(45, 27, 2), quality=85, subsampling=1)
    yield "q85_444.jpg", jpeg_bytes(rgb, quality=85, subsampling=0)
    yield "gray.jpg", jpeg_bytes(texture(37, 23, 3, channels=1), quality=85)
    yield "restart_420.jpg", jpeg_bytes(texture(53, 35, 4), quality=85, subsampling=2,
                                        restart_marker_blocks=3)
    yield "progressive_420.jpg", jpeg_bytes(texture(43, 31, 5), quality=85, subsampling=2,
                                            progressive=True)
    yield "progressive_gray.jpg", jpeg_bytes(texture(29, 19, 6, channels=1), quality=90,
                                             progressive=True)
    yield "optimize_420.jpg", jpeg_bytes(texture(39, 25, 7), quality=80, subsampling=2,
                                         optimize=True)
    yield "rgb_444.jpg", jpeg_bytes(texture(33, 21, 8), quality=90, keep_rgb=True)
    # 47x23 at 4:2:2 is 3x3 MCUs of 16x8 pixels, read as 23x47 at 4:4:0:
    # 3x3 MCUs of 8x16.
    yield "q85_440.jpg", as_440(jpeg_bytes(texture(47, 23, 9), quality=85, subsampling=1),
                                23, 47)


def large_fixture() -> bytes:
    """A synthetic-scene render at 480x320 upscaled to 1920x1280, 4:2:0 at
    quality 90."""
    boxes = []
    for obj in range(2):
        center, yaw = synthetic.box_trajectory(obj, 0, 5)
        ext, color = synthetic.box_spec(obj)
        boxes.append((center, yaw, ext, obj + 1, color))
    rgb, _, _, _ = synthetic._render(synthetic.camera_pose(0, 0), 480, 320, 420.0, boxes)
    img = Image.fromarray((rgb * 255).astype(np.uint8)).resize((1920, 1280), Image.LANCZOS)
    return jpeg_bytes(np.asarray(img), quality=90, subsampling=2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=os.path.join(REPO, "tests", "data", "jpeg"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    decodes = {}
    for name, data in list(small_fixtures()) + [(LARGE, large_fixture())]:
        with open(os.path.join(args.out, name), "wb") as fh:
            fh.write(data)
        decoded = np.asarray(Image.open(io.BytesIO(data)))
        if name == LARGE:
            decodes[name + ".sha256"] = np.array(hashlib.sha256(decoded.tobytes()).hexdigest())
        else:
            decodes[name] = decoded
        print(f"{name}: {len(data)} bytes, decoded {decoded.shape}")
    np.savez_compressed(os.path.join(args.out, "pil_decodes.npz"), **decodes)
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"{args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
