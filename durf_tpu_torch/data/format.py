"""On-disk scene-directory format: readers, writers and a PNG codec (numpy).

A scene directory holds:
  images_{factor}/          RGB PNG images at each downsample factor
  poses_bounds.npy          [N, 17] (3x5 [R|t|hwf] flattened + near/far) or
                            [N, 19] with the principal point (cx, cy) appended
  3D_boxes.npy              dict: "{ts}_{obj}_center" (4x4), "{ts}_{obj}_ext" (3,)
  depth_images.npz          arr_0: per-image [H, W] metric depth (0 = no return)
  sky_masks.npz             arr_0: per-image [H, W] binary sky masks
  2D_boxes.npz              arr_0: per-image [H, W] integer instance-id masks

Images are read and written by `read_png` / `write_png`, built on the
standard library's zlib and numpy: the port needs no imaging package. The
reader takes what PIL writes (8-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, every row filter); anything else (JPEG, 16-bit, palette,
interlaced) raises a ValueError that names the file.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from os import path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (gray, RGB, gray+alpha, RGBA); 3 (palette) is refused.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def natsorted(names):
    """Natural sort ('img2' < 'img10')."""

    def key(s):
        return [int(tok) if tok.isdigit() else tok.lower() for tok in re.split(r"(\d+)", s)]

    return sorted(names, key=key)


def _chunks(data: bytes, name: str):
    """(type, payload) of every chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        payload = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + payload):
            raise ValueError(f"{name}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG without an IEND chunk")


def _unfilter(rows: np.ndarray, height: int, width: int, channels: int, name: str) -> np.ndarray:
    """Undo the per-row filters of 8-bit scanlines [H, 1 + W * C].

    Average and Paeth predict a byte from the reconstructed bytes to its
    left, above and above-left, so a row cannot be undone in one vector
    operation. Every pixel of an anti-diagonal r + x = d depends only on
    diagonals d - 1 and d - 2, so the image is undone one anti-diagonal at a
    time (H + W - 1 steps), all five filters at once, each row by its own.
    """
    filters = rows[:, 0].astype(np.int32)
    if filters.max(initial=0) > 4:
        raise ValueError(f"{name}: unknown PNG row filter {int(filters.max())}")
    raw = rows[:, 1:].reshape(height, width, channels).astype(np.int32)
    if not filters.any():
        return raw.astype(np.uint8)
    # Reconstructed bytes with a zero row above and a zero column to the left.
    rec = np.zeros((height + 1, width + 1, channels), np.int32)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        x = d - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filters[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(filename: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced PNG as uint8: [H, W] for gray, else
    [H, W, C] (C = 2 gray+alpha, 3 RGB, 4 RGBA), as `np.asarray` of the image
    opened by PIL gives it. Raises ValueError naming the file for anything
    else: not a PNG (a JPEG, say), another bit depth, a palette, interlacing."""
    with open(filename, "rb") as fh:
        data = fh.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{filename}: not a PNG file (the port reads PNG images only)")
    header, idat = None, []
    for ctype, payload in _chunks(data, filename):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{filename}: PNG without an IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if depth != 8:
        raise ValueError(f"{filename}: {depth}-bit PNG; only 8-bit images are read")
    if color not in _CHANNELS:
        raise ValueError(f"{filename}: PNG color type {color} (palette) is not read")
    if interlace != 0:
        raise ValueError(f"{filename}: interlaced PNG is not read")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{filename}: unknown PNG compression or filter method")
    channels = _CHANNELS[color]
    stride = 1 + width * channels
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{filename}: corrupt PNG image data ({e})") from e
    if flat.size < height * stride:
        raise ValueError(f"{filename}: PNG image data too short")
    img = _unfilter(flat[: height * stride].reshape(height, stride), height, width, channels,
                    filename)
    return img[..., 0] if channels == 1 else img


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(filename: str, image: np.ndarray) -> None:
    """Write a uint8 image ([H, W] gray, or [H, W, C] with C in 1-4) as an
    8-bit PNG, every row with filter 0 (none)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"{filename}: write_png takes uint8 images, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"{filename}: write_png takes [H, W] or [H, W, 1-4], got {image.shape}")
    height, width, channels = image.shape
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), image.reshape(height, width * channels)], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE[channels], 0, 0, 0)
    with open(filename, "wb") as fh:
        fh.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def load_image_dir(data_dir: str, factor: int = 0):
    """Load images_{factor}/ as a list of [H, W, 3] float32 arrays in [0, 1].

    Alpha channels are dropped; gray images are repeated into three
    channels. Files ending in jpg / jpeg are listed as the reference lists
    them, and refused by read_png.
    """
    suffix = f"_{factor}" if factor > 0 else ""
    imgdir = path.join(data_dir, "images" + suffix)
    if not path.exists(imgdir):
        raise FileNotFoundError(f"image folder {imgdir} does not exist")
    files = [
        path.join(imgdir, f)
        for f in natsorted(os.listdir(imgdir))
        if f.lower().endswith(("jpg", "jpeg", "png"))
    ]
    images = []
    for f in files:
        img = read_png(f)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        images.append(img.astype(np.float32)[..., :3] / 255.0)
    return images


def load_poses_bounds(data_dir: str):
    """Load poses_bounds.npy.

    Returns:
      (poses [N, 3, 5], bounds [N, 2], principal_points [N, 2] or None).
      17 columns = CARLA layout (obbpose_dataset.py:399-406); 19 columns
      appends the principal point (Waymo, obbpose_dataset.py:1659-1664).
    """
    arr = np.load(path.join(data_dir, "poses_bounds.npy"))
    if arr.shape[-1] == 17:
        pp = None
    elif arr.shape[-1] == 19:
        pp = arr[:, 17:].astype(np.float32)
    else:
        raise ValueError(f"poses_bounds.npy must have 17 or 19 cols, got {arr.shape}")
    poses = arr[:, :15].reshape([-1, 3, 5]).astype(np.float32)
    bounds = arr[:, 15:17].astype(np.float32)
    return poses, bounds, pp


def load_boxes_3d(data_dir: str) -> dict:
    """Load the 3D_boxes.npy dict of per-timestep box poses and extents."""
    return np.load(path.join(data_dir, "3D_boxes.npy"), allow_pickle=True).item()


def load_npz_stack(data_dir: str, name: str):
    """Load an arr_0-keyed npz of per-image arrays as a list."""
    data = np.load(path.join(data_dir, name), allow_pickle=True)["arr_0"]
    return [np.asarray(x) for x in data]


def save_scene(
    data_dir: str,
    images: list,
    poses_hwf: np.ndarray,
    bounds: np.ndarray,
    boxes_3d: dict,
    depths: list,
    sky_masks: list,
    masks_2d: list,
    factor: int = 4,
    principal_points: np.ndarray | None = None,
    base_factor: int | None = None,
):
    """Write a complete scene directory in the reference on-disk format.

    Per-factor npz files for non-base pyramid levels get a _{factor} suffix
    (the c2f contract, reference c2f_obb_dataset.py:628-653).
    """
    base_factor = factor if base_factor is None else base_factor
    suffix = "" if factor == base_factor else f"_{factor}"
    os.makedirs(path.join(data_dir, f"images_{factor}"), exist_ok=True)
    for i, img in enumerate(images):
        write_png(
            path.join(data_dir, f"images_{factor}", f"img_{i:04d}.png"),
            (np.clip(img, 0, 1) * 255).astype(np.uint8),
        )
    flat = poses_hwf.reshape([len(images), 15])
    cols = [flat, bounds.reshape(len(images), 2)]
    if principal_points is not None:
        cols.append(principal_points.reshape(len(images), 2))
    np.save(path.join(data_dir, "poses_bounds.npy"), np.concatenate(cols, axis=-1))
    np.save(path.join(data_dir, "3D_boxes.npy"), boxes_3d, allow_pickle=True)

    def to_array(lst):
        # Stack when all images share a resolution, else a ragged object array
        # (the CARLA 5-camera rig mixes resolutions).
        if len({x.shape for x in lst}) == 1:
            return np.stack(lst)
        arr = np.empty(len(lst), dtype=object)
        for i, x in enumerate(lst):
            arr[i] = x
        return arr

    np.savez(path.join(data_dir, f"depth_images{suffix}.npz"), to_array(depths))
    np.savez(path.join(data_dir, f"sky_masks{suffix}.npz"), to_array(sky_masks))
    if not suffix:  # instance masks exist only at the base factor
        np.savez(path.join(data_dir, "2D_boxes.npz"), to_array(masks_2d))
