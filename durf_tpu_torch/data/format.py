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
interlaced) raises a ValueError that names the file. The apps' other
outputs are written the same way: float32 depth as TIFF
(`write_tiff_float32`) and trajectories as animated GIF (`write_gif`).
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


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A float image in [0, 1] (clipped) as uint8, 255 * x truncated."""
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


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


# Baseline TIFF field types.
_TIFF_SHORT, _TIFF_LONG = 3, 4


def write_tiff_float32(filename: str, array: np.ndarray) -> None:
    """Write an [H, W] array as a little-endian baseline TIFF of float32
    samples: one strip, uncompressed, BitsPerSample 32, SampleFormat 3
    (IEEE float), PhotometricInterpretation 1 (black is zero). PIL opens it
    in mode "F", as it opens the TIFF it writes for a float32 image."""
    data = np.ascontiguousarray(array, dtype="<f4")
    if data.ndim != 2:
        raise ValueError(f"{filename}: write_tiff_float32 takes [H, W], got {data.shape}")
    height, width = data.shape
    pixels = data.tobytes()
    ifd_offset = 8 + len(pixels) + (len(pixels) & 1)  # the IFD starts on a word
    entries = [  # (tag, type, value), ascending tags
        (256, _TIFF_LONG, width),  # ImageWidth
        (257, _TIFF_LONG, height),  # ImageLength
        (258, _TIFF_SHORT, 32),  # BitsPerSample
        (259, _TIFF_SHORT, 1),  # Compression: none
        (262, _TIFF_SHORT, 1),  # PhotometricInterpretation: BlackIsZero
        (273, _TIFF_LONG, 8),  # StripOffsets
        (277, _TIFF_SHORT, 1),  # SamplesPerPixel
        (278, _TIFF_LONG, height),  # RowsPerStrip
        (279, _TIFF_LONG, len(pixels)),  # StripByteCounts
        (339, _TIFF_SHORT, 3),  # SampleFormat: IEEE float
    ]
    ifd = struct.pack("<H", len(entries))
    for tag, kind, value in entries:
        packed = struct.pack("<HH", value, 0) if kind == _TIFF_SHORT else struct.pack("<I", value)
        ifd += struct.pack("<HHI", tag, kind, 1) + packed
    ifd += struct.pack("<I", 0)  # no next IFD
    with open(filename, "wb") as fh:
        fh.write(struct.pack("<2sHI", b"II", 42, ifd_offset) + pixels
                 + b"\0" * (len(pixels) & 1) + ifd)


# GIF: a fixed 6 x 7 x 6 colour cube (252 colours; the 7 green levels
# because the eye tells greens apart best), so every channel lies within
# half a level step of its colour: 255 / 5 / 2 = 25.5 for red and blue,
# 255 / 6 / 2 = 21.25 for green.
GIF_LEVELS = (6, 7, 6)
GIF_HALF_STEP = tuple(255.0 / (n - 1) / 2 for n in GIF_LEVELS)
_GIF_MIN_CODE = 8  # 8-bit pixel indices
_GIF_MAX_CODES = 4096  # 12-bit codes


def _gif_palette() -> np.ndarray:
    """[256, 3] uint8: the cube's 252 colours, red slowest, then 4 black."""
    axes = [np.round(np.arange(n) * 255.0 / (n - 1)) for n in GIF_LEVELS]
    cube = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([cube, np.zeros((256 - len(cube), 3))]).astype(np.uint8)


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    """Palette index of each pixel of a uint8 [H, W, 3] frame: each channel
    rounded to its nearest level."""
    levels = np.asarray(GIF_LEVELS)
    q = np.rint(frame.astype(np.float64) * (levels - 1) / 255.0).astype(np.int64)
    return ((q[..., 0] * levels[1] + q[..., 1]) * levels[2] + q[..., 2]).astype(np.uint8)


def _gif_lzw(indices: np.ndarray) -> bytes:
    """GIF's LZW: variable-width codes from 9 to 12 bits, a clear code first
    and whenever the table is full, the end code last; packed LSB first."""
    clear, end = 1 << _GIF_MIN_CODE, (1 << _GIF_MIN_CODE) + 1
    codes, widths = [clear], [_GIF_MIN_CODE + 1]
    table, next_code, width = {}, end + 1, _GIF_MIN_CODE + 1
    pixels = indices.reshape(-1).tolist()
    prefix = pixels[0]
    for c in pixels[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < _GIF_MAX_CODES:
            table[key] = next_code
            next_code += 1
            # The decoder adds each entry one code later, so a code is
            # widened once the entry after it no longer fits.
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            codes.append(clear)
            widths.append(width)
            table, next_code, width = {}, end + 1, _GIF_MIN_CODE + 1
        prefix = c
    codes.append(prefix)
    widths.append(width)
    if next_code < _GIF_MAX_CODES and next_code + 1 > (1 << width) and width < 12:
        width += 1  # the decoder's entry for the last code
    codes.append(end)
    widths.append(width)
    codes_a, widths_a = np.asarray(codes, np.int64), np.asarray(widths, np.int64)
    starts = np.cumsum(widths_a) - widths_a
    bits = np.zeros(int(widths_a.sum()), np.uint8)
    for b in range(12):
        sel = widths_a > b
        bits[starts[sel] + b] = (codes_a[sel] >> b) & 1
    return np.packbits(bits, bitorder="little").tobytes()


def write_gif(filename: str, frames, duration_ms: int = 80, loop: int = 0) -> None:
    """Write uint8 [H, W, 3] frames as an animated GIF89a: one global
    palette, the fixed 6 x 7 x 6 colour cube of `_gif_palette` (each
    channel within GIF_HALF_STEP of the frame's), `duration_ms` per frame
    (GIF counts in 1/100 s), the NETSCAPE2.0 block repeating the animation
    `loop` times (0: forever), the pixels LZW-coded by `_gif_lzw`."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError(f"{filename}: write_gif needs at least one frame")
    height, width = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (height, width, 3):
            raise ValueError(f"{filename}: write_gif takes uint8 [H, W, 3] frames of one size, "
                             f"got {f.dtype} {f.shape}")
    out = [b"GIF89a", struct.pack("<HHBBB", width, height, 0xF7, 0, 0),
           _gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0" + struct.pack("<BBHB", 3, 1, loop, 0)]
    for f in frames:
        data = _gif_lzw(_gif_indices(f))
        blocks = b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255]
                          for i in range(0, len(data), 255))
        out += [b"\x21\xf9\x04" + struct.pack("<BHBB", 0, round(duration_ms / 10), 0, 0),
                b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 0),
                bytes([_GIF_MIN_CODE]) + blocks + b"\x00"]
    out.append(b"\x3b")
    with open(filename, "wb") as fh:
        fh.write(b"".join(out))


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
        write_png(path.join(data_dir, f"images_{factor}", f"img_{i:04d}.png"), to_uint8(img))
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
