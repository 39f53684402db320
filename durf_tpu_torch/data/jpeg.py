"""JPEG decoding in numpy and the standard library.

`decode_jpeg(data, name)` returns what `np.asarray(PIL.Image.open(f))`
returns for the same file: uint8 [H, W, 3] for colour, [H, W] for gray,
computed as libjpeg(-turbo) computes it with its default settings:

  * Huffman-coded frames: baseline and extended sequential (SOF0, SOF1) and
    progressive (SOF2: spectral selection, successive approximation, EOB
    runs), 8-bit samples, 1 or 3 components with sampling factors h, v in
    {1, 2}; restart intervals (DRI / RSTn), byte stuffing and fill bytes;
    APPn and COM segments skipped;
  * the integer "islow" inverse DCT of jidctint.c, on every block at once;
  * "fancy" chroma upsampling (jdsample.c's h2v1, h1v2 and h2v2 triangle
    filters with their rounding biases);
  * jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16) with range limiting.

The colour space follows libjpeg's rule: a JFIF marker, or an Adobe APP14
marker with transform 1, means YCbCr; Adobe transform 0, or component ids
'R', 'G', 'B' without either marker, means RGB. No EXIF orientation is
applied, as `np.asarray(Image.open(...))` applies none.

Refused with a ValueError that names the file and the reason: arithmetic
coding (SOF9-11, SOF13-15), lossless (SOF3) and hierarchical frames,
12-bit samples, 2 or 4 components (CMYK, YCCK), sampling factors above 2,
progressive files whose scans leave one of the first ten coefficients
unrefined (libjpeg would smooth those blocks), and truncated or corrupt
data.

Huffman decoding is the one sequential part. It reads a 16-bit window of
the bit stream per symbol and looks the symbol, its extra bits and its
value up in one table entry (`_HuffmanTable`), in a plain Python loop.
"""

from __future__ import annotations

import struct
from array import array

import numpy as np

SOI, EOI, SOS, DHT, DQT, DRI = 0xD8, 0xD9, 0xDA, 0xC4, 0xDB, 0xDD
SOF_READ = {0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive"}
SOF_REFUSED = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded (SOF11)", 0xCC: "arithmetic-coded (DAC)",
    0xCD: "hierarchical arithmetic-coded (SOF13)", 0xCE: "hierarchical arithmetic-coded (SOF14)",
    0xCF: "hierarchical arithmetic-coded (SOF15)", 0xDE: "hierarchical (DHP)",
    0xDF: "hierarchical (EXP)", 0xDC: "DNL-sized",
}

# jpeg_natural_order: the zig-zag position k -> the row-major index of the
# 8x8 block, with 16 extra entries of 63 that absorb a corrupt run length
# as libjpeg's table does.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
_NATURAL = ZIGZAG.tolist() + [63] * 16
# libjpeg smooths a progressive image's blocks while one of its first ten
# coefficients is unrefined (jdcoefct.c SAVED_COEFS).
_SMOOTHED_COEFS = 10

# jidctint.c's constants: FIX(x) = round(x * 2^13).
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX_0_298631336, _FIX_0_390180644, _FIX_0_541196100 = 2446, 3196, 4433
_FIX_0_765366865, _FIX_0_899976223, _FIX_1_175875602 = 6270, 7373, 9633
_FIX_1_501321110, _FIX_1_847759065, _FIX_1_961570560 = 12299, 15137, 16069
_FIX_2_053119869, _FIX_2_562915447, _FIX_3_072711026 = 16819, 20995, 25172

# jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16).
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_CHROMA = np.arange(256, dtype=np.int64) - 128
_CR_R = ((_fix(1.40200) * _CHROMA + _ONE_HALF) >> _SCALEBITS).astype(np.int32)
_CB_B = ((_fix(1.77200) * _CHROMA + _ONE_HALF) >> _SCALEBITS).astype(np.int32)
_CR_G = (-_fix(0.71414) * _CHROMA).astype(np.int32)
_CB_G = (-_fix(0.34414) * _CHROMA + _ONE_HALF).astype(np.int32)


def _idct_range_limit(x: np.ndarray) -> np.ndarray:
    """jdmaster.c's post-IDCT table indexed by x & 1023, x the descaled
    sample before the +128 level shift: clamped within +-384, wrapped
    beyond, as libjpeg's table does."""
    i = x & 1023
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896)))


class _HuffmanTable:
    """A Huffman table as lookups over the next 16 bits of the stream.

    `fast[w]` packs, for a 16-bit window w whose code and extra bits fit in
    it, the bits they take (bits 0-4), the zig-zag advance (bits 5-11: run +
    1 for a coefficient, 16 for ZRL, 64 for EOB; 0 in DC tables) and the
    signed value (bits 12 up); 0 where they do not fit. `length[w]` and
    `symbol[w]` give the code alone (length 0: no code starts with w).
    """

    def __init__(self, counts, symbols, name: str, kind: str):
        length = np.zeros(1 << 16, np.int64)
        symbol = np.zeros(1 << 16, np.int64)
        code = k = 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                if code + 1 > 1 << bits:
                    raise ValueError(f"{name}: bad Huffman table (codes overflow {bits} bits)")
                lo, hi = code << (16 - bits), (code + 1) << (16 - bits)
                length[lo:hi] = bits
                symbol[lo:hi] = symbols[k]
                code += 1
                k += 1
            code <<= 1
        size = symbol & 15 if kind == "ac" else symbol
        run = symbol >> 4
        total = length + size
        fits = (length > 0) & (total <= 16) & (size <= 15)
        w = np.arange(1 << 16, dtype=np.int64)
        extra = (w >> np.clip(16 - total, 0, 16)) & ((1 << np.clip(size, 0, 15)) - 1)
        value = np.where(extra < (1 << np.maximum(size - 1, 0)), extra - (1 << size) + 1, extra)
        value = np.where(size == 0, 0, value)
        if kind == "ac":
            advance = np.where(size > 0, run + 1, np.where(run == 15, 16, 64))
        else:
            advance = np.zeros_like(run)
        self.fast = np.where(fits, total | (advance << 5) | (value << 12), 0).tolist()
        self.length = length.tolist()
        self.symbol = symbol.tolist()


def _extend(bits: int, size: int) -> int:
    """The signed value of `size` extra bits (HUFF_EXTEND)."""
    return bits - (1 << size) + 1 if size and bits < 1 << (size - 1) else bits


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


class _Bits:
    """One scan's entropy-coded data, unstuffed, its restart segments laid
    end to end: `win[i]` is the 32-bit big-endian word at byte i, `starts`
    the bit offset of each segment, `ends` where each one's data ends."""

    def __init__(self, segments):
        self.starts, self.ends, offset = [], [], 0
        for seg in segments:
            self.starts.append(offset * 8)
            offset += len(seg)
            self.ends.append(offset * 8)
        raw = np.frombuffer(b"".join(segments) + bytes(8), np.uint8).astype(np.int64)
        self.win = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8) | raw[3:]).tolist()


def _split_scan(data: bytes, pos: int, name: str):
    """The entropy-coded segments of the scan starting at `pos` (split at
    RSTn, unstuffed) and the offset of the marker that ends the scan."""
    segments, start, find = [], pos, data.find
    while True:
        i = find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError(f"{name}: truncated JPEG (the scan runs to the end of the file)")
        nxt = data[i + 1]
        if nxt == 0x00:
            pos = i + 2
            continue
        j = i + 1
        while j < len(data) and data[j] == 0xFF:  # fill bytes before a marker
            j += 1
        if j >= len(data):
            raise ValueError(f"{name}: truncated JPEG (fill bytes run to the end of the file)")
        segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= data[j] <= 0xD7:
            start = pos = j + 1
            continue
        return segments, j - 1


def _truncated(name, scan):
    return ValueError(f"{name}: truncated or corrupt entropy-coded data in scan {scan}")


def _decode_sequential(bits, coef, slots, n_mcu, restart, ncomp, name, scan):
    """Huffman-decode a sequential scan into `coef` (an int32 array of
    natural-order blocks). `slots` lists, for each block of an MCU in scan
    order, (block bases of every MCU, component index, DC table, AC table)."""
    win, natural = bits.win, _NATURAL
    pred = [0] * ncomp
    seg = 0
    pos = bits.starts[0]
    per_seg = restart if restart else n_mcu
    try:
        for m in range(n_mcu):
            if m and m % per_seg == 0:
                if pos > bits.ends[seg]:
                    raise _truncated(name, scan)
                seg += 1
                pos = bits.starts[seg]
                pred = [0] * ncomp
            for bases, ci, dct, act in slots:
                base = bases[m]
                # DC difference.
                e = dct.fast[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if e:
                    pos += e & 31
                    diff = e >> 12
                else:
                    pos, diff = _slow_symbol(win, pos, dct, name, scan, dc=True)
                pred[ci] += diff
                coef[base] = pred[ci]
                # AC run/size symbols until EOB or k = 63.
                fast = act.fast
                k = 1
                while k < 64:
                    e = fast[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        pos, e = _slow_symbol(win, pos, act, name, scan, dc=False)
                    else:
                        pos += e & 31
                    k += (e >> 5) & 127
                    v = e >> 12
                    if v:
                        coef[base + natural[k - 1]] = v
    except IndexError:
        raise _truncated(name, scan) from None
    if pos > bits.ends[seg] or seg != len(bits.starts) - 1:
        raise _truncated(name, scan)


def _slow_symbol(win, pos, table, name, scan, dc):
    """A symbol whose code and extra bits do not fit in 16 bits. Returns
    (new position, DC difference) or (new position, packed AC entry)."""
    w = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
    length = table.length[w]
    if not length:
        raise ValueError(f"{name}: corrupt Huffman code in scan {scan}")
    sym = table.symbol[w]
    pos += length
    size = sym if dc else sym & 15
    if size > 16:
        raise ValueError(f"{name}: corrupt Huffman symbol {sym} in scan {scan}")
    value = 0
    if size:
        value = _extend((win[pos >> 3] >> (32 - size - (pos & 7))) & ((1 << size) - 1), size)
        pos += size
    if dc:
        return pos, value
    run = sym >> 4
    advance = run + 1 if size else (16 if run == 15 else 64)
    return pos, (advance << 5) | (value << 12)


class _Reader:
    """A bit reader over `_Bits` for the progressive scans."""

    def __init__(self, bits):
        self.win, self.pos = bits.win, bits.starts[0]

    def get(self, n: int) -> int:
        if not n:
            return 0
        pos = self.pos
        value = (self.win[pos >> 3] >> (32 - n - (pos & 7))) & ((1 << n) - 1)
        self.pos = pos + n
        return value

    def symbol(self, table, name, scan) -> int:
        pos = self.pos
        w = (self.win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
        length = table.length[w]
        if not length:
            raise ValueError(f"{name}: corrupt Huffman code in scan {scan}")
        self.pos = pos + length
        return table.symbol[w]


def _decode_progressive(bits, coef, slots, n_units, restart, ncomp, ss, se, ah, al, name,
                        scan):
    """Huffman-decode one progressive scan (jdphuff.c): a DC first or
    refinement scan over MCUs, or an AC first or refinement scan over one
    component's blocks. `slots` as in `_decode_sequential`."""
    rd = _Reader(bits)
    natural = _NATURAL
    pred = [0] * ncomp
    eobrun = 0
    seg = 0
    per_seg = restart if restart else n_units
    p1, m1 = 1 << al, -1 << al
    try:
        for m in range(n_units):
            if m and m % per_seg == 0:
                if rd.pos > bits.ends[seg]:
                    raise _truncated(name, scan)
                seg += 1
                rd.pos = bits.starts[seg]
                pred = [0] * ncomp
                eobrun = 0
            for bases, ci, dct, act in slots:
                base = bases[m]
                if ss == 0:  # DC scans
                    if ah == 0:
                        size = rd.symbol(dct, name, scan)
                        if size > 16:
                            raise ValueError(f"{name}: corrupt DC symbol in scan {scan}")
                        pred[ci] += _extend(rd.get(size), size)
                        coef[base] = pred[ci] * p1
                    elif rd.get(1):
                        coef[base] |= p1
                    continue
                if ah == 0:  # AC first scan
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        rs = rd.symbol(act, name, scan)
                        r, size = rs >> 4, rs & 15
                        if size:
                            k += r
                            coef[base + natural[k]] = _extend(rd.get(size), size) * p1
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + rd.get(r) - 1
                            break
                        k += 1
                    continue
                # AC refinement scan.
                k = ss
                if not eobrun:
                    while k <= se:
                        rs = rd.symbol(act, name, scan)
                        r, size = rs >> 4, rs & 15
                        if size:
                            if size != 1:
                                raise ValueError(
                                    f"{name}: corrupt refinement symbol in scan {scan}")
                            size = p1 if rd.get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + rd.get(r)
                            break
                        while k <= se:
                            at = base + natural[k]
                            c = coef[at]
                            if c:
                                if rd.get(1) and not c & p1:
                                    coef[at] = c + p1 if c >= 0 else c + m1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if size:
                            coef[base + natural[k]] = size
                        k += 1
                if eobrun:
                    while k <= se:
                        at = base + natural[k]
                        c = coef[at]
                        if c and rd.get(1) and not c & p1:
                            coef[at] = c + p1 if c >= 0 else c + m1
                        k += 1
                    eobrun -= 1
    except IndexError:
        raise _truncated(name, scan) from None
    if rd.pos > bits.ends[seg] or seg != len(bits.starts) - 1:
        raise _truncated(name, scan)


def _idct_islow(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow on [N, 64] natural-order coefficients:
    uint8 [N, 8, 8] samples. Blocks whose AC coefficients are all zero take
    libjpeg's shortcut, which gives the same values."""
    n = len(blocks)
    out = np.empty((n, 8, 8), np.uint8)
    c = blocks.astype(np.int64) * quant.astype(np.int64)
    flat = ~c[:, 1:].any(axis=1)
    dc = _idct_range_limit(((c[flat, 0] << _PASS1_BITS) + 16) >> 5)
    out[flat] = dc.astype(np.uint8)[:, None, None]
    full = np.nonzero(~flat)[0]
    if len(full):
        c = c[full].reshape(-1, 8, 8)
        ws = _idct_1d(c.transpose(0, 2, 1), _CONST_BITS - _PASS1_BITS)  # columns
        res = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)  # rows
        out[full] = _idct_range_limit(res).astype(np.uint8)
    return out


def _idct_1d(x: np.ndarray, shift: int) -> np.ndarray:
    """One pass of jidctint.c over the last axis of x [..., 8]: returns
    DESCALE(..., shift) of the 8 outputs, also along the last axis."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    z1 = (x2 + x6) * _FIX_0_541196100
    tmp2 = z1 + x6 * -_FIX_1_847759065
    tmp3 = z1 + x2 * _FIX_0_765366865
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _FIX_1_175875602
    t0 = t0 * _FIX_0_298631336
    t1 = t1 * _FIX_2_053119869
    t2 = t2 * _FIX_3_072711026
    t3 = t3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    outs = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return (np.stack(outs, axis=-1) + half) >> shift


def _rows_around(plane: np.ndarray):
    """The rows above and below each row of `plane`, edge rows repeated."""
    above = np.concatenate([plane[:1], plane[:-1]], axis=0)
    below = np.concatenate([plane[1:], plane[-1:]], axis=0)
    return above, below


def _cols_around(plane: np.ndarray):
    left = np.concatenate([plane[:, :1], plane[:, :-1]], axis=1)
    right = np.concatenate([plane[:, 1:], plane[:, -1:]], axis=1)
    return left, right


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        a.shape[:axis] + (2 * a.shape[axis],) + a.shape[axis + 1:])


def _upsample(plane: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """jdsample.c's default upsampling of one component's [dh, dw] samples
    by (hx, vx) in {1, 2}: the triangle filters h2v1_fancy_upsample,
    h1v2_fancy_upsample and h2v2_fancy_upsample (h2 only when dw > 2, else
    replication, as jinit_upsampler chooses)."""
    p = plane.astype(np.int32)
    if hx == 1 and vx == 1:
        return plane
    if hx == 2 and p.shape[1] <= 2:
        up = np.repeat(p, 2, axis=1)
        return (np.repeat(up, 2, axis=0) if vx == 2 else up).astype(np.uint8)
    if hx == 1:  # h1v2
        above, below = _rows_around(p)
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2, 0).astype(np.uint8)
    if vx == 1:  # h2v1
        left, right = _cols_around(p)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1).astype(np.uint8)
    above, below = _rows_around(p)
    sums = _interleave(3 * p + above, 3 * p + below, 0)  # the column sums of each output row
    left, right = _cols_around(sums)
    return _interleave((3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4, 1).astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert: table lookups, then range limiting."""
    y = y.astype(np.int32)
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS), 0, 255)
    out[..., 2] = np.clip(y + _CB_B[cb], 0, 255)
    return out


def _segment(data: bytes, pos: int, name: str):
    """(payload, offset after it) of the length-prefixed segment at pos."""
    if pos + 2 > len(data):
        raise ValueError(f"{name}: truncated JPEG (a segment's length runs past the end)")
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    if length < 2 or pos + length > len(data):
        raise ValueError(f"{name}: truncated JPEG (a segment runs past the end of the file)")
    return data[pos + 2:pos + length], pos + length


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a JPEG file's bytes as uint8 [H, W, 3] (colour) or [H, W]
    (gray). Raises ValueError naming `name` for what it does not read."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos = 2
    quant, dc_tables, ac_tables = {}, {}, {}
    restart, comps, progressive = 0, None, False
    jfif, adobe = False, None
    coef = width = height = None
    scan = 0
    coef_bits = None
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"{name}: truncated or corrupt JPEG (no marker at byte {pos})")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == EOI:
            break
        if marker in SOF_REFUSED:
            raise ValueError(f"{name}: {SOF_REFUSED[marker]} JPEG (marker 0xFF{marker:02X}) "
                             "is not read; baseline, extended and progressive Huffman are")
        if marker == SOI:
            raise ValueError(f"{name}: a second SOI marker at byte {pos - 2}")
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue  # a stray RSTn or TEM carries no segment
        payload, pos = _segment(data, pos, name)
        if marker in SOF_READ:
            if comps is not None:
                raise ValueError(f"{name}: a second frame header (marker 0xFF{marker:02X})")
            progressive = marker == 0xC2
            precision, height, width, nf = struct.unpack(">BHHB", payload[:6])
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG (marker 0xFF{marker:02X}); "
                                 "only 8-bit samples are read")
            if height == 0 or width == 0:
                raise ValueError(f"{name}: JPEG of size {width}x{height} (DNL) is not read")
            if nf not in (1, 3):
                kind = "CMYK / YCCK" if nf == 4 else f"{nf}-component"
                raise ValueError(f"{name}: {kind} JPEG (marker 0xFF{marker:02X}) is not read; "
                                 "gray and 3-component colour are")
            if len(payload) < 6 + 3 * nf:
                raise ValueError(f"{name}: truncated frame header")
            comps = []
            for i in range(nf):
                cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if h not in (1, 2) or v not in (1, 2):
                    raise ValueError(f"{name}: sampling factors {h}x{v} (marker "
                                     f"0xFF{marker:02X}); only 1 and 2 are read")
                comps.append(_Component(cid, h, v, tq))
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            offset = 0
            for c in comps:
                c.width = -(-width * c.h // hmax)
                c.height = -(-height * c.v // vmax)
                c.bw, c.bh = mcux * c.h, mcuy * c.v  # blocks, padded to whole MCUs
                c.offset = offset
                offset += c.bw * c.bh * 64
            coef = array("i", bytes(4 * offset))
            coef_bits = [[-1] * 64 for _ in comps]
        elif marker == DHT:
            i = 0
            while i < len(payload):
                tc, th = payload[i] >> 4, payload[i] & 15
                counts = list(payload[i + 1:i + 17])
                n = sum(counts)
                symbols = list(payload[i + 17:i + 17 + n])
                if len(counts) != 16 or len(symbols) != n or tc > 1 or th > 3:
                    raise ValueError(f"{name}: corrupt Huffman table segment")
                table = _HuffmanTable(counts, symbols, name, "ac" if tc else "dc")
                (ac_tables if tc else dc_tables)[th] = table
                i += 17 + n
        elif marker == DQT:
            i = 0
            while i < len(payload):
                pq, tq = payload[i] >> 4, payload[i] & 15
                size = 128 if pq else 64
                raw = payload[i + 1:i + 1 + size]
                if len(raw) != size or tq > 3:
                    raise ValueError(f"{name}: corrupt quantization table segment")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int64)
                table = np.empty(64, np.int64)
                table[ZIGZAG] = vals
                quant[tq] = table
                i += 1 + size
        elif marker == DRI:
            (restart,) = struct.unpack(">H", payload[:2])
        elif marker == 0xE0 and payload[:5] == b"JFIF\0" and len(payload) >= 14:
            jfif = True
        elif marker == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe = payload[11]
        elif marker == SOS:
            if comps is None:
                raise ValueError(f"{name}: scan before the frame header")
            scan += 1
            ns = payload[0]
            by_id = {c.id: i for i, c in enumerate(comps)}
            members = []
            for i in range(ns):
                cid, tables = payload[1 + 2 * i:3 + 2 * i]
                if cid not in by_id:
                    raise ValueError(f"{name}: scan {scan} names unknown component {cid}")
                members.append((by_id[cid], tables >> 4, tables & 15))
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            segments, pos = _split_scan(data, pos, name)
            _decode_scan(comps, members, coef, coef_bits, _Bits(segments), dc_tables, ac_tables,
                         restart, progressive, ss, se, ah, al, width, height, name, scan)
        elif not (0xE0 <= marker <= 0xEF or marker == 0xFE):
            raise ValueError(f"{name}: unsupported JPEG marker 0xFF{marker:02X}")
    if comps is None or scan == 0:
        raise ValueError(f"{name}: JPEG without a frame or a scan")
    for ci, bits_of in enumerate(coef_bits):
        if any(b != 0 for b in bits_of[:_SMOOTHED_COEFS]):
            if not progressive:
                raise ValueError(f"{name}: component {comps[ci].id} has no scan")
            raise ValueError(f"{name}: the progressive scans leave component {comps[ci].id}'s "
                             "first coefficients unrefined (libjpeg would smooth its blocks)")
    return _samples(comps, coef, quant, width, height, jfif, adobe, name)


def _decode_scan(comps, members, coef, coef_bits, bits, dc_tables, ac_tables, restart,
                 progressive, ss, se, ah, al, width, height, name, scan):
    """Check one scan's header against the frame and decode its data."""
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    if progressive:
        if ss == 0 and se != 0 or ss > se or se > 63 or (ss and len(members) != 1):
            raise ValueError(f"{name}: bad progressive scan parameters in scan {scan}")
        if ah and ah - 1 != al or al > 13:
            raise ValueError(f"{name}: bad successive approximation in scan {scan}")
        for ci, _, _ in members:
            for k in range(ss, se + 1):
                expect = -1 if not ah else ah
                if coef_bits[ci][k] != expect:
                    raise ValueError(f"{name}: scan {scan} refines coefficient {k} out of order")
                coef_bits[ci][k] = al
    else:  # libjpeg only warns about other Ss, Se, Ah, Al and decodes all 64
        for ci, _, _ in members:
            coef_bits[ci] = [0] * 64
    if len(members) == 1:  # non-interleaved: the component's own blocks
        c = comps[members[0][0]]
        bw, bh = -(-c.width // 8), -(-c.height // 8)
        rows = np.arange(bh)[:, None] * c.bw + np.arange(bw)[None, :]
        layout = [(c, (c.offset + 64 * rows.reshape(-1)).tolist())]
        units = bw * bh
    else:
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
        layout = []
        for ci, _, _ in members:
            c = comps[ci]
            for v in range(c.v):
                for h in range(c.h):
                    block = (my * c.v + v) * c.bw + mx * c.h + h
                    layout.append((c, (c.offset + 64 * block.reshape(-1)).tolist()))
        units = mcux * mcuy
    tables = {ci: (td, ta) for ci, td, ta in members}
    slots = []
    for c, bases in layout:
        ci = comps.index(c)
        td, ta = tables[ci]
        need_dc = ss == 0 and ah == 0
        need_ac = se > 0 or not progressive
        if need_dc and td not in dc_tables or need_ac and ta not in ac_tables:
            raise ValueError(f"{name}: scan {scan} uses an undefined Huffman table")
        slots.append((bases, ci, dc_tables.get(td), ac_tables.get(ta)))
    nseg = -(-units // restart) if restart else 1
    if len(bits.starts) != nseg:
        raise _truncated(name, scan)
    if progressive:
        _decode_progressive(bits, coef, slots, units, restart, len(comps), ss, se, ah, al, name,
                            scan)
    else:
        _decode_sequential(bits, coef, slots, units, restart, len(comps), name, scan)


def _samples(comps, coef, quant, width, height, jfif, adobe, name):
    """Inverse DCT, upsampling and colour conversion of the decoded
    coefficients."""
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    flat = np.frombuffer(coef, np.int32)
    planes = []
    for c in comps:
        if c.tq not in quant:
            raise ValueError(f"{name}: component {c.id} uses undefined quantization table {c.tq}")
        blocks = flat[c.offset:c.offset + c.bw * c.bh * 64].reshape(-1, 64)
        pix = _idct_islow(blocks, quant[c.tq]).reshape(c.bh, c.bw, 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width]
        up = _upsample(plane, hmax // c.h, vmax // c.v)
        planes.append(up[:height, :width])
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0])
    ids = tuple(c.id for c in comps)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == (82, 71, 66)  # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)
