"""What K1 and K2 read and write at the flagship widths (8x256 trunk, head
128): the tensor maps of their TMA copies and the weight-slice schedule
their producer warp walks (csrc/mlp_wide.cuh).

Everything a wide kernel addresses is described here, in Python, so that the
CPU tests can replay it (tests/test_torch_wide_layout.py): each map is a
`spec` of nine int64 fields, [buffer, element offset, dim0 (columns), dim1
(rows), dim2 (planes), row stride, plane stride, box columns, box rows],
over one of the buffers XSAVE (the saved input rows), ACT (saved
activations), G (cotangent workspace), W (forward weight pack, [K][N] per
layer) and WT (transposed pack, [N][K]); each slice is [spec, c0, c1, c2],
the coordinates of one box the producer loads into a ring stage. The C side
encodes each spec with cuTensorMapEncodeTiled (128-byte swizzle, zeros past
the dims) and checks that the schedule has exactly the slices its consumers
take.

K1 multiplies activation tiles by WT's K-major slices; K2 multiplies
cotangent tiles by W's, which is already the K-major operand of G W^T.

K3 and K4 at the object width (8x128 trunk, head 128; csrc/mlp_obj.cuh)
read only the forward pack. At that width every activation and cotangent
segment is [N][128], so one 3-D map covers all of them: plane o * P + seg
for object o and segment seg (trunk_0.., bottleneck, head_0..; P planes a
object, the cotangent workspace's per-object stride padded to whole
planes); and every 128-column layer of the pack starts on a whole row of
the pack seen as [rows][128], so one map with the object as its plane
covers every layer of every object. Their schedules are one object's
slices; the producer walks them once per object that the tile runs, adding
the object to the plane. K3 reads its weights MN-major: a slice is a
64-row block of W_l [K][128], two 64 x 64 boxes (c0 and c0 + 64).

K1 and K2 at 128 / 128 run the mask-free build of the same kernels (one
object, every tile) on K3's and K4's plans for N_obj = 1.
"""

from __future__ import annotations

import functools

from durf_tpu_torch.ops.kernels import build

WIDE_WIDTHS = (256, 128)  # (net_width, net_width_condition) of the wide kernels
BOX = 64  # columns of one swizzled box: 128 bytes of bf16
SLICE_BYTES = 32768  # one ring stage
MAX_MAPS, MAX_SLICES, MAX_JOBS, MAX_X_CHUNKS = 16, 64, 14, 2
OBJ_WIDTHS = (128, 128)  # (net_width, net_width_condition) of the object kernels
OBJ_SLICE_BYTES = 16384  # one ring stage of K3 and K4
OBJ_FWD_BOXES = 2  # boxes a K3 slice loads: c0 and c0 + 64
SPEC_FIELDS, SLICE_FIELDS = 9, 4
XSAVE, ACT, G, W, WT = range(5)
# Fixed map slots: K1 x_save, activations (trunk and bottleneck), head
# activations; K2 activations, head activations, cotangents (trunk and
# bottleneck), head cotangents. Weight maps follow.
F_XSAVE, F_ACT, F_ACT_HEAD = range(3)
B_ACT, B_ACT_HEAD, B_G, B_G_HEAD = range(4)
# K3's and K4's map slots.
O_XSAVE, O_ACT, O_W = range(3)
OB_ACT, OB_G, OB_W, OB_WX = range(4)


def is_wide(config) -> bool:
    """Whether K1 and K2 run the wgmma + TMA kernels for this MLP."""
    return (config.net_width, config.net_width_condition) == WIDE_WIDTHS


def x_chunks(in_dim: int) -> int:
    return -(-in_dim // BOX)


def spec(buf, offset, cols, rows, planes=1, box_rows=BOX, plane_stride=None) -> list:
    """One tensor map over `planes` matrices [rows][cols] (row-major, plane
    stride in elements), boxes of 64 columns x box_rows rows."""
    stride2 = rows * cols if plane_stride is None else plane_stride
    return [buf, offset, cols, rows, planes, cols, stride2, BOX, box_rows]


def _check(specs, slices) -> None:
    if len(specs) > MAX_MAPS or len(slices) > MAX_SLICES:
        raise ValueError(
            f"the wide MLP kernels take at most {MAX_MAPS} maps and {MAX_SLICES} slices; this MLP "
            f"needs {len(specs)} and {len(slices)}"
        )
    for s in specs:
        if s[7] * s[8] * 2 > SLICE_BYTES:
            raise ValueError(f"box {s[7]}x{s[8]} exceeds a ring stage")


def fwd_plan(config, in_dim: int, n: int, wt_offs, wtx_offs, act_offs):
    """K1's maps and slice schedule: (specs, slices) as lists of int lists.
    wt_offs / wtx_offs: the transposed pack's offsets (pack_weights_t);
    act_offs: the saved-activation segments (act_layout)."""
    from durf_tpu_torch.ops.kernels.fused_mlp import reads_x  # fused_mlp imports this module

    w, wc = config.net_width, config.net_width_condition
    d, dc = config.net_depth, config.net_depth_condition
    xc = x_chunks(in_dim)
    specs = [
        spec(XSAVE, 0, BOX * xc, n),
        spec(ACT, act_offs[0], w, n, d + 1),
        spec(ACT, act_offs[d + 1], wc, n, dc),
    ]
    slices = []

    def weights(offset, k, rows, planes=1):
        specs.append(spec(WT, offset, k, rows, planes, box_rows=rows))
        return len(specs) - 1

    for i in range(d):
        if i > 0:
            m = weights(wt_offs[i], w, w)
            slices += [[m, BOX * s, 0, 0] for s in range(w // BOX)]
        if reads_x(config, i):  # concat(h, x) @ k: the x rows' [J][64] chunks
            m = weights(wtx_offs[i], BOX, w, xc)
            slices += [[m, 0, 0, c] for c in range(xc)]
    m = weights(wt_offs[d + 1], w, w)  # bottleneck
    slices += [[m, BOX * s, 0, 0] for s in range(w // BOX)]
    m = weights(wt_offs[d + 2], w, wc)  # head_0's first `width` rows, transposed
    slices += [[m, BOX * s, 0, 0] for s in range(w // BOX)]
    for i in range(1, dc):
        m = weights(wt_offs[d + 2 + i], wc, wc)
        slices += [[m, BOX * s, 0, 0] for s in range(wc // BOX)]
    _check(specs, slices)
    return specs, slices


def bwd_plan(config, in_dim: int, n: int, w_offs, act_offs, g_offs, need_dx: bool):
    """K2's tile-kernel maps and slice schedule. w_offs: the forward pack's
    offsets (pack_weights); act_offs, g_offs: act_layout and g_layout, in
    which the trunk and bottleneck segments, and the head segments, follow
    each other at a fixed stride (one 3-D map each)."""
    from durf_tpu_torch.ops.kernels.fused_mlp import reads_x  # fused_mlp imports this module

    w, wc = config.net_width, config.net_width_condition
    d, dc = config.net_depth, config.net_depth_condition
    xc = x_chunks(in_dim)
    if g_offs[d + 1] != g_offs[0] + d * w * n or g_offs[d + 2 + dc - 1] != g_offs[d + 2] + (dc - 1) * wc * n:
        raise ValueError("the cotangent layout does not keep its segments at a fixed stride")
    specs = [
        spec(ACT, act_offs[0], w, n, d + 1),
        spec(ACT, act_offs[d + 1], wc, n, dc),
        spec(G, g_offs[0], w, n, d + 1),
        spec(G, g_offs[d + 2], wc, n, dc),
    ]
    slices = []

    def weights(offset, k, rows, box_rows=None):
        specs.append(spec(W, offset, k, rows, box_rows=box_rows or rows))
        return len(specs) - 1

    for i in range(dc - 1, 0, -1):  # head_i -> head_{i-1}: W_i [wc][wc]
        m = weights(w_offs[d + 2 + i], wc, wc)
        slices += [[m, BOX * s, 0, 0] for s in range(wc // BOX)]
    m = weights(w_offs[d + 2], wc, w)  # head_0 -> bottleneck: its first `width` rows
    slices += [[m, BOX * s, 0, 0] for s in range(wc // BOX)]
    m = weights(w_offs[d + 1], w, w)  # bottleneck -> trunk_{d-1}
    slices += [[m, BOX * s, 0, 0] for s in range(w // BOX)]
    for i in range(d - 1, -1, -1):
        if need_dx and reads_x(config, i):  # dx: the x rows of W_i, in 64-row chunks
            m = weights(w_offs[i] + (w * w if i > 0 else 0), w, in_dim, box_rows=BOX)
            slices += [[m, BOX * s, BOX * c, 0] for c in range(xc) for s in range(w // BOX)]
        if i > 0:
            m = weights(w_offs[i], w, w)
            slices += [[m, BOX * s, 0, 0] for s in range(w // BOX)]
    _check(specs, slices)
    return specs, slices


def is_obj(config) -> bool:
    """Whether the wgmma + TMA object kernels run this MLP: K3 and K4, and
    K1 and K2 in their mask-free build."""
    return (config.net_width, config.net_width_condition) == OBJ_WIDTHS


def obj_planes(config) -> tuple:
    """(activation planes, cotangent planes) of one object in K3's and K4's
    3-D maps: the [N][128] segments trunk_0.., bottleneck, head_0..; the
    cotangent workspace adds one plane for the 8-wide density and rgb rows."""
    segs = config.net_depth + 1 + config.net_depth_condition
    return segs, segs + 1


def obj_g_stride(config, n: int) -> int:
    """Per-object stride (elements) of K4's cotangent workspace: g_layout's
    segments, padded to whole [N][128] planes."""
    return obj_planes(config)[1] * config.net_width * n


def _obj_rows(config, w_offs, w_stride) -> list:
    """Each layer's first row in the forward pack seen as [rows][128]."""
    w = config.net_width
    if w_stride % w or any(o % w for o in w_offs):
        raise ValueError("the object kernels need every layer of the pack on a whole 128-wide row")
    return [o // w for o in w_offs]


def obj_fwd_plan(config, in_dim: int, n: int, n_obj: int, w_offs, w_stride: int, x_cols: int):
    """K3's maps and one object's slice schedule (c2 = 0; the producer adds
    the object). w_offs, w_stride: the forward pack (pack_weights);
    x_cols: the saved input rows' columns."""
    from durf_tpu_torch.ops.kernels.fused_mlp import reads_x  # fused_mlp imports this module

    w, d, dc = config.net_width, config.net_depth, config.net_depth_condition
    xc = x_chunks(in_dim)
    rows = _obj_rows(config, w_offs, w_stride)
    specs = [
        spec(XSAVE, 0, x_cols, n),
        spec(ACT, 0, w, n, n_obj * obj_planes(config)[0]),
        spec(W, 0, w, w_stride // w, n_obj, plane_stride=w_stride),
    ]
    blocks = lambda r, k: [[O_W, 0, r + BOX * s, 0] for s in range(k)]  # noqa: E731
    slices = []
    for i in range(d):
        if i > 0:
            slices += blocks(rows[i], w // BOX)
        if reads_x(config, i):  # the x rows of concat(h, x) @ k
            slices += blocks(rows[i] + (w if i > 0 else 0), xc)
    for l in range(d + 1, d + 2 + dc):  # bottleneck, head_0 (its first width rows), head_i
        slices += blocks(rows[l], w // BOX)
    _check(specs, slices)
    return specs, slices


def obj_bwd_plan(config, in_dim: int, n: int, n_obj: int, w_offs, w_stride: int, need_dx: bool):
    """K4's tile-kernel maps and one object's slice schedule (c2 = 0; the
    producer adds the object): W_l's K-major [128][64] boxes, and [64][64]
    boxes of the x rows for dx."""
    from durf_tpu_torch.ops.kernels.fused_mlp import reads_x  # fused_mlp imports this module

    w, d, dc = config.net_width, config.net_depth, config.net_depth_condition
    xc = x_chunks(in_dim)
    rows = _obj_rows(config, w_offs, w_stride)
    act_planes, g_planes = obj_planes(config)
    specs = [
        spec(ACT, 0, w, n, n_obj * act_planes),
        spec(G, 0, w, n, n_obj * g_planes),
        spec(W, 0, w, w_stride // w, n_obj, box_rows=w, plane_stride=w_stride),
        spec(W, 0, w, w_stride // w, n_obj, plane_stride=w_stride),
    ]
    cols = lambda m, r: [[m, BOX * s, r, 0] for s in range(w // BOX)]  # noqa: E731
    slices = []
    for l in range(d + 1 + dc, d, -1):  # head_i -> head_{i-1}, head_0 -> bottleneck, -> trunk
        slices += cols(OB_W, rows[l])
    for i in range(d - 1, -1, -1):
        if need_dx and reads_x(config, i):
            for c in range(xc):
                slices += cols(OB_WX, rows[i] + (w if i > 0 else 0) + BOX * c)
        if i > 0:
            slices += cols(OB_W, rows[i])
    _check(specs, slices)
    return specs, slices


@functools.lru_cache(maxsize=64)
def _c_obj_plan(kind: str, config, in_dim: int, n: int, n_obj: int, w_offs, w_stride, extra):
    if kind == "obj_fwd":
        specs, slices = obj_fwd_plan(config, in_dim, n, n_obj, w_offs, w_stride, extra)
    else:
        specs, slices = obj_bwd_plan(config, in_dim, n, n_obj, w_offs, w_stride, extra)
    flat = lambda rows: build.offsets([v for r in rows for v in r])  # noqa: E731
    return flat(specs), len(specs), flat(slices), len(slices)


def c_obj_plan(kind: str, config, in_dim: int, n: int, n_obj: int, w_offs, w_stride: int, extra):
    """K3's ("obj_fwd", extra = x_cols) or K4's ("obj_bwd", extra = need_dx)
    plan as the C entry points take it, built once per shape."""
    return _c_obj_plan(kind, Keyed(config), in_dim, n, n_obj, tuple(w_offs), w_stride, extra)


@functools.lru_cache(maxsize=64)
def _c_plan(kind: str, config, in_dim: int, n: int, offsets, need_dx: bool):
    if kind == "fwd":
        specs, slices = fwd_plan(config, in_dim, n, *offsets)
    else:
        specs, slices = bwd_plan(config, in_dim, n, *offsets, need_dx)
    flat = lambda rows: build.offsets([v for r in rows for v in r])  # noqa: E731
    return flat(specs), len(specs), flat(slices), len(slices)


def c_plan(kind: str, config, in_dim: int, n: int, offsets, need_dx: bool = True):
    """The plan as the C entry points take it (specs, n_specs, slices,
    n_slices), built once per shape. kind: "fwd" (offsets = (wt_offs,
    wtx_offs, act_offs)) or "bwd" ((w_offs, act_offs, g_offs))."""
    frozen = tuple(tuple(o) for o in offsets)
    return _c_plan(kind, Keyed(config), in_dim, n, frozen, need_dx)


def config_key(config) -> tuple:
    """The fields of an MLPConfig that shape a kernel's plan."""
    return (
        config.net_depth, config.net_width, config.net_depth_condition,
        config.net_width_condition, config.skip_layer, config.num_rgb_channels,
        config.num_density_channels,
    )


class Keyed:
    """A config as a cache key: hashed and compared by config_key."""

    def __init__(self, config):
        self.config = config
        self.key = config_key(config)

    def __getattr__(self, name):
        return getattr(self.config, name)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, Keyed) and self.key == other.key
