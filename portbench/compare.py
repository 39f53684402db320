"""The numbers that decide `correct`, each compared with its limit.

Training: the program's readings (each step's loss, the per-leaf norm of
the first gradient as Adam got it, the per-leaf norm of the parameters'
change after three steps) against the reference's: the worst step's loss,
and the worst and the median leaf of the gradient and of the change. A
leaf's gap is the gap between the two norms over the larger of the
reference leaf's norm and the median leaf's; leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out. Where the configuration trains the box poses,
the pose table is also compared as a vector over the rows (timesteps) the
check steps drew, as the norm of the difference over the reference's norm:
its first gradient as Adam got it, and its change over the entries that
moved by their gradient (pose_moving). A cell compares the numbers its
limits name.
Rendering: the largest absolute gap of a pixel's rgb and acc on the views
compared (and of its depth over the reference's depth range, a reading the
control does not separate from the program's: reported, not compared).
"""

from __future__ import annotations

import statistics


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: gap} of two {leaf: norm} maps: the gap of the norms over the
    larger of the reference leaf's norm and the median leaf's."""
    floor = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in leaves}


def moving_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    floor = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= 1e-3 * floor]


# Adam's first update of an entry is about lr times the sign of its
# gradient, whatever the gradient's size, so an entry whose gradient is
# within round-off of 0 steps a full lr either way on either side. The
# pose change is compared over the entries whose reference gradient, at
# the first check step that drew their row, is at least this share of
# that row's largest.
POSE_MOVING = 1e-2


def pose_moving(first_grad, rows):
    """The mask, over the rows `rows` of the pose table, of the entries
    whose gradient `first_grad` (each row's at the first step that drew
    it) is at least POSE_MOVING of its row's largest."""
    g = first_grad[sorted(set(rows))].abs()
    top = g.flatten(1).max(1).values.view(-1, *[1] * (g.dim() - 1))
    return g >= POSE_MOVING * top


def vector_gap(prog, ref, rows, keep=None) -> float:
    """||prog - ref|| / ||ref|| over the leading-axis rows `rows` of two
    tensors (and of those rows' entries `keep`)."""
    idx = sorted(set(rows))
    a, b = prog[idx].double(), ref[idx].double()
    if keep is not None:
        a, b = a[keep], b[keep]
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def train_numbers(prog: dict, ref: dict) -> dict:
    """{number: value} of training readings {'loss': [3], 'grad': {leaf:
    norm}, 'change': {leaf: norm}}, with the pose vectors ('pose_grad',
    'pose_change', and the reference's 'pose_rows' and 'pose_first_grad')
    where the reference has them."""
    moving = sorted(moving_leaves(ref["grad"]))
    grad = leaf_gaps(prog["grad"], ref["grad"], moving)
    change = leaf_gaps(prog["change"], ref["change"], moving)
    pose = {}
    if "pose_rows" in ref:
        rows = ref["pose_rows"]
        pose = {"pose_grad_gap": vector_gap(prog["pose_grad"], ref["pose_grad"], rows),
                "pose_change_gap": vector_gap(prog["pose_change"], ref["pose_change"], rows,
                                              pose_moving(ref["pose_first_grad"], rows))}
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(grad.values()),
        "grad_median_gap": statistics.median(grad.values()),
        "change_gap": max(change.values()),
        "change_median_gap": statistics.median(change.values()),
        **pose,
        "_leaves": {"grad": max(grad, key=grad.get), "change": max(change, key=change.get),
                    "moving": len(moving), "all": len(ref["grad"])},
    }


def render_numbers(prog: dict, ref: dict) -> dict:
    """{number: value} of {'rgb', 'depth', 'acc'} tensors of the compared
    views on both sides."""
    depth_scale = float(ref["depth"].abs().max().clamp(min=1e-6))
    return {
        "rgb_gap": float((prog["rgb"] - ref["rgb"]).abs().max()),
        "acc_gap": float((prog["acc"] - ref["acc"]).abs().max()),
        "depth_gap": float((prog["depth"] - ref["depth"]).abs().max()) / depth_scale,
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number at most its limit; checks maps each
    number to {'value', 'limit'}."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
