"""The numbers that decide `correct`, each compared with its limit.

Training: the program's readings (each step's loss, the per-leaf norm of
the first gradient as Adam got it, the per-leaf norm of the parameters'
change after three steps) against the reference's: the worst step's loss,
and the worst and the median leaf of the gradient and of the change. A
leaf's gap is the gap between the two norms over the larger of the
reference leaf's norm and the median leaf's; leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out. A cell compares the numbers its limits name.
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


def train_numbers(prog: dict, ref: dict) -> dict:
    """{number: value} of training readings {'loss': [3], 'grad': {leaf:
    norm}, 'change': {leaf: norm}}."""
    moving = sorted(moving_leaves(ref["grad"]))
    grad = leaf_gaps(prog["grad"], ref["grad"], moving)
    change = leaf_gaps(prog["change"], ref["change"], moving)
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(grad.values()),
        "grad_median_gap": statistics.median(grad.values()),
        "change_gap": max(change.values()),
        "change_median_gap": statistics.median(change.values()),
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
