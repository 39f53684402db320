"""The MLP operations a step's batch needs (forward and backward: the field
MLPs on every sample, each object MLP on the samples of the rays hitting
its box; K2's recompute and the eager ops left out) over a step's time in
the untraced steps before the trace, at the chip's bf16 peak, in %."""

from portbench.work import PEAKS


def read(s):
    if s.busy_s == 0.0:
        return None
    return 100.0 * s.work["flops"] / (s.untraced_unit_s * PEAKS["bf16_flops"])
