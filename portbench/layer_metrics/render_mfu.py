"""The forward MLP operations of a view's rays over a view's time in the
untraced units before the trace, at the chip's bf16 peak, in %."""

from portbench.work import PEAKS


def read(s):
    if s.busy_s == 0.0:
        return None
    return 100.0 * s.work["flops"] / (s.untraced_unit_s * PEAKS["bf16_flops"])
