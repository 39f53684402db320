"""The 95th percentile of every step of the window, each step timed by the
CUDA events recorded at its boundaries on the step's stream."""

from portbench.stats import percentile


def read(win):
    return percentile(win.unit_ms, 95)
