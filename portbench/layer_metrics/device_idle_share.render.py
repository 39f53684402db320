"""1 - the device's busy time per unit (the union of its kernel, copy and
set intervals in the traced units) over a unit's time in the untraced
units before them, in %. The profiler slows the host down, so the traced
window's own length would count its overhead as idle."""


def read(s):
    if s.busy_s == 0.0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.units / s.untraced_unit_s)
