"""K1's least time from its shapes over its device time, in %."""


def read(s):
    t = s.group_s["K1"]
    return 100.0 * s.work["k1_bound_s"] * s.units / t if t > 0 else None
