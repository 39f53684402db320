"""K2's least time from its shapes (operations at the bf16 peak or bytes
at the memory peak, per launch) over its device time, all four launches, in
%."""


def read(s):
    t = s.group_s["K2"]
    return 100.0 * s.work["k2_bound_s"] * s.units / t if t > 0 else None
