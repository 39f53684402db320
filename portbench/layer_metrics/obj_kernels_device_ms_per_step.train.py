"""K3 + K4 device ms per traced step."""


def read(s):
    ms = 1e3 * (s.group_s["K3"] + s.group_s["K4"]) / s.units
    return ms if ms > 0 else None
