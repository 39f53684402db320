"""Device ms per traced step of every kernel, copy and set outside the
hand-written kernels K1-K6: the model's, ray ops' and losses' eager work."""


def read(s):
    return 1e3 * s.group_s["other"] / s.units
