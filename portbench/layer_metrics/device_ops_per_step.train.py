"""Device kernels, copies and sets per traced step."""


def read(s):
    return s.device_ops / s.units
