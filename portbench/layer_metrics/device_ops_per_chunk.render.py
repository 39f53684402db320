"""Device kernels, copies and sets per traced render chunk."""


def read(s):
    return s.device_ops / s.chunks if s.chunks else None
