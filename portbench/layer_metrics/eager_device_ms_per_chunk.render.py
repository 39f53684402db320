"""Device ms per traced render chunk outside the hand-written kernels."""


def read(s):
    return 1e3 * s.group_s["other"] / s.chunks if s.chunks else None
