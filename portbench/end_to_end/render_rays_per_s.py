"""Rays of the full views completed over the whole window, on the host
clock."""


def read(win):
    return win.units * win.rays_per_unit / win.window_s
