"""Rays trained over the whole window: every step's batch, from one
synchronize before the window to one after it, on the host clock."""


def read(win):
    return win.units * win.rays_per_unit / win.window_s
