"""Paths (pixels x samples) of every render the window completed, in
millions, over the window's host-clock seconds: a stall anywhere shows."""


def read(rec):
    return rec.paths / rec.window_s / 1e6
