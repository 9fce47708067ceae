"""Renders the window completed over its host-clock seconds."""


def read(rec):
    return len(rec.latencies_s) / rec.window_s
