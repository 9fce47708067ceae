"""From the harness's first statement to the window's start: imports,
scene load, the cluster build and upload, the warm-up's captures (and, in
a checkout's first run, the kernel builds)."""


def read(rec):
    return rec.setup_s
