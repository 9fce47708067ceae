"""The Renderer's ``accel_build`` phase (scene/ and accel/clusters.py),
host clock, in set-up."""


def read(rec):
    return rec.accel_build_s
