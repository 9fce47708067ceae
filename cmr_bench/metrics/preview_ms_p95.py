"""The 95th percentile of every render's latency in the window, call to
returned image, in ms (linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec.latencies_s), 95)) * 1e3
