"""Super boxes K1's walks entered per bounce over the window's K1 sites,
from the pass control's counters."""

from cmr_bench.metrics._walk import k1_supers_per_bounce as read  # noqa: F401
