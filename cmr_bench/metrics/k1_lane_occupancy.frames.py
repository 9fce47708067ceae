"""Live lanes at K1's launches over the lanes they covered, in %, from the
pass control's counters."""

from cmr_bench.metrics._program import k1_lane_occupancy as read  # noqa: F401
