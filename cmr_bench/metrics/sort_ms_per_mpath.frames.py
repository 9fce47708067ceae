"""Card ms of the pass plan's sort segments, summed over the cards, per
million paths, from the pass control's counters."""

from cmr_bench.metrics._program import sort_ms_per_mpath as read  # noqa: F401
