"""Card ms of K1's segments inside the graphs, summed over the cards, per
million paths, from the pass control's counters."""

from cmr_bench.metrics._program import k1_ms_per_mpath as read  # noqa: F401
