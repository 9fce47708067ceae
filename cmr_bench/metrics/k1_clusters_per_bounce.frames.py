"""Clusters K1's walks tested per bounce over the window's K1 sites, from
the pass control's counters."""

from cmr_bench.metrics._walk import k1_clusters_per_bounce as read  # noqa: F401
