"""K1 launches of the window, counted on the cards, per million paths."""

from cmr_bench.metrics._shared import k1_launches_per_mpath as read  # noqa: F401
