"""Each card's wait for its band's slowest card, in % (parallel/sharding.py)."""

from cmr_bench.metrics._shared import card_wait_share as read  # noqa: F401
