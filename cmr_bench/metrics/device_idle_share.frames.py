"""The cards' idle share of the window between tile calls, in %."""

from cmr_bench.metrics._shared import device_idle_share as read  # noqa: F401
