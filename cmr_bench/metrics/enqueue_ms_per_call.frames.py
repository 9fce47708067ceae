"""Host ms inside each tile call into render/megarender.py (a mean)."""

from cmr_bench.metrics._shared import enqueue_ms as read  # noqa: F401
