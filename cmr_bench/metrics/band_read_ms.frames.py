"""Host ms a band read (the band's copy to the host and its accumulation),
from the port's spans."""

from cmr_bench.metrics._program import band_read_ms as read  # noqa: F401
