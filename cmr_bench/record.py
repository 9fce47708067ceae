"""What one run measured, as the metric readers get it.

Times are seconds. ``latencies_s`` holds every render of the window, call
to returned image, in order. The spans and counters are filled by the
traced run (``--trace 1``) alone; a reader that finds them empty returns
None and its metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Span:
    """One tile call into the port's tile renderer, on one card."""

    card: int
    shape: tuple  # (width, rows, samples) of the call
    band: int  # the dispatch_cells call it belongs to, -1 on one card
    render: int  # the window's render it belongs to
    host_s: float  # host clock inside the call (it returns before the card finishes)
    start_s: float  # on the card, from the card's window-start event
    device_s: float  # on the card, the call's first queued work to its last


@dataclasses.dataclass
class Record:
    paths_per_render: int
    setup_s: float
    window_s: float
    latencies_s: List[float]
    accel_build_s: float = 0.0
    capture_s: float = 0.0
    k1_launches: Optional[int] = None
    cards: List[int] = dataclasses.field(default_factory=list)
    spans: List[Span] = dataclasses.field(default_factory=list)

    @property
    def paths(self) -> int:
        return self.paths_per_render * len(self.latencies_s)

    def busy_s(self) -> dict:
        """{card: seconds of its tile-call spans}."""
        out = {c: 0.0 for c in self.cards}
        for s in self.spans:
            out[s.card] = out.get(s.card, 0.0) + s.device_s
        return out
