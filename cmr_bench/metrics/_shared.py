"""Arithmetic the per-layer readers share; readers of one quantity split
by the end-to-end metric it moves (``.frames``, ``.preview``) call the
same function here."""

import math


def enqueue_ms(rec):
    """Mean host ms inside a tile call, which returns before its card
    finishes: input copies, the pass-cache lookup, the graph replay's
    launch, the outputs' clones."""
    if not rec.spans:
        return None
    return 1e3 * sum(s.host_s for s in rec.spans) / len(rec.spans)


def k1_launches_per_mpath(rec):
    """K1 launches the window ran, counted on the cards, per million
    paths completed."""
    if not rec.k1_launches:
        return None
    return rec.k1_launches / (rec.paths / 1e6)


def device_idle_share(rec):
    """100 x (1 - a card's tile-call time over the window), a mean over the
    cards: the idle between calls. Idle inside a call is not in it."""
    busy = rec.busy_s()
    if not rec.spans or not busy or not all(math.isfinite(v) for v in busy.values()):
        return None
    return 100.0 * (1.0 - sum(busy.values()) / len(busy) / rec.window_s)


def card_wait_share(rec):
    """Per band, each card's wait for the band's slowest card; summed over
    the bands over the slowest cards' summed time, x 100, a mean over the
    cards."""
    bands: dict = {}
    for s in rec.spans:
        if s.band >= 0 and math.isfinite(s.device_s):
            per = bands.setdefault(s.band, {})
            per[s.card] = per.get(s.card, 0.0) + s.device_s
    cards = sorted({c for per in bands.values() for c in per})
    if len(cards) < 2:
        return None
    slowest = sum(max(per.values()) for per in bands.values())
    wait = [sum(max(per.values()) - per.get(c, 0.0) for per in bands.values()) for c in cards]
    return 100.0 * sum(wait) / len(cards) / slowest
