"""Group boxes K1's walks entered per bounce over the window's K1 sites,
from the pass control's counters (field 'groups' of the port's recorder
segments: the two-level walk's group boxes above the supers, which K1
takes on a grid of many supers). None where the run had no card, or where
the program counts no group (a port without the field)."""

from cmr_bench.metrics._program import _segments


def read(rec):
    seg = _segments(rec)
    if seg is None or not seg["k1"].get("bounces") or "groups" not in seg["k1"]:
        return None
    return seg["k1"]["groups"] / seg["k1"]["bounces"]
