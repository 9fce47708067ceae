"""Arithmetic of the readers of K1's walk counts: the bounces its launches
ran, the super boxes their walks entered and the clusters they tested,
which each K1 launch leaves at the pass control's site that follows it
(the port's ``utils.timing.recorder`` segments, fields 'bounces',
'supers' and 'clusters'). Each returns None where the run had no card, or
where the program counts no walk (a port without these fields)."""

from cmr_bench.metrics._program import _segments


def _per_bounce(rec, field):
    seg = _segments(rec)
    if seg is None or not seg["k1"].get("bounces"):
        return None
    return seg["k1"][field] / seg["k1"]["bounces"]


def k1_supers_per_bounce(rec):
    """Super boxes entered by K1's walks over the window, summed over the
    cards' K1 sites, per bounce those launches ran."""
    return _per_bounce(rec, "supers")


def k1_clusters_per_bounce(rec):
    """Cluster boxes entered by K1's walks (each then tested slot by slot)
    over the window, summed over the cards' K1 sites, per bounce."""
    return _per_bounce(rec, "clusters")
