"""Arithmetic of the per-layer readers that read the port's own recorder
(``complex_materials_renderer_tpu_torch.utils.timing.recorder``): its
host spans, and the cards' counter blocks that it snapshots at the end of
each render (the pass control's sites: K1 segments, sort segments, live
and covered lanes). The window is the recorder's last
``len(rec.latencies_s)`` renders; the render before them, the warm-up,
gives the starting snapshot. Each returns None where the run had no card,
or where the program keeps no such record (a port without the recorder)."""


def _window(rec):
    """(recorder, the render before the window, the window's renders), or
    None."""
    if not rec.cards or not rec.latencies_s:
        return None
    try:
        from complex_materials_renderer_tpu_torch.utils import timing
    except ImportError:
        return None
    recorder = getattr(timing, "recorder", None)
    if recorder is None or not hasattr(recorder, "segments"):
        return None
    renders = recorder.renders()
    n = len(rec.latencies_s)
    if len(renders) < n + 1 or not renders[-n - 1].devices:
        return None
    return recorder, renders[-n - 1], renders[-n:]


def band_read_ms(rec):
    """Mean host ms a band read: the band's copy to the host and its
    accumulation (``band_read`` + ``band_accumulate``), over the window."""
    w = _window(rec)
    if w is None:
        return None
    renders = w[2]
    reads = sum(r.counts.get("band_read", 0) for r in renders)
    if not reads:
        return None
    secs = sum(r.totals.get("band_read", 0.0) + r.totals.get("band_accumulate", 0.0)
               for r in renders)
    return 1e3 * secs / reads


def _segments(rec):
    w = _window(rec)
    if w is None:
        return None
    recorder, start, renders = w
    return recorder.segments(start, renders[-1])


def k1_ms_per_mpath(rec):
    """Card ms of the K1 segments inside the graphs, summed over the
    cards, per million paths the window completed."""
    seg = _segments(rec)
    if seg is None or not seg["k1"]["k1"]:
        return None
    return seg["k1"]["ns"] / 1e6 / (rec.paths / 1e6)


def sort_ms_per_mpath(rec):
    """Card ms of the pass plan's sort segments (the sort, the bank
    scatter and the control launch after them), summed over the cards, per
    million paths the window completed."""
    seg = _segments(rec)
    if seg is None or not seg["sort"]["visits"]:
        return None
    return seg["sort"]["ns"] / 1e6 / (rec.paths / 1e6)


def k1_lane_occupancy(rec):
    """100 x the live lanes at K1's launches over the lanes they covered,
    over the window's K1 launches on every card."""
    seg = _segments(rec)
    if seg is None or not seg["k1"]["lanes"]:
        return None
    return 100.0 * seg["k1"]["live"] / seg["k1"]["lanes"]
