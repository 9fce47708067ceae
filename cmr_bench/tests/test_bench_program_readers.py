"""The readers of the port's own recorder (``metrics/_program.py``) on a
synthetic recorder: the window is its last N renders, the render before
them gives the starting snapshot, and every reader gives None with no
card, too few renders, or a port without the recorder."""

import pytest

from cmr_bench import spec
from cmr_bench.record import Record

READERS = [f"{m}.{k}" for m in ("band_read_ms", "k1_ms_per_mpath", "sort_ms_per_mpath",
                                 "k1_lane_occupancy") for k in ("frames", "preview")]
K1 = "K1 at width 65536, cap 1, phase 0"
SORT = "sort before phase 1"
KINDS = {K1: ("k1", 65536), SORT: ("sort", None)}


def _block(pc, sites: dict) -> list:
    """A counter block prefix with ``sites`` {label: [visits, K1, live,
    lanes, ns]}, each value at its field of the site's ``SITE_FIELDS``."""
    idx = {label: pc.site_index(pc.Site(label, *KINDS.get(label, ("other", None))))
           for label in sites}
    block = [0] * (pc.CNT_SITES + (max(idx.values()) + 1) * pc.SITE_FIELDS)
    at = (pc.SITE_VISITS, pc.SITE_K1, pc.SITE_LIVE, pc.SITE_LANES, pc.SITE_NS)
    for label, fields in sites.items():
        base = pc.CNT_SITES + idx[label] * pc.SITE_FIELDS
        for field, value in zip(at, fields):
            block[base + field] = value
    return block


@pytest.fixture
def recorder(monkeypatch):
    """A recorder of five renders on cuda:0: one before the warm-up, the
    warm-up and three in the window; each window render adds 10 K1
    launches of 50 ms in all on 800 live of 1000 lanes, 2 sorts of 6 ms,
    and two band reads of 1 ms and accumulations of 0.5 ms."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
    from complex_materials_renderer_tpu_torch.utils import timing

    rec = timing.Recorder()
    for i in range(5):
        r = timing.RenderRecord(i)
        n = i if i >= 1 else 0
        extra = 999 if i == 0 else 0  # an older render's counts, outside the window
        r._blocks["cuda:0"] = _block(pc, {
            K1: [10 * n, 10 * n, 800 * n, 1000 * n, 50_000_000 * n + extra],
            SORT: [2 * n, 0, 0, 0, 6_000_000 * n],
            "pass head": [n, 0, 0, 0, 1_000_000 * n]})
        r.totals = {"render": 0.1, "band_read": 0.002 + 0.1 * (i < 2),
                    "band_accumulate": 0.001, "tile_call": 0.01}
        r.counts = {"render": 1, "band_read": 2, "band_accumulate": 2, "tile_call": 2}
        rec._records.append(r)
    monkeypatch.setattr(timing, "recorder", rec)
    return rec


def _rec(cards=(0,), renders=3, paths=2_000_000):
    return Record(paths_per_render=paths, setup_s=1.0, window_s=1.0,
                  latencies_s=[0.3] * renders, cards=list(cards))


def test_readers_over_the_window(recorder):
    rec = _rec()
    read = {name: spec.reader(name)(rec) for name in READERS}
    # Window: renders 2-4 over render 1's snapshot: 3 x (10 launches, 50 ms).
    for k in ("frames", "preview"):
        assert read[f"k1_ms_per_mpath.{k}"] == pytest.approx(150.0 / 6.0)
        assert read[f"sort_ms_per_mpath.{k}"] == pytest.approx(18.0 / 6.0)
        assert read[f"k1_lane_occupancy.{k}"] == pytest.approx(80.0)
        # (1 ms + 0.5 ms) a read; the warm-up's slow read is outside.
        assert read[f"band_read_ms.{k}"] == pytest.approx(1.5)


def test_a_longer_window_starts_earlier(recorder):
    rec = _rec(renders=4)  # renders 1-4 over render 0's snapshot
    assert spec.reader("k1_ms_per_mpath.frames")(rec) == pytest.approx(
        (200.0 - 0.000999) / 8.0)
    assert spec.reader("band_read_ms.frames")(rec) == pytest.approx(
        (1e3 * (0.102 + 3 * 0.002 + 4 * 0.001)) / 8)


def test_none_without_a_card_a_snapshot_or_the_recorder(recorder, monkeypatch):
    for name in READERS:
        assert spec.reader(name)(_rec(cards=())) is None
        assert spec.reader(name)(_rec(renders=5)) is None  # no render before the window
    recorder._records[1]._blocks.clear()
    for name in READERS:
        assert spec.reader(name)(_rec()) is None  # the starting render has no snapshot
    from complex_materials_renderer_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "recorder")
    for name in READERS:
        assert spec.reader(name)(_rec()) is None
