"""The readers of K1's walk counts (``metrics/_walk.py`` and
``metrics/k1_groups_per_bounce.frames.py``) on a synthetic recorder: the
window's K1 sites' supers, clusters and groups entered over their bounces,
the sort sites left out; None with no card, and the groups' reader None on
a port whose recorder has no 'groups' field."""

import pytest

from cmr_bench import spec
from cmr_bench.record import Record

READERS = ("k1_supers_per_bounce.frames", "k1_clusters_per_bounce.frames",
           "k1_groups_per_bounce.frames")
K1 = "K1 at width 65536, cap 1, phase 0"
SORT = "sort before phase 1"


@pytest.fixture
def recorder(monkeypatch):
    """A recorder of four renders on cuda:0, one before the window: each
    window render adds a K1 site's 1,000 bounces over 1,900 supers, 2,000
    clusters and 700 groups, and a sort site's visits."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
    from complex_materials_renderer_tpu_torch.utils import timing

    k1 = pc.site_index(pc.Site(K1, "k1", 65536))
    sort = pc.site_index(pc.Site(SORT, "sort"))
    rec = timing.Recorder()
    for i in range(4):
        r = timing.RenderRecord(i)
        block = [0] * (pc.CNT_SITES + (max(k1, sort) + 1) * pc.SITE_FIELDS)
        for site, fields in ((k1, dict(visits=10, k1=10, live=800, lanes=1000, bounces=1000,
                                       supers=1900, clusters=2000, groups=700, ns=5_000_000)),
                             (sort, dict(visits=2, ns=600_000))):
            base = pc.CNT_SITES + site * pc.SITE_FIELDS
            for key, v in fields.items():
                block[base + pc.SITE_KEYS.index(key)] = v * i
        r._blocks["cuda:0"] = block
        rec._records.append(r)
    monkeypatch.setattr(timing, "recorder", rec)
    return rec


def _rec(cards=(0,), renders=3):
    return Record(paths_per_render=1_000_000, setup_s=1.0, window_s=1.0,
                  latencies_s=[0.3] * renders, cards=list(cards))


def test_walk_readers_over_the_window(recorder):
    read = {name: spec.reader(name)(_rec()) for name in READERS}
    assert read["k1_supers_per_bounce.frames"] == pytest.approx(1.9)
    assert read["k1_clusters_per_bounce.frames"] == pytest.approx(2.0)
    assert read["k1_groups_per_bounce.frames"] == pytest.approx(0.7)


def test_walk_readers_none_without_a_card_or_the_field(recorder, monkeypatch):
    for name in READERS:
        assert spec.reader(name)(_rec(cards=())) is None
        assert spec.reader(name)(_rec(renders=4)) is None  # no render before the window
    segments = recorder.segments

    def without_groups(first, last):
        out = segments(first, last)
        for acc in out.values():
            acc.pop("groups")
        return out

    monkeypatch.setattr(recorder, "segments", without_groups)
    assert spec.reader("k1_groups_per_bounce.frames")(_rec()) is None
    assert spec.reader("k1_supers_per_bounce.frames")(_rec()) == pytest.approx(1.9)


def test_groups_reader_is_listed_for_the_tiled_cell_alone():
    bench = spec.load_benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "k1_groups_per_bounce.frames"]
    assert entry["workloads"] == ["showcase-tiled-1080p-frames"]
    assert entry["moves"] == "mpaths_per_s" and entry["layer"] == "kernels/megakernel.py (K1)"
