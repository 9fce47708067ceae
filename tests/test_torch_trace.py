"""The port's recorder (utils/timing.py) and the pass control's site counts
(kernels/pass_control.py).

On the CPU: the recorder's nesting, render ids and bounds; one render's
band spans; the CPU executor's per-site counts against a recount of the
alive lanes; the clock conversion and the idle split against a fake
clock. The ``gpu`` tests, on a card: a graph replay's per-site counts
against the eager executor's and against the CPU executor's control (the
plain version) on the card's tensors, a call's segments against its
interval, and the host's wait for a band against the call's end stamp on
the shared clock. Neither JAX nor the test helpers are imported, so the card runs
this file with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_trace.py
"""

import dataclasses
import os

import pytest
import torch

from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
from complex_materials_renderer_tpu_torch.render import megarender as mr
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import load_scene
from complex_materials_renderer_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = ("tile_call", "band_wait", "band_read", "band_accumulate")


def _isobox(device="cpu", **kw):
    obj = os.path.join(REPO, "scenes", "isobox.obj")
    base = dict(width=32, height=16, num_samples=2, shard="none", device=device,
                backend="cluster", engine="mega", max_depth=4, rr_depth=2)
    base.update(kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **base))
    return Renderer(scene, dataclasses.replace(scene.options, **base))


def test_recorder_nesting_render_ids_and_bound():
    rec = timing.Recorder(renders=3, span_renders=2)
    with rec.span("outside") as outside:  # timed, kept in no render
        pass
    assert outside.render is None and outside.parent == -1 and outside.end >= outside.start
    ids = []
    for i in range(4):
        with rec.render(["cpu"]) as r:
            ids.append(r.id)
            with rec.span("a"):
                with rec.span("b"):
                    pass
            with rec.render(["cpu"]) as inner:  # a render inside a render adds nothing
                assert inner is r
            with rec.span("a"):
                pass
    assert ids == [0, 1, 2, 3]
    kept = rec.renders()
    assert [r.id for r in kept] == [1, 2, 3]  # the latest ``renders``
    assert kept[0].spans is None and kept[1].spans is not None  # spans of the latest two
    last = kept[-1]
    assert [(s.name, s.parent, s.render) for s in last.spans] == [
        ("render", -1, 3), ("a", 0, 3), ("b", 1, 3), ("a", 0, 3)]
    assert all(s.start <= s.end for s in last.spans)
    assert last.counts == {"render": 1, "a": 2, "b": 1}
    root = last.spans[0]
    assert last.totals["render"] == pytest.approx(root.end - root.start)
    assert last.devices == ["cpu"] and rec.previous(last, "cpu") is kept[1]
    assert not rec.rendering


def test_render_records_a_span_set_per_band_and_chunk(monkeypatch):
    """Two bands of two 1-sample chunks: one tile_call, band_wait,
    band_read and band_accumulate each, under the render's root span, and
    the render's snapshot of the CPU's counters holds its K1 launches."""
    import complex_materials_renderer_tpu_torch.renderer as rd

    monkeypatch.setattr(rd, "_auto_row_chunk", lambda width: 8)
    r = _isobox(sample_chunk=1)
    before = pc.device_counts("cpu").tolist()
    r.render()
    rec = timing.recorder.renders()[-1]
    delta = [b - a for a, b in zip(before, rec.block("cpu"))]  # the snapshot at the render's end
    ran = delta[pc.CNT_K1]
    assert rec.counts == {"render": 1, **{name: 4 for name in BANDS}}
    names = [s.name for s in rec.spans if s.parent == 0]
    assert names == list(BANDS) * 4
    assert all(s.parent == -1 for s in rec.spans[:1])
    assert dict(r.timer.items()).keys() >= {"render", *BANDS, "accel_build"}
    sites = pc.site_counts(delta)
    assert ran > 0 and sum(f[pc.SITE_K1] for f in sites.values()) == ran
    assert sites["pass head"][pc.SITE_VISITS] == 4  # a sample step a chunk
    assert all(f[pc.SITE_NS] == 0 for f in sites.values())  # no card clock on the CPU
    report = r.timer.report()
    assert f"render {rec.id}:" in report and "K1 lane occupancy" in report


class _Recount(pc.HostLoop):
    """The CPU executor, recounting on the host the alive lanes of each K1
    call that runs and charging them to the site of the control launch
    after it."""

    sites: dict = {}

    def __init__(self, device, device_ctrl):
        super().__init__(device, device_ctrl)
        self.pending = None

    def k1(self, kern, state, cap, ctrl):
        run, live = int(ctrl[pc.CTRL_RUN]), int(ctrl[pc.CTRL_LIVE])
        if run and live > 0:
            self.pending = (int(state.alive.sum()), live * pc.BLOCK)
        super().k1(kern, state, cap, ctrl)

    def control(self, alive, ctrl, flags, site=pc.SITE_OTHER, **kw):
        if self.pending is not None:
            assert flags & pc.AFTER_K1
            got = self.sites.setdefault(site, [0, 0, 0])
            got[0] += 1
            got[1] += self.pending[0]
            got[2] += self.pending[1]
            self.pending = None
        super().control(alive, ctrl, flags, site=site, **kw)


@pytest.mark.parametrize("mode,schedule", [("off", ""), ("off", "1:1,2:1"), ("all", ""),
                                           ("hybrid", "")])
def test_plain_site_counts_match_a_recount(monkeypatch, mode, schedule):
    """The CPU executor's per-site counts over a 64x32 tile: the sites' K1
    launches sum to index 0 and their visits to index 1, live lanes never
    exceed the lanes launched, and each site's K1 launches, live lanes and
    lanes equal a recount of ``alive`` at each K1 call."""
    r = _isobox(width=64, height=32)
    _Recount.sites = {}
    monkeypatch.setattr(mr, "HostLoop", _Recount)
    counts = pc.device_counts("cpu")
    before = counts.clone()
    mr.render_beauty_mega(r.camera, r.scene_arrays, r.accel, r.lights, (64, 32), 2,
                          max_depth=4, rr_depth=2, schedule_mode=mode, schedule=schedule)
    delta = (counts - before).tolist()
    sites = pc.site_counts(delta)
    assert sum(f[pc.SITE_K1] for f in sites.values()) == delta[pc.CNT_K1] > 0
    assert sum(f[pc.SITE_VISITS] for f in sites.values()) == delta[pc.CNT_CONTROL]
    assert all(f[pc.SITE_LIVE] <= f[pc.SITE_LANES] for f in sites.values())
    recount = {pc.site_labels()[pc.site_index(s)]: v for s, v in _Recount.sites.items()}
    assert recount == {label: [f[pc.SITE_K1], f[pc.SITE_LIVE], f[pc.SITE_LANES]]
                       for label, f in sites.items() if f[pc.SITE_K1]}
    table = {site.label: site for site in pc.sites()}
    assert all(table[label].kind == "k1" and table[label].width for label in recount)
    if schedule:
        assert any(label.startswith("K1 spill") for label in recount)


def test_site_table_raises_when_full(monkeypatch):
    """Sites are registered with what they ran and K1's width, a label
    stands for one site, and a full table raises."""
    monkeypatch.setattr(pc, "_SITES", list(pc._SITES))
    monkeypatch.setattr(pc, "_SITE_INDEX", dict(pc._SITE_INDEX))
    k1 = pc.Site("test K1 at width 1024", "k1", 1024)
    i = pc.site_index(k1)
    assert pc.site_index(k1) == i and pc.sites()[i] == k1 and pc.site_labels()[i] == k1.label
    head = pc.site_index("test head")
    assert pc.sites()[head] == pc.Site("test head", "other", None)
    with pytest.raises(ValueError, match="test K1 at width 1024"):
        pc.site_index(pc.Site(k1.label, "sort"))
    n = len(pc._SITES)
    for j in range(pc.MAX_SITES - n):
        assert pc.site_index(f"test site {j}") == n + j
    assert pc.site_index("test site 0") == n  # a label is found again
    with pytest.raises(RuntimeError, match="site table is full"):
        pc.site_index("one more")


def test_clock_conversion_and_idle_split_on_a_fake_clock():
    """``calibrate`` keeps the try of the smallest round trip; a ring of
    call intervals converts to the host clock; the idle between two calls
    splits by the top-level spans that overlap it."""
    host = iter([10.0, 10.004, 20.0, 20.002, 30.0, 30.010])
    stamps = iter([5_000_000_000, 5_000_000_000 + 10_001_000_000, 0])
    cal = timing.calibrate(lambda: None, lambda: None, lambda: next(stamps),
                           clock=lambda: next(host), tries=3)
    # The second try: 20.001 s on the host is 15.001 s on the card.
    assert cal.error_s == pytest.approx(0.001)
    assert cal.offset_ns == pytest.approx(15.001e9 - 20.001e9)
    assert cal.to_host(15.001e9) == pytest.approx(20.001)

    rec = timing.Recorder()
    rec.calibrations["cuda:0"] = timing.Calibration(offset_ns=5e9, error_s=1e-4)
    block = [0] * (pc.CNT_SITES + 2 * pc.SITE_FIELDS)
    calls = [(6.0e9, 6.5e9), (6.7e9, 7.0e9)]  # host 1.0-1.5 s and 1.7-2.0 s
    for i, (a, b) in enumerate(calls):
        block[pc.CNT_HEAD + 2 * i:pc.CNT_HEAD + 2 * i + 2] = [a, b]
    block[pc.CNT_CALLS] = 2
    r = timing.RenderRecord(0)
    r.spans = [timing.Span("render", 0.9, 2.1, -1, 0), timing.Span("band_wait", 1.0, 1.55, 0, 0),
               timing.Span("band_read", 1.55, 1.6, 0, 0),
               timing.Span("band_accumulate", 1.6, 1.65, 0, 0),
               timing.Span("tile_call", 1.65, 1.66, 0, 0)]
    r._blocks["cuda:0"] = block
    rec._records.append(r)
    assert rec.calls(r, "cuda:0") == [pytest.approx((1.0, 1.5)), pytest.approx((1.7, 2.0))]
    split = rec.idle_by_span([r])
    assert split == {"band_wait": pytest.approx(0.05), "band_read": pytest.approx(0.05),
                     "band_accumulate": pytest.approx(0.05), "tile_call": pytest.approx(0.01),
                     "no span": pytest.approx(0.04)}


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card present")
    return torch.device("cuda", torch.cuda.current_device())


def _one_call(r, executor, mode):
    return mr.render_beauty_mega(r.camera, r.scene_arrays, r.accel, r.lights, (48, 32), 4,
                                 max_depth=4, rr_depth=2, schedule_mode=mode,
                                 schedule="1:1,2:1" if mode == "off" else "",
                                 executor=executor)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "all", "hybrid"])
def test_graph_site_counts_equal_eager(cuda, mode):
    """A graph replay counts at every site what the eager executor counts
    (visits, K1 launches, live lanes, lanes), bit-equal images; the replay
    also counts its call's end."""
    r = _isobox(device="cuda")
    _one_call(r, "auto", mode)  # the capture, and one replay
    counts = pc.device_counts(cuda)
    b0 = counts.clone()
    eager = _one_call(r, "eager", mode)
    b1 = counts.clone()
    graph = _one_call(r, "auto", mode)
    b2 = counts.clone()
    assert torch.equal(eager, graph)
    e = pc.site_counts((b1 - b0).tolist())
    g = pc.site_counts((b2 - b1).tolist())
    assert g.pop("call end")[pc.SITE_VISITS] == 1 and "call end" not in e
    assert {k: v[:pc.SITE_NS] for k, v in e.items()} == {k: v[:pc.SITE_NS] for k, v in g.items()}
    assert sum(v[pc.SITE_K1] for v in g.values()) == int((b2 - b1)[pc.CNT_K1]) > 0


class _PlainControl(pc.HostLoop):
    """The CPU executor's steps on the card: the kernels take the control
    block (K1 its run flag, live blocks and ld base), and every control
    launch is the plain version, ``pass_control_plain``, which counts at
    the sites all that the card's kernel counts but the clock."""

    def __init__(self, device, device_ctrl):
        super().__init__(device, True)

    def control(self, alive, ctrl, flags, site=pc.SITE_OTHER, handle=None, handles=None, **kw):
        pc.pass_control_plain(alive, ctrl, self.counts,
                              flags | pc.SITE_COUNT | pc.DEVICE_COUNT,
                              site=pc.site_index(site), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "all", "hybrid"])
def test_graph_site_counts_equal_plain_control(cuda, mode, monkeypatch):
    """A graph replay counts at every site (visits, K1 launches, live
    lanes, lanes) what the same tile counts with the control kernel's plain
    version in its place, and renders the same image: the card's SITE_COUNT
    branch against its plain statement."""
    r = _isobox(device="cuda")
    _one_call(r, "auto", mode)  # the capture, and one replay
    counts = pc.device_counts(cuda)
    b0 = counts.clone()
    graph = _one_call(r, "auto", mode)
    b1 = counts.clone()
    monkeypatch.setattr(mr, "HostLoop", _PlainControl)
    plain = _one_call(r, "eager", mode)
    b2 = counts.clone()
    assert torch.equal(graph, plain)
    g = pc.site_counts((b1 - b0).tolist())
    p = pc.site_counts((b2 - b1).tolist())
    assert g.pop("call end")[pc.SITE_VISITS] == 1 and "call end" not in p
    assert {k: v[:pc.SITE_NS] for k, v in g.items()} == {k: v[:pc.SITE_NS] for k, v in p.items()}
    assert all(v[pc.SITE_NS] == 0 for v in p.values())
    assert (b1 - b0)[:2].tolist() == (b2 - b1)[:2].tolist() and int((b1 - b0)[pc.CNT_K1]) > 0


@pytest.mark.gpu
def test_call_segments_sum_to_its_interval(cuda):
    """The segments of one replay, over every site, sum to the call's
    interval in the ring: each segment is the difference of two stamps, so
    they sum to it to the nanosecond (within one timer step a segment a
    fortiori)."""
    r = _isobox(device="cuda")
    _one_call(r, "auto", "off")
    counts = pc.device_counts(cuda)
    before = counts.clone()
    _one_call(r, "auto", "off")
    after = counts.clone()
    delta = (after - before).tolist()
    assert delta[pc.CNT_CALLS] == 1
    (start, end), = pc.call_intervals(after.tolist(), int(before[pc.CNT_CALLS]))
    segs = pc.site_counts(delta)
    total = sum(v[pc.SITE_NS] for v in segs.values())
    assert end > start and delta[pc.CNT_CALL_NS] == end - start
    assert total == end - start, (total, end - start)
    kinds = {site.label: site.kind for site in pc.sites()}
    assert segs["pass head"][pc.SITE_NS] > 0 and any(
        v[pc.SITE_NS] > 0 for k, v in segs.items() if kinds[k] == "k1")


@pytest.mark.gpu
def test_band_wait_ends_after_the_call_on_one_clock(cuda, monkeypatch):
    """On the shared clock each band's wait ends after its call's end
    stamp, less the calibration's error; the calibration's error is
    small."""
    import complex_materials_renderer_tpu_torch.renderer as rd

    monkeypatch.setattr(rd, "_auto_row_chunk", lambda width: 16)
    r = _isobox(device="cuda", width=48, height=32, num_samples=4, sample_chunk=2)
    r.render()  # captures
    r.render()
    rec = timing.recorder.renders()[-1]
    key = str(cuda)
    cal = timing.recorder.calibrations[key]
    assert 0 < cal.error_s < 0.01
    calls = timing.recorder.calls(rec, key)
    waits = [s for s in rec.spans if s.name == "band_wait"]
    assert len(calls) == len(waits) == 4
    for (_, end), wait in zip(calls, waits):
        assert wait.end >= end - cal.error_s, (wait.end, end, cal.error_s)
    split = timing.recorder.idle_by_span([rec])
    assert set(split) <= {*BANDS, "no span"}
