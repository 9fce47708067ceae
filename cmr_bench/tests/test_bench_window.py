"""The end-to-end and per-layer arithmetic over synthetic windows."""

import pytest

from cmr_bench import spec
from cmr_bench.record import Record, Span


def _window(latencies, paths=1_000_000):
    return Record(paths_per_render=paths, setup_s=5.0, window_s=sum(latencies),
                  latencies_s=list(latencies))


def test_rate_and_tail_count_every_render_and_a_stall_moves_them():
    steady = _window([0.04] * 400)
    stalled = _window([0.04] * 399 + [2.0])
    rate, p95, per_s = (spec.reader(n) for n in ("mpaths_per_s", "preview_ms_p95",
                                                 "previews_per_s"))
    assert rate(steady) == pytest.approx(400 / 16.0)
    assert per_s(steady) == pytest.approx(25.0)
    assert p95(steady) == pytest.approx(40.0)
    assert rate(stalled) == pytest.approx(400 / (399 * 0.04 + 2.0))
    assert rate(stalled) < 0.9 * rate(steady)
    assert per_s(stalled) < 0.9 * per_s(steady)
    # One stalled render of 400 sits above the 95th percentile; 5% do not.
    assert p95(stalled) == pytest.approx(40.0)
    tail = _window([0.04] * 370 + [0.2] * 30)
    assert p95(tail) == pytest.approx(200.0)


def test_idle_wait_and_launch_arithmetic():
    def span(card, band, start, dur, host=0.001):
        return Span(card, (1920, 34, 32), band, 0, host, start, dur)

    rec = Record(paths_per_render=2_000_000, setup_s=1.0, window_s=1.0, latencies_s=[1.0],
                 cards=[0, 1], k1_launches=400,
                 spans=[span(0, 0, 0.0, 0.4), span(1, 0, 0.0, 0.5),
                        span(0, 1, 0.5, 0.4), span(1, 1, 0.5, 0.3)])
    assert spec.reader("device_idle_share.frames")(rec) == pytest.approx(100 * (1 - 0.8))
    # Band 0: card 0 waits 0.1 of 0.5; band 1: card 1 waits 0.1 of 0.4.
    assert spec.reader("card_wait_share")(rec) == pytest.approx(100 * 0.1 / 0.9)
    assert spec.reader("k1_launches_per_mpath.frames")(rec) == pytest.approx(200.0)
    assert spec.reader("enqueue_ms_per_call.preview")(rec) == pytest.approx(1.0)
    one_card = Record(paths_per_render=1, setup_s=1.0, window_s=1.0, latencies_s=[1.0],
                      cards=[0], spans=[span(0, -1, 0.0, 0.9)])
    assert spec.reader("card_wait_share")(one_card) is None
    untraced = _window([0.5])
    for name in ("device_idle_share.preview", "enqueue_ms_per_call.frames",
                 "k1_launches_per_mpath.preview", "capture_s"):
        assert spec.reader(name)(untraced) is None


def test_wrappers_see_samples_calls(monkeypatch):
    """Adaptive sampling's samples call under both wrappers: the warm-up
    runs the first call of a lane count and gives zeros of (lanes, 3) for
    the next; the spans record each call with the shape (lanes,)."""
    import types

    import torch

    from complex_materials_renderer_tpu_torch.render import megarender

    from cmr_bench import tracing

    ran = []

    def fake(camera, scene, grid, lights, pixel_xy, *a, **kw):
        ran.append(pixel_xy.shape[0])
        return torch.ones((pixel_xy.shape[0], 3))

    monkeypatch.setattr(megarender, "render_samples_mega", fake)
    grid = types.SimpleNamespace(device=torch.device("cpu"))
    call = lambda n: megarender.render_samples_mega(None, None, grid, None,  # noqa: E731
                                                    torch.zeros((n, 2)), None, None, (4, 4))
    with tracing.WarmShapes() as warm:
        first, again, other = call(8), call(8), call(16)
    assert ran == [8, 16] and warm.shapes == {("cpu", (8,)), ("cpu", (16,))}
    assert first.sum() == 24 and again.shape == (8, 3) and again.sum() == 0 and other.sum() == 48
    with tracing.Spans([]) as spans:
        call(8)
        call(8)
    assert [s.shape for s in spans.spans()] == [(8,), (8,)]
    assert megarender.render_samples_mega is fake


def test_breakdown_names_each_call_shape():
    from cmr_bench import run

    rec = Record(paths_per_render=1, setup_s=1.0, window_s=1.0, latencies_s=[0.5, 0.5],
                 cards=[0], spans=[Span(0, (1920, 34, 32), -1, 0, 0.001, 0.1, 0.2),
                                   Span(0, (1920, 34, 32), -1, 0, 0.001, 0.35, 0.1),
                                   Span(0, (1048576,), -1, 1, 0.001, 0.5, 0.1),
                                   Span(0, (1048576,), -1, 1, 0.001, 0.7, 0.1)])
    out = run._breakdown(rec)
    assert dict(out["device_ops"]) == pytest.approx({
        "megarender tile call 1920x34 at 32 spp": 0.3,
        "megarender samples call of 1048576 lanes": 0.2})
    gaps = dict(out["idle_gaps"])
    assert gaps["between tile calls of a render (renderer.py: band read, accumulation)"] == \
        pytest.approx(0.05)
    assert gaps["between samples calls of a render (renderer.py render_adaptive: read, "
                "allocation)"] == pytest.approx(0.1)
    assert gaps["window start to the first tile call"] == pytest.approx(0.1)
    assert gaps["the last samples call to the window's end"] == pytest.approx(0.2)


@pytest.mark.parametrize("shape,kind", [((1920, 34, 32), "tile"), ((1048576,), "samples")])
def test_breakdown_edge_gaps_name_the_call_kind(shape, kind):
    """The gaps before a card's first call and after its last are named
    after the kind of call they border: a tile cell's names as they were,
    an adaptive cell's after its samples calls."""
    from cmr_bench import run

    rec = Record(paths_per_render=1, setup_s=1.0, window_s=1.0, latencies_s=[0.5],
                 cards=[0], spans=[Span(0, shape, -1, 0, 0.001, 0.25, 0.5)])
    gaps = dict(run._breakdown(rec)["idle_gaps"])
    assert gaps[f"window start to the first {kind} call"] == pytest.approx(0.25)
    assert gaps[f"the last {kind} call to the window's end"] == pytest.approx(0.25)
    assert not any(("tile" if kind == "samples" else "samples") in name for name in gaps)
