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
