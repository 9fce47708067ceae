"""The band loop's run-ahead (renderer.py ``_band_loop``,
``CALLS_IN_FLIGHT``) on the CPU: call k + 1 is queued before call k is
read, at most ``CALLS_IN_FLIGHT`` calls are unread, the reads keep the
calls' order, and the image is the one of a loop that reads each call
before the next (``CALLS_IN_FLIGHT`` = 1), on one device and over 8 shards
of the CPU, in parity and counter mode; a checkpoint written after the
first read holds what that loop writes after its first call, and resumes
to the uninterrupted image bit for bit; each render counts its calls
queued ahead of an unread one ("calls_ahead"). No JAX is imported."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import complex_materials_renderer_tpu_torch.renderer as rd
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import load_scene
from complex_materials_renderer_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8  # eight shards of the one CPU


def _isobox(**kw):
    """A 32x16 isobox render at 2 spp in 1-sample calls on the CPU's mega
    engine."""
    obj = os.path.join(REPO, "scenes", "isobox.obj")
    base = dict(width=32, height=16, num_samples=2, sample_chunk=1, shard="none",
                device="cpu", backend="cluster", engine="mega", max_depth=4, rr_depth=2)
    base.update(kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **base))
    return Renderer(scene, dataclasses.replace(scene.options, **base))


@pytest.fixture
def two_bands(monkeypatch):
    """One device renders the 16 rows in two bands of 8."""
    monkeypatch.setattr(rd, "_auto_row_chunk", lambda width: 8)


class _Spy:
    """A band call that logs each call and each read of its image, and the
    most calls ever unread."""

    def __init__(self, call):
        self.call, self.events, self.unread, self.most = call, [], 0, 0

    def __call__(self, row0, band_h, n, done, rng_state):
        k = sum(e == "call" for e, _ in self.events)
        self.events.append(("call", k))
        read, rng_state = self.call(row0, band_h, n, done, rng_state)
        self.unread += 1
        self.most = max(self.most, self.unread)
        return _SpyRead(self, read, k), rng_state


class _SpyRead:
    def __init__(self, spy, read, k):
        self.spy, self.inner, self.k = spy, read, k

    def wait(self):
        self.inner.wait()

    def read(self):
        self.spy.events.append(("read", self.k))
        self.spy.unread -= 1
        return self.inner.read()


@pytest.mark.parametrize("in_flight", [2, 3])
def test_next_call_is_queued_before_the_last_is_read(monkeypatch, two_bands, in_flight):
    """Two bands of two chunks: each call k + 1 comes before call k's
    read, the reads keep the calls' order, and at most ``CALLS_IN_FLIGHT``
    calls are ever unread."""
    monkeypatch.setattr(rd, "CALLS_IN_FLIGHT", in_flight)
    r = _isobox()
    spy = _Spy(r._tile_call())
    rows, chunk = rd._band_plan(r.options, 1)
    assert (rows, chunk) == (8, 1)
    r._band_loop(spy, rows, chunk, None)
    calls = [i for i, (e, _) in enumerate(spy.events) if e == "call"]
    reads = [i for i, (e, _) in enumerate(spy.events) if e == "read"]
    assert len(calls) == len(reads) == 4
    assert [k for e, k in spy.events if e == "read"] == [0, 1, 2, 3]
    assert all(reads[k] > calls[k + 1] for k in range(3))
    assert spy.most == in_flight


@pytest.mark.parametrize("sharded", [False, True], ids=["one-device", "8-shards"])
@pytest.mark.parametrize("rng", ["parity", "counter"])
def test_image_equals_a_loop_without_run_ahead(monkeypatch, two_bands, sharded, rng):
    """The image, bit for bit, of the loop that reads each call before the
    next: on one device two bands of two 1-sample calls; over 8 shards of
    the CPU two 8-row bands (parity: one call a band; counter: two)."""
    kw = dict(rng=rng)
    if sharded:
        monkeypatch.setattr(Renderer, "_shard_devices", lambda self: CPU8)
        monkeypatch.setattr(rd, "LANES_PER_PASS", 32)  # 8-row bands of one row a shard
        kw["shard"] = "auto"
    images = {}
    for in_flight in (1, 2):
        monkeypatch.setattr(rd, "CALLS_IN_FLIGHT", in_flight)
        r = _isobox(**kw)
        images[in_flight] = r.render()
        calls = timing.recorder.renders()[-1].counts["dispatch" if sharded else "tile_call"]
        assert calls == (2 if sharded and rng == "parity" else 4)
    np.testing.assert_array_equal(images[2], images[1])


def test_checkpoint_after_the_first_read_resumes_bit_equal(tmp_path, monkeypatch, two_bands):
    """A parity render stopped after its first checkpoint: the file holds
    what the loop without run-ahead writes after its first call (the first
    band's first sample and its RNG words, read behind that call), and the
    render resumed from it equals the uninterrupted one bit for bit."""
    mono = _isobox().render()
    real_save = Renderer._save_checkpoint

    def stop(path, *args):
        real_save(path, *args)
        raise KeyboardInterrupt

    monkeypatch.setattr(Renderer, "_save_checkpoint", staticmethod(stop))
    saved = {}
    for in_flight in (1, 2):
        monkeypatch.setattr(rd, "CALLS_IN_FLIGHT", in_flight)
        ck = str(tmp_path / f"in_flight_{in_flight}.npz")
        with pytest.raises(KeyboardInterrupt):
            _isobox().render(checkpoint_path=ck)
        saved[in_flight] = dict(np.load(ck, allow_pickle=True))
    assert saved[2].keys() == saved[1].keys()
    for key, value in saved[1].items():
        if key == "rng":
            assert len(value) == len(saved[2][key]) == 1
            np.testing.assert_array_equal(saved[2][key][0], value[0])
        else:
            np.testing.assert_array_equal(saved[2][key], value)
    assert saved[2]["done"].tolist() == [1] and saved[2]["row_ids"].tolist() == [0]
    monkeypatch.setattr(Renderer, "_save_checkpoint", staticmethod(real_save))
    ck = str(tmp_path / "in_flight_2.npz")
    resumed = _isobox().render(checkpoint_path=ck)
    assert not os.path.exists(ck)
    np.testing.assert_array_equal(resumed, mono)


@pytest.mark.parametrize("in_flight,bands,ahead", [(2, True, 3), (3, True, 3), (1, True, 0),
                                                   (2, False, 0)])
def test_calls_ahead_counts_every_call_but_the_first(monkeypatch, in_flight, bands, ahead):
    """"calls_ahead" in the render's counts (and the CLI's report): every
    call but the first of a render of four calls; none without run-ahead,
    or in a render of one call."""
    monkeypatch.setattr(rd, "CALLS_IN_FLIGHT", in_flight)
    if bands:
        monkeypatch.setattr(rd, "_auto_row_chunk", lambda width: 8)
    r = _isobox(sample_chunk=1 if bands else 0)
    r.render()
    rec = timing.recorder.renders()[-1]
    assert rec.counts["tile_call"] == (4 if bands else 1)
    assert rec.counts.get("calls_ahead", 0) == ahead
    assert f"calls queued ahead of an unread call: {ahead}" in r.timer.report()
