"""Wrappers the harness installs on the port's module attributes for a
block, and takes off after it: nothing inside the program changes.

Both callers of a tile render look the tile function up at call time
(``Renderer._beauty_fn`` in renderer.py, ``_beauty_fn`` in
parallel/sharding.py), and the sharded render looks up
``dispatch_cells`` and ``combine_cells`` at call time too, so a wrapper on
the module attribute sees every call on every card.

- ``WarmShapes``: the first tile call of each (card, call shape) runs,
  which captures its graph and replays it; later calls of a shape return
  zeros at once. One render under it warms every shape the render uses.
- ``Spans``: each tile call's host time, with a CUDA event on its card
  before and after it; each ``dispatch_cells`` call (a band) and each
  ``combine_cells`` call's host time.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch

from .record import Span

PORT = "complex_materials_renderer_tpu_torch"
TILE_FUNCS = (("render.megarender", "render_beauty_mega"), ("render.integrator", "render_beauty"))


class _Patched:
    """Module attributes replaced inside the block."""

    def __init__(self):
        self.saved = []

    def patch(self, module: str, attr: str, make):
        mod = importlib.import_module(f"{PORT}.{module}")
        real = getattr(mod, attr)
        self.saved.append((mod, attr, real))
        setattr(mod, attr, make(real))

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self.saved):
            setattr(mod, attr, real)
        self.saved = []
        return False


def _shape(args) -> tuple:
    """(card, (width, rows, samples)) of a tile call's positional
    arguments (camera, scene, accel, lights, resolution, num_samples)."""
    dev = args[2].device
    w, h = args[4]
    return dev, (int(w), int(h), int(args[5]))


class WarmShapes(_Patched):
    def __enter__(self):
        seen = set()

        def make(real):
            def call(*args, **kw):
                dev, shape = _shape(args)
                if (str(dev), shape) not in seen:
                    seen.add((str(dev), shape))
                    return real(*args, **kw)
                img = torch.zeros((shape[1], shape[0], 3), dtype=torch.float32, device=dev)
                if kw.get("return_rng"):
                    return img, torch.zeros((shape[0] * shape[1],), dtype=torch.int64, device=dev)
                return img
            return call

        for module, attr in TILE_FUNCS:
            self.patch(module, attr, make)
        self.shapes = seen
        return self


class Spans(_Patched):
    """Spans of the window's tile calls, bands and combines."""

    def __init__(self, cards):
        super().__init__()
        self.cards = list(cards)
        self.cuda = torch.cuda.is_available() and bool(self.cards)
        self.raw, self.dispatch_s, self.combine_s = [], [], []
        self.band = -1
        self.render = 0  # the window's render under way, set by its loop

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self):
        if self.cuda:
            self.origin = {}
            for c in self.cards:
                with torch.cuda.device(c):
                    self.origin[c] = self._event()

        def tile(real):
            def call(*args, **kw):
                dev, shape = _shape(args)
                on_card = self.cuda and dev.type == "cuda"
                with torch.cuda.device(dev) if on_card else contextlib.nullcontext():
                    start = self._event() if on_card else None
                    t0 = time.perf_counter()
                    out = real(*args, **kw)
                    host = time.perf_counter() - t0
                    end = self._event() if on_card else None
                self.raw.append((dev.index if on_card else -1, shape, self.band, self.render, host,
                                 start, end))
                return out
            return call

        def dispatch(real):
            def call(*args, **kw):
                self.band += 1
                t0 = time.perf_counter()
                out = real(*args, **kw)
                self.dispatch_s.append(time.perf_counter() - t0)
                return out
            return call

        def combine(real):
            def call(*args, **kw):
                t0 = time.perf_counter()
                out = real(*args, **kw)
                self.combine_s.append(time.perf_counter() - t0)
                return out
            return call

        for module, attr in TILE_FUNCS:
            self.patch(module, attr, tile)
        self.patch("parallel.sharding", "dispatch_cells", dispatch)
        self.patch("parallel.sharding", "combine_cells", combine)
        return self

    def spans(self) -> list:
        """The tile calls as ``Span``s, their card times read from the events
        (each card synchronised first)."""
        if self.cuda:
            for c in self.cards:
                torch.cuda.synchronize(c)
        out = []
        for card, shape, band, render, host, start, end in self.raw:
            if start is None:
                out.append(Span(card, shape, band, render, host, float("nan"), float("nan")))
                continue
            out.append(Span(card, shape, band, render, host,
                            self.origin[card].elapsed_time(start) / 1e3,
                            start.elapsed_time(end) / 1e3))
        return out
