"""The port's recorder: named spans on the host clock, and the cards'
counters, read on one clock.

The reference prints exactly two numbers, "CPU setup time" and "GPU render
time" (main.cpp:408-410, with command recording miscounted as GPU time —
SURVEY §5). The port records instead, always and in one place
(``recorder``):

- host spans (``Recorder.span``, ``PhaseTimer.phase``): a name, a start and
  an end on ``time.perf_counter``, the span it nests in and the render it
  belongs to. Each ``Renderer.render()`` is a root span, "render"
  (``Recorder.render``); inside it, each band and sample chunk of the
  single-device loop has a "tile_call" (host time in the tile function),
  a "band_wait" (the host queues the band's copy behind the call and
  waits for the call's end on the card), a "band_read" (the wait for that
  copy: the band's copy to the host, which the card starts at the call's
  end with no round trip through the host) and a
  "band_accumulate" (the scale-and-add, and the checkpoint's save); a
  render over several cards has "dispatch" and "combine" in place of
  "tile_call". The spans of the latest ``SPAN_RENDERS`` renders are kept.
- one ``RenderRecord`` a render (the latest ``RENDERS``): its span totals
  by name, and on each device it ran on a snapshot of that device's
  counter block (kernels/pass_control.py ``device_counts``: the K1 and
  control launches, each site's visits, K1 launches, live and covered
  lanes and device nanoseconds, the ring of call intervals). The snapshot
  is a clone queued on the device's stream at the render's end, with no
  host synchronise; it is read to the host when the record is read.
- one ``Calibration`` a card, measured at its first render: the offset of
  the card's %globaltimer from ``time.perf_counter`` and its error, so that
  the calls' intervals and the host spans share one clock
  (``Recorder.calls``, ``Recorder.idle_by_span``).

A site's segment runs from one control launch's entry on the card to the
next one's (or a call's end stamp), so it holds the control launch that
opens it. torch.profiler does not see the kernels inside a CUDA graph's
conditional bodies, where most of a render's work runs on the card
(ROADMAP P13): these segments are the device-side view.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, NamedTuple, Optional

import torch

SPAN_RENDERS = 64  # the latest renders whose spans are kept
RENDERS = 2048  # the latest renders whose records (totals, snapshots) are kept
ROOT = "render"  # the name of a render's root span


@dataclasses.dataclass
class Span:
    name: str
    start: float  # time.perf_counter
    end: float
    parent: int  # the enclosing span's index in its render's spans, -1 for none
    render: Optional[int]  # the id of the render it belongs to, None outside one


class Calibration(NamedTuple):
    """A card's %globaltimer against ``time.perf_counter``: card ns =
    host seconds x 1e9 + ``offset_ns``, to within ``error_s``."""

    offset_ns: float
    error_s: float

    def to_host(self, ns) -> float:
        return (ns - self.offset_ns) / 1e9


def calibrate(launch, sync, read, clock=time.perf_counter, tries: int = 5) -> Calibration:
    """The offset of a device clock from ``clock``: ``sync()``, read the
    host clock, ``launch()`` a stamp, ``sync()``, read the host clock again;
    the stamp (``read()``) lies between the two reads, so the error is half
    their distance. The try of the smallest error of ``tries`` is kept."""
    best = None
    for _ in range(tries):
        sync()
        h0 = clock()
        launch()
        sync()
        h1 = clock()
        cal = Calibration(read() - 1e9 * (h0 + h1) / 2, (h1 - h0) / 2)
        if best is None or cal.error_s < best.error_s:
            best = cal
    return best


class RenderRecord:
    """What the recorder keeps of one render."""

    def __init__(self, rid: int):
        self.id = rid
        self.spans: Optional[list] = []  # None once older than the latest SPAN_RENDERS
        self.totals: Dict[str, float] = {}  # seconds of its spans by name
        self.counts: Dict[str, int] = {}  # its spans by name
        self._blocks: dict = {}  # device -> counter block snapshot (a tensor until read)

    @property
    def devices(self) -> list:
        return list(self._blocks)

    def block(self, device) -> Optional[list]:
        """The snapshot of ``device``'s counter block at this render's end,
        on the host (read at the first call), or None."""
        key = str(device)
        b = self._blocks.get(key)
        if isinstance(b, torch.Tensor):
            b = self._blocks[key] = b.tolist()
        return b


class _Open:
    """The context of one span (``Recorder.span``): a class, not a
    generator, since a render opens several a band."""

    __slots__ = ("recorder", "name", "totals", "span")

    def __init__(self, recorder: "Recorder", name: str, totals: Optional[dict]):
        self.recorder, self.name, self.totals = recorder, name, totals

    def __enter__(self) -> Span:
        r = self.recorder
        rec = r._current
        self.span = s = Span(self.name, time.perf_counter(), 0.0,
                             r._stack[-1] if r._stack else -1, rec.id if rec is not None else None)
        if rec is not None:
            rec.spans.append(s)
            r._stack.append(len(rec.spans) - 1)
        return s

    def __exit__(self, *exc) -> bool:
        s, name = self.span, self.name
        s.end = time.perf_counter()
        dt = s.end - s.start
        rec = self.recorder._current
        if s.render is not None and rec is not None:
            self.recorder._stack.pop()
            rec.totals[name] = rec.totals.get(name, 0.0) + dt
            rec.counts[name] = rec.counts.get(name, 0) + 1
        if self.totals is not None:
            self.totals[name] = self.totals.get(name, 0.0) + dt
        return False


class _Render:
    """The context of one render (``Recorder.render``)."""

    __slots__ = ("recorder", "devices", "totals", "ids", "rec", "root")

    def __init__(self, recorder: "Recorder", devices, totals: Optional[dict],
                 ids: Optional[list]):
        self.recorder, self.devices, self.totals, self.ids = recorder, devices, totals, ids
        self.rec = None

    def __enter__(self) -> RenderRecord:
        r = self.recorder
        if r._current is not None:
            return r._current
        from ..kernels.pass_control import _device_key

        self.devices = devices = list(dict.fromkeys(_device_key(d) for d in self.devices))
        for d in devices:
            if d.startswith("cuda") and d not in r.calibrations:
                r._calibrate(d)
        self.rec = rec = RenderRecord(r._next_id)
        r._next_id += 1
        r._records.append(rec)
        if len(r._records) > r.span_renders:
            r._records[-r.span_renders - 1].spans = None
        if self.ids is not None:
            self.ids.append(rec.id)
            del self.ids[:-SPAN_RENDERS]
        r._current, r._stack = rec, []
        self.root = r.span(ROOT, self.totals)
        self.root.__enter__()
        return rec

    def __exit__(self, *exc) -> bool:
        if self.rec is None:
            return False
        r = self.recorder
        try:
            self.root.__exit__(*exc)
        finally:
            r._current, r._stack = None, []
            r._snapshot(self.rec, self.devices)
        return False


class Recorder:
    """The spans and render records of this process (``recorder``)."""

    def __init__(self, renders: int = RENDERS, span_renders: int = SPAN_RENDERS):
        self._records: collections.deque = collections.deque(maxlen=renders)
        self.span_renders = span_renders
        self.calibrations: Dict[str, Calibration] = {}
        self._current: Optional[RenderRecord] = None
        self._stack: list = []  # indices of the open spans in the current render
        self._next_id = 0

    @property
    def rendering(self) -> bool:
        return self._current is not None

    def span(self, name: str, totals: Optional[dict] = None) -> "_Open":
        """A span around a ``with`` block, kept in the render under way if
        there is one (a span outside a render is timed, not kept); its
        seconds are also added to ``totals[name]`` when given."""
        return _Open(self, name, totals)

    def render(self, devices=(), totals: Optional[dict] = None,
               ids: Optional[list] = None) -> "_Render":
        """A render's root span and record, for a ``with`` block (its
        seconds also added to ``totals``, its id appended to ``ids``); at
        its end, a snapshot of each of ``devices``' counter blocks. Inside a
        render it adds nothing."""
        return _Render(self, devices, totals, ids)

    def _snapshot(self, rec: RenderRecord, devices) -> None:
        from ..kernels import pass_control as pc

        n = pc.CNT_SITES + len(pc.site_labels()) * pc.SITE_FIELDS
        for d in devices:  # each clone is queued on its own card's current stream
            rec._blocks[d] = pc.device_counts(d)[:n].clone()

    def _calibrate(self, device: str) -> None:
        from ..kernels import pass_control as pc

        block = pc.device_counts(device)
        self.calibrations[device] = calibrate(
            lambda: pc.stamp(device, pc.STAMP_CALIBRATE), lambda: torch.cuda.synchronize(device),
            lambda: int(block[pc.CNT_CALIBRATE]))

    def renders(self) -> list:
        """The kept render records, oldest first."""
        return list(self._records)

    def record(self, rid: int) -> Optional[RenderRecord]:
        return next((r for r in self._records if r.id == rid), None)

    def previous(self, rec: RenderRecord, device) -> Optional[RenderRecord]:
        """The latest kept record before ``rec`` with a snapshot of ``device``."""
        key = str(device)
        best = None
        for r in self._records:
            if r is rec:
                break
            if key in r._blocks:
                best = r
        return best

    def site_delta(self, first: Optional[RenderRecord], last: RenderRecord, device) -> dict:
        """{label: [visits, K1 launches, live lanes, covered lanes, ns]} on
        ``device`` between the snapshots of ``first`` (None: from zero) and
        ``last``."""
        from ..kernels import pass_control as pc

        b = last.block(device) or []
        a = (first.block(device) if first is not None else None) or []
        a = a + [0] * (len(b) - len(a))
        return pc.site_counts([y - x for x, y in zip(a, b)])

    def segments(self, first: Optional[RenderRecord], last: RenderRecord) -> dict:
        """{'k1' | 'sort' | 'other': {'visits', 'k1' (K1 launches that ran),
        'live' (their live lanes), 'lanes' (the lanes they covered), 'ns'}}
        summed over the cards between two snapshots."""
        from ..kernels import pass_control as pc

        keys = ("visits", "k1", "live", "lanes", "ns")
        out = {k: dict.fromkeys(keys, 0) for k in ("k1", "sort", "other")}
        kinds = {site.label: site.kind for site in pc.sites()}
        for d in last.devices:
            if d.startswith("cuda"):
                for label, fields in self.site_delta(first, last, d).items():
                    acc = out[kinds[label]]
                    for k, v in zip(keys, fields):
                        acc[k] += v
        return out

    def calls(self, rec: RenderRecord, device) -> list:
        """The (start, end) of ``rec``'s calls on the card ``device``, on the
        host clock, as far as its snapshot's ring holds them."""
        from ..kernels import pass_control as pc

        cal = self.calibrations.get(str(device))
        block = rec.block(device)
        if cal is None or block is None:
            return []
        prev = self.previous(rec, device)
        since = prev.block(device)[pc.CNT_CALLS] if prev is not None else 0
        return [(cal.to_host(a), cal.to_host(b)) for a, b in pc.call_intervals(block, since)]

    def idle_by_span(self, records) -> dict:
        """The idle of each card between consecutive calls of ``records``
        (within a render and from one render to the next), split by the
        renders' top-level host spans that overlap it: {span name | 'no
        span' (inside a render, outside its spans) | 'outside render()':
        seconds}, a mean over the cards."""
        out: dict = {}
        tops = [s for rec in records for s in rec.spans or () if s.parent == 0]
        roots = [s for rec in records for s in rec.spans or () if s.parent == -1]
        cards = {d for rec in records for d in rec.devices}
        n_cards = 0
        for d in sorted(cards):
            calls = sorted(c for rec in records for c in self.calls(rec, d))
            n_cards += bool(calls)
            for (_, e0), (s1, _) in zip(calls, calls[1:]):
                if s1 <= e0:
                    continue
                overlap = lambda s: max(0.0, min(s.end, s1) - max(s.start, e0))  # noqa: E731
                spanned = 0.0
                for s in tops:
                    o = overlap(s)
                    if o > 0:
                        out[s.name] = out.get(s.name, 0.0) + o
                        spanned += o
                inside = sum(overlap(s) for s in roots)
                out["no span"] = out.get("no span", 0.0) + max(0.0, inside - spanned)
                out["outside render()"] = out.get("outside render()", 0.0) + (s1 - e0 - inside)
        return {k: v / max(1, n_cards) for k, v in out.items() if v > 0}

    def report(self, rec: RenderRecord) -> list:
        """Lines of ``rec``: its top-level spans, the cards' idle between its
        calls by host span, and on each device its segments (K1 by width,
        sorts, the rest) and K1's lane occupancy."""
        from ..kernels import pass_control as pc

        root = rec.totals.get(ROOT, 0.0)
        spans = ", ".join(f"{name} {rec.counts[name]} x {1e3 * t / rec.counts[name]:.3f} ms"
                          for name, t in rec.totals.items() if name != ROOT)
        lines = [f"render {rec.id}: {1e3 * root:.1f} ms; host spans: {spans or 'none'}"]
        idle = self.idle_by_span([rec])
        if idle:
            by_span = sorted(idle.items(), key=lambda x: -x[1])
            lines.append("  idle between calls on the card, by host span: "
                         + ", ".join(f"{name} {1e3 * t:.3f} ms" for name, t in by_span))
        info = {site.label: site for site in pc.sites()}
        for d in rec.devices:
            prev = self.previous(rec, d)
            sites = self.site_delta(prev, rec, d)
            block, before = rec.block(d), prev.block(d) if prev else [0] * pc.CNT_HEAD
            calls = block[pc.CNT_CALLS] - before[pc.CNT_CALLS]
            call_ns = block[pc.CNT_CALL_NS] - before[pc.CNT_CALL_NS]
            by_kind = {"k1": 0, "sort": 0, "other": 0}
            widths: dict = {}
            live = lanes = 0
            for label, (_, k1, lv, ln, ns) in sites.items():
                site = info[label]
                by_kind[site.kind] += ns
                if site.kind == "k1":
                    w = widths.setdefault(site.width, [0, 0])
                    w[0] += ns
                    w[1] += k1
                    live, lanes = live + lv, lanes + ln
            occ = f"{100.0 * live / lanes:.1f}%" if lanes else "no launch"
            k1 = ", ".join(f"width {w}: {ns / 1e6:.2f} ms in {n} launches"
                           for w, (ns, n) in sorted(widths.items(), key=lambda x: -(x[0] or 0)))
            if d.startswith("cuda"):
                lines.append(
                    f"  {d}: {calls} calls, {call_ns / 1e6:.2f} ms on the card: K1 "
                    f"{by_kind['k1'] / 1e6:.2f} ms ({k1 or 'none'}), sorts "
                    f"{by_kind['sort'] / 1e6:.2f} ms, the rest {by_kind['other'] / 1e6:.2f} ms; "
                    f"K1 lane occupancy {occ}")
            else:
                n = sum(v[1] for v in widths.values())
                lines.append(f"  {d}: K1 {n} launches (no device time off the card); "
                             f"K1 lane occupancy {occ}")
        return lines


recorder = Recorder()  # the process's one recorder


class PhaseTimer:
    """Per-name totals of one owner's spans (``Renderer.timer``): each
    ``phase`` and ``render`` is also a span of ``recorder``."""

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}
        self._renders: list = []  # ids of the renders this timer made

    def phase(self, name: str) -> "_Open":
        return recorder.span(name, self._elapsed)

    def render(self, devices=()) -> "_Render":
        """A render's root span (``Recorder.render``), counted in the
        "render" total; inside another render it adds nothing."""
        return recorder.render(devices, self._elapsed, self._renders)

    def items(self):
        return self._elapsed.items()

    def report(self) -> str:
        lines = [f"{name} time: {seconds * 1e3:.1f} ms" for name, seconds in self._elapsed.items()]
        for rid in self._renders:
            rec = recorder.record(rid)
            if rec is not None and rec.spans is not None:
                lines += recorder.report(rec)
        return "\n".join(lines)
