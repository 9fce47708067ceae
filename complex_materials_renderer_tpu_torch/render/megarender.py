"""Beauty-pass loop around the path-tracing megakernel (kernels/megakernel.py).

Counterpart of complex_materials_renderer_tpu/render/megarender.py
(``render_beauty_mega`` :339, ``render_samples_mega`` :591,
``_make_advance`` :213). The bounce loop runs as a short PHASE SCHEDULE of
kernel calls:

- phase 1 advances every lane a bounce or two in one kernel call;
- between phases the wavefront is compacted (live lanes first, by a stable
  sort on a coherence key) and shrunk, banking the dropped dead lanes'
  radiance and RNG state;
- the final phase runs the stragglers to termination.

The dynamic modes (``all``, ``hybrid``) keep the full lane arrays and bound
each kernel call to the live leading blocks (``live_blocks``). Lanes start
in 32x32 pixel tiles so neighbouring lanes trace neighbouring pixels.

Per-lane RNG streams are those of the JAX package (same masked PCG draws,
same counter seeds, same ld dimensions), so the images agree with it up to
float rounding. ``render_pixels_mega``, which the JAX package lacks, runs
the uniform parity pass over chosen pixels: the per-pixel check of a
parity frame, which ``render_samples_mega`` (stateless modes only) cannot
serve. The per-pass kernel is ``trace_paths_mega``, or with
``trace_engine`` binned or pair the wavefront bounce loop over the binned
tracer (render/binnedrender.py) or the pair sweep (render/pairrender.py).

As the JAX package runs a tile render as one ``jit`` program, the pass
loop is a fixed plan of steps (``PassPlan``: sorts, scatters, K1 and the
pass control kernel of kernels/pass_control.py, which keeps the loop
counts, ``live_blocks`` and ``dim0`` on the device). On the card each
engine captures each call shape's steps once as a CUDA graph
(``CallGraph``), its loops conditional nodes (the binned and pair
engines' own loops and guards nested in them), and replays it: no value
goes to the host between a call's first launch and its last. On the CPU,
and on the card when asked (``executor='eager'``), ``HostLoop`` runs the
same steps and reads the loop conditions on the host.
"""

from __future__ import annotations

import dataclasses
import os
import time
import weakref
from collections import OrderedDict
from functools import lru_cache, partial
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import partition as pt
from ..kernels import pass_control as pc
from ..kernels.cluster_grid import DeviceClusterGrid
from ..kernels.pass_control import GraphCapture, HostLoop
from ..kernels.megakernel import (
    BLOCK,
    DRAWS_PER_BOUNCE,
    MegaState,
    fresh_state,
    pack_media,
    pack_misc,
    plain_context,
    trace_paths_mega,
)
from ..kernels.megakernel import prepare as prepare_megakernel
from ..ops import rng as rng_ops
from ..ops.camera import Camera, generate_rays
from ..ops.medium import media_tensors
from .hitinfo import Lights, SceneArrays

TILE = 32  # pixels per tile side; 32x32 = one 1024-lane block
# Widest wave one step of the counter/ld sample loop runs, read once at
# import from CMR_STEP_LANES as the JAX package does (megarender.py:47).
STEP_LANES = int(os.environ.get("CMR_STEP_LANES", 1 << 16))


@lru_cache(maxsize=32)
def _tile_perm(width: int, height: int):
    """Static lane order: row-major pixels regrouped into 32x32 tiles.
    Returns (perm, inv) int32 index arrays of length width*height."""
    idx = np.arange(width * height, dtype=np.int32).reshape(height, width)
    parts = []
    for ty in range(0, height, TILE):
        for tx in range(0, width, TILE):
            parts.append(idx[ty : ty + TILE, tx : tx + TILE].reshape(-1))
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def _phase_schedule(rp: int, max_depth: int, schedule: str = ""):
    """(lane_width, bounce_cap) pairs: the wavefront shrinks as paths die
    and the last phase runs to termination (cap = max_depth).
    ``schedule`` = "div:cap,div:cap,..." overrides the default widths
    (div = lane-width divisor; the renderer reads CMR_MEGA_SCHED)."""
    if schedule:
        raw = [
            (rp // int(d), int(c))
            for d, c in (p.split(":") for p in schedule.split(","))
        ]
    else:
        raw = [
            (rp, 1), (rp // 2, 1), (rp // 4, 1), (rp // 8, 1),
            (rp // 16, 2), (rp // 32, 2), (rp // 64, max_depth),
        ]
    sched = []
    for w, cap in raw:
        w = max(BLOCK, -(-w // BLOCK) * BLOCK)
        w = min(w, rp)
        if sched and w >= sched[-1][0]:
            continue
        sched.append((w, cap))
    if not sched:
        sched = [(rp, max_depth)]
    sched[-1] = (sched[-1][0], max_depth)
    return sched


def _resolve_dynamic(schedule_mode: str, grid) -> str:
    """off = static per-width phase schedule; hybrid = dynamic
    ``live_blocks`` with 8 per-bounce sorts then a to-death tail; all =
    sort every bounce to death. auto picks by scene size."""
    dynamic = schedule_mode
    if dynamic == "1":
        dynamic = "all"
    if dynamic == "auto":
        dynamic = "all" if grid.num_clusters > 128 else "off"
    if dynamic not in ("off", "all", "hybrid"):
        raise ValueError(f"schedule mode must be auto|off|all|hybrid, got {schedule_mode!r}")
    return dynamic


@dataclasses.dataclass(frozen=True)
class PassKnobs:
    """The tile pass's knobs, each default stated here once. The entry
    points take them as keywords (an unknown name raises ``TypeError``)
    and the record is the knob part of each call shape's graph key.

    ``schedule_mode``: auto | off | hybrid | all (``_resolve_dynamic``);
    ``schedule``: the phase widths (``_phase_schedule``); ``sortkey``: dir |
    pos; ``debug``: the megakernel's CMR_MEGA_DEBUG ablations
    (``kernels.megakernel.ABLATIONS``), which the other engines ignore;
    ``trace_engine`` swaps the per-pass kernel: mega | binned (with
    ``binned_list`` and ``binned_cap``) | pair."""

    max_depth: int = 32
    rr_depth: int = 16
    nee_max_media: int = 4
    rng_mode: str = "parity"
    tir: str = "reflect"
    direct: str = "scatter"
    schedule_mode: str = "auto"
    schedule: str = ""
    sortkey: str = "dir"
    debug: str = ""
    trace_engine: str = "mega"
    binned_list: int = 8
    binned_cap: int = 12


def _make_kern(grid, scene, lights, media9, misc, k: PassKnobs):
    """The per-pass bounce kernel of the selected trace engine
    (megarender.py:166-210): the megakernel (its CMR_MEGA_DEBUG ablations
    ``debug``), or the wavefront bounce loop over the binned or the pair
    tracer, which ignore ``debug`` as in the JAX package. Each updates the
    state in place."""
    ld = k.rng_mode == "ld"
    if k.trace_engine == "binned":
        from .binnedrender import make_binned_kern

        return make_binned_kern(grid, scene, lights, media9, max_depth=k.max_depth,
                                rr_depth=k.rr_depth, nee_max_media=k.nee_max_media, tir=k.tir,
                                list_len=k.binned_list, cap_iters=k.binned_cap, direct=k.direct,
                                ld=ld)
    if k.trace_engine == "pair":
        from .pairrender import make_pair_kern

        return make_pair_kern(grid, scene, lights, media9, max_depth=k.max_depth,
                              rr_depth=k.rr_depth, nee_max_media=k.nee_max_media, tir=k.tir,
                              direct=k.direct, ld=ld)
    if k.trace_engine != "mega":
        raise ValueError(f"trace engine must be mega|binned|pair, got {k.trace_engine!r}")
    kw = dict(background=scene.background, max_depth=k.max_depth, rr_depth=k.rr_depth,
              nee_max_media=k.nee_max_media, tir_kill=(k.tir == "kill"),
              analytic_direct=(k.direct == "analytic"), ld=ld, debug=k.debug)
    # The plain version's constants, read to the host once, not per call.
    plain = plain_context(grid, media9, misc, **kw) if grid.device.type == "cpu" else None
    kern = partial(trace_paths_mega, grid, media9, misc, plain=plain, **kw)
    kern.is_k1 = True  # its calls count as K1 launches
    kern.prepare = partial(prepare_megakernel, nee_max_media=k.nee_max_media, debug=k.debug)
    return kern


class PassPlan:
    """The wavefront advance (``_make_advance``) as a fixed sequence of
    steps: sorts (``kernels.partition``, the JAX ``_partition_live``) with
    their bank scatters, K1 calls at a width and bounce cap, control
    launches (``kernels.pass_control``), the spill loop ``while (n_alive >
    next_w) { K1; control }``, and in the dynamic modes ``while any alive {
    sort; control; K1; control }`` (all) or eight guarded sorted bounces and
    a tail (hybrid).

    Calling it runs ``state`` to termination and returns (radiance, rng)
    banked by lane id: ``bank_rows`` real rows (one more spill row takes the
    pad lanes). ``dim0`` is the ld-mode Sobol dimension base; it lives in
    the control block, which advances it by 8 * max_iters after each K1
    call that ran. The executor ``ex`` runs the steps: ``HostLoop`` (the
    default for the state's device) or ``GraphCapture``.

    Each control launch names the step that ends there (its site,
    ``kernels.pass_control.Site``): "pass head" (the camera rays and the
    state's copies), the K1 sites "K1 at width w, cap c, phase i", "K1
    spill at phase i, width w", "K1 dynamic bounce, width w" and "K1 hybrid
    tail, width w", the sort sites "sort before phase i" (the sort, the
    bank scatter and the shrink) and "sort of a dynamic bounce", and
    "dynamic guard"; the binned and pair engines' bounce kernels take
    "bounce" where K1 takes "K1", and their sites are not K1's."""

    def __init__(self, kern, dynamic, sched, scene, sortkey, max_depth):
        self.kern, self.dynamic, self.sched = kern, dynamic, sched
        self.scene, self.sortkey, self.max_depth = scene, sortkey, max_depth
        # Every engine's kernel reads the control block; only K1's calls
        # count as K1 launches.
        is_k1 = getattr(kern, "is_k1", False)
        self.after = pc.AFTER_K1 | (0 if is_k1 else pc.NOT_K1)
        self.kname, self.kkind = ("K1", "k1") if is_k1 else ("bounce", "other")
        self.scratch = None  # the sorts' on the card (kernels.partition.Scratch)

    def _kern_site(self, label: str, width: int) -> pc.Site:
        """The site of the control launch after the kernel at ``width``."""
        return pc.Site(f"{self.kname} {label}", self.kkind, width)

    def prepare(self, device, lanes: int) -> None:
        """Build and allocate, before a capture, what the steps launch."""
        from ..kernels import build

        build.build([("pass_control",), ("partition",)])
        self.scratch = pt.Scratch(device, lanes)
        self.kern.prepare(device, lanes)

    def __call__(self, state: MegaState, lane: torch.Tensor, bank_rows: int, dim0: int = 0,
                 ex=None):
        ex = pc.executor(state.org.device, ex)
        dev = state.org.device
        # The steps update the state, the lanes and the banks in place.
        state = MegaState(*(x.clone() for x in state))
        lane = lane.clone()
        rad_bank = torch.zeros((bank_rows + 1, 3), dtype=torch.float32, device=dev)
        rng_bank = torch.zeros((bank_rows + 1,), dtype=torch.int64, device=dev)
        ctrl = pc.new_ctrl(dev)
        ex.control(state.alive, ctrl, pc.INIT, site="pass head", dim0=int(dim0))
        if self.dynamic != "off":
            self._dynamic(ex, state, lane, ctrl)
        else:
            state, lane = self._phases(ex, state, lane, ctrl, rad_bank, rng_bank)
        rad_bank[lane] = state.rad
        rng_bank[lane] = state.rng
        return rad_bank[:bank_rows], rng_bank[:bank_rows]

    def _sort(self, state, lane, banks=None):
        """Sort the lanes in place (a graph finds them at the same addresses
        on every iteration), banking the tail with ``banks``; on the card in
        the scratch of ``prepare``."""
        pt.partition(state, lane, self.scene.world_lo, self.scene.world_hi, self.sortkey, banks,
                     scratch=self.scratch)

    def _sorted_bounce(self, ex, state, lane, ctrl, cap):
        """Sort, bound K1 to the live leading blocks, run ``cap`` bounces."""
        self._sort(state, lane)
        ex.control(state.alive, ctrl, pc.SET_LIVE,
                   site=pc.Site("sort of a dynamic bounce", "sort"))
        ex.k1(self.kern, state, cap, ctrl)

    def _dynamic(self, ex, state, lane, ctrl):
        # The lanes keep their full width; K1 runs the live leading blocks.
        w = state.alive.shape[0]
        bounce_site = self._kern_site(f"dynamic bounce, width {w}", w)
        if self.dynamic == "all":
            def bounce(h):
                self._sorted_bounce(ex, state, lane, ctrl, 1)
                ex.control(state.alive, ctrl, self.after | pc.COND, site=bounce_site,
                           advance=DRAWS_PER_BOUNCE, handle=h)

            h = ex.cond()
            ex.control(state.alive, ctrl, pc.COND, site="dynamic guard", handle=h)
            ex.loop(h, ctrl, bounce)
            return

        def guarded(h):
            self._sorted_bounce(ex, state, lane, ctrl, 1)
            ex.control(state.alive, ctrl, self.after, site=bounce_site, advance=DRAWS_PER_BOUNCE)

        for _ in range(8):  # hybrid: 8 guarded sorted bounces, then the tail
            h = ex.cond()
            ex.control(state.alive, ctrl, pc.COND, site="dynamic guard", handle=h)
            ex.guard(h, ctrl, guarded)
        self._sorted_bounce(ex, state, lane, ctrl, self.max_depth)
        ex.control(state.alive, ctrl, self.after,
                   site=self._kern_site(f"hybrid tail, width {w}", w),
                   advance=DRAWS_PER_BOUNCE * self.max_depth)

    def _phases(self, ex, state, lane, ctrl, rad_bank, rng_bank):
        for i, (w, cap) in enumerate(self.sched):
            if i > 0:
                # Shrink to this phase's width: live lanes first, bank the
                # dropped tail (all dead: the spill loop below made sure
                # that at most w lanes are alive).
                self._sort(state, lane, banks=(rad_bank, rng_bank, w))
                state = MegaState(*(x[:w] for x in state))
                lane = lane[:w]
                ex.control(state.alive, ctrl, pc.SET_FULL,
                           site=pc.Site(f"sort before phase {i}", "sort"))
            ex.k1(self.kern, state, cap, ctrl)
            advance = DRAWS_PER_BOUNCE * cap
            k1_site = self._kern_site(f"at width {w}, cap {cap}, phase {i}", w)
            if i + 1 == len(self.sched):
                ex.control(state.alive, ctrl, self.after, site=k1_site, advance=advance)
                continue
            # Paths that die slower than the schedule assumes keep bouncing
            # at this width until they fit the next one.
            next_w = self.sched[i + 1][0]
            spill_site = self._kern_site(f"spill at phase {i}, width {w}", w)

            def spill(h, state=state, cap=cap, advance=advance, next_w=next_w, site=spill_site):
                ex.k1(self.kern, state, cap, ctrl)
                ex.control(state.alive, ctrl, self.after | pc.COND, site=site, advance=advance,
                           threshold=next_w, handle=h)

            h = ex.cond()
            ex.control(state.alive, ctrl, self.after | pc.COND, site=k1_site, advance=advance,
                       threshold=next_w, handle=h)
            ex.loop(h, ctrl, spill)
        return state, lane


def _pass_plan(scene, grid, lights, step, k: PassKnobs) -> PassPlan:
    """The pass loop (the JAX ``_make_advance``) of passes ``step`` lanes
    wide over the selected engine's kernel, on the device of ``grid``: the
    dynamic mode or the static phase schedule of ``k``; the media and light
    rows come from the tables' ``PassCache``, uploaded once."""
    cache = pass_cache(scene, grid, lights)
    kern = _make_kern(grid, cache.wave_scene, lights, cache.media9, cache.misc, k)
    return PassPlan(kern, _resolve_dynamic(k.schedule_mode, grid),
                    _phase_schedule(step, k.max_depth, k.schedule), scene, k.sortkey, k.max_depth)


class PassCache:
    """What the tile renderers keep across the calls over one scene's
    tables: the media and light rows and the wavefront engine's scene with
    its media table on the device, uploaded once, and on the card the CUDA
    graph of each call shape (``graphs``; the tables stay referenced, since
    a graph reads them by address). ``grid`` is the accel: a cluster grid,
    or the wavefront engine's BVH."""

    def __init__(self, scene, grid, lights):
        self.tables = (scene, grid, lights)
        self.media9 = pack_media(scene.media, scene.scale, device=grid.device)
        self.misc = pack_misc(lights, scene.world_lo, scene.world_hi, device=grid.device)
        self.wave_scene = dataclasses.replace(scene, media=media_tensors(scene.media,
                                                                         grid.device))
        self.graphs: dict = {}


_CACHES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_RECENT: OrderedDict = OrderedDict()
CACHED_TABLES = 8  # table sets whose PassCache is kept, besides one a visible card


@lru_cache(maxsize=1)
def kept_tables() -> int:
    """How many of the most recently used table sets keep their
    ``PassCache``: CACHED_TABLES and one more a visible card, so that a
    sharded render (a copy of the tables a card, parallel/sharding.py)
    loses no card's graphs while it runs."""
    return CACHED_TABLES + (torch.cuda.device_count() if torch.cuda.is_available() else 0)


def pass_cache(scene, grid, lights) -> PassCache:
    """The ``PassCache`` of these tables (by identity): kept while a caller
    holds it (``Renderer`` does) or while it is one of the ``kept_tables()``
    most recently used."""
    key = (id(scene), id(grid), id(lights))
    cache = _CACHES.get(key)
    if cache is None:
        cache = _CACHES[key] = PassCache(scene, grid, lights)
    _RECENT[key] = cache
    _RECENT.move_to_end(key)
    while len(_RECENT) > kept_tables():
        _RECENT.popitem(last=False)
    return cache


def release(tables) -> None:
    """Let go of the kept ``PassCache`` of every table set that holds one of
    ``tables`` (what a caller holds stays)."""
    ids = {id(t) for t in tables}
    for key in [k for k in _RECENT if ids.intersection(k)]:
        del _RECENT[key]


class Capture(NamedTuple):
    key: tuple  # the call shape
    device: torch.device
    seconds: float


# Every graph captured in this process.
captures: list = []


_CAPTURE_STREAMS: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """The stream that graphs of ``device`` are captured on, made once a
    device (``torch.cuda.graph``'s default one lies on whichever card was
    current when it was made)."""
    device = torch.device(device)
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _CAPTURE_STREAMS[device]


class CallGraph:
    """One call shape of a tile renderer captured as a CUDA graph: the
    call's inputs are copied into static buffers, the graph replayed and its
    outputs copied out, all on the current stream of the graph's card,
    between a start and an end stamp (``pass_control.stamp``: the call's
    interval on the card's clock, and the tail after its last control
    launch). The capture runs ``program(ex, *inputs)`` once on the card's
    ``_capture_stream`` with a ``GraphCapture`` executor; a failed capture
    raises. It waits for nothing: unlike ``torch.cuda.graph`` it
    neither synchronises the card nor empties the allocator's cache (which
    frees memory on every card and so waits for each), so a capture on one
    card leaves the others working."""

    def __init__(self, key, program, inputs, device):
        # The program holds what its kernels read by address (the engines'
        # tables and packed rows): kept while the graph is.
        self.program = program
        self.inputs = [x.clone() for x in inputs]
        self.device = device
        self.ex = GraphCapture(device)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.device(device), torch.cuda.stream(_capture_stream(device)):
            self.graph.capture_begin(capture_error_mode="relaxed")
            try:
                self.outputs = program(self.ex, *self.inputs)
            finally:
                self.graph.capture_end()
        captures.append(Capture(key, torch.device(device), time.perf_counter() - t0))

    def __call__(self, inputs):
        pc.stamp(self.device, pc.STAMP_START)
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        out = tuple(o.clone() for o in self.outputs)
        pc.stamp(self.device, pc.STAMP_END)
        return out


def _execute(scene, grid, lights, prepare, key, program, inputs, executor: str, lanes: int):
    """Run a tile program: with ``executor='auto'`` as a CUDA graph on the
    card, on the CPU executor on the CPU; 'eager' asks for the eager
    executor (the card's comparison for the graph). ``prepare(device,
    lanes)`` builds and makes, on the card before a capture or an eager
    call, what the program launches and reads. No executor stands in for
    another that fails."""
    dev = grid.device
    if executor not in ("auto", "eager"):
        raise ValueError(f"executor must be auto|eager, got {executor!r}")
    if executor == "eager" or dev.type != "cuda":
        if dev.type == "cuda":
            prepare(dev, lanes)
        return program(HostLoop(dev, executor == "auto"), *inputs)
    cache = pass_cache(scene, grid, lights)
    call = cache.graphs.get(key)
    if call is None:
        rng_ops.sobol_table(dev)  # the ld draws' rows, read on the device
        prepare(dev, lanes)
        call = cache.graphs[key] = CallGraph(key, program, inputs, dev)
    return call(inputs)


def _tile_lanes(width, height, pixel_offset, row_offset, full_w, dev):
    """Pixel coordinates (R, 2) and linear frame indices (R,) of a tile's
    pixels in lane order (32x32 tiles), and the inverse permutation."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int64, device=dev),
        torch.arange(width, dtype=torch.int64, device=dev),
        indexing="ij",
    )
    pixel_xy = torch.stack(
        [xs.reshape(-1) + pixel_offset, ys.reshape(-1) + row_offset], dim=-1
    )
    linear = pixel_xy[:, 1] * full_w + pixel_xy[:, 0]
    perm, inv = _tile_perm_on(width, height, dev)
    return pixel_xy[perm], linear[perm], inv


_TILE_PERMS: dict = {}


def _tile_perm_on(width: int, height: int, dev):
    """``_tile_perm`` as int64 tensors on ``dev``, uploaded once a shape, so
    that a call of a shape seen before copies nothing from the host."""
    key = (width, height, str(dev))
    if key not in _TILE_PERMS:
        perm_np, inv_np = _tile_perm(width, height)
        _TILE_PERMS[key] = (torch.from_numpy(perm_np.astype(np.int64)).to(dev),
                            torch.from_numpy(inv_np.astype(np.int64)).to(dev))
    return _TILE_PERMS[key]


def _step_lanes(r: int, rng_mode: str) -> int:
    """Lanes of one pass. The stateless RNG modes walk (pixel-group,
    sample-chunk) steps of at most STEP_LANES lanes; parity carries a
    sequential per-pixel stream across samples and keeps step == tile
    (padded to whole blocks)."""
    rp = -(-r // BLOCK) * BLOCK
    return min(rp, STEP_LANES) if rng_mode in ("counter", "ld") else rp


def _camera_state(camera, pixel_xy, words, full_resolution, ld=False) -> MegaState:
    """Fresh state of one camera ray per lane through ``pixel_xy``,
    jittered by the first two draws of the lanes' RNG ``words`` (PCG words,
    or the (R, 3) words of ``seed_ld`` at dimension 0 in ld mode)."""
    words, j1 = rng_ops.next_float(words, dim=0)
    words, j2 = rng_ops.next_float(words, dim=1)
    org, direction = generate_rays(camera, pixel_xy, torch.stack([j1, j2], dim=-1),
                                   full_resolution)
    if ld:
        return fresh_state(org, direction, words[:, 0], aux=words[:, 1])
    return fresh_state(org, direction, words)


def _pad_lanes(state: MegaState, rp: int) -> MegaState:
    """Pad a parity pass to ``rp`` lanes with dead lanes."""
    padn = rp - state.org.shape[0]
    if padn == 0:
        return state

    def padded(x, fill):
        tail = torch.full((padn,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    return MegaState(
        org=padded(state.org, 0.0), dir=padded(state.dir, 1.0),
        thr=padded(state.thr, 0.0), rad=padded(state.rad, 0.0),
        rng=padded(state.rng, 0), depth=padded(state.depth, 0),
        alive=padded(state.alive, False), aux=padded(state.aux, 0),
    )


def _sample_packing(step: int, num_samples: int):
    """(sg, pg) of the counter/ld modes' SAMPLE-PACKED LANES: the streams
    are derived per (pixel, sample), so SG sample-lanes of one pixel sit
    side by side and a pass covers PG = step / SG pixels."""
    sg = 1
    for cand_sg in (16, 8, 4, 2):
        if num_samples % cand_sg == 0 and step % cand_sg == 0:
            sg = cand_sg
            break
    return sg, step // sg


def _packed_passes(camera, pixel_xy, linear, step, num_samples, rng_mode,
                   sample_offset, full_resolution):
    """Yield (pixel group, state, ld dimension base) of every pass of the
    counter and ld modes, in render order. ``sample_offset``: an int, or a
    (1,) int64 tensor on the lanes' device."""
    dev = linear.device
    r = linear.shape[0]
    sg, pg = _sample_packing(step, num_samples)
    n_groups = -(-r // pg)
    k = num_samples // sg  # sample chunks per pixel group
    pad_px = n_groups * pg - r
    pix_pad = torch.cat([pixel_xy, torch.zeros((pad_px, 2), dtype=pixel_xy.dtype, device=dev)])
    lin_pad = torch.cat([linear, torch.zeros((pad_px,), dtype=linear.dtype, device=dev)])
    val_pad = torch.cat([torch.ones((r,), dtype=torch.bool, device=dev),
                         torch.zeros((pad_px,), dtype=torch.bool, device=dev)])
    sub = torch.arange(sg, dtype=torch.int64, device=dev).repeat(pg)
    for t in range(n_groups * k):
        g, c = divmod(t, k)
        base = g * pg
        pix_lane = pix_pad[base:base + pg].repeat_interleave(sg, dim=0)
        lin_lane = lin_pad[base:base + pg].repeat_interleave(sg)
        val_lane = val_pad[base:base + pg].repeat_interleave(sg)
        s_lane = (sub + c * sg + sample_offset) & rng_ops.MASK32
        if rng_mode == "ld":
            # Camera jitter = Sobol dims 0, 1; bounce draws start at dim 2.
            words, d0 = rng_ops.seed_ld(lin_lane, s_lane), 2
        else:
            words, d0 = rng_ops.seed_counter(lin_lane, s_lane), 0
        state = _camera_state(camera, pix_lane, words, full_resolution, ld=rng_mode == "ld")
        yield g, state._replace(alive=state.alive & val_lane), d0


def _parity_samples(advance, camera, pixel_xy, rng_t, num_samples, full_resolution, ex=None):
    """(radiance summed over ``num_samples`` samples, the next RNG words)
    of one lane a pixel in parity mode: each sample's camera ray is drawn
    from the pixel's stream, which the pass carries to the next sample.
    The lanes are padded to whole blocks with dead lanes. ``ex``: the pass
    plan's executor. The sample loop is a counted WHILE loop (the JAX
    ``lax.scan``, megarender.py:557), so a graph captures its body once
    however many samples a call takes."""
    dev = pixel_xy.device
    ex = pc.executor(dev, ex)
    r = pixel_xy.shape[0]
    rp = -(-r // BLOCK) * BLOCK
    # The loop's carry, updated in place: the summed radiance and the words.
    acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    words = rng_t.clone()
    # Pad lanes point at the bank's spill row r.
    lane0 = torch.cat([
        torch.arange(r, dtype=torch.int64, device=dev),
        torch.full((rp - r,), r, dtype=torch.int64, device=dev),
    ])
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    ctrl = pc.new_ctrl(dev)

    def one_sample(h):
        state = _pad_lanes(_camera_state(camera, pixel_xy, words, full_resolution), rp)
        rad_t, rng_next = advance(state, lane0, r, ex=ex)
        acc.add_(rad_t)
        words.copy_(rng_next)
        ex.control(one, ctrl, pc.COND | pc.ITER_STEP | pc.ITER_CAP, site="sample loop step",
                   cap=num_samples, handle=h)

    h = ex.cond()
    ex.control(one, ctrl, pc.COND | pc.ITER_RESET | pc.ITER_CAP, site="sample loop head",
               cap=num_samples, handle=h)
    ex.loop(h, ctrl, one_sample)
    return acc, words


def first_pass_state(camera: Camera, resolution, num_samples: int, rng_mode: str = "parity",
                     full_resolution=None, row_offset=0):
    """(state, ld dimension base) of the first kernel pass that
    ``render_beauty_mega`` makes over a tile whose first row is the frame's
    ``row_offset``: the first sample of every pixel in parity mode, the
    first pixel group's packed samples in the counter and ld modes."""
    dev = camera.origin.device
    width, height = resolution
    full = tuple(full_resolution) if full_resolution else (width, height)
    pixel_xy, linear, _ = _tile_lanes(width, height, 0, row_offset, full[0], dev)
    step = _step_lanes(linear.shape[0], rng_mode)
    if rng_mode in ("counter", "ld"):
        _, state, d0 = next(_packed_passes(camera, pixel_xy, linear, step, num_samples,
                                           rng_mode, 0, full))
        return state, d0
    state = _camera_state(camera, pixel_xy, rng_ops.seed_from_pixel(linear), full)
    return _pad_lanes(state, step), 0




def _sample_offset_on(sample_offset, dev) -> torch.Tensor:
    """The sample offset as a (1,) int64 tensor on ``dev`` (an int is
    written there by a fill, which reads nothing back)."""
    if isinstance(sample_offset, torch.Tensor):
        return sample_offset.to(dev, torch.int64).reshape(1)
    return torch.full((1,), int(sample_offset), dtype=torch.int64, device=dev)


def _beauty_program(ex, *inputs, advance, width, height, num_samples, rng_mode, step, full):
    """The device work of one ``render_beauty_mega`` call: (image, next RNG
    words in row-major order) from the camera, the tile's lanes and inverse
    permutation, the parity words and the sample offset."""
    camera, (pixel_xy_t, linear_t, inv, rng_t, offset) = Camera(*inputs[:5]), inputs[5:]
    dev = linear_t.device
    r = linear_t.shape[0]
    if rng_mode in ("counter", "ld"):
        sg, pg = _sample_packing(step, num_samples)
        acc = torch.zeros((-(-r // pg) * pg, 3), dtype=torch.float32, device=dev)
        lane = torch.arange(step, dtype=torch.int64, device=dev)
        for g, state, d0 in _packed_passes(camera, pixel_xy_t, linear_t, step, num_samples,
                                           rng_mode, offset, full):
            rad_step, _ = advance(state, lane, step, dim0=d0, ex=ex)
            # Pad pixels' lanes start dead, so their radiance stays zero.
            acc[g * pg:(g + 1) * pg] += rad_step.reshape(pg, sg, 3).sum(dim=1)
        acc = acc[:r]
        # Counter/ld streams are re-derived per (pixel, sample): the
        # carried rng is never consumed on resume; return the next chunk's
        # seed position as a deterministic placeholder.
        final_rng = rng_ops.seed_counter(linear_t, offset + num_samples)
    else:
        acc, final_rng = _parity_samples(advance, camera, pixel_xy_t, rng_t, num_samples, full,
                                         ex=ex)
    img = acc[inv].reshape(height, width, 3) / float(num_samples)
    return img, final_rng[inv]


def render_beauty_mega(
    camera: Camera,
    scene: SceneArrays,
    grid: DeviceClusterGrid,
    lights: Lights,
    resolution,
    num_samples: int,
    *,
    pixel_offset=0,
    row_offset=0,
    full_resolution=None,
    sample_offset=0,
    rng_state=None,
    return_rng=False,
    executor: str = "auto",
    **knobs,
):
    """Render an (H, W, 3) tile of the beauty pass with the megakernel, on
    the device of ``grid`` (the tables and the camera must be there too).

    Same contract as the JAX ``render_beauty_mega``: the returned image is
    the mean over this call's samples; ``pixel_offset``/``row_offset`` and
    ``full_resolution`` place the tile in the full frame; ``rng_state`` (u32
    words in int64, row-major) carries the parity stream across sample
    chunks; ``sample_offset`` is an int or a tensor. ``knobs``: the pass's
    ``PassKnobs``.

    On the card every engine runs the call as one CUDA graph per call
    shape, as the JAX ``jit`` runs it as one program: no value goes to the
    host between its first launch and its last. ``executor='eager'`` runs
    the same steps from the host instead (the comparison for the graph).
    """
    k = PassKnobs(**knobs)
    rng_mode = k.rng_mode
    if rng_mode not in ("parity", "counter", "ld"):
        raise ValueError(f"rng mode must be parity|counter|ld, got {rng_mode!r}")
    dev = grid.device
    width, height = resolution
    full = tuple(full_resolution) if full_resolution else (width, height)
    pixel_xy_t, linear_t, inv = _tile_lanes(width, height, pixel_offset, row_offset, full[0], dev)
    r = linear_t.shape[0]
    step = _step_lanes(r, rng_mode)
    advance = _pass_plan(scene, grid, lights, step, k)
    if rng_mode != "parity":
        rng_t = torch.zeros((0,), dtype=torch.int64, device=dev)  # the streams are derived
    elif rng_state is not None:
        rng_t = rng_ops.to_u32(rng_state.to(dev))[_tile_perm_on(width, height, dev)[0]]
    else:
        rng_t = rng_ops.seed_from_pixel(linear_t)
    inputs = (*camera, pixel_xy_t, linear_t, inv, rng_t, _sample_offset_on(sample_offset, dev))
    program = partial(_beauty_program, advance=advance, width=width, height=height,
                      num_samples=num_samples, rng_mode=rng_mode, step=step, full=full)
    key = ("beauty", width, height, num_samples, full, k)
    img, final_rng = _execute(scene, grid, lights, advance.prepare, key, program, inputs, executor,
                              step)
    if return_rng:
        return img, final_rng
    return img


def _samples_program(ex, *inputs, advance, ch, n_steps, rng_mode, full):
    """The device work of one ``render_samples_mega`` call: each lane's
    radiance from the camera and the padded (pixel, sample, valid) lanes."""
    camera, (pixel_xy, sample_idx, valid) = Camera(*inputs[:5]), inputs[5:]
    dev = pixel_xy.device
    out = torch.zeros((n_steps * ch, 3), dtype=torch.float32, device=dev)
    lane = torch.arange(ch, dtype=torch.int64, device=dev)
    for base in range(0, n_steps * ch, ch):
        pix = pixel_xy[base:base + ch]
        val = valid[base:base + ch]
        lin = pix[:, 1] * full[0] + pix[:, 0]
        s_lane = sample_idx[base:base + ch]
        if rng_mode == "ld":
            # Camera jitter = Sobol dims 0, 1; bounce draws start at dim 2,
            # the uniform path's stream for the same (pixel, sample).
            words, d0 = rng_ops.seed_ld(lin, s_lane), 2
        else:
            words, d0 = rng_ops.seed_counter(lin, s_lane), 0
        state = _camera_state(camera, pix, words, full, ld=rng_mode == "ld")
        state = state._replace(alive=state.alive & val)
        rad, _ = advance(state, lane, ch, dim0=d0, ex=ex)
        out[base:base + ch] = torch.where(val[:, None], rad, 0.0)
    return (out,)


def render_samples_mega(
    camera: Camera,
    scene: SceneArrays,
    grid: DeviceClusterGrid,
    lights: Lights,
    pixel_xy,
    sample_idx,
    valid,
    full_resolution,
    *,
    rng_mode: str = "counter",
    chunk_lanes: int = 1 << 16,
    executor: str = "auto",
    **knobs,
):
    """One camera sample per lane at caller-chosen (pixel, sample index)
    pairs: the entry point of adaptive sampling (megarender.py:591 of the
    JAX package).

    ``pixel_xy`` (L, 2) integer full-frame pixel coordinates,
    ``sample_idx`` (L,) u32 per-pixel sample numbers (carried in int64),
    ``valid`` (L,) bool: invalid lanes trace nothing and return exactly 0.
    Returns (L, 3) float32 radiance on the device of ``grid``. Only the
    stateless RNG modes are defined here (each (pixel, sample) stream is
    derived on its own), so a lane's radiance is the uniform path's for the
    same pair. Lanes run in waves of ``chunk_lanes``, each padded to whole
    1024-lane blocks, through the engine's pass loop; on the card as one
    CUDA graph per L, as ``render_beauty_mega`` (``executor``). ``knobs``:
    the pass's other ``PassKnobs``.
    """
    if rng_mode not in ("counter", "ld"):
        raise ValueError(
            "render_samples_mega requires a stateless RNG mode "
            f"(counter | ld), got {rng_mode!r}"
        )
    dev = grid.device
    full = tuple(full_resolution)
    pixel_xy = torch.as_tensor(pixel_xy).to(dev, torch.int64)
    sample_idx = torch.as_tensor(sample_idx).to(dev, torch.int64) & rng_ops.MASK32
    valid = torch.as_tensor(valid).to(dev, torch.bool)
    n = pixel_xy.shape[0]
    ch = min(chunk_lanes, -(-n // BLOCK) * BLOCK)
    ch = max(BLOCK, (ch // BLOCK) * BLOCK)
    n_steps = -(-n // ch)
    pad = n_steps * ch - n
    if pad:
        pixel_xy = torch.cat([pixel_xy, pixel_xy.new_zeros((pad, 2))])
        sample_idx = torch.cat([sample_idx, sample_idx.new_zeros((pad,))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    k = PassKnobs(rng_mode=rng_mode, **knobs)
    advance = _pass_plan(scene, grid, lights, ch, k)
    program = partial(_samples_program, advance=advance, ch=ch, n_steps=n_steps,
                      rng_mode=rng_mode, full=full)
    key = ("samples", n_steps * ch, ch, full, k)
    (out,) = _execute(scene, grid, lights, advance.prepare, key, program,
                      (*camera, pixel_xy, sample_idx, valid), executor, ch)
    return out[:n]


def _pixels_program(ex, *inputs, advance, num_samples, full):
    """The device work of one ``render_pixels_mega`` call: (summed
    radiance, next RNG words) of the pixels from the camera and their
    parity words."""
    camera, (pixel_xy, rng_t) = Camera(*inputs[:5]), inputs[5:]
    return _parity_samples(advance, camera, pixel_xy, rng_t, num_samples, full, ex=ex)


def render_pixels_mega(
    camera: Camera,
    scene: SceneArrays,
    grid: DeviceClusterGrid,
    lights: Lights,
    pixel_xy,
    num_samples: int,
    full_resolution,
    *,
    rng_state=None,
    return_rng=False,
    executor: str = "auto",
    **knobs,
):
    """``num_samples`` parity samples of each of caller-chosen pixels: the
    parity counterpart of ``render_samples_mega``, which the stateless
    modes alone can serve by (pixel, sample) pairs.

    ``pixel_xy`` (L, 2) integer full-frame pixel coordinates, one lane a
    pixel, padded to whole blocks, all through the uniform parity pass's
    sample loop at once. A pixel's stream
    is seeded from its frame index, as ``render_beauty_mega`` seeds it, or
    taken from ``rng_state`` (L,) (u32 words in int64) to carry it across
    calls. Returns the (L, 3) float32 mean over this call's samples on the
    device of ``grid`` (and with ``return_rng`` the next RNG words), so a
    pixel's value is the one the uniform render of the frame gives it. On
    the card as one CUDA graph per L, as ``render_beauty_mega``
    (``executor``). ``knobs``: the pass's ``PassKnobs`` but the RNG mode.
    """
    dev = grid.device
    full = tuple(full_resolution)
    pixel_xy = torch.as_tensor(pixel_xy).to(dev, torch.int64)
    n = pixel_xy.shape[0]
    rng_t = (
        rng_ops.to_u32(torch.as_tensor(rng_state).to(dev))
        if rng_state is not None
        else rng_ops.seed_from_pixel(pixel_xy[:, 1] * full[0] + pixel_xy[:, 0])
    )
    k = PassKnobs(rng_mode="parity", **knobs)
    rp = -(-n // BLOCK) * BLOCK
    advance = _pass_plan(scene, grid, lights, rp, k)
    program = partial(_pixels_program, advance=advance, num_samples=num_samples, full=full)
    key = ("pixels", n, num_samples, full, k)
    acc, next_rng = _execute(scene, grid, lights, advance.prepare, key, program,
                             (*camera, pixel_xy, rng_t), executor, rp)
    img = acc / float(num_samples)
    if return_rng:
        return img, next_rng
    return img
