"""Beauty-pass loop around the path-tracing megakernel (kernels/megakernel.py).

Counterpart of complex_materials_renderer_tpu/render/megarender.py
(``render_beauty_mega`` :339, ``_make_advance`` :213). The bounce loop
runs as a short PHASE SCHEDULE of kernel calls:

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
float rounding. Every function here is host control flow and PyTorch
tensor glue; the per-pass kernel is ``trace_paths_mega``, or with
``trace_engine`` binned or pair the wavefront bounce loop over the binned
tracer (render/binnedrender.py) or the pair sweep (render/pairrender.py).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import torch

from ..kernels.cluster_grid import DeviceClusterGrid
from ..kernels.megakernel import (
    BLOCK,
    DRAWS_PER_BOUNCE,
    MegaState,
    fresh_state,
    pack_media,
    pack_misc,
    trace_paths_mega,
)
from ..ops import rng as rng_ops
from ..ops.camera import Camera, generate_rays
from .hitinfo import Lights, SceneArrays
from .integrator import coherence_key

TILE = 32  # pixels per tile side; 32x32 = one 1024-lane block
# Widest wave one step of the counter/ld sample loop runs (megarender.py:47
# of the JAX package reads it from CMR_STEP_LANES; here it is a constant).
STEP_LANES = 1 << 16


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


def _partition_live(state: MegaState, lane: torch.Tensor, scene: SceneArrays,
                    sortkey: str = "dir"):
    """Compact and re-sort the wavefront: dead lanes last, live lanes by
    (direction octant, Morton cell of origin), or cell-major for
    ``sortkey='pos'``. The sort is stable, like ``jnp.argsort``."""
    key = coherence_key(state.org, state.dir, state.alive, scene.world_lo, scene.world_hi,
                        sortkey)
    perm = torch.argsort(key, stable=True)
    return MegaState(*(x[perm] for x in state)), lane[perm]


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


def _make_kern(grid, scene, lights, media9, misc, *, trace_engine, max_depth, rr_depth,
               nee_max_media, tir, direct, rng_mode, binned_list, binned_cap):
    """The per-pass bounce kernel of the selected trace engine
    (megarender.py:166-210): the megakernel, or the wavefront bounce loop
    over the binned or the pair tracer. Each updates the state in place."""
    ld = rng_mode == "ld"
    if trace_engine == "binned":
        from .binnedrender import make_binned_kern

        return make_binned_kern(grid, scene, lights, media9, max_depth=max_depth,
                                rr_depth=rr_depth, nee_max_media=nee_max_media, tir=tir,
                                list_len=binned_list, cap_iters=binned_cap, direct=direct, ld=ld)
    if trace_engine == "pair":
        from .pairrender import make_pair_kern

        return make_pair_kern(grid, scene, lights, media9, max_depth=max_depth,
                              rr_depth=rr_depth, nee_max_media=nee_max_media, tir=tir,
                              direct=direct, ld=ld)
    if trace_engine != "mega":
        raise ValueError(f"trace engine must be mega|binned|pair, got {trace_engine!r}")
    return partial(
        trace_paths_mega, grid, media9, misc,
        background=scene.background, max_depth=max_depth, rr_depth=rr_depth,
        nee_max_media=nee_max_media, tir_kill=(tir == "kill"),
        analytic_direct=(direct == "analytic"), ld=ld,
    )


def _make_advance(kern, dynamic, sched, scene, sortkey, max_depth):
    """Build the wavefront advance: run ``state`` to termination and return
    (radiance, rng) banked by lane id — ``bank_rows`` real rows (one more
    spill row takes the pad lanes).

    ``dim0`` is the ld-mode Sobol dimension base. Alive lanes run exactly
    ``max_iters`` bounce iterations per kernel call, so the base advances
    by 8 * max_iters per call. ``kern`` updates the state in place."""

    def _advance(state: MegaState, lane: torch.Tensor, bank_rows: int, dim0: int = 0):
        dev = state.org.device
        rad_bank = torch.zeros((bank_rows + 1, 3), dtype=torch.float32, device=dev)
        rng_bank = torch.zeros((bank_rows + 1,), dtype=torch.int64, device=dev)

        def n_alive(st) -> int:
            return int(st.alive.sum())

        if dynamic != "off":
            def sorted_bounce(st, ln, d0):
                st, ln = _partition_live(st, ln, scene, sortkey)
                kern(st, max_iters=1, live_blocks=-(-n_alive(st) // BLOCK), dim0=d0)
                return st, ln, d0 + DRAWS_PER_BOUNCE

            if dynamic == "all":
                while bool(state.alive.any()):
                    state, lane, dim0 = sorted_bounce(state, lane, dim0)
            else:  # hybrid
                for _ in range(8):
                    if bool(state.alive.any()):
                        state, lane, dim0 = sorted_bounce(state, lane, dim0)
                state, lane = _partition_live(state, lane, scene, sortkey)
                kern(state, max_iters=max_depth,
                     live_blocks=-(-n_alive(state) // BLOCK), dim0=dim0)
            rad_bank[lane] = state.rad
            rng_bank[lane] = state.rng
            return rad_bank[:bank_rows], rng_bank[:bank_rows]

        for i, (w, cap) in enumerate(sched):
            if i > 0:
                # Shrink to this phase's width: live lanes first, bank the
                # dropped tail (all dead: the spill loop below made sure
                # that at most w lanes are alive).
                state, lane = _partition_live(state, lane, scene, sortkey)
                drop = lane[w:]
                rad_bank[drop] = state.rad[w:]
                rng_bank[drop] = state.rng[w:]
                state = MegaState(*(x[:w] for x in state))
                lane = lane[:w]
            kern(state, max_iters=cap, dim0=dim0)
            dim0 += DRAWS_PER_BOUNCE * cap
            if i + 1 < len(sched):
                # Paths that die slower than the schedule assumes keep
                # bouncing at this width until they fit the next one.
                next_w = sched[i + 1][0]
                while n_alive(state) > next_w:
                    kern(state, max_iters=cap, dim0=dim0)
                    dim0 += DRAWS_PER_BOUNCE * cap

        rad_bank[lane] = state.rad
        rng_bank[lane] = state.rng
        return rad_bank[:bank_rows], rng_bank[:bank_rows]

    return _advance


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
    perm_np, inv_np = _tile_perm(width, height)
    perm = torch.from_numpy(perm_np.astype(np.int64)).to(dev)
    inv = torch.from_numpy(inv_np.astype(np.int64)).to(dev)
    return pixel_xy[perm], linear[perm], inv


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
    or the (R, 2) words of ``seed_ld`` in ld mode)."""
    words, j1 = rng_ops.next_float(words)
    words, j2 = rng_ops.next_float(words)
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
    counter and ld modes, in render order."""
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
        s_lane = (sub + c * sg + int(sample_offset)) & rng_ops.MASK32
        if rng_mode == "ld":
            # Camera jitter = Sobol dims 0, 1; bounce draws start at dim 2.
            words, d0 = rng_ops.seed_ld(lin_lane, s_lane), 2
        else:
            words, d0 = rng_ops.seed_counter(lin_lane, s_lane), 0
        state = _camera_state(camera, pix_lane, words, full_resolution, ld=rng_mode == "ld")
        yield g, state._replace(alive=state.alive & val_lane), d0


def first_pass_state(camera: Camera, resolution, num_samples: int, rng_mode: str = "parity",
                     full_resolution=None):
    """(state, ld dimension base) of the first kernel pass that
    ``render_beauty_mega`` makes over a tile at the frame's origin: the
    first sample of every pixel in parity mode, the first pixel group's
    packed samples in the counter and ld modes."""
    dev = camera.origin.device
    width, height = resolution
    full = tuple(full_resolution) if full_resolution else (width, height)
    pixel_xy, linear, _ = _tile_lanes(width, height, 0, 0, full[0], dev)
    step = _step_lanes(linear.shape[0], rng_mode)
    if rng_mode in ("counter", "ld"):
        _, state, d0 = next(_packed_passes(camera, pixel_xy, linear, step, num_samples,
                                           rng_mode, 0, full))
        return state, d0
    state = _camera_state(camera, pixel_xy, rng_ops.seed_from_pixel(linear), full)
    return _pad_lanes(state, step), 0


def render_beauty_mega(
    camera: Camera,
    scene: SceneArrays,
    grid: DeviceClusterGrid,
    lights: Lights,
    resolution,
    num_samples: int,
    max_depth: int = 32,
    rr_depth: int = 16,
    nee_max_media: int = 4,
    rng_mode: str = "parity",
    pixel_offset=0,
    row_offset=0,
    full_resolution=None,
    sample_offset=0,
    rng_state=None,
    return_rng=False,
    tir: str = "reflect",
    schedule_mode: str = "auto",
    schedule: str = "",
    sortkey: str = "dir",
    debug: str = "",
    direct: str = "scatter",
    trace_engine: str = "mega",
    binned_list: int = 8,
    binned_cap: int = 12,
):
    """Render an (H, W, 3) tile of the beauty pass with the megakernel, on
    the device of ``grid`` (the tables and the camera must be there too).

    Same contract as the JAX ``render_beauty_mega``: the returned image is
    the mean over this call's samples; ``pixel_offset``/``row_offset`` and
    ``full_resolution`` place the tile in the full frame; ``rng_state`` (u32
    words in int64, row-major) carries the parity stream across sample
    chunks. ``schedule_mode``: auto | off | hybrid | all. ``trace_engine``
    swaps the per-pass kernel: mega | binned (with ``binned_list`` and
    ``binned_cap``) | pair.
    """
    if debug:
        raise NotImplementedError(
            f"CMR_MEGA_DEBUG={debug!r}: the TPU timing ablations are not "
            "ported (ROADMAP Queue 1, item 15)"
        )
    if rng_mode not in ("parity", "counter", "ld"):
        raise ValueError(f"rng mode must be parity|counter|ld, got {rng_mode!r}")
    dev = grid.device
    width, height = resolution
    full_w, full_h = full_resolution if full_resolution else (width, height)
    pixel_xy_t, linear_t, inv = _tile_lanes(width, height, pixel_offset, row_offset, full_w, dev)
    r = linear_t.shape[0]
    rp = -(-r // BLOCK) * BLOCK  # lanes padded to whole blocks
    step = _step_lanes(r, rng_mode)

    media9 = pack_media(scene.media, scene.scale, device=dev)
    misc = pack_misc(lights, scene.world_lo, scene.world_hi, device=dev)
    dynamic = _resolve_dynamic(schedule_mode, grid)
    sched = _phase_schedule(step, max_depth, schedule)
    kern = _make_kern(
        grid, scene, lights, media9, misc, trace_engine=trace_engine, max_depth=max_depth,
        rr_depth=rr_depth, nee_max_media=nee_max_media, tir=tir, direct=direct,
        rng_mode=rng_mode, binned_list=binned_list, binned_cap=binned_cap,
    )
    _advance = _make_advance(kern, dynamic, sched, scene, sortkey, max_depth)

    if rng_mode in ("counter", "ld"):
        sg, pg = _sample_packing(step, num_samples)
        acc = torch.zeros((-(-r // pg) * pg, 3), dtype=torch.float32, device=dev)
        lane = torch.arange(step, dtype=torch.int64, device=dev)
        for g, state, d0 in _packed_passes(camera, pixel_xy_t, linear_t, step, num_samples,
                                           rng_mode, sample_offset, (full_w, full_h)):
            rad_step, _ = _advance(state, lane, step, dim0=d0)
            # Pad pixels' lanes start dead, so their radiance stays zero.
            acc[g * pg:(g + 1) * pg] += rad_step.reshape(pg, sg, 3).sum(dim=1)
        acc = acc[:r]
        # Counter/ld streams are re-derived per (pixel, sample): the
        # carried rng is never consumed on resume; return the next chunk's
        # seed position as a deterministic placeholder.
        final_rng = rng_ops.seed_counter(linear_t, int(sample_offset) + num_samples)
    else:
        perm = torch.from_numpy(_tile_perm(width, height)[0].astype(np.int64)).to(dev)
        rng_t = (
            rng_ops.to_u32(rng_state.to(dev))[perm]
            if rng_state is not None
            else rng_ops.seed_from_pixel(linear_t)
        )
        acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
        # Pad lanes point at the bank's spill row r.
        lane0 = torch.cat([
            torch.arange(r, dtype=torch.int64, device=dev),
            torch.full((rp - r,), r, dtype=torch.int64, device=dev),
        ])
        for _ in range(num_samples):
            state = _pad_lanes(_camera_state(camera, pixel_xy_t, rng_t, (full_w, full_h)), rp)
            rad_t, rng_t = _advance(state, lane0, r)
            acc = acc + rad_t
        final_rng = rng_t

    img = acc[inv].reshape(height, width, 3) / float(num_samples)
    if return_rng:
        return img, final_rng[inv]
    return img
