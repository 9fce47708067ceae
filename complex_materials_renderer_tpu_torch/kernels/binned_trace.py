"""Binned per-lane traversal: the candidate listing (K4) and the binned
round (K5).

Counterpart of complex_materials_renderer_tpu/kernels/binned_trace.py
(``_make_listing_kernel`` :88, ``_make_round_kernel`` :199, ``trace_binned``
:355). A trace runs generations; each generation

1. LISTS, per lane, the L nearest-entry candidate clusters as packed int32
   keys [entry-t f32 bits & ~ID_MASK | 14-bit cluster id] above a strict
   lower key t_lo (``listing``: K4);
2. runs ROUNDS until no lane lists a cluster: the lanes are regrouped by
   their head cluster id (a stable sort, as ``lax.sort``), so that each
   1024-lane block holds lanes that need the same few clusters, and the
   round (``run_round``: K5) serves each block's smallest head cluster id
   up to ``cap_iters`` times;
3. RELISTS the lanes whose list overflowed and whose bound still lies
   beyond their L-th key (t_lo = that key).

The lane order is restored at the end. Payloads ('full', 'dist', 'occl',
'nee') and their states are those of ``cluster_test``; the round carries
a payload's state as one (fields, lanes) int32 tensor with float fields as
their bit patterns, so the sorts move one tensor per kind.

On CUDA tensors ``listing`` and ``run_round`` launch the kernels of
``csrc/binned_listing.cu`` and ``csrc/binned_round.cu`` (or raise); on CPU
tensors they run ``listing_plain`` and ``round_plain``. The plain round is
block-faithful: it picks the served cluster per 1024-lane block as the
kernel does, so the two agree on every lane. The generation and round
loops are the JAX ``lax.while_loop``s (:496-553): run by an executor
(kernels/pass_control.py), on the card conditional WHILE nodes of the
caller's CUDA graph whose conditions the control kernel sets, the loop
state updated in place. K5 takes its live blocks from the control block,
as the JAX round takes them as a traced scalar (:531-533); its (G, S)
ladder (``round_split``) is one IF node a rung. On the eager executor the
host reads each condition and passes K5 its live blocks as an int.
"""

from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from ..render.hitinfo import T_MIN
from . import pass_control as pc
from .cluster_grid import DeviceClusterGrid
from .cluster_test import (
    LIST_CTA,
    group_size,
    listing_group,
    nee_list_len,
    nee_unpack_mat,
    nee_unpack_t,
    payload_bound,
    payload_state0,
    slot_table,
    trace_slots,
)
from .megakernel import MAX_SUPERS, _require, _safe_inv

BLOCK = 1024  # lanes of one round block (the TPU kernel's (8, 128) tile)
# K5 on the card: threads per lane it is built for, threads of a CTA
# (csrc/binned_round.cu SERVE_THREADS) and the threads a launch aims for.
ROUND_GROUPS = (1, 2, 4, 8)
ROUND_CTA = 512
ROUND_FILL = 1 << 17
EMPTY = 2147483647  # empty list slot / resolved-lane t_lo
ID_BITS = 14  # cluster id field of a key
ID_MASK = (1 << ID_BITS) - 1
BIGC = 1 << 20  # no-cluster sentinel of the regroup key and the serve loop
MAX_MEDIA_ROWS = 63  # the NEE keys' 6-bit media-row field
PAYLOAD_IDS = {"full": 0, "dist": 1, "occl": 2, "nee": 3}

_T_MIN = float(np.float32(T_MIN))
_TEN_TMIN = float(np.float32(10.0) * np.float32(T_MIN))
_LANE_CHUNK = 1 << 22  # lanes x clusters of one plain listing step


def n_state(payload: str, K_NEE: int) -> int:
    """Fields of a payload's state."""
    return {"full": 11, "dist": 2, "occl": 1}.get(payload, K_NEE + 1)


def _float_field(payload: str, K_NEE: int, i: int) -> bool:
    return payload != "nee" or i == K_NEE


def state_bits(state) -> torch.Tensor:
    """A payload state (tuple of float32/int32 tensors) as one (ns, n)
    int32 tensor, float fields as their bit patterns."""
    return torch.stack([x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x
                        for x in state])


def state_fields(bits: torch.Tensor, payload: str, K_NEE: int):
    """The inverse of ``state_bits``."""
    return tuple(bits[i].view(torch.float32) if _float_field(payload, K_NEE, i) else bits[i]
                 for i in range(bits.shape[0]))


def entry_of(key: torch.Tensor) -> torch.Tensor:
    """The (rounded-down) AABB entry of a key (binned_trace.py:341)."""
    return (key & ~ID_MASK).view(torch.float32)


def _check_payload(payload: str) -> None:
    if payload not in PAYLOAD_IDS:
        raise ValueError(f"unknown payload {payload!r}")


def check_grid(grid: DeviceClusterGrid, media9: torch.Tensor) -> None:
    """The caps of the packed keys (ROADMAP R4): 14-bit cluster ids and 63
    media rows."""
    if grid.num_clusters > (1 << ID_BITS):
        raise ValueError(
            f"{grid.num_clusters} clusters exceed the binned tracer's {ID_BITS}-bit id field"
        )
    if media9.shape[0] > MAX_MEDIA_ROWS:
        raise ValueError(f"{media9.shape[0]} media rows exceed the 63-medium key field")


def scene_box_clamp(eff, o, d, world_lo, world_hi):
    """``eff`` clamped to the scene-box exit along each ray
    (binned_trace.py:400-419, megakernel.traverse parity)."""
    lo = torch.as_tensor(world_lo, dtype=torch.float32, device=o.device).reshape(3)
    hi = torch.as_tensor(world_hi, dtype=torch.float32, device=o.device).reshape(3)

    def axis_exit(i):
        inv = _safe_inv(d[:, i])
        return torch.maximum((lo[i] - o[:, i]) * inv, (hi[i] - o[:, i]) * inv)

    tf = torch.minimum(torch.minimum(axis_exit(0), axis_exit(1)), axis_exit(2))
    return torch.minimum(eff, torch.clamp(tf, min=0.0) * float(np.float32(1.0001)) + _TEN_TMIN)


# --------------------------------------------------------------------------
# K4: the listing
# --------------------------------------------------------------------------


def _entries(boxes, O, INV, bnd):
    """Slab entries (n, B) of rays against boxes (B, 8) within [T_MIN, bnd]
    and the hit mask, in the TPU kernel's operation order (:130-146)."""
    tn = tf = None
    for a in range(3):
        s0 = (boxes[None, :, a] - O[a][:, None]) * INV[a][:, None]
        s1 = (boxes[None, :, a + 3] - O[a][:, None]) * INV[a][:, None]
        lo_s, hi_s = torch.minimum(s0, s1), torch.maximum(s0, s1)
        tn = lo_s if tn is None else torch.maximum(tn, lo_s)
        tf = hi_s if tf is None else torch.minimum(tf, hi_s)
    tn = torch.clamp(tn, min=_T_MIN)
    tf = torch.minimum(tf, bnd[:, None])
    return tn, tn <= tf


def listing_plain(grid: DeviceClusterGrid, rays: torch.Tensor, bound: torch.Tensor,
                  tlo: torch.Tensor, list_len: int):
    """The plain version of the listing: (keys (L, n) int32, tlim (n,)).
    ``rays`` is (6, n) (origin, direction), ``bound`` the per-lane walk
    bound, ``tlo`` the strict lower key (EMPTY: list nothing)."""
    n = rays.shape[1]
    L = list_len
    dev = rays.device
    keys = torch.full((L, n), EMPTY, dtype=torch.int32, device=dev)
    act = (tlo != EMPTY).nonzero().squeeze(1)
    C = grid.num_clusters
    ids = torch.arange(C, dtype=torch.int32, device=dev)
    owner = (ids // grid.super_factor).to(torch.int64)
    step = max(1, _LANE_CHUNK // max(1, C))
    for lo in range(0, act.numel(), step):
        idx = act[lo:lo + step]
        O = tuple(rays[a, idx] for a in range(3))
        INV = tuple(_safe_inv(rays[3 + a, idx]) for a in range(3))
        bnd = bound[idx]
        _, hit_s = _entries(grid.super_bounds, O, INV, bnd)
        tn, hit = _entries(grid.bounds, O, INV, bnd)
        hit = hit & hit_s[:, owner]
        key = (tn.view(torch.int32) & ~ID_MASK) | ids
        key = torch.where(hit & (key > tlo[idx, None]), key, torch.full_like(key, EMPTY))
        if C < L:
            key = torch.cat([key, torch.full((key.shape[0], L - C), EMPTY, dtype=torch.int32,
                                             device=dev)], dim=1)
        keys[:, idx] = torch.topk(key, L, dim=1, largest=False, sorted=True).values.t()
    return keys, keys[L - 1].clone()


def listing_span(lanes: int, supers: int) -> int:
    """Lanes of a CTA of K4's tile walk over ``lanes`` lanes of a grid of
    ``supers`` supers: a CTA whose lanes all list gets the G of
    ``listing_group`` at the width's ``group_size`` (65,536 lanes: 64 lanes
    a CTA at G = 4), so that a launch whose lanes all list puts about
    FILL_THREADS threads on the card."""
    return LIST_CTA // listing_group(LIST_CTA // group_size(lanes), supers)


# The most supers on which K4 takes the one-thread walk: on showcase tiled
# to 1, 2, 3 and 7 supers the tile walk's prologue and its box levels cost
# more than its culls and tiles save, from 12 supers on they do not (PERF.md).
LIST_ONE_THREAD_SUPERS = 7


def listing_split(lanes: int, supers: int):
    """(variant, span, group) of a K4 launch over ``lanes`` lanes of a grid
    of ``supers`` supers (csrc/binned_listing.cu). The one-thread walk
    (variant 0, 128 lanes a CTA) on a grid of at most
    LIST_ONE_THREAD_SUPERS supers, and on a grid of more than MAX_SUPERS,
    whose boxes do not fit the tile walk's shared memory. Otherwise the
    tile walk (variant 1) over ``listing_span`` lanes a CTA, each CTA
    choosing G from its own listing lanes (group 0)."""
    if supers <= LIST_ONE_THREAD_SUPERS or supers > MAX_SUPERS:
        return 0, 128, 0
    return 1, listing_span(lanes, supers), 0


def listing(grid: DeviceClusterGrid, rays: torch.Tensor, bound: torch.Tensor,
            tlo: torch.Tensor, list_len: int):
    """(keys (L, n) int32, tlim (n,) int32) of the listing: the kernel of
    ``csrc/binned_listing.cu`` on CUDA tensors (launches counted in
    ``listing.launches``; variant and tiles from ``listing_split``),
    ``listing_plain`` on CPU tensors."""
    if list_len < 1:
        raise ValueError(f"list_len must be >= 1, got {list_len}")
    if rays.device.type == "cpu":
        return listing_plain(grid, rays, bound, tlo, list_len)
    from . import build

    dev = rays.device
    n = rays.shape[1]
    C, S = grid.num_clusters, grid.num_supers
    _require(grid.bounds, "bounds", torch.float32, (C, 8), dev)
    _require(grid.super_bounds, "super_bounds", torch.float32, (S, 8), dev)
    _require(rays, "rays", torch.float32, (6, n), dev)
    _require(bound, "bound", torch.float32, (n,), dev)
    _require(tlo, "tlo", torch.int32, (n,), dev)
    for t, name in ((grid.bounds, "bounds"), (grid.super_bounds, "super_bounds")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads float4 rows)")
    keys = torch.empty((list_len, n), dtype=torch.int32, device=dev)
    tlim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return keys, tlim
    fn = build.binned_listing(list_len)
    variant, span, group = listing_split(n, S)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p(grid.bounds), p(grid.super_bounds), p(rays), p(bound), p(tlo), p(keys),
                 p(tlim), n, C, S, grid.super_factor, variant, span, group,
                 ctypes.c_void_p(stream))
    pc.count_launch(listing, "K4", dev)
    if err != 0:
        raise RuntimeError(f"listing kernel launch failed: {build.error_string(err)}")
    return keys, tlim


listing.launches = 0  # CUDA launches made by listing


# --------------------------------------------------------------------------
# K5: the round
# --------------------------------------------------------------------------


def round_plain(grid: DeviceClusterGrid, media9: torch.Tensor, lb, rays: torch.Tensor,
                keys: torch.Tensor, state: torch.Tensor, payload: str, K_NEE: int,
                cap_iters: int, served: list | None = None):
    """The plain version of the round: (keys, state, iters) after serving
    each 1024-lane block below ``lb`` blocks up to ``cap_iters`` times
    (binned_trace.py:225-319). ``keys`` (L, n) and ``state`` (ns, n,
    ``state_bits``) are not modified; ``iters`` is (n / 1024,) int32.
    ``served``, when given, receives for each serving iteration the
    cluster served in each block (BIGC: none) and how many of the block's
    lanes held it: the work a round needs."""
    L, n = keys.shape
    blocks = n // BLOCK
    dev = keys.device
    keys = keys.clone()
    state = state.clone()
    iters = torch.zeros((blocks,), dtype=torch.int32, device=dev)
    live = torch.arange(blocks, device=dev) < int(torch.as_tensor(lb).reshape(-1)[0])
    med_ids = media9[:, 0].tolist()
    W = grid.width
    empty = torch.full_like(keys[0], EMPTY)
    for _ in range(cap_iters):
        go = live & (keys[0].view(blocks, BLOCK) != EMPTY).any(dim=1)
        if not bool(go.any()):
            break
        iters += go.to(torch.int32)
        go_lane = go.repeat_interleave(BLOCK)
        fields = state_fields(state, payload, K_NEE)
        bnd = payload_bound(payload, fields, K_NEE)
        head = keys[0]
        clear = go_lane & (head != EMPTY) & (entry_of(head) >= bnd)
        keys = torch.where(clear[None], EMPTY, keys)
        head = keys[0]
        hid = torch.where(head != EMPTY, head & ID_MASK, torch.full_like(head, BIGC))
        c = torch.where(go, hid.view(blocks, BLOCK).amin(dim=1), torch.full_like(go, BIGC,
                                                                                dtype=torch.int32))
        c_lane = c.repeat_interleave(BLOCK)
        match = (keys != EMPTY) & ((keys & ID_MASK) == c_lane[None])
        has_c = match.any(dim=0)
        if served is not None:
            served.append((c, has_c.view(blocks, BLOCK).sum(dim=1)))
        for cv in torch.unique(c[c < BIGC]).tolist():
            cc = min(cv, grid.num_clusters - 1)
            lanes = ((c_lane == cv) & (has_c if payload == "nee" else True)).nonzero().squeeze(1)
            if lanes.numel() == 0:
                continue
            sub = trace_slots(slot_table(grid, cc * W, (cc + 1) * W),
                              tuple(rays[a, lanes] for a in range(6)), payload,
                              tuple(f[lanes] for f in fields), _T_MIN, K_NEE, med_ids,
                              in_order=True)
            state[:, lanes] = state_bits(sub)
            fields = state_fields(state, payload, K_NEE)
        shift = torch.cummax(match.to(torch.int32), dim=0).values.bool()
        nxt = torch.cat([keys[1:], empty[None]])
        keys = torch.where(shift, nxt, keys)
    return keys, state, iters


def round_split(live_blocks: int):
    """(G, S) of a K5 launch over ``live_blocks`` blocks of 1024 lanes: G
    threads per lane and thread block clusters of S = 1024 G / 512 CTAs of
    512 threads, one cluster per block. G is the smallest of ROUND_GROUPS
    with live lanes x G >= ROUND_FILL, so that the few live blocks of a late
    round still spread over the card (PERF.md has the times at every G).
    S = 16 (G = 8, 16 live blocks or fewer) is beyond the portable cluster
    size of 8; the kernel asks the card for it (a card that cannot place
    such a cluster refuses the launch, and the wrapper raises)."""
    for g in ROUND_GROUPS:
        if live_blocks * BLOCK * g >= ROUND_FILL:
            break
    return g, BLOCK * g // ROUND_CTA


def round_ladder(blocks: int):
    """The (G, S) ladder of K5 over 1 to ``blocks`` live blocks: (first
    live blocks, last, G) a rung (``pass_control.ladder`` of
    ``round_split``)."""
    return pc.ladder(lambda lb: round_split(lb)[0], blocks)


def round_edges(blocks: int) -> list:
    """The control kernel's rung edges of ``round_ladder`` in listed lanes
    (live blocks = ceil(lanes / 1024)): a rung from a live blocks holds the
    lanes from 1024 (a - 1) + 1."""
    return [BLOCK * (a - 1) + 1 for a, _, _ in round_ladder(blocks)] + [BLOCK * blocks + 1]


def run_round(grid: DeviceClusterGrid, media9: torch.Tensor, lb, rays: torch.Tensor,
              keys: torch.Tensor, state: torch.Tensor, payload: str, K_NEE: int, cap_iters: int,
              ctrl: torch.Tensor | None = None, group: int | None = None,
              iters: torch.Tensor | None = None):
    """(keys, state, iters) after one round: the kernel of
    ``csrc/binned_round.cu`` on CUDA tensors, which updates ``keys`` and
    ``state`` in place (the Pallas call's aliases; launches counted in
    ``run_round.launches``, or on the card when captured), ``round_plain``
    on CPU tensors. ``lb``, the live blocks, is a host int: it sizes the
    grid and picks G and S (``round_split``). Or ``lb`` is None and
    ``ctrl``, a pass control block, holds the live blocks on the card
    (CTRL_LIVE) and ``group`` is a rung of ``round_ladder``: the grid
    covers that rung's most live blocks and the kernel serves those below
    the count. ``iters``, when given, receives the serving iterations (on
    the card a block beyond the live blocks keeps its value)."""
    _check_payload(payload)
    n_blocks = keys.shape[1] // BLOCK
    if ctrl is not None:
        if lb is not None:
            raise ValueError("a round with the control block takes no host live blocks")
        rungs = {g: b for _, b, g in round_ladder(max(1, n_blocks))}
        if group not in rungs:
            raise ValueError(f"group {group!r} is no rung of the round's ladder {rungs}")
    if rays.device.type == "cpu":
        out = round_plain(grid, media9, ctrl[pc.CTRL_LIVE] if ctrl is not None else lb, rays,
                          keys, state, payload, K_NEE, cap_iters)
        if iters is not None:
            iters.copy_(out[2])
            return out[0], out[1], iters
        return out
    from . import build

    dev = rays.device
    L, n = keys.shape
    if n % BLOCK:
        raise ValueError(f"the round takes whole blocks of {BLOCK} lanes, got {n}")
    if ctrl is None and (not isinstance(lb, int) or not 0 <= lb <= n // BLOCK):
        raise ValueError(f"live blocks must be a host int in [0, {n // BLOCK}], got {lb!r}")
    if (K_NEE - 2) % 2 or K_NEE < 2:
        raise ValueError(f"K-list length {K_NEE} is not 2 * nee_bound + 2")
    C = grid.num_clusters
    row_w = grid.run_rows.shape[1]
    _require(grid.run_rows, "run_rows", torch.float32, (C * grid.runs_per_cluster, row_w), dev)
    _require(media9, "media9", torch.float32, (media9.shape[0], 9), dev)
    _require(rays, "rays", torch.float32, (6, n), dev)
    _require(keys, "keys", torch.int32, (L, n), dev)
    _require(state, "state", torch.int32, (n_state(payload, K_NEE), n), dev)
    if iters is None:
        iters = torch.zeros((n // BLOCK,), dtype=torch.int32, device=dev)
    _require(iters, "iters", torch.int32, (n // BLOCK,), dev)
    if ctrl is not None:
        _require(ctrl, "ctrl", torch.int32, (pc.CTRL_LEN,), dev)
        lb, g, live = min(rungs[group], n // BLOCK), group, ctypes.c_void_p(ctrl.data_ptr())
    else:
        g, live = (round_split(lb)[0] if lb else 0), None
    if lb == 0:
        return keys, state, iters
    fn = build.binned_round(L, (K_NEE - 2) // 2)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p(media9), media9.shape[0], p(grid.run_rows), p(rays), p(keys), p(state),
                 p(iters), n, lb, C, grid.runs_per_cluster, grid.run_size, row_w,
                 PAYLOAD_IDS[payload], int(cap_iters), g, live, ctypes.c_void_p(stream))
    pc.count_launch(run_round, "K5", dev)
    if err != 0:
        raise RuntimeError(f"round kernel launch failed: {build.error_string(err)}")
    return keys, state, iters


run_round.launches = 0  # CUDA launches made by run_round


# --------------------------------------------------------------------------
# The trace
# --------------------------------------------------------------------------


def _head_order(keys):
    """(sorted group keys, permutation) of the stable sort of the lanes by
    head cluster id, empty lists last (binned_trace.py:513-532)."""
    head = keys[0]
    gkey = torch.where(head != EMPTY, head & ID_MASK, torch.full_like(head, BIGC))
    return torch.sort(gkey, stable=True)


def regroup(keys, *lane_arrays):
    """Sort the lanes by head cluster id, empty lists last, stably. Returns
    (live lanes, keys, the arrays) with every (rows, lanes) or (lanes,)
    array permuted along its lanes."""
    g0, perm = _head_order(keys)
    live = (g0 < BIGC).sum()
    return (live, keys[:, perm]) + tuple(a[..., perm] for a in lane_arrays)


def regroup_into(keys, *lane_arrays) -> None:
    """``regroup`` in place: the same permutation written back into
    ``keys`` and each array, so that a loop body of a graph finds them at
    the same addresses every iteration."""
    _, perm = _head_order(keys)
    for a in (keys,) + lane_arrays:
        a.copy_(a[..., perm])


def trace_binned(grid: DeviceClusterGrid, media9: torch.Tensor, o: torch.Tensor,
                 d: torch.Tensor, bound: torch.Tensor, payload: str, world_lo=None,
                 world_hi=None, nee_max_media: int = 4, list_len: int = 8, cap_iters: int = 12,
                 max_gens: int = 64, debug_stats: bool = False, ex=None):
    """Per-lane-work-proportional trace (binned_trace.py:355); the payload
    contract of the megakernel's traverse: t == the per-lane bound on a
    miss, slot and mat -1. 'nee' returns K ts, K media rows (float) and
    t_opq. ``world_lo``/``world_hi`` clamp 'full' and 'dist' to the scene
    box. ``debug_stats`` also returns [generations, rounds, serving
    iterations, live-lane rounds]. ``ex`` runs the generation and round
    loops (``pass_control.executor``: the caller's graph capture, the CPU
    executor or the eager one)."""
    _check_payload(payload)
    check_grid(grid, media9)
    L = list_len
    K_NEE = nee_list_len(nee_max_media)
    dev = o.device
    ex = pc.executor(dev, ex)
    r = o.shape[0]
    blocks = -(-r // BLOCK)
    rp = blocks * BLOCK

    eff = torch.where(bound > _T_MIN, bound, torch.zeros_like(bound)).to(torch.float32)
    if payload in ("full", "dist"):
        eff = scene_box_clamp(eff, o, d, world_lo, world_hi)
    rays = torch.cat([o.t(), d.t()]).to(torch.float32)
    if rp != r:
        # Pad lanes carry eff == 0: missed, and they list nothing.
        pad = torch.zeros((6, rp - r), dtype=torch.float32, device=dev)
        pad[3] = 1.0
        rays = torch.cat([rays, pad], dim=1)
        eff = torch.cat([eff, torch.zeros((rp - r,), dtype=torch.float32, device=dev)])
    # The loop state, updated in place by the loops' steps.
    rays = rays.contiguous()
    state = state_bits(payload_state0(payload, eff, K_NEE))
    lane = torch.arange(rp, dtype=torch.int64, device=dev)
    tlo = torch.where(eff > _T_MIN, torch.full((rp,), -1, dtype=torch.int32, device=dev),
                      torch.full((rp,), EMPTY, dtype=torch.int32, device=dev))
    stats = torch.zeros((4,), dtype=torch.int64, device=dev)
    rungs = round_ladder(blocks)
    edges = round_edges(blocks)
    gen_ctrl = pc.new_ctrl(dev)

    def generation(h_gen):
        bnd = payload_bound(payload, state_fields(state, payload, K_NEE), K_NEE).contiguous()
        keys, tlim = listing(grid, rays, bnd, tlo, L)
        stats[0] += 1
        round_ctrl = pc.new_ctrl(dev)

        def one_round(h_round):
            regroup_into(keys, rays, state, tlo, tlim, lane)
            iters = torch.zeros((blocks,), dtype=torch.int32, device=dev)
            handles = ex.conds(len(rungs))
            ex.control(keys[0] != EMPTY, round_ctrl, pc.SET_LIVE | pc.RUNGS, edges=edges,
                       handles=handles)

            def served(ks, st, it):
                if ks is not keys:  # the plain round returns new tensors
                    keys.copy_(ks)
                    state.copy_(st)

            def rung(g, _h):
                served(*run_round(grid, media9, None, rays, keys, state, payload, K_NEE,
                                  cap_iters, ctrl=round_ctrl, group=g, iters=iters))

            def host(lb):
                served(*run_round(grid, media9, lb, rays, keys, state, payload, K_NEE,
                                  cap_iters, iters=iters))

            ex.rungs(handles, round_ctrl, [partial(rung, g) for _, _, g in rungs],
                     host=(pc.CTRL_LIVE, host))
            stats[1] += 1
            stats[2] += iters.sum()
            stats[3] += round_ctrl[pc.CTRL_NALIVE]
            ex.control(keys[0] != EMPTY, round_ctrl, pc.COND, handle=h_round)

        h_round = ex.cond()
        ex.control(keys[0] != EMPTY, round_ctrl, pc.COND, handle=h_round)
        ex.loop(h_round, round_ctrl, one_round)
        bnd2 = payload_bound(payload, state_fields(state, payload, K_NEE), K_NEE)
        unresolved = (tlim != EMPTY) & (entry_of(tlim) < bnd2)
        tlo.copy_(torch.where(unresolved, tlim, torch.full_like(tlim, EMPTY)))
        ex.control(tlo != EMPTY, gen_ctrl, pc.COND | pc.ITER_STEP | pc.ITER_CAP, cap=max_gens,
                   handle=h_gen)

    h_gen = ex.cond()
    ex.control(tlo != EMPTY, gen_ctrl, pc.COND | pc.ITER_RESET | pc.ITER_CAP, cap=max_gens,
               handle=h_gen)
    ex.loop(h_gen, gen_ctrl, generation)

    restored = torch.empty_like(state)
    restored[:, lane] = state
    result = tuple(x[:r] for x in state_fields(restored, payload, K_NEE))
    if payload == "nee":
        eff_r = eff[:r]
        ts = tuple(nee_unpack_t(k, eff_r) for k in result[:K_NEE])
        ms = tuple(nee_unpack_mat(k) for k in result[:K_NEE])
        result = ts + ms + (result[K_NEE],)
    if debug_stats:
        return result, stats
    return result
