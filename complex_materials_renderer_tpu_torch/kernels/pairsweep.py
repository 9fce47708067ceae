"""Pair-expanded cluster-major traversal: the pair sweep (K6).

Counterpart of complex_materials_renderer_tpu/kernels/pairsweep.py
(``_make_sweep_kernel`` :111, ``trace_pairs`` :177, ``_derive_full``
:420). A trace runs generations; each generation

1. LISTS each lane's L nearest-entry candidate clusters with the binned
   listing (K4, ``binned_trace.listing``);
2. EXPANDS one (lane, cluster) pair per list entry into a flat key
   [cluster id << 16 | lane], sorts the keys once (stably, carrying the
   original index) so that the pairs come cluster-major, and gathers each
   pair's ray and seed (the lane's best t, or its nearest opaque t);
3. SWEEPS the pairs in 1024-pair blocks (``sweep``: K6): each block serves
   its distinct cluster ids smallest first against all its pairs; K6
   takes the generation's pair count from the control block
   (kernels/pass_control.py), its G ladder (``group_size``) one IF node a
   rung whose grid covers that rung's most pairs;
4. sends the results back to pair order (the inverse of the sort) and
   FOLDS them per lane; lanes whose list overflowed relist from their L-th
   key, as in the binned trace.

'full' sweeps as 'dist' and derives the shading payload from the winning
slot at the end (``_derive_full``). The lane field of the flat key caps a
trace at 65,536 lanes, the Renderer's pass width. The generation loop is
the JAX ``lax.while_loop`` (:388-405) on ``any(t_lo != EMPTY)`` and the
generation cap: run by an executor, on the card a conditional WHILE node
of the caller's CUDA graph, its state updated in place; on the eager
executor the host reads its condition and passes K6 its pair count as an
int.

On CUDA tensors ``sweep`` launches the kernel of ``csrc/pair_sweep.cu``
(or raises); on CPU tensors it runs ``sweep_plain``, which serves per
1024-pair block as the kernel does, so the two agree on every pair.
``chunk_blocks`` (the TPU kernel's blocks per grid step) only pads the
pair count to whole steps; it never changes a result.
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from .binned_trace import (
    BIGC,
    BLOCK,
    EMPTY,
    ID_MASK,
    PAYLOAD_IDS,
    _T_MIN,
    check_grid,
    entry_of,
    listing,
    n_state,
    scene_box_clamp,
    state_bits,
    state_fields,
)
from .cluster_grid import DeviceClusterGrid
from .cluster_test import (
    _DET_BIG,
    _DET_MIN,
    group_size,
    nee_list_len,
    nee_unpack_mat,
    nee_unpack_t,
    payload_bound,
    payload_state0,
    slot_table,
    trace_slots,
)
from . import pass_control as pc
from .megakernel import _INF, _require

LANE_BITS = 16  # flat pair key = [cluster id << 16 | lane]
MAX_LANES = 1 << LANE_BITS
SWEEP_PAYLOADS = ("dist", "occl", "nee")


def _seed_state(payload: str, seed: torch.Tensor, K_NEE: int):
    """A pair's initial sweep state from its seed (pairsweep.py:138-144)."""
    if payload == "nee":
        empty = torch.full(seed.shape, EMPTY, dtype=torch.int32, device=seed.device)
        return tuple([empty] * K_NEE) + (seed,)
    if payload == "occl":
        return (seed,)
    return (seed, torch.full_like(seed, -1.0))


def sweep_plain(grid: DeviceClusterGrid, media9: torch.Tensor, rays: torch.Tensor,
                cid: torch.Tensor, payload: str, K_NEE: int) -> torch.Tensor:
    """The plain version of the sweep: the (ns, P) ``state_bits`` of every
    pair. ``rays`` is (7, P) (origin, direction, seed), ``cid`` (P,) the
    pairs' cluster ids (BIGC: padding); P is a multiple of 1024."""
    P = cid.shape[0]
    blocks = P // BLOCK
    state = state_bits(_seed_state(payload, rays[6], K_NEE))
    cidv = cid.view(blocks, BLOCK).clone()
    med_ids = media9[:, 0].tolist()
    W = grid.width
    while True:
        c = cidv.amin(dim=1)
        go = c < BIGC
        if not bool(go.any()):
            break
        mine = (cidv == c[:, None]) & go[:, None]
        fields = state_fields(state, payload, K_NEE)
        c_pair = c.repeat_interleave(BLOCK)
        for cv in torch.unique(c[go]).tolist():
            sel = c_pair == cv
            if payload == "nee":
                sel = sel & mine.reshape(-1)
            pairs = sel.nonzero().squeeze(1)
            sub = trace_slots(slot_table(grid, cv * W, (cv + 1) * W),
                              tuple(rays[a, pairs] for a in range(6)), payload,
                              tuple(f[pairs] for f in fields), _T_MIN, K_NEE, med_ids,
                              in_order=True)
            state[:, pairs] = state_bits(sub)
        cidv = torch.where(mine, torch.full_like(cidv, BIGC), cidv)
    return state


def seed_state_bits(rays: torch.Tensor, payload: str, K_NEE: int) -> torch.Tensor:
    """The (ns, P) ``state_bits`` of every pair before the sweep: its seed
    state, which a pair that no block serves keeps."""
    return state_bits(_seed_state(payload, rays[6], K_NEE))


def sweep_ladder(P: int):
    """K6's G ladder over 1 to ``P`` valid pairs: (first pairs, last, G) a
    rung (``pass_control.ladder`` of ``group_size``)."""
    return pc.ladder(group_size, P)


def sweep(grid: DeviceClusterGrid, media9: torch.Tensor, rays: torch.Tensor, cid: torch.Tensor,
          payload: str, K_NEE: int, pairs: int | None = None,
          ctrl: torch.Tensor | None = None, group: int | None = None,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """The (ns, P) ``state_bits`` of the pair sweep: the kernel of
    ``csrc/pair_sweep.cu`` on CUDA tensors (launches counted in
    ``sweep.launches``, or on the card when captured), ``sweep_plain`` on
    CPU tensors. The kernel needs ``pairs``, the number of valid pairs (cid
    < BIGC) as a host int: it picks the threads per pair (``group_size``)
    and sizes the grid, and the wrapper never reads it back from the card;
    with no valid pair nothing is launched and every pair keeps its seed
    state. Or ``pairs`` is None and ``ctrl``, a pass control block, holds
    the count on the card (CTRL_NALIVE) and ``group`` is a rung of
    ``sweep_ladder``: the grid covers that rung's most pairs. ``out``, when
    given, receives the state (and holds the seed state where the kernel is
    not launched)."""
    if payload not in SWEEP_PAYLOADS:
        raise ValueError(f"the sweep takes 'dist', 'occl' or 'nee', got {payload!r}")
    P = cid.shape[0]
    if ctrl is not None:
        if pairs is not None:
            raise ValueError("a sweep with the control block takes no host pair count")
        rungs = {g: b for _, b, g in sweep_ladder(max(1, P))}
        if group not in rungs:
            raise ValueError(f"group {group!r} is no rung of the sweep's ladder")
    if rays.device.type == "cpu":
        state = sweep_plain(grid, media9, rays, cid, payload, K_NEE)
        if out is not None:
            out.copy_(state)
            return out
        return state
    from . import build

    dev = rays.device
    if P % BLOCK:
        raise ValueError(f"the sweep takes whole blocks of {BLOCK} pairs, got {P}")
    if (K_NEE - 2) % 2 or K_NEE < 2:
        raise ValueError(f"K-list length {K_NEE} is not 2 * nee_bound + 2")
    C = grid.num_clusters
    row_w = grid.run_rows.shape[1]
    _require(grid.run_rows, "run_rows", torch.float32, (C * grid.runs_per_cluster, row_w), dev)
    _require(media9, "media9", torch.float32, (media9.shape[0], 9), dev)
    _require(rays, "rays", torch.float32, (7, P), dev)
    _require(cid, "cid", torch.int32, (P,), dev)
    if ctrl is None and (not isinstance(pairs, int) or not 0 <= pairs <= P):
        raise ValueError(f"pairs must be a host int in [0, {P}], got {pairs!r}")
    ns = n_state(payload, K_NEE)
    if out is None:
        out = seed_state_bits(rays, payload, K_NEE) if pairs == 0 else \
            torch.empty((ns, P), dtype=torch.int32, device=dev)
    _require(out, "out", torch.int32, (ns, P), dev)
    if P == 0 or pairs == 0:
        return out
    if ctrl is not None:
        _require(ctrl, "ctrl", torch.int32, (pc.CTRL_LEN,), dev)
        most, g = min(rungs[group], P), group
        count = ctypes.c_void_p(ctrl.data_ptr() + 4 * pc.CTRL_NALIVE)
    else:
        most, g, count = pairs, group_size(pairs), None
    fn = build.pair_sweep((K_NEE - 2) // 2)
    cover = max(BLOCK, -(-most // BLOCK) * BLOCK)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p(media9), media9.shape[0], p(grid.run_rows), p(rays), p(cid), p(out), P,
                 cover, C, grid.runs_per_cluster, grid.run_size, row_w, PAYLOAD_IDS[payload],
                 g, count, ctypes.c_void_p(stream))
    pc.count_launch(sweep, "K6", dev)
    if err != 0:
        raise RuntimeError(f"pair sweep launch failed: {build.error_string(err)}")
    return out


sweep.launches = 0  # CUDA launches made by sweep


def expand_pairs(keys: torch.Tensor, rays: torch.Tensor, seed: torch.Tensor,
                 chunk_blocks: int):
    """The sweep's inputs from a listing (pairsweep.py:298-326): (pair rays
    (7, Ppad), cluster ids (Ppad,), the sort's original index (Ppad,)).
    Flat index f = list slot * lanes + lane; padding and empty slots carry
    BIGC and sort last; their rays are those of the last lane (the TPU
    gather clamps the index)."""
    L, rp = keys.shape
    dev = keys.device
    P = L * rp
    step_pairs = chunk_blocks * BLOCK
    Ppad = -(-P // step_pairs) * step_pairs
    lanes = torch.arange(rp, dtype=torch.int32, device=dev)
    flat = torch.where(keys == EMPTY, EMPTY, ((keys & ID_MASK) << LANE_BITS) | lanes).reshape(-1)
    if Ppad != P:
        flat = torch.cat([flat, torch.full((Ppad - P,), EMPTY, dtype=torch.int32, device=dev)])
    skey, orig = torch.sort(flat, stable=True)
    lane_p = torch.clamp(skey & (MAX_LANES - 1), max=rp - 1).to(torch.int64)
    cid = torch.where(skey == EMPTY, BIGC, skey >> LANE_BITS).to(torch.int32)
    pair_rays = torch.cat([rays, seed[None]])[:, lane_p].contiguous()
    return pair_rays, cid, orig


def _fold(payload: str, state, keys: torch.Tensor, results, K_NEE: int):
    """Fold the (fields, L, lanes) per-pair results into the per-lane
    state (pairsweep.py:360-386). A NEE list keeps the K smallest keys of
    the lane's and its pairs' keys, as the min/max insertion chain does."""
    valid = keys != EMPTY
    L = keys.shape[0]
    if payload == "nee":
        topq = torch.minimum(state[K_NEE],
                             torch.where(valid, results[K_NEE], _INF).amin(dim=0))
        cand = torch.where(valid[None], torch.stack(results[:K_NEE]), EMPTY)
        allk = torch.cat([torch.stack(state[:K_NEE]), cand.reshape(K_NEE * L, -1)])
        top = torch.topk(allk, K_NEE, dim=0, largest=False, sorted=True).values
        return tuple(top[i] for i in range(K_NEE)) + (topq,)
    if payload == "occl":
        return (torch.minimum(state[0], torch.where(valid, results[0], _INF).amin(dim=0)),)
    t, slot = state
    for i in range(L):
        better = valid[i] & (results[0][i] < t)
        t = torch.where(better, results[0][i], t)
        slot = torch.where(better, results[1][i], slot)
    return (t, slot)


def trace_pairs(grid: DeviceClusterGrid, media9: torch.Tensor, o: torch.Tensor,
                d: torch.Tensor, bound: torch.Tensor, payload: str, world_lo=None,
                world_hi=None, nee_max_media: int = 4, list_len: int = 12, max_gens: int = 64,
                chunk_blocks: int = 8, ex=None):
    """Cluster-major pair-sweep trace (pairsweep.py:177); the payload
    contract of trace_binned. ``list_len`` bounds the candidates of one
    generation (overflow relists, never truncates). ``ex`` runs the
    generation loop (``pass_control.executor``)."""
    if payload not in PAYLOAD_IDS:
        raise ValueError(f"unknown payload {payload!r}")
    check_grid(grid, media9)
    L = list_len
    K_NEE = nee_list_len(nee_max_media)
    dev = o.device
    ex = pc.executor(dev, ex)
    r = o.shape[0]
    blocks = -(-r // BLOCK)
    rp = blocks * BLOCK
    if rp > MAX_LANES:
        raise ValueError(
            f"pair trace pass width {rp} exceeds {MAX_LANES} lanes (the flat key's "
            "16-bit lane field); chunk the pass"
        )
    spayload = "dist" if payload == "full" else payload

    eff = torch.where(bound > _T_MIN, bound, torch.zeros_like(bound)).to(torch.float32)
    if payload in ("full", "dist") and world_lo is not None:
        eff = scene_box_clamp(eff, o, d, world_lo, world_hi)
    rays = torch.cat([o.t(), d.t()]).to(torch.float32)
    if rp != r:
        pad = torch.zeros((6, rp - r), dtype=torch.float32, device=dev)
        pad[3] = 1.0
        rays = torch.cat([rays, pad], dim=1)
        eff = torch.cat([eff, torch.zeros((rp - r,), dtype=torch.float32, device=dev)])
    rays = rays.contiguous()
    # The loop state, updated in place by the generations.
    state = tuple(x.clone() for x in payload_state0(spayload, eff, K_NEE))
    tlo = torch.where(eff > _T_MIN, torch.full((rp,), -1, dtype=torch.int32, device=dev),
                      torch.full((rp,), EMPTY, dtype=torch.int32, device=dev))
    rungs = sweep_ladder(L * rp)
    edges = pc.rung_edges(rungs)
    gen_ctrl = pc.new_ctrl(dev)

    def generation(h_gen):
        keys, tlim = listing(grid, rays, payload_bound(spayload, state, K_NEE).contiguous(), tlo,
                             L)
        pair_ctrl = pc.new_ctrl(dev)
        handles = ex.conds(len(rungs))
        # The generation's pair count, on the card: K6's rung and its cover.
        ex.control((keys != EMPTY).reshape(-1), pair_ctrl, pc.RUNGS, site="K4 pair listing",
                   edges=edges, handles=handles)
        seed = state[K_NEE] if spayload == "nee" else state[0]
        pair_rays, cid, orig = expand_pairs(keys, rays, seed, chunk_blocks)
        out = seed_state_bits(pair_rays, spayload, K_NEE)

        def rung(g, _h):
            sweep(grid, media9, pair_rays, cid, spayload, K_NEE, ctrl=pair_ctrl, group=g,
                  out=out)

        def host(pairs):
            sweep(grid, media9, pair_rays, cid, spayload, K_NEE, pairs, out=out)

        ex.rungs(handles, pair_ctrl, [partial(rung, g) for _, _, g in rungs],
                 host=(pc.CTRL_NALIVE, host))
        back = torch.empty_like(out)
        back[:, orig] = out
        results = state_fields(back[:, :L * rp].reshape(-1, L, rp), spayload, K_NEE)
        for x, y in zip(state, _fold(spayload, state, keys, results, K_NEE)):
            x.copy_(y)
        bnd2 = payload_bound(spayload, state, K_NEE)
        unresolved = (tlim != EMPTY) & (entry_of(tlim) < bnd2)
        tlo.copy_(torch.where(unresolved, tlim, torch.full_like(tlim, EMPTY)))
        ex.control(tlo != EMPTY, gen_ctrl, pc.COND | pc.ITER_STEP | pc.ITER_CAP,
                   site="K6 pair sweep", cap=max_gens, handle=h_gen)

    h_gen = ex.cond()
    ex.control(tlo != EMPTY, gen_ctrl, pc.COND | pc.ITER_RESET | pc.ITER_CAP,
               site="pair trace head", cap=max_gens, handle=h_gen)
    ex.loop(h_gen, gen_ctrl, generation)

    if payload == "full":
        return tuple(x[:r] for x in _derive_full(grid, state, rays))
    result = tuple(s[:r] for s in state)
    if payload == "nee":
        eff_r = eff[:r]
        ts = tuple(nee_unpack_t(k, eff_r) for k in result[:K_NEE])
        ms = tuple(nee_unpack_mat(k) for k in result[:K_NEE])
        result = ts + ms + (result[K_NEE],)
    return result


def _derive_full(grid: DeviceClusterGrid, state, rays: torch.Tensor):
    """The shading payload from the winning (t, slot) (pairsweep.py:420):
    the slot's components (``slot_table``) and one Moller-Trumbore
    recompute in the tester's operation order."""
    t, slot_f = state
    ox, oy, oz, dx, dy, dz = rays
    hit = slot_f >= 0.0
    slot = torch.clamp(slot_f, min=0.0).to(torch.int64)
    sl = slot_table(grid)
    ax, ay, az = sl.ax[slot], sl.ay[slot], sl.az[slot]
    e1x, e1y, e1z = sl.e1x[slot], sl.e1y[slot], sl.e1z[slot]
    e2x, e2y, e2z = sl.e2x[slot], sl.e2y[slot], sl.e2z[slot]
    mat = sl.mat[slot]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(det.abs() > _DET_MIN, det, torch.full_like(det, _DET_BIG))
    sx = ox - ax
    sy = oy - ay
    sz = oz - az
    uu = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    zero = torch.zeros_like(t)
    neg1 = torch.full_like(t, -1.0)
    sel = lambda a, miss: torch.where(hit, a, miss)  # noqa: E731
    return (
        t, sel(slot_f, neg1), sel(uu, zero), sel(vv, zero),
        sel(e1y * e2z - e1z * e2y, zero), sel(e1z * e2x - e1x * e2z, zero),
        sel(e1x * e2y - e1y * e2x, torch.ones_like(t)), sel(mat, neg1),
        sel(ax + uu * e1x + vv * e2x, zero), sel(ay + uu * e1y + vv * e2y, zero),
        sel(az + uu * e1z + vv * e2z, zero),
    )
