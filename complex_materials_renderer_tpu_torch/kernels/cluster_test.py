"""Triangle tester over cluster slots (K2): constants, packed NEE keys and
the plain PyTorch payloads.

Counterpart of complex_materials_renderer_tpu/kernels/cluster_test.py
(``make_cluster_tester`` :119, a device function inlined in the Pallas
megakernel). On the card the tester is the ``__device__`` code of
``csrc/cluster_test.cuh``, inlined in the megakernel; this module holds
the constants both share and the plain version, which tests a whole slot
range at once (brute force over slots, chunked over lanes) and merges the
result into a payload state exactly as the sequential walk's strict
updates would:

- ``full`` -> (t, slot, u, v, nx, ny, nz, mat, px, py, pz)
- ``dist`` -> (t, slot);  ``occl`` -> (t,)
- ``nee``  -> K packed int32 keys [t-bits & ~63 | media row] + t_opq
- ``dnee`` -> ``dist`` for ray set A + ``nee`` for ray set B, one origin

Closest hits: the first slot (lowest index) of least t among hits with
t_min < t < bound — what the strict ``tt < t_best`` walk keeps. The
standalone closest-hit kernel K3 (``cluster_trace.py``) shares this plain
tester with another far-edge acceptance (``additive_eps``, see ``_mt``). NEE: the
K smallest media keys below the final opaque bound t_opq. A walk may
also keep keys beyond a t_opq that shrank after their insertion; the
shadow march (megakernel ``nee_resolve``) treats such keys exactly like
empty slots, so both give the same light. The binned and pair engines,
which hold their kernels to this version key for key, ask for the walk's
keys (``in_order``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEE_MAT_BITS = 6
NEE_MAT_MASK = (1 << NEE_MAT_BITS) - 1
KEY_EMPTY = 2147483647
# Spare K-list slots that absorb duplicate (coincident-shell) media
# boundaries; see the JAX module for the history.
NEE_DUP_SPARE = 2

_EPS = float(np.float32(1e-6))
_ONE_EPS = float(np.float32(1.0) + np.float32(1e-6))
_DET_MIN = float(np.float32(1e-12))
_DET_BIG = float(np.float32(1e30))
_INF = float(np.float32(3e38))

PAYLOADS = ("full", "dist", "occl", "nee", "dnee")

# Threads per ray (G) of the group walk of the CUDA kernels K1 and K3
# (csrc/cluster_test.cuh ``group_cluster_full``), each built for all of
# these; and the threads a launch aims to put on the card: about the
# H100's 132 SMs x 2,048 resident threads, rounded down to 2^18 so that
# the main path's 65,536-lane launches take G = 4, which measured fastest
# there (PERF.md).
GROUP_SIZES = (1, 2, 4, 8, 16, 32)
FILL_THREADS = 1 << 18


def group_size(lanes: int) -> int:
    """G for a K1 or K3 launch of ``lanes`` rays: the smallest G with
    lanes x G >= FILL_THREADS, at most 32, so that a narrow launch still
    fills the card (PERF.md has the times at every G)."""
    for g in GROUP_SIZES:
        if lanes * g >= FILL_THREADS:
            return g
    return GROUP_SIZES[-1]


def nee_list_len(nee_max_media: int) -> int:
    """K-list length: enter+exit per media pair, plus the spares."""
    return 2 * nee_max_media + NEE_DUP_SPARE


def nee_unpack_t(key: torch.Tensor, miss) -> torch.Tensor:
    """Boundary distance of a packed key (quantized down <= 63 ulps);
    ``miss`` for empty slots."""
    t = (key & ~NEE_MAT_MASK).view(torch.float32)
    return torch.where(key == KEY_EMPTY, miss, t)


def nee_unpack_mat(key: torch.Tensor) -> torch.Tensor:
    """Media-table row index of a packed key; -1.0 for empty slots."""
    m = (key & NEE_MAT_MASK).to(torch.float32)
    return torch.where(key == KEY_EMPTY, torch.full_like(m, -1.0), m)


def payload_state0(payload: str, TMAX, K_NEE: int = 0, TMAX_B=None):
    """Initial traversal state for a payload kind (t == TMAX on miss,
    slot/mat == -1)."""
    zeros = torch.zeros_like(TMAX)
    neg1 = torch.full_like(TMAX, -1.0)
    if payload == "full":
        return (TMAX, neg1, zeros, zeros, zeros, zeros,
                torch.ones_like(TMAX), neg1, zeros, zeros, zeros)
    empty = torch.full(TMAX.shape, KEY_EMPTY, dtype=torch.int32, device=TMAX.device)
    if payload == "nee":
        return tuple([empty] * K_NEE) + (TMAX,)
    if payload == "dnee":
        return (TMAX, neg1) + tuple([empty] * K_NEE) + (TMAX_B,)
    if payload == "occl":
        return (TMAX,)
    return (TMAX, neg1)


def payload_bound(payload: str, state, K_NEE: int = 0):
    """Early-exit bound: t_best, or min(K-th media key, t_opq) for 'nee'."""
    if payload == "nee":
        kth = nee_unpack_t(state[K_NEE - 1], _INF)
        return torch.minimum(kth, state[K_NEE])
    return state[0]


class SlotTable(NamedTuple):
    """A contiguous slot range of the grid, one entry per slot."""

    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    e1x: torch.Tensor
    e1y: torch.Tensor
    e1z: torch.Tensor
    e2x: torch.Tensor
    e2y: torch.Tensor
    e2z: torch.Tensor
    mat: torch.Tensor
    qa: torch.Tensor
    qb: torch.Tensor
    slot0: int  # global index of the first slot


def slot_table(grid, lo: int = 0, hi: int | None = None) -> SlotTable:
    """Slots [lo, hi) of a DeviceClusterGrid (slot = cluster*width + j)."""
    comps = [grid.v0x, grid.v0y, grid.v0z, grid.e1x, grid.e1y, grid.e1z,
             grid.e2x, grid.e2y, grid.e2z, grid.mat, grid.qa, grid.qb]
    return SlotTable(*(c.reshape(-1)[lo:hi] for c in comps), slot0=lo)


def media_index(mat: torch.Tensor, med_ids) -> torch.Tensor:
    """Media-table row index per material id (-1 = none), first matching
    row wins (volpath:137-145)."""
    idx = torch.full_like(mat, -1.0)
    for i in reversed(range(len(med_ids))):
        mid = float(med_ids[i])
        idx = torch.where((mat == mid) & (mid >= 0.0), torch.full_like(idx, float(i)), idx)
    return idx


def _mt(sl: SlotTable, O, D, additive_eps: bool = False):
    """Moller-Trumbore of every lane (rows) against every slot (columns),
    in the JAX tester's operation order. Returns (uu, vv, tt, inside).

    The far-edge tests are K2's, ``<= q * (1 + eps)`` (cluster_test.py
    :212-227 of the JAX package), or with ``additive_eps`` those of the
    standalone closest-hit kernel K3, ``<= q + eps`` (pallas_trace.py
    :301-308): on triangle slots (q = 0.5) K3 admits u+v <= 1 + 2e-6 where
    K2 admits u+v <= 1 + 1e-6."""
    OX, OY, OZ = (o[:, None] for o in O)
    DX, DY, DZ = (d[:, None] for d in D)
    px = DY * sl.e2z - DZ * sl.e2y
    py = DZ * sl.e2x - DX * sl.e2z
    pz = DX * sl.e2y - DY * sl.e2x
    det = sl.e1x * px + sl.e1y * py + sl.e1z * pz
    inv_det = 1.0 / torch.where(det.abs() > _DET_MIN, det, torch.full_like(det, _DET_BIG))
    sx = OX - sl.ax
    sy = OY - sl.ay
    sz = OZ - sl.az
    uu = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * sl.e1z - sz * sl.e1y
    qy = sz * sl.e1x - sx * sl.e1z
    qz = sx * sl.e1y - sy * sl.e1x
    vv = (DX * qx + DY * qy + DZ * qz) * inv_det
    t_num = sl.e2x * qx + sl.e2y * qy + sl.e2z * qz
    tt = t_num * inv_det
    qa1 = 1.0 - sl.qa
    qb1 = 1.0 - sl.qb
    if additive_eps:
        lim_b, lim_a = sl.qb + _EPS, sl.qa + _EPS
    else:
        lim_b, lim_a = sl.qb * _ONE_EPS, sl.qa * _ONE_EPS
    inside = (
        (uu >= -_EPS)
        & (vv >= -_EPS)
        & (uu * sl.qb + vv * qa1 <= lim_b)
        & (uu * qb1 + vv * sl.qa <= lim_a)
    )
    return uu, vv, tt, inside


def _closest(sl: SlotTable, O, D, state, t_min, full: bool, additive_eps: bool = False):
    """Merge the closest hit over ``sl`` into a (t, slot[, ...]) state."""
    uu, vv, tt, inside = _mt(sl, O, D, additive_eps)
    t_best = state[0]
    ok = inside & (tt > t_min) & (tt < t_best[:, None])
    masked = torch.where(ok, tt, torch.full_like(tt, float("inf")))
    tmin, j = masked.min(dim=1)
    improved = ok.any(dim=1)
    t_new = torch.where(improved, tmin, t_best)
    if len(state) == 1:
        return (t_new,)
    slot = torch.where(improved, (j + sl.slot0).to(torch.float32), state[1])
    if not full:
        return (t_new, slot)
    jj = j[:, None]
    u = uu.gather(1, jj)[:, 0]
    v = vv.gather(1, jj)[:, 0]
    g = lambda a: a[j]  # noqa: E731 - per-lane component of the winning slot
    e1x, e1y, e1z, e2x, e2y, e2z = (g(a) for a in (sl.e1x, sl.e1y, sl.e1z, sl.e2x, sl.e2y, sl.e2z))
    upd = (
        u, v,
        e1y * e2z - e1z * e2y,
        e1z * e2x - e1x * e2z,
        e1x * e2y - e1y * e2x,
        g(sl.mat),
        g(sl.ax) + u * e1x + v * e2x,
        g(sl.ay) + u * e1y + v * e2y,
        g(sl.az) + u * e1z + v * e2z,
    )
    rest = tuple(torch.where(improved, a, b) for a, b in zip(upd, state[2:]))
    return (t_new, slot) + rest


def _nee(sl: SlotTable, O, D, state, t_min, K_NEE, med_ids, mask=None, in_order=False):
    """Merge the NEE boundary sweep over ``sl`` into (K keys..., t_opq).

    A media hit is kept when it lies below the final t_opq; with
    ``in_order``, as in the walk, slot by slot: below t_opq as it stood
    before its slot (the lane's t_opq and the opaque hits of the slots
    before it), so the keys equal the walk's, including keys beyond an
    opaque hit found later. ``mask`` (per lane) lets only its lanes accept
    hits (cluster_test.py:307-308 of the JAX package)."""
    _, _, tt, inside = _mt(sl, O, D)
    midx = media_index(sl.mat, med_ids)
    med = midx >= 0.0
    valid_geom = inside & (tt > t_min)
    if mask is not None:
        valid_geom = valid_geom & mask[:, None]
    inf = torch.full_like(tt, float("inf"))
    t_in = state[K_NEE][:, None]
    opq_run = torch.minimum(torch.cummin(torch.where(valid_geom & ~med, tt, inf), dim=1).values,
                            t_in)
    t_opq = opq_run[:, -1]
    t_before = torch.cat([t_in, opq_run[:, :-1]], dim=1) if in_order else t_opq[:, None]
    valid = valid_geom & med & (tt < t_before)
    mat_i = torch.clamp(midx, min=0.0).to(torch.int32)
    key = (tt.view(torch.int32) & ~NEE_MAT_MASK) | mat_i
    cand = torch.where(valid, key, torch.full_like(key, KEY_EMPTY))
    allk = torch.cat([torch.stack(state[:K_NEE], dim=1), cand], dim=1)
    keys = torch.topk(allk, K_NEE, dim=1, largest=False, sorted=True).values
    return tuple(keys[:, i].contiguous() for i in range(K_NEE)) + (t_opq,)


def _lane_chunk(n_slots: int, device) -> int:
    budget = (1 << 25) if torch.device(device).type == "cuda" else (1 << 21)
    return max(1, budget // max(1, n_slots))


def trace_slots(sl: SlotTable, rays, payload: str, state, t_min,
               K_NEE: int = 0, med_ids=(), additive_eps: bool = False, mask=None,
               in_order: bool = False):
    """Test every slot of ``sl`` against every lane and merge the hits
    into ``state`` (see payload_state0). ``rays`` is (OX, OY, OZ, DX, DY,
    DZ), or for 'dnee' (OX, OY, OZ, DX, DY, DZ, DXB, DYB, DZB).
    ``additive_eps`` selects K3's acceptance for 'full' (see ``_mt``);
    ``mask`` (per lane) restricts which lanes accept 'nee' hits, and
    ``in_order`` keeps the 'nee' keys of a walk over the slots in order
    (see ``_nee``)."""
    if payload not in PAYLOADS:
        raise ValueError(f"unknown payload {payload!r}")
    n = rays[0].shape[0]
    step = _lane_chunk(sl.ax.shape[0], rays[0].device)
    outs = []
    for lo in range(0, n, step):
        r = tuple(x[lo:lo + step] for x in rays)
        st = tuple(x[lo:lo + step] for x in state)
        O, DA = r[0:3], r[3:6]
        if payload == "full":
            outs.append(_closest(sl, O, DA, st, t_min, full=True, additive_eps=additive_eps))
        elif payload in ("dist", "occl"):
            outs.append(_closest(sl, O, DA, st, t_min, full=False))
        elif payload == "nee":
            outs.append(_nee(sl, O, DA, st, t_min, K_NEE, med_ids,
                             None if mask is None else mask[lo:lo + step], in_order))
        else:
            a = _closest(sl, O, DA, st[:2], t_min, full=False)
            b = _nee(sl, O, r[6:9], st[2:], t_min, K_NEE, med_ids)
            outs.append(a + b)
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))
