"""Path-tracing megakernel (K1): the whole per-sample bounce loop in one
kernel launch.

Counterpart of complex_materials_renderer_tpu/kernels/megakernel.py
(``trace_paths_mega`` :1475, the ``pallas_call`` at :1594 with the body
``_make_kernel`` :348). On a CUDA state, ``trace_paths_mega`` launches the
hand-written kernel of ``csrc/megakernel.cu`` (a tile of ``group_size``
threads per lane, the triangle tester K2 of ``csrc/cluster_test.cuh``
inlined); on a CPU state it runs ``trace_paths_mega_plain``, a vectorised
PyTorch transcription of the Pallas body's ``bounce`` (:992-1370),
``nee_setup`` and ``nee_resolve`` and of the helpers at :89-345, over all
lanes at once, with a brute-force traversal over all slots
(``cluster_test.trace_slots``).
The plain version is what the CPU tests run and what the card's kernel is
held against.

Per bounce: closest-hit traversal ('full', clamped to the scene-box
exit), Fresnel boundary event, the free-flight candidate draw, the fused
'dnee' traversal (distance to the next boundary along the transmitted
direction, bounded by the candidate, plus the NEE K-list sweep toward the
light from the same origin), free-flight sampling, the shadow march over
the K-list (0.9 per-boundary factor), HG scattering, medium
pass-through with the stale-normal second boundary, diffuse shading, and
Russian roulette after ``rr_depth``. Randoms are PCG32 (parity and
counter modes) or lockstep Owen-scrambled Sobol (ld mode), drawn in the
kernel. Physics and RNG order follow the JAX kernel line by line; see
its docstrings for the reference (volpath) line map.

On a grid of more than 16 supers (``two_level_walk``) the
default instance's walks test the grid's group boxes (``group_bounds``,
each over consecutive supers) above the supers, in index order, and skip
the supers of a group they miss; on fewer, and in the ablation instances,
they walk the supers alone. Both walks enter the same super and cluster
boxes and give the same state.

Each launch counts its walk, always: its lanes' bounces, the super boxes
its walks entered, the cluster boxes they entered (whose slots the tile
then tests) and the group boxes they entered (0 in the flat walk), in the
walks of the default instance ('full' and the fused 'dnee'; the
ablations' own walks count nothing), added to the card's accumulator
(``pass_control.walk_counts``, or ``walk``) for the next control launch
to move to its site. The group walk takes every box decision of the
one-thread walk, so the plain version gives the same counts from the
walk's bound before each box (``cluster_test``'s ``width``).

``debug`` takes the JAX kernel's ``CMR_MEGA_DEBUG`` ablations, a
comma-separated set of ``ABLATIONS`` tokens with the JAX semantics (see
``csrc/megakernel.cu`` for each). On the card each set is a CUDA instance
of its own (``ablation_mask``, a library per mask); the plain version
runs the same semantics. 'nofuse', 'ordered' and 'carrywalk' give the
default result (the walks are exact); the others are timing ablations
with other images.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import rng as rng_ops
from ..render import hitinfo
from .cluster_grid import DeviceClusterGrid
from .pass_control import (
    CTRL_DIM0,
    CTRL_LEN,
    CTRL_LIVE,
    CTRL_RUN,
    WALK_BOUNCES,
    WALK_CLUSTERS,
    WALK_GROUPS,
    WALK_LEN,
    WALK_SUPERS,
    walk_counts,
)
from .cluster_test import (
    group_size,
    nee_list_len,
    nee_unpack_mat,
    nee_unpack_t,
    payload_state0,
    slot_table,
    trace_slots,
)

BLOCK = 1024  # lanes per live block (the unit of ``live_blocks``)

# CMR_MEGA_DEBUG tokens and their bits in the ablation mask
# (csrc/megakernel.cu ``CMR_MEGA_ABLATE``; 'carrywalk' is read here only,
# ``cuda_instance``).
ABLATIONS = {"nofuse": 1, "ordered": 2, "carrywalk": 4, "cullonly": 8, "notrace": 16,
             "nophys": 32, "nodist": 64, "nonee": 128}
# Tokens that turn off the fused dist+NEE walk (megakernel.py:398-401).
_UNFUSED = (ABLATIONS["nofuse"] | ABLATIONS["ordered"] | ABLATIONS["carrywalk"]
            | ABLATIONS["nodist"] | ABLATIONS["nonee"])
# The token sets that the checks and timings run: each token alone, nonee
# with nodist, and notrace with cullonly (cullonly without its closest-hit
# walk: what cullonly's culls are timed against). The exact walks render
# the default image; the others time a part of the bounce.
ABLATION_SETS = ("nofuse", "ordered", "carrywalk", "cullonly", "notrace", "notrace,cullonly",
                 "nophys", "nodist", "nonee", "nonee,nodist")
EXACT_ABLATIONS = ("nofuse", "ordered", "carrywalk")

MAX_SUPERS = 1024  # super-cluster cap of the JAX kernel's (8, 128) entry table
# The default K1 tests group boxes above the super boxes on a grid of more
# than this many supers, and walks the supers alone on fewer. On an H100
# the two-level walk cost one-super grids 4-6% of their frames and gained a
# 172-super grid 11%; K1 alone crossed over between 12 and 18 supers
# (PERF.md §6).
FLAT_WALK_SUPERS = 16
DRAWS_PER_BOUNCE = 8  # rng draw sites per bounce iteration (sites 0-7)


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


_INF = _f32(3e38)
INV_FOURPI = _f32(0.07957747154594767)
LN_CLAMP = _f32(9.210340371976184)  # ln(1e4): the <1e-4 transmittance clamp depth
INV_PI = _f32(0.31830988618)
PI = _f32(3.14159265359)
TWOPI = _f32(6.28318530718)
PI_4 = float(np.float32(PI) / np.float32(4.0))
PI_2 = float(np.float32(PI) / np.float32(2.0))
REFLECTANCE = _f32(0.8)
_R_INV_PI = float(np.float32(REFLECTANCE) * np.float32(INV_PI))  # folded in float32
NO_INTERACTION = _f32(500000.0)
_ISO_EPS = _f32(1e-4)
T_MIN = _f32(hitinfo.T_MIN)
T_MAX = _f32(hitinfo.T_MAX)
_TEN_TMIN = float(np.float32(10.0) * np.float32(T_MIN))


def ablation_mask(debug: str) -> int:
    """The ablation mask of a comma-separated CMR_MEGA_DEBUG token set (''
    gives 0, the default kernel). An unknown token raises. With 'ordered'
    the walk is the ordered one, as in the JAX kernel, so 'carrywalk' is
    dropped beside it."""
    mask = 0
    for tok in debug.split(","):
        tok = tok.strip()
        if tok:
            if tok not in ABLATIONS:
                raise ValueError(f"unknown CMR_MEGA_DEBUG token {tok!r}; "
                                 f"expected some of {', '.join(ABLATIONS)}")
            mask |= ABLATIONS[tok]
    if mask & ABLATIONS["ordered"]:
        mask &= ~ABLATIONS["carrywalk"]
    return mask


def cuda_instance(mask: int) -> tuple[int, bool]:
    """The ablation mask of the CUDA library that runs ``mask``, and
    whether it launches one thread a lane. 'carrywalk' (the linear walk by
    one thread a lane, no tile) has no library of its own: it is the
    'nofuse' instance at G = 1, where the closest-hit tests are the
    thread's own (a linear walk in slot order keeps the lower slot of an
    equal t) and the 'nee' walk is the one-thread test
    (csrc/megakernel.cu ``thread_cluster_nee``)."""
    if mask & ABLATIONS["carrywalk"]:
        return (mask & ~ABLATIONS["carrywalk"]) | ABLATIONS["nofuse"], True
    return mask, False


class MegaState(NamedTuple):
    """Full per-lane path state. uint32 words (``rng``, ``aux``) are held
    in int64 tensors with values in [0, 2^32)."""

    org: torch.Tensor  # (R, 3) float32
    dir: torch.Tensor  # (R, 3) float32
    thr: torch.Tensor  # (R, 3) float32 throughput
    rad: torch.Tensor  # (R, 3) float32 accumulated radiance
    rng: torch.Tensor  # (R,) int64: PCG32 state (ld: shuffled sample index)
    depth: torch.Tensor  # (R,) int32
    alive: torch.Tensor  # (R,) bool
    aux: torch.Tensor  # (R,) int64: ld-mode pixel hash; zeros otherwise


def fresh_state(o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor, aux=None) -> MegaState:
    """Path state for freshly generated camera rays (post-jitter RNG)."""
    r = o.shape[0]
    dev = o.device
    return MegaState(
        org=o.contiguous(),
        dir=d.contiguous(),
        thr=torch.ones((r, 3), dtype=torch.float32, device=dev),
        rad=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        rng=rng.to(torch.int64).contiguous(),
        depth=torch.zeros((r,), dtype=torch.int32, device=dev),
        alive=torch.ones((r,), dtype=torch.bool, device=dev),
        aux=(aux.to(torch.int64).contiguous() if aux is not None
             else torch.zeros((r,), dtype=torch.int64, device=dev)),
    )


def from_jax_arrays(org, dir, thr, rad, rng, depth, alive, aux, device="cpu") -> MegaState:
    """A MegaState from the JAX package's MegaState fields given as numpy
    arrays (uint32 ``rng``/``aux`` become int64 words)."""
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dt))).to(device)  # noqa: E731
    return MegaState(
        org=t(org, np.float32), dir=t(dir, np.float32),
        thr=t(thr, np.float32), rad=t(rad, np.float32),
        rng=t(np.asarray(rng, np.uint32), np.int64),
        depth=t(depth, np.int32), alive=t(alive, np.bool_),
        aux=t(np.asarray(aux, np.uint32), np.int64),
    )


def pack_media(media, scale, device="cpu") -> torch.Tensor:
    """The kernel's (max(M,1), 9) media rows from a MediaTable:
    [mat_id, sigma_s*scale rgb, sigma_a*scale rgb, mean(g), ior]
    (volpath:141 and :438)."""
    mat_id = np.asarray(media.mat_id, np.float32)
    m = mat_id.shape[0]
    if m == 0:
        return torch.full((1, 9), -1.0, dtype=torch.float32, device=device)
    if m > 63:
        # The NEE sweep packs the media-table ROW INDEX into 6 bits of
        # its int32 boundary keys (cluster_test.NEE_MAT_BITS).
        raise ValueError(f"{m} media rows exceed the 63-medium key field")
    scale = np.float32(scale)
    rows = np.concatenate(
        [
            mat_id[:, None],
            np.asarray(media.sigma_s, np.float32) * scale,
            np.asarray(media.sigma_a, np.float32) * scale,
            np.mean(np.asarray(media.g, np.float32), axis=-1, keepdims=True, dtype=np.float32),
            np.asarray(media.ior, np.float32)[:, None],
        ],
        axis=-1,
    ).astype(np.float32)
    return torch.from_numpy(rows).to(device)


def pack_misc(lights, world_lo, world_hi, device="cpu") -> torch.Tensor:
    """Light position + intensity + scene AABB as the kernel's (16,) row:
    [light xyz, intensity rgb, pad, pad, lo xyz, hi xyz, pad, pad]."""
    h = lambda x: np.asarray(torch.as_tensor(x).cpu(), np.float32).reshape(-1)  # noqa: E731
    row = np.concatenate([
        h(lights.position), h(lights.intensity), np.zeros(2, np.float32),
        h(world_lo), h(world_hi), np.zeros(2, np.float32),
    ])
    return torch.from_numpy(row).to(device)


# --------------------------------------------------------------------------
# Plain PyTorch version: helpers (megakernel.py:153-345)
# --------------------------------------------------------------------------

_W = torch.where
_MAX = torch.maximum
_MIN = torch.minimum


def _full(ref, v):
    return torch.full_like(ref, v)


def _max_s(x, v):
    return torch.clamp(x, min=v)


def _norm3(x, y, z):
    n = torch.sqrt(x * x + y * y + z * z)
    inv = 1.0 / _max_s(n, 1e-20)
    return x * inv, y * inv, z * inv


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _max3(a, b, c):
    return _MAX(a, _MAX(b, c))


def _min3(a, b, c):
    return _MIN(a, _MIN(b, c))


def _safe_inv(v):
    tiny = _f32(1e-12)
    return 1.0 / _W(v.abs() < tiny, _W(v < 0, _full(v, -tiny), _full(v, tiny)), v)


def _fresnel_r(n1, n2, dx, dy, dz, nx, ny, nz):
    cos1 = torch.clamp(_dot3(dx, dy, dz, nx, ny, nz).abs(), 0.0, 1.0)
    sin1 = torch.sqrt(_max_s(1.0 - cos1 * cos1, 0.0))
    sin_t2 = n1 / n2 * sin1
    tir = sin_t2 >= 1.0
    s2 = torch.clamp(sin_t2, -1.0, 1.0)
    c2 = torch.sqrt(_max_s(1.0 - s2 * s2, 0.0))
    c1 = cos1
    rs = (n1 * c1 - n2 * c2) / (n1 * c1 + n2 * c2)
    rp = (n1 * c2 - n2 * c1) / (n1 * c2 + n2 * c1)
    r = (rs * rs + rp * rp) * 0.5
    return _W(tir, _full(r, 0.0), r), tir


def _boundary_event(dx, dy, dz, nx, ny, nz, ior):
    d_dot_n = _dot3(dx, dy, dz, nx, ny, nz)
    going_out = d_dot_n > 0.0
    one = torch.ones_like(ior)
    from_ior = _W(going_out, ior, one)
    to_ior = _W(going_out, one, ior)
    eta = from_ior / to_ior
    cos_i = -d_dot_n
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(_max_s(1.0 - sin2_t, 0.0))
    k = eta * cos_i - cos_t
    fx = eta * dx + k * nx
    fy = eta * dy + k * ny
    fz = eta * dz + k * nz
    fx = _W(tir, nx, fx)
    fy = _W(tir, ny, fy)
    fz = _W(tir, nz, fz)
    fx, fy, fz = _norm3(fx, fy, fz)
    two_d = 2.0 * d_dot_n
    rx, ry, rz = _norm3(dx - two_d * nx, dy - two_d * ny, dz - two_d * nz)
    r, _ = _fresnel_r(from_ior, to_ior, dx, dy, dz, nx, ny, nz)
    tx = _W(tir, rx, fx)
    ty = _W(tir, ry, fy)
    tz = _W(tir, rz, fz)
    return rx, ry, rz, tx, ty, tz, r, tir


def _weight(ss_r, ss_g, ss_b, er, eg, eb):
    def albedo(ss, ext):
        return _W(ext > 0.0, ss / _max_s(ext, 1e-30), _full(ss, -1.0))

    weight = _max3(albedo(ss_r, er), albedo(ss_g, eg), albedo(ss_b, eb))
    weight = _max_s(weight, -1.0)
    return _W(weight > 0.0, _max_s(weight, 0.5), weight)


def _free_flight_candidate(rand, ss_r, ss_g, ss_b, sa_r, sa_g, sa_b):
    er = ss_r + sa_r
    eg = ss_g + sa_g
    eb = ss_b + sa_b
    density = _min3(er, eg, eb)
    weight = _weight(ss_r, ss_g, ss_b, er, eg, eb)
    draw = rand < weight
    r_scaled = _W(draw, rand / _W(draw, weight, _full(weight, 1.0)), _full(rand, 0.0))
    exp_sample = -torch.log(_max_s(1.0 - r_scaled, _f32(1e-37))) / _max_s(density, 1e-30)
    return _W(draw & (density > 0.0), exp_sample, _full(exp_sample, NO_INTERACTION))


def _sample_distance(rand, ss_r, ss_g, ss_b, sa_r, sa_g, sa_b, dist):
    er = ss_r + sa_r
    eg = ss_g + sa_g
    eb = ss_b + sa_b
    density = _min3(er, eg, eb)
    weight = _weight(ss_r, ss_g, ss_b, er, eg, eb)
    sampled = _free_flight_candidate(rand, ss_r, ss_g, ss_b, sa_r, sa_g, sa_b)
    success = sampled < dist
    t = _W(success, sampled, dist)
    pf0 = torch.exp(-density * t)
    prob_success = density * pf0 * weight
    prob_fail = weight * pf0 + (1.0 - weight)
    tr_r = torch.exp(-er * t)
    tr_g = torch.exp(-eg * t)
    tr_b = torch.exp(-eb * t)
    zero = _max3(tr_r, tr_g, tr_b) < 1e-4
    z = torch.zeros_like(tr_r)
    return (success, t, prob_fail, prob_success,
            _W(zero, z, tr_r), _W(zero, z, tr_g), _W(zero, z, tr_b))


def _hg_sample(ix, iy, iz, g, r1, r2):
    iso = g.abs() < _ISO_EPS
    safe_g = _W(iso, torch.ones_like(g), g)
    tmp = (1.0 - g * g) / (1.0 - g + 2.0 * g * r1)
    cos_aniso = (1.0 + g * g - tmp * tmp) / (2.0 * safe_g)
    cos_iso = 1.0 - 2.0 * r1
    cos_theta = _W(iso, cos_iso, cos_aniso)
    sin_theta = torch.sqrt(_max_s(1.0 - cos_theta * cos_theta, 0.0))
    phi = TWOPI * r2
    lx = sin_theta * torch.cos(phi)
    ly = sin_theta * torch.sin(phi)
    lz = cos_theta
    nx, ny, nz = -ix, -iy, -iz
    use_x = nx.abs() > ny.abs()
    inv_a = 1.0 / torch.sqrt(_max_s(nx * nx + nz * nz, 1e-20))
    inv_b = 1.0 / torch.sqrt(_max_s(ny * ny + nz * nz, 1e-20))
    zero = torch.zeros_like(nx)
    tx = _W(use_x, nz * inv_a, zero)
    ty = _W(use_x, zero, nz * inv_b)
    tz = _W(use_x, -nx * inv_a, -ny * inv_b)
    sx = ty * nz - tz * ny
    sy = tz * nx - tx * nz
    sz = tx * ny - ty * nx
    return (sx * lx + tx * ly + nx * lz,
            sy * lx + ty * ly + ny * lz,
            sz * lx + tz * ly + nz * lz)


def _concentric_disk(r1, r2):
    u = 2.0 * r1 - 1.0
    v = 2.0 * r2 - 1.0
    zero = (u == 0.0) & (v == 0.0)
    use_u = u * u > v * v
    one = torch.ones_like(u)
    r = _W(use_u, u, v)
    phi = _W(
        use_u,
        PI_4 * (v / _W(use_u, u, one)),
        PI_2 - (u / _W(use_u, one, _W(v == 0.0, one, v))) * PI_4,
    )
    r = _W(zero, torch.zeros_like(r), r)
    phi = _W(zero, torch.zeros_like(phi), phi)
    return r * torch.cos(phi), r * torch.sin(phi)


# --------------------------------------------------------------------------
# Plain PyTorch version: the bounce (megakernel.py:754-1370)
# --------------------------------------------------------------------------


class _Plain(NamedTuple):
    """Per-call constants of the plain version."""

    slots: object  # cluster_test.SlotTable over the whole grid
    # a partitioned grid's slots of the opaque supers and of the media
    # supers (the unfused NEE march), None otherwise
    slots_opq: object
    slots_med: object
    mask: int  # the ablation mask
    media: list  # rows of media9 as lists of 9 floats
    misc: list  # 16 floats
    med_ids: list  # media mat-ids (the NEE sweep's opaque/media split)
    K: int
    background: int
    max_depth: int
    rr_depth: int
    nee_max_media: int
    tir_kill: bool
    analytic_direct: bool
    ld: bool
    sob: torch.Tensor | None  # (SOBOL_DIMS, 30) int64 direction numbers
    bounds: torch.Tensor  # (C, 8) cluster boxes, the walk's lower level
    super_bounds: torch.Tensor  # (S, 8) super boxes, its top level
    # (n_groups, 8) group boxes above the supers, when the walk tests them
    # (``two_level_walk``), else None
    group_bounds: torch.Tensor | None
    super_factor: int
    width: int  # slots of a cluster


def _box_clamp(cx, O, INV, TMAX):
    """Clamp the walk bound to the scene-box exit (megakernel.py:546-567)."""
    m = cx.misc

    def axis_exit(lo_i, hi_i, o, inv):
        return _MAX((m[lo_i] - o) * inv, (m[hi_i] - o) * inv)

    tf = _min3(axis_exit(8, 11, O[0], INV[0]),
               axis_exit(9, 12, O[1], INV[1]),
               axis_exit(10, 13, O[2], INV[2]))
    return _MIN(TMAX, _max_s(tf, 0.0) * _f32(1.0001) + _TEN_TMIN)


def _subset_trace(cx, rays, payload, state, tmax, bounds=False):
    """trace_slots on the lanes whose bound admits a hit (tmax > t_min);
    the other lanes cannot change their state. With ``bounds``, (state,
    the walk's (lanes, clusters) bound before each cluster), ``tmax`` on
    the other lanes."""
    act = (tmax > T_MIN).nonzero().squeeze(1)
    kw = dict(width=cx.width) if bounds else {}
    every = tmax[:, None].expand(-1, cx.bounds.shape[0]).clone() if bounds else None
    if act.numel() == 0:
        return (state, every) if bounds else state
    if act.numel() == tmax.numel():
        return trace_slots(cx.slots, rays, payload, state, T_MIN, cx.K, cx.med_ids, **kw)
    sub = trace_slots(cx.slots, tuple(r[act] for r in rays), payload,
                      tuple(s[act] for s in state), T_MIN, cx.K, cx.med_ids, **kw)
    if bounds:
        sub, got = sub
        every[act] = got
    out = []
    for s, v in zip(state, sub):
        s = s.clone()
        s[act] = v
        out.append(s)
    return (tuple(out), every) if bounds else tuple(out)


def _slab(boxes, O, INV, tmax):
    """csrc/cluster_test.cuh ``slab_hit`` of every lane (rows) against
    every box of ``boxes`` (columns), under the (lanes, boxes) bound
    ``tmax``."""
    tn = tf = None
    for a in range(3):
        s0 = (boxes[:, a] - O[a][:, None]) * INV[a][:, None]
        s1 = (boxes[:, a + 3] - O[a][:, None]) * INV[a][:, None]
        lo, hi = _MIN(s0, s1), _MAX(s0, s1)
        tn, tf = (lo, hi) if tn is None else (_MAX(tn, lo), _MIN(tf, hi))
    return _MAX(tn, _full(tn, T_MIN)) <= _MIN(tf, tmax)


def _tally(cx, walk, O, sets):
    """Add the supers entered, the clusters tested and the groups entered
    by the linear walk from ``O`` to ``walk``: ``sets`` holds (INV, need,
    bound before each cluster) of each ray set the walk serves; a box is
    entered when a set that needs it meets it under that set's bound before
    the first cluster it holds (trace_full and trace_dnee of
    csrc/megakernel.cu), a super only in a group entered where the walk
    tests the groups."""
    C, S, SF = cx.bounds.shape[0], cx.super_bounds.shape[0], cx.super_factor
    dev = cx.bounds.device
    first = torch.arange(S, device=dev) * SF
    owner = torch.arange(C, device=dev) // SF
    groups = cx.group_bounds
    if groups is not None:
        ends = groups[:, 6].to(torch.int64)
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        g_first = starts * SF
        g_owner = torch.repeat_interleave(torch.arange(ends.shape[0], device=dev), ends - starts)
    n = O[0].shape[0]
    step = max(1, (1 << 24) // max(1, C))
    for lo in range(0, n, step):
        o = tuple(x[lo:lo + step] for x in O)
        sup = clu = grp = None
        for inv, need, before in sets:
            inv = tuple(x[lo:lo + step] for x in inv)
            m = need[lo:lo + step, None]
            b = before[lo:lo + step]
            s_hit = m & _slab(cx.super_bounds, o, inv, b[:, first])
            c_hit = m & _slab(cx.bounds, o, inv, b)
            sup, clu = (s_hit, c_hit) if sup is None else (sup | s_hit, clu | c_hit)
            if groups is not None:
                g_hit = m & _slab(groups, o, inv, b[:, g_first])
                grp = g_hit if grp is None else grp | g_hit
        if groups is not None:
            sup = sup & grp[:, g_owner]
            walk[WALK_GROUPS] += grp.sum()
        clu = clu & sup[:, owner]
        walk[WALK_SUPERS] += sup.sum()
        walk[WALK_CLUSTERS] += clu.sum()


def _counts_full(cx) -> bool:
    """Whether the closest hit is the 'full' walk of trace_full (the
    ablations notrace, cullonly and ordered replace it)."""
    return not cx.mask & (ABLATIONS["notrace"] | ABLATIONS["cullonly"] | ABLATIONS["ordered"])


def _cullonly(cx) -> bool:
    """The walks keep their culls and do nothing: a walk's result is its
    initial state (megakernel.py:592-598)."""
    return bool(cx.mask & ABLATIONS["cullonly"])


def _trace_full(cx, O, D, TMAX, payload="full", walk=None):
    """The closest hit ('full', or 'dist' for the unfused distance walk)
    under the scene-box clamped bound; with ``walk``, the walk's box visits
    added there."""
    INV = tuple(_safe_inv(d) for d in D)
    TMAX = _box_clamp(cx, O, INV, TMAX)
    st0 = payload_state0(payload, TMAX)
    if _cullonly(cx):
        return st0
    if walk is None:
        return _subset_trace(cx, O + D, payload, st0, TMAX)
    st, before = _subset_trace(cx, O + D, payload, st0, TMAX, bounds=True)
    _tally(cx, walk, O, [(INV, torch.ones_like(TMAX, dtype=torch.bool), before)])
    return st


def _trace_dnee(cx, O, DA, TMAX_A, DB, TMAX_B, walk):
    """The fused walk's result: (t, slot) along set A (scene-box clamped)
    + the K-list and t_opq along set B, from the shared origin O; the
    walk's box visits added to ``walk``."""
    INV = tuple(_safe_inv(d) for d in DA)
    TMAX_A = _box_clamp(cx, O, INV, TMAX_A)
    st0 = payload_state0("dnee", TMAX_A, cx.K, TMAX_B=TMAX_B)
    if _cullonly(cx):
        return st0
    a, before_a = _subset_trace(cx, O + DA, "dist", st0[:2], TMAX_A, bounds=True)
    b, before_b = _subset_trace(cx, O + DB, "nee", st0[2:], TMAX_B, bounds=True)
    _tally(cx, walk, O, [(INV, TMAX_A > T_MIN, before_a),
                         (tuple(_safe_inv(d) for d in DB), TMAX_B > T_MIN, before_b)])
    return a + b


def _media_scan(cx, mat):
    zeros = torch.zeros_like(mat)
    has = torch.zeros_like(mat, dtype=torch.bool)
    out = [zeros] * 7 + [torch.ones_like(mat)]
    for row in cx.media:
        mid = row[0]
        m = (mat == mid) & (mid >= 0.0) & ~has
        out = [_W(m, _full(o, row[1 + f]), o) for f, o in enumerate(out)]
        has = has | m
    return (has, *out)


def _media_scan_idx(cx, idx):
    out = [torch.zeros_like(idx)] * 7 + [torch.ones_like(idx)]
    for mi, row in enumerate(cx.media):
        m = idx == float(mi)
        out = [_W(m, _full(o, row[1 + f]), o) for f, o in enumerate(out)]
    return (idx >= 0.0, *out)


def _shade_color(cx, px, py, nx):
    if cx.background == 1:
        fx = torch.floor(px)
        fy = torch.floor(py)
        even = (torch.remainder(fx, 2.0) == 0.0) == (torch.remainder(fy, 2.0) == 0.0)
        c = _W(even, _full(px, 0.8), _full(px, 0.3))
        return c, c, c
    if cx.background == 2:
        is_red = nx > 0.99
        is_green = nx < -0.99
        e8, e0 = _full(px, 0.8), _full(px, 0.0)
        cr = _W(is_red, e8, _W(is_green, e0, e8))
        cg = _W(is_red, e0, _W(is_green, e8, e8))
        cb = _W(is_red, e0, _W(is_green, e0, e8))
        return cr, cg, cb
    base = _full(px, 0.8)
    return base, base, base


def _nee_setup(cx, px, py, pz, active):
    m = cx.misc
    tlx = m[0] - px
    tly = m[1] - py
    tlz = m[2] - pz
    ldist = torch.sqrt(tlx * tlx + tly * tly + tlz * tlz)
    inv = 1.0 / _max_s(ldist, 1e-20)
    eff = _W(active, ldist, torch.zeros_like(ldist))
    return (tlx * inv, tly * inv, tlz * inv, ldist, eff,
            m[3] * inv * inv, m[4] * inv * inv, m[5] * inv * inv)


def _nee_resolve(cx, keys, t_op, eff, ldist, lv_r, lv_g, lv_b, active):
    """The shadow march over the K collected boundary keys
    (megakernel.py:875-967)."""
    ts = [nee_unpack_t(k, eff) for k in keys]
    ms = [nee_unpack_mat(k) for k in keys]
    ones = torch.ones_like(eff)
    zero = torch.zeros_like(eff)
    tr_r = tr_g = tr_b = ones
    running = active
    in_med = torch.zeros_like(active)
    ex_r = ex_g = ex_b = zero
    last_t = zero
    n_real = zero
    real_cap = float(2 * cx.nee_max_media)
    for i in range(cx.K):
        t_i = ts[i]
        m_i = ms[i]
        rem = ldist - last_t
        dup = t_i <= last_t + T_MIN
        cut = _W(in_med, last_t + _max_s(rem, T_MIN), last_t + _f32(0.999) * rem)
        window = _MIN(cut, eff)
        opq = running & (t_op > last_t + T_MIN) & (t_op < window) & (t_op < t_i)
        tr_r = _W(opq, zero, tr_r)
        tr_g = _W(opq, zero, tr_g)
        tr_b = _W(opq, zero, tr_b)
        running = running & ~opq
        consider = running & ~dup
        real = consider & (t_i < window)
        n_real = n_real + _W(real, ones, zero)
        ended = consider & ~real
        (_has, ss_r, ss_g, ss_b, sa_r, sa_g, sa_b, _g2, _i2) = _media_scan_idx(cx, m_i)
        boundary = real
        exitl = boundary & in_med
        seg = _MIN(t_i - last_t, rem)
        a_r = 0.9 * torch.exp(-ex_r * seg)
        a_g = 0.9 * torch.exp(-ex_g * seg)
        a_b = 0.9 * torch.exp(-ex_b * seg)
        tr_r = _W(exitl, tr_r * a_r, tr_r)
        tr_g = _W(exitl, tr_g * a_g, tr_g)
        tr_b = _W(exitl, tr_b * a_b, tr_b)
        enterl = boundary & ~in_med
        ex_r = _W(enterl, ss_r + sa_r, ex_r)
        ex_g = _W(enterl, ss_g + sa_g, ex_g)
        ex_b = _W(enterl, ss_b + sa_b, ex_b)
        last_t = _W(boundary, t_i, last_t)
        in_med = in_med ^ boundary
        running = running & ~ended
    dark = running | (n_real >= real_cap)
    tr_r = _W(dark, zero, tr_r)
    tr_g = _W(dark, zero, tr_g)
    tr_b = _W(dark, zero, tr_b)
    return lv_r * tr_r, lv_g * tr_g, lv_b * tr_b


def _nee_march(cx, px, py, pz, active):
    """The unfused NEE march (megakernel.py:831-874): on a partitioned grid
    the nearest opaque hit over the opaque supers and the K-list over the
    media supers, one K-list sweep otherwise; then the shadow march."""
    (ldx, ldy, ldz, ldist, eff, lv_r, lv_g, lv_b) = _nee_setup(cx, px, py, pz, active)
    rays = (px, py, pz, ldx, ldy, ldz)
    hits = payload_state0("nee", eff, cx.K)
    t_op = eff
    if not _cullonly(cx):
        if cx.slots_opq is not None:
            (t_op,) = _subset_trace(cx._replace(slots=cx.slots_opq), rays, "occl", (eff,), eff)
            hits = _subset_trace(cx._replace(slots=cx.slots_med), rays, "nee", hits, eff)
        else:
            hits = _subset_trace(cx, rays, "nee", hits, eff)
    t_op = _MIN(t_op, hits[cx.K])
    return _nee_resolve(cx, hits[:cx.K], t_op, eff, ldist, lv_r, lv_g, lv_b, active)


def _make_draw(cx, it, PH, dim_base):
    if not cx.ld:
        def pcg(state, mask, site):
            ns = rng_ops.step(state)
            value = rng_ops.u32_to_float(rng_ops._output(ns)) * rng_ops._INV_U32
            return _W(mask, ns, state), value
        return pcg

    def draw(s_idx, mask, site):
        dim = dim_base + (it * DRAWS_PER_BOUNCE + site)
        # A row by a host int, or by a 0-d tensor from the control block.
        row = cx.sob[dim] if isinstance(dim, int) else cx.sob.index_select(0, dim.reshape(1))[0]
        return s_idx, rng_ops.owen_draw(rng_ops.sobol_value(s_idx, row), PH, dim)

    return draw


def _bounce(cx, st, it, PH, dim_base, walk):
    """One bounce iteration of live lanes (megakernel.py:992-1370: the
    default fused walk, or the ablations of ``cx.mask``), drawing ld
    dimensions from ``dim_base`` (clipped); the walks' box visits added to
    ``walk``."""
    (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
     ra_r, ra_g, ra_b, rng, depth, alive) = st
    mask = cx.mask
    draw = _make_draw(cx, it, PH, dim_base)
    zero = torch.zeros_like(ox)
    eff = _W(alive, _full(ox, T_MAX), zero)
    if mask & (ABLATIONS["notrace"] | ABLATIONS["cullonly"]):
        # A fabricated hit (megakernel.py:999-1011); under cullonly at
        # 2 + t_walk * 1e-30, after the walk with identity bodies (:1016-1035).
        t = _full(ox, 2.0)
        if not mask & ABLATIONS["notrace"]:
            t = t + _trace_full(cx, (ox, oy, oz), (dx, dy, dz), eff)[0] * _f32(1e-30)
        slot, gnx, gnz, mat = zero, zero, zero, zero
        u = v = _full(ox, 0.3)
        gny = torch.ones_like(ox)
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    else:
        (t, slot, u, v, gnx, gny, gnz, mat, px, py, pz) = _trace_full(
            cx, (ox, oy, oz), (dx, dy, dz), eff, walk=walk if _counts_full(cx) else None
        )
    hit = slot >= 0.0
    got_hit = alive & hit
    if mask & ABLATIONS["nophys"]:
        # Mirror the ray at the hit (megakernel.py:1037-1047); the flip,
        # the +0.01 and depth + 1 are unmasked.
        depth = depth + 1
        return (_W(got_hit, px, ox), _W(got_hit, py, oy), _W(got_hit, pz, oz), -dx, -dy, -dz,
                th_r, th_g, th_b, ra_r + _f32(0.01), ra_g, ra_b, rng, depth,
                got_hit & (depth < cx.max_depth))
    nx, ny, nz = _norm3(gnx, gny, gnz)
    has0, ss_r, ss_g, ss_b, sa_r, sa_g, sa_b, g, ior = _media_scan(cx, mat)
    col_r, col_g, col_b = _shade_color(cx, px, py, nx)
    has_med = got_hit & has0

    # boundary event #1 (volpath:633-670)
    (rf1x, rf1y, rf1z, td1x, td1y, td1z, r1, tir1) = _boundary_event(
        dx, dy, dz, nx, ny, nz, ior
    )
    rng, rand_f = draw(rng, has_med, 0)
    do_reflect = has_med & (rand_f < r1)
    transmitted = has_med & ~do_reflect
    dax = _W(do_reflect, rf1x, _W(transmitted, td1x, dx))
    day = _W(do_reflect, rf1y, _W(transmitted, td1y, dy))
    daz = _W(do_reflect, rf1z, _W(transmitted, td1z, dz))
    ox = _W(do_reflect, px, ox)
    oy = _W(do_reflect, py, oy)
    oz = _W(do_reflect, pz, oz)
    depth = depth + has_med.to(torch.int32)

    # free-flight draw before the boundary trace
    rng, rand_d = draw(rng, transmitted, 1)
    cand = _free_flight_candidate(rand_d, ss_r, ss_g, ss_b, sa_r, sa_g, sa_b)

    diffuse = got_hit & ~has_med
    backface = diffuse & (_dot3(dx, dy, dz, nx, ny, nz) > 0.0)
    shade = diffuse & ~backface

    if cx.analytic_direct:
        density0 = _min3(ss_r + sa_r, ss_g + sa_g, ss_b + sa_b)
        ad_gate = transmitted & (density0 > 0.0)
        if cx.tir_kill:
            ad_gate = ad_gate & ~tir1

    # the distance walk bound: the free-flight candidate (and the analytic
    # term's depth)
    bound = _MIN(cand * _f32(1.00001) + _TEN_TMIN, _full(cand, T_MAX))
    if cx.analytic_direct:
        t_star = _W(
            ad_gate,
            LN_CLAMP / _max_s(density0, 1e-30) * _f32(1.00001) + _TEN_TMIN,
            zero,
        )
        bound = _MIN(_MAX(bound, t_star), _full(bound, T_MAX))
    fused = not mask & _UNFUSED
    if fused:
        # fused dist+NEE walk ('dnee')
        may_scatter = transmitted & (cand < T_MAX)
        need_light = ad_gate if cx.analytic_direct else may_scatter
        (ldx, ldy, ldz, ldist, eff_b, lv_r, lv_g, lv_b) = _nee_setup(
            cx, px, py, pz, need_light | shade
        )
        dn = _trace_dnee(
            cx, (px, py, pz), (dax, day, daz), _W(transmitted, bound, zero),
            (ldx, ldy, ldz), eff_b, walk,
        )
        seg_len = _W(dn[1] >= 0.0, dn[0], _full(dn[0], T_MAX))
    elif mask & ABLATIONS["nodist"]:
        seg_len = _full(px, T_MAX)
    else:
        # the separate distance walk (megakernel.py:1171-1199)
        dt, dslot = _trace_full(cx, (px, py, pz), (dax, day, daz),
                                _W(transmitted, bound, zero), "dist")
        seg_len = _W(dslot >= 0.0, dt, _full(dt, T_MAX))

    # free-flight sampling (volpath:691)
    (succ, ms_t, prob_fail, prob_success, tr_r, tr_g, tr_b) = _sample_distance(
        rand_d, ss_r, ss_g, ss_b, sa_r, sa_g, sa_b, seg_len
    )
    scatter = transmitted & succ
    if cx.tir_kill:
        scatter = scatter & ~tir1
    pass_med = transmitted & ~scatter

    # NEE (volpath:697/:773; no RNG draws)
    if mask & ABLATIONS["nonee"]:
        li_r = li_g = li_b = torch.ones_like(px)
    elif fused:
        li_r, li_g, li_b = _nee_resolve(
            cx, dn[2:2 + cx.K], dn[2 + cx.K], eff_b, ldist, lv_r, lv_g, lv_b,
            need_light | shade,
        )
    else:
        li_r, li_g, li_b = _nee_march(
            cx, px, py, pz, (ad_gate if cx.analytic_direct else scatter) | shade)
    tmp_g = 1.0 + g * g
    phase_nee = INV_FOURPI * (1.0 - g * g) / (tmp_g * torch.sqrt(tmp_g))
    if cx.analytic_direct:
        t_cap = _MIN(seg_len, LN_CLAMP / _max_s(density0, 1e-30))

        def _ad(ss, sa):
            ext = ss + sa
            return ss * (1.0 - torch.exp(-ext * t_cap)) / _max_s(ext, 1e-30)

        w_ad = phase_nee
        ra_r = ra_r + _W(ad_gate, th_r * _ad(ss_r, sa_r) * li_r * w_ad, zero)
        ra_g = ra_g + _W(ad_gate, th_g * _ad(ss_g, sa_g) * li_g * w_ad, zero)
        ra_b = ra_b + _W(ad_gate, th_b * _ad(ss_b, sa_b) * li_b * w_ad, zero)

    # scatter branch (volpath:693-710)
    ps_pos = prob_success > 0.0
    safe_ps = _W(ps_pos, prob_success, torch.ones_like(prob_success))
    sc_r = _W(ps_pos, ss_r * tr_r / safe_ps, zero)
    sc_g = _W(ps_pos, ss_g * tr_g / safe_ps, zero)
    sc_b = _W(ps_pos, ss_b * tr_b / safe_ps, zero)
    th_r = _W(scatter, th_r * sc_r, th_r)
    th_g = _W(scatter, th_g * sc_g, th_g)
    th_b = _W(scatter, th_b * sc_b, th_b)
    if not cx.analytic_direct:
        ra_r = ra_r + _W(scatter, th_r * li_r * phase_nee, zero)
        ra_g = ra_g + _W(scatter, th_g * li_g * phase_nee, zero)
        ra_b = ra_b + _W(scatter, th_b * li_b * phase_nee, zero)

    rng, r_ph1 = draw(rng, scatter, 2)
    rng, r_ph2 = draw(rng, scatter, 3)
    hgx, hgy, hgz = _hg_sample(-dax, -day, -daz, g, r_ph1, r_ph2)
    ox = _W(scatter, px + hgx * ms_t, ox)
    oy = _W(scatter, py + hgy * ms_t, oy)
    oz = _W(scatter, pz + hgz * ms_t, oz)
    ndx = _W(scatter, hgx, dax)
    ndy = _W(scatter, hgy, day)
    ndz = _W(scatter, hgz, daz)

    # pass-through branch (volpath:713-756)
    pf_pos = prob_fail > 0.0
    safe_pf = _W(pf_pos, prob_fail, torch.ones_like(prob_fail))
    pp_r = _W(pf_pos, tr_r / safe_pf, zero)
    pp_g = _W(pf_pos, tr_g / safe_pf, zero)
    pp_b = _W(pf_pos, tr_b / safe_pf, zero)
    th_r = _W(pass_med, th_r * pp_r, th_r)
    th_g = _W(pass_med, th_g * pp_g, th_g)
    th_b = _W(pass_med, th_b * pp_b, th_b)
    pox = px + dax * ms_t
    poy = py + day * ms_t
    poz = pz + daz * ms_t
    # boundary event #2 with the stale entry normal (volpath:723-753)
    (rf2x, rf2y, rf2z, td2x, td2y, td2z, r2, tir2) = _boundary_event(
        dax, day, daz, nx, ny, nz, ior
    )
    rng, rand_f2 = draw(rng, pass_med, 4)
    pd_reflect = rand_f2 < r2
    ox = _W(pass_med, pox, ox)
    oy = _W(pass_med, poy, oy)
    oz = _W(pass_med, poz, oz)
    ndx = _W(pass_med, _W(pd_reflect, rf2x, td2x), ndx)
    ndy = _W(pass_med, _W(pd_reflect, rf2y, td2y), ndy)
    ndz = _W(pass_med, _W(pd_reflect, rf2z, td2z), ndz)

    # diffuse branch (volpath:758-779)
    rng, r_d1 = draw(rng, shade, 5)
    rng, r_d2 = draw(rng, shade, 6)
    ddx, ddy = _concentric_disk(r_d1, r_d2)
    temp = 1.0 - ddx * ddx - ddy * ddy
    ddz = _W(temp <= 0.0, _full(temp, _f32(1e-10)), torch.sqrt(_max_s(temp, 0.0)))
    th_r = _W(shade, th_r * REFLECTANCE, th_r)
    th_g = _W(shade, th_g * REFLECTANCE, th_g)
    th_b = _W(shade, th_b * REFLECTANCE, th_b)
    visible = (_dot3(-dx, -dy, -dz, nx, ny, nz) > 0.0) & (
        _dot3(ddx, ddy, ddz, nx, ny, nz) > 0.0
    )
    deval = _W(visible, _R_INV_PI * ddz, zero)
    ra_r = ra_r + _W(shade, th_r * li_r * deval * col_r, zero)
    ra_g = ra_g + _W(shade, th_g * li_g * deval * col_g, zero)
    ra_b = ra_b + _W(shade, th_b * li_b * deval * col_b, zero)
    wox, woy, woz = _norm3(ddx, ddy, ddz)
    ox = _W(shade, px + wox * T_MIN, ox)
    oy = _W(shade, py + woy * T_MIN, oy)
    oz = _W(shade, pz + woz * T_MIN, oz)
    ndx = _W(shade, wox, ndx)
    ndy = _W(shade, woy, ndy)
    ndz = _W(shade, woz, ndz)

    redirected = do_reflect | scatter | pass_med | shade
    dx = _W(redirected, ndx, dx)
    dy = _W(redirected, ndy, dy)
    dz = _W(redirected, ndz, dz)

    # depth + russian roulette (volpath:786-797)
    enders = scatter | shade
    depth = depth + (enders | pass_med).to(torch.int32)
    rr = enders & (depth > cx.rr_depth)
    rng, rand_rr = draw(rng, rr, 7)
    q = _MIN(_max3(th_r, th_g, th_b), _full(th_r, 0.95))
    survive = rand_rr <= q
    boost = 1.0 / _max_s(q, 1e-20)
    rs = rr & survive
    th_r = _W(rs, th_r * boost, th_r)
    th_g = _W(rs, th_g * boost, th_g)
    th_b = _W(rs, th_b * boost, th_b)

    continuing = do_reflect | pass_med | (enders & (~rr | survive))
    alive = continuing & (depth < cx.max_depth)
    if cx.tir_kill:
        alive = alive & ~((transmitted & tir1) | (pass_med & tir2))
    return (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
            ra_r, ra_g, ra_b, rng, depth, alive)


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def _check_call(grid, state, max_depth, max_iters, ld, dim0, live_blocks, ctrl=None):
    """Shared argument checks; returns (max_iters, lanes to run, ld base).
    With a control block ``ctrl`` the lanes are the static width and the
    base is None: both come from the block when the kernel runs."""
    if max_iters is None:
        max_iters = max_depth
    if grid.num_supers > MAX_SUPERS:
        raise ValueError(
            f"{grid.num_supers} super-clusters exceed the (8,128) entry table; "
            "scene too large for the megakernel (max ~2M triangles)"
        )
    r = state.org.shape[0]
    nrows = max_iters * DRAWS_PER_BOUNCE
    if ld and nrows > rng_ops.SOBOL_DIMS:
        raise ValueError(
            f"ld mode draws {nrows} dimensions per call; the Sobol "
            f"table has {rng_ops.SOBOL_DIMS}"
        )
    if ctrl is not None:
        if live_blocks is not None or not (isinstance(dim0, int) and dim0 == 0):
            raise ValueError("with a control block, live_blocks and dim0 come from it")
        if ctrl.dtype != torch.int32 or tuple(ctrl.shape) != (CTRL_LEN,) \
                or ctrl.device != state.org.device or not ctrl.is_contiguous():
            raise ValueError(f"ctrl must be a contiguous int32 ({CTRL_LEN},) tensor on the "
                             "state's device")
        return max_iters, r, None
    blocks = -(-r // BLOCK)
    lb = blocks if live_blocks is None else int(live_blocks)
    lanes = max(0, min(r, lb * BLOCK))
    dim_base = 0
    if ld:
        # The JAX kernel clips the row base (megakernel.py:1548-1552).
        dim_base = min(max(int(dim0), 0), rng_ops.SOBOL_DIMS - nrows)
    return max_iters, lanes, dim_base


def plain_context(grid: DeviceClusterGrid, media9: torch.Tensor, misc: torch.Tensor,
                  background: int = 1, max_depth: int = 32, rr_depth: int = 16,
                  nee_max_media: int = 4, tir_kill: bool = False, analytic_direct: bool = False,
                  ld: bool = False, debug: str = "") -> _Plain:
    """The per-call constants of the plain version (the slot tables, the
    media rows and the light row read to the host), which a caller that
    runs many calls with the same arguments builds once and passes as
    ``plain``."""
    mask = ablation_mask(debug)
    media_rows = media9.detach().cpu().tolist()
    # A partitioned grid's opaque supers [0, S_OPQ) hold the clusters (and
    # slots) before the media supers'.
    cut = min(grid.num_opaque_supers * grid.super_factor, grid.num_clusters) * grid.width
    return _Plain(
        slots=slot_table(grid),
        slots_opq=slot_table(grid, 0, cut) if grid.num_opaque_supers > 0 else None,
        slots_med=slot_table(grid, cut) if grid.num_opaque_supers > 0 else None,
        mask=mask,
        media=media_rows,
        misc=misc.detach().cpu().tolist(),
        med_ids=[row[0] for row in media_rows],
        K=nee_list_len(nee_max_media),
        background=int(background),
        max_depth=int(max_depth),
        rr_depth=int(rr_depth),
        nee_max_media=int(nee_max_media),
        tir_kill=bool(tir_kill),
        analytic_direct=bool(analytic_direct),
        ld=bool(ld),
        sob=rng_ops.sobol_table(grid.bounds.device) if ld else None,
        bounds=grid.bounds,
        super_bounds=grid.super_bounds,
        group_bounds=grid.group_bounds if _levels(grid, mask) else None,
        super_factor=int(grid.super_factor),
        width=grid.width,
    )


def two_level_walk(num_supers: int) -> bool:
    """Whether the default K1's walk tests the group boxes above the
    supers: on a grid of more than FLAT_WALK_SUPERS supers."""
    return num_supers > FLAT_WALK_SUPERS


def _levels(grid: DeviceClusterGrid, mask: int) -> bool:
    """Whether K1's walk tests ``grid``'s group boxes: in the default
    instance (the ablation instances keep the flat walk), by the super
    count (``two_level_walk``)."""
    return mask == 0 and two_level_walk(grid.num_supers)


def trace_paths_mega_plain(
    grid: DeviceClusterGrid,
    media9: torch.Tensor,
    misc: torch.Tensor,
    state: MegaState,
    background: int = 1,
    max_depth: int = 32,
    rr_depth: int = 16,
    nee_max_media: int = 4,
    tir_kill: bool = False,
    max_iters: int | None = None,
    live_blocks=None,
    analytic_direct: bool = False,
    ld: bool = False,
    dim0=0,
    debug: str = "",
    ctrl: torch.Tensor | None = None,
    plain: _Plain | None = None,
    walk: torch.Tensor | None = None,
) -> MegaState:
    """The plain PyTorch version of ``trace_paths_mega`` (same arguments,
    same in-place update, the same walk counts added to ``walk``), on any
    device. ``plain``: the context of ``plain_context`` for these
    arguments, else built here. With ``ctrl`` the run flag, live_blocks and
    the ld base are read from the control block by tensor operations, so
    the call sends no value to the host."""
    max_iters, lanes, dim_base = _check_call(
        grid, state, max_depth, max_iters, ld, dim0, live_blocks, ctrl
    )
    walk = _walk_counts(walk, state.alive.device)
    cx = plain if plain is not None else plain_context(
        grid, media9, misc, background=background, max_depth=max_depth, rr_depth=rr_depth,
        nee_max_media=nee_max_media, tir_kill=tir_kill, analytic_direct=analytic_direct,
        ld=ld, debug=debug,
    )
    dev = state.alive.device
    idx = torch.arange(state.alive.shape[0], device=dev)
    if ctrl is None:
        in_live = idx < lanes
    else:
        # Lanes at or beyond live_blocks * 1024 keep their state, and every
        # lane does when the run flag is 0 (megakernel.py:1589-1609); the
        # ld base is clipped as megakernel.py:1548-1552 clips it.
        in_live = (idx < ctrl[CTRL_LIVE].clamp(min=0) * BLOCK) & (ctrl[CTRL_RUN] != 0)
        dim_base = ctrl[CTRL_DIM0].to(torch.int64).clamp(
            0, rng_ops.SOBOL_DIMS - max_iters * DRAWS_PER_BOUNCE)
    lockstep = bool(cx.mask & ABLATIONS["nophys"])
    blk = idx // BLOCK
    for it in range(max_iters):
        if lockstep:
            # nophys's unmasked writes reach every lane of a 1024-lane block
            # while any lane of it lives (megakernel.py:1386-1394).
            live_blk = torch.zeros(-(-idx.shape[0] // BLOCK), dtype=torch.bool, device=dev)
            live_blk[blk[state.alive & in_live]] = True
            live = (live_blk[blk] & in_live).nonzero().squeeze(1)
        else:
            live = (state.alive & in_live).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        walk[WALK_BOUNCES] += (state.alive & in_live).sum()
        st = (
            *(state.org[live, i] for i in range(3)),
            *(state.dir[live, i] for i in range(3)),
            *(state.thr[live, i] for i in range(3)),
            *(state.rad[live, i] for i in range(3)),
            state.rng[live], state.depth[live], state.alive[live],
        )
        out = _bounce(cx, st, it, state.aux[live] if ld else None, dim_base, walk)
        state.org[live] = torch.stack(out[0:3], dim=1)
        state.dir[live] = torch.stack(out[3:6], dim=1)
        state.thr[live] = torch.stack(out[6:9], dim=1)
        state.rad[live] = torch.stack(out[9:12], dim=1)
        state.rng[live] = out[12]
        state.depth[live] = out[13]
        state.alive[live] = out[14]
    return state


def trace_paths_mega(
    grid: DeviceClusterGrid,
    media9: torch.Tensor,  # (max(M,1), 9) pre-scaled media table (pack_media)
    misc: torch.Tensor,  # (16,) light, intensity, scene AABB (pack_misc)
    state: MegaState,
    background: int = 1,
    max_depth: int = 32,
    rr_depth: int = 16,
    nee_max_media: int = 4,
    tir_kill: bool = False,
    max_iters: int | None = None,
    live_blocks=None,
    analytic_direct: bool = False,
    ld: bool = False,
    dim0=0,
    debug: str = "",
    ctrl: torch.Tensor | None = None,
    plain: _Plain | None = None,
    walk: torch.Tensor | None = None,
) -> MegaState:
    """Advance R paths up to ``max_iters`` bounce iterations in ONE kernel.

    With ``max_iters=None`` (= max_depth) paths run to termination. A
    smaller cap returns the mid-flight state so the caller can compact
    the wavefront and continue (render/megarender.py's schedules). Lanes
    at or beyond ``live_blocks * 1024`` are not touched.

    ``live_blocks`` and ``dim0`` are host ints, or come from the card: with
    ``ctrl``, the pass control block (``kernels.pass_control``), the launch
    covers the state's whole width and the kernel reads the run flag,
    ``live_blocks`` and ``dim0`` there (the JAX kernel's traced scalars,
    megakernel.py:1487, :1548-1552, :1589-1592), so the call needs no value
    from the host and can be captured in a CUDA graph.

    The state is updated IN PLACE and returned: the counterpart of the
    Pallas call's ``input_output_aliases``. A CUDA state launches the
    kernel of ``csrc/megakernel.cu`` built for ``debug``'s ablation mask
    (or raises); a CPU state runs ``trace_paths_mega_plain`` (with the
    context ``plain`` when given).

    ``walk``: a (WALK_LEN,) int64 tensor on the state's device that the
    call adds its walk counts to (bounces, supers entered, clusters
    tested, groups entered); by default the device's accumulator
    (``pass_control.walk_counts``).
    """
    if state.org.device.type == "cpu":
        return trace_paths_mega_plain(
            grid, media9, misc, state, background=background,
            max_depth=max_depth, rr_depth=rr_depth,
            nee_max_media=nee_max_media, tir_kill=tir_kill,
            max_iters=max_iters, live_blocks=live_blocks,
            analytic_direct=analytic_direct, ld=ld, dim0=dim0, debug=debug,
            ctrl=ctrl, plain=plain, walk=walk,
        )
    max_iters, lanes, dim_base = _check_call(
        grid, state, max_depth, max_iters, ld, dim0, live_blocks, ctrl
    )
    walk = _walk_counts(walk, state.org.device)
    _launch(grid, media9, misc, state, lanes, dim_base, ctrl, walk, background=background,
            max_depth=max_depth, rr_depth=rr_depth, nee_max_media=nee_max_media,
            tir_kill=tir_kill, analytic_direct=analytic_direct, ld=ld,
            max_iters=max_iters, mask=ablation_mask(debug))
    return state


# CUDA launches made by trace_paths_mega outside a graph capture (the
# launches of a captured pass are counted on the card, kernels.pass_control).
trace_paths_mega.launches = 0

_SOBOL_I32: dict = {}
_ITERS: dict = {}


def _walk_counts(walk, device) -> torch.Tensor:
    """``walk`` checked, or the device's walk accumulator."""
    if walk is None:
        return walk_counts(device)
    _require(walk, "walk", torch.int64, (WALK_LEN,), torch.device(device))
    return walk


def nophys_iters(device, lanes: int) -> torch.Tensor:
    """nophys's per-lane and per-block iteration counts for launches of up
    to ``lanes`` lanes on ``device``: allocated once (each launch zeroes
    what it uses), so a launch allocates nothing and can be captured."""
    key = (str(device), lanes)
    if key not in _ITERS:
        _ITERS[key] = torch.zeros(lanes + -(-lanes // BLOCK), dtype=torch.int32, device=device)
    return _ITERS[key]


def prepare(device, lanes: int, nee_max_media: int, debug: str = "") -> None:
    """Build the library of ``debug``'s instance and make what its launches
    on ``device`` of up to ``lanes`` lanes read (the Sobol rows, nophys's
    counts), so that a capture of them builds and allocates nothing."""
    from . import build

    mask, _one_thread = cuda_instance(ablation_mask(debug))
    build.megakernel(nee_max_media, mask)
    _sobol_i32(device)
    walk_counts(device)
    if mask & ABLATIONS["nophys"]:
        nophys_iters(device, lanes)


def _sobol_i32(device) -> torch.Tensor:
    """The (SOBOL_DIMS, 30) direction numbers as int32 bit patterns on
    ``device`` (cached per device: they never change)."""
    key = str(device)
    if key not in _SOBOL_I32:
        _SOBOL_I32[key] = torch.from_numpy(
            rng_ops.sobol_matrices().view(np.int32).copy()
        ).to(device)
    return _SOBOL_I32[key]


def _require(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(grid, media9, misc, state, lanes, dim_base, ctrl, walk, *, background, max_depth,
            rr_depth, nee_max_media, tir_kill, analytic_direct, ld, max_iters, mask):
    """Check every tensor and launch the CUDA kernel of ablation mask
    ``mask`` on the current stream (with the control block ``ctrl``, or
    over ``lanes`` lanes at the ld base ``dim_base``), adding its walk
    counts to ``walk``."""
    from . import build

    if nee_max_media < 0:
        raise ValueError(f"--nee-bound must be >= 0, got {nee_max_media}")
    dev = state.org.device
    r = state.org.shape[0]
    C, S = grid.num_clusters, grid.num_supers
    row_w = grid.run_rows.shape[1]
    _require(grid.bounds, "bounds", torch.float32, (C, 8), dev)
    _require(grid.super_bounds, "super_bounds", torch.float32, (S, 8), dev)
    n_groups = grid.group_bounds.shape[0]
    _require(grid.group_bounds, "group_bounds", torch.float32, (n_groups, 8), dev)
    _require(grid.run_rows, "run_rows", torch.float32,
             (C * grid.runs_per_cluster, row_w), dev)
    _require(media9, "media9", torch.float32, (media9.shape[0], 9), dev)
    _require(misc, "misc", torch.float32, (16,), dev)
    for name, dt, shape in (
        ("org", torch.float32, (r, 3)), ("dir", torch.float32, (r, 3)),
        ("thr", torch.float32, (r, 3)), ("rad", torch.float32, (r, 3)),
        ("rng", torch.int64, (r,)), ("depth", torch.int32, (r,)),
        ("alive", torch.bool, (r,)), ("aux", torch.int64, (r,)),
    ):
        _require(getattr(state, name), name, dt, shape, dev)
    if media9.shape[0] > 63:
        raise ValueError(f"{media9.shape[0]} media rows exceed the 63-medium key field")
    if lanes == 0:
        return
    sob = _sobol_i32(dev)
    lib_mask, one_thread = cuda_instance(mask)
    fn = build.megakernel(nee_max_media, lib_mask)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    # The two-level walk's group boxes, or null for the flat walk.
    groups = p(grid.group_bounds) if _levels(grid, lib_mask) else None
    # G from the launch's static width (carrywalk: one thread, whatever the width).
    group = 1 if one_thread else group_size(lanes)
    # nophys: each lane's iterations and each 1024-lane block's most.
    iters = nophys_iters(dev, r) if mask & ABLATIONS["nophys"] else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            p(grid.bounds), p(grid.super_bounds), groups, p(grid.run_rows),
            p(media9), p(misc), p(sob), 0 if dim_base is None else dim_base,
            None if ctrl is None else p(ctrl), p(state.org), p(state.dir), p(state.thr), p(state.rad),
            p(state.rng), p(state.depth), p(state.alive), p(state.aux),
            lanes, C, S, n_groups, grid.runs_per_cluster, grid.run_size, row_w,
            media9.shape[0], grid.super_factor, grid.num_opaque_supers,
            int(background), int(max_depth), int(rr_depth), int(bool(tir_kill)),
            int(bool(analytic_direct)), int(bool(ld)), int(max_iters), group,
            None if iters is None else p(iters), p(walk), ctypes.c_void_p(stream),
        )
        if not torch.cuda.is_current_stream_capturing():
            trace_paths_mega.launches += 1
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: {build.error_string(err)}")

