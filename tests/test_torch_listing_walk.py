"""The tile walk of the CUDA listing kernel K4, stated in plain PyTorch.

On the card (csrc/binned_listing.cu, variant 1) each CTA of LIST_CTA
threads takes ``span`` lanes, compacts its listing lanes (t_lo != EMPTY)
in lane order and serves each with a tile of G threads, G from the CTA's
count of listing lanes (``cluster_test.listing_group``) unless the launch
fixes it. A warp walks the group boxes (each the bounds of
LIST_SUPER_GROUP consecutive supers), then the supers of the groups its
tiles need, each level in chunks of G:

- the tile's bound ``lim`` is the least L-th key of its threads; thread j
  tests box base + j and needs it when the ray meets it and its masked
  entry is not above lim's masked entry (the group and super culls);
- a ballot gives each tile its needed boxes and the warp their union; the
  warp walks the union in order: the supers of a group it needs, then
  thread j of each tile that needs a super tests its clusters lo + j,
  lo + j + G, ...;
- a cluster key above t_lo enters the thread's own L-list only below lim
  (the key cull), and lim then follows the thread's own L-th key;

then L rounds of a tile minimum merge the threads' lists. The CUDA code
cannot run here, so this file states that walk over the plain version's
box arithmetic (``binned_trace._entries``) and holds it, bit for bit,
against ``listing_plain``, which the kernel is held to on the card, at
G in {1, 2, 4, 8, 16, 32} and at the per-CTA rule; on showcase, gembox, a
tiled grid of many supers, random soups with ``super_factor=4``, a stack
of coincident boxes (equal entries, ties broken by id), with fresh and
relisting t_lo, at L in {1, 2, 4, 8, 12}, and on a grid of fewer clusters
than L. It also holds that the walk saves work: on the tiled grid it tests
under half the boxes that the one-thread walk of variant 0 tests.
"""

import os

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.kernels.megakernel import _safe_inv
from complex_materials_renderer_tpu_torch.scene import load_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (1, 2, 4, 8, 16, 32)
LISTS = (1, 2, 4, 8, 12)
EMPTY = bt.EMPTY
LANES = 320
HIGH = ~bt.ID_MASK  # the entry field of a key


# --------------------------------------------------------------------------
# The walk
# --------------------------------------------------------------------------


def _insert(slots, key, acc):
    """The L-step min/max chain into sorted ``slots`` (..., L) where
    ``acc``."""
    out = []
    for i in range(slots.shape[-1]):
        s = slots[..., i]
        out.append(torch.where(acc, torch.minimum(key, s), s))
        key = torch.where(acc, torch.maximum(key, s), key)
    return torch.stack(out, -1)


def _vote(ent, hit, lim, want, base, end, G):
    """One vote: thread j of each tile tests box base + j (< end) where
    ``want``; it needs the box when the ray meets it and its masked entry is
    not above lim's. Returns the tiles' needs (warps, tiles, G) and the
    warp's union (warps, G)."""
    j = torch.arange(G)
    i = (base + j).clamp(max=end - 1)
    need = want & (base + j < end) & hit[:, :, i] & (ent[:, :, i] <= (lim & HIGH)[..., None])
    return need, need.any(dim=1)


def _warp_walk(grid, rays, bound, tlo, lanes, L, G, work):
    """Keys (L, warps, tiles) of the tile walk of warps of 32 / G tiles,
    ``lanes`` (warps, tiles) their lanes (-1: an idle tile)."""
    nw, W = lanes.shape
    has = lanes >= 0
    ln = lanes.clamp(min=0).reshape(-1)
    O = tuple(rays[a, ln] for a in range(3))
    INV = tuple(_safe_inv(rays[3 + a, ln]) for a in range(3))
    S, SF, C, GS = grid.num_supers, grid.super_factor, grid.num_clusters, ct.LIST_SUPER_GROUP
    sb = grid.super_bounds
    groups = torch.stack([torch.cat([sb[k:k + GS, 0:3].amin(0), sb[k:k + GS, 3:6].amax(0),
                                     sb[k, 6:8]]) for k in range(0, S, GS)])
    entries = {}
    for name, boxes in (("group", groups), ("super", sb), ("cluster", grid.bounds)):
        tn, hit = (x.reshape(nw, W, -1) for x in bt._entries(boxes, O, INV, bound[ln]))
        entries[name] = (tn.view(torch.int32).to(torch.int64) & HIGH, hit)
    key_c = entries["cluster"][0] | torch.arange(C)
    hit_c = entries["cluster"][1]
    t_lo = tlo[ln].to(torch.int64).reshape(nw, W, 1)
    slots = torch.full((nw, W, G, L), EMPTY, dtype=torch.int64)
    j = torch.arange(G)
    ng = groups.shape[0]
    for gb in range(0, ng, G):
        gneed, guni = _vote(*entries["group"], slots[..., L - 1].amin(dim=2), has[..., None], gb,
                            ng, G)
        work["groups"] += int(has.sum()) * min(G, ng - gb)
        for gbit in range(G):
            if not bool(guni[:, gbit].any()):
                continue
            s0 = (gb + gbit) * GS
            s1 = min(s0 + GS, S)
            gwant = (guni[:, gbit, None] & gneed[:, :, gbit])[..., None]
            for base in range(s0, s1, G):
                lim_tile = slots[..., L - 1].amin(dim=2)
                need, uni = _vote(*entries["super"], lim_tile, gwant, base, s1, G)
                work["supers"] += int(gwant.sum()) * min(G, s1 - base)
                lim = lim_tile[..., None].expand(nw, W, G).clone()
                for bit in range(G):
                    if not bool(uni[:, bit].any()):
                        continue
                    lo = (base + bit) * SF
                    hi = min(lo + SF, C)
                    want = (uni[:, bit, None] & need[:, :, bit])[..., None]
                    for off in range(0, hi - lo, G):
                        c = (lo + off + j).clamp(max=C - 1)
                        act = want & (lo + off + j < hi)
                        work["clusters"] += int(act.sum())
                        key = key_c[:, :, c]
                        acc = act & hit_c[:, :, c] & (key > t_lo) & (key < lim)
                        slots = _insert(slots, key, acc)
                        lim = torch.where(acc, torch.minimum(lim, slots[..., L - 1]), lim)
    out = []
    for _ in range(L):
        m = slots[..., 0].amin(dim=2)
        out.append(m)
        pop = slots[..., 0] == m[..., None]
        shifted = torch.cat([slots[..., 1:], torch.full_like(slots[..., :1], EMPTY)], -1)
        slots = torch.where(pop[..., None], shifted, slots)
    return torch.stack(out)


def tile_walk(grid, rays, bound, tlo, L, group=0, span=None, work=None):
    """(keys (L, n) int32, tlim (n,)) of the kernel's tile walk: CTAs of
    ``span`` lanes (the wrapper's ``listing_span`` by default), each
    listing lane a tile of ``group`` threads (0: ``listing_group`` of the
    CTA's listing lanes). ``work`` counts the boxes the walk tests."""
    n = rays.shape[1]
    span = span or bt.listing_span(n, grid.num_supers)
    work = {"groups": 0, "supers": 0, "clusters": 0} if work is None else work
    keys = torch.full((L, n), EMPTY, dtype=torch.int64)
    by_group = {}
    for lo in range(0, n, span):
        live = lo + (tlo[lo:lo + span] != EMPTY).nonzero().squeeze(1)
        if live.numel() == 0:
            continue
        g = group or ct.listing_group(live.numel(), grid.num_supers)
        assert live.numel() * g <= ct.LIST_CTA
        per_warp = 32 // g
        tiles = torch.full((-(-live.numel() // per_warp) * per_warp,), -1, dtype=torch.int64)
        tiles[:live.numel()] = live
        by_group.setdefault(g, []).append(tiles.view(-1, per_warp))
    for g, warps in by_group.items():
        lanes = torch.cat(warps)
        got = _warp_walk(grid, rays, bound, tlo, lanes, L, g, work)
        has = lanes >= 0
        keys[:, lanes[has]] = got[:, has]
    keys = keys.to(torch.int32)
    return keys, keys[L - 1].clone()


def one_thread_work(grid, rays, bound, tlo):
    """Boxes the one-thread walk (variant 0) tests: every super for every
    listing lane, every cluster of a super the lane meets."""
    live = (tlo != EMPTY).nonzero().squeeze(1)
    O = tuple(rays[a, live] for a in range(3))
    INV = tuple(_safe_inv(rays[3 + a, live]) for a in range(3))
    _, hit_s = bt._entries(grid.super_bounds, O, INV, bound[live])
    per_super = torch.tensor([min(grid.super_factor, grid.num_clusters - s * grid.super_factor)
                              for s in range(grid.num_supers)])
    return live.numel() * grid.num_supers + int((hit_s.to(torch.int64) @ per_super).sum())


# --------------------------------------------------------------------------
# Scenes and rays
# --------------------------------------------------------------------------


def _shipped(name):
    obj = os.path.join(REPO, "scenes", f"{name}.obj")
    scene = load_scene(obj, RenderOptions(obj_path=obj))
    return scene.triangles, scene.mat_ids


def _grid(tris, mats, **kw):
    return device_cluster_grid(build_clusters(np.asarray(tris, np.float32), np.asarray(mats),
                                              **kw), "cpu")


def _tiled():
    """Gembox tiled 4 x 4 on the ground plane at width 8: many supers."""
    tris, mats = _shipped("gembox")
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    step = (hi - lo) * np.float32(1.1)
    offs = [(step[0] * i, 0.0, step[2] * k) for i in range(4) for k in range(4)]
    tiled = np.concatenate([tris + np.float32(off) for off in offs])
    return _grid(tiled, np.tile(mats, 16), cluster_size=8, super_factor=4)


def _soup(seed):
    rs = np.random.default_rng(seed)
    base = rs.uniform(-2.0, 2.0, size=(320, 1, 3))
    tris = base + rs.uniform(-0.5, 0.5, size=(320, 3, 3))
    return _grid(tris, np.arange(320) % 3 == 0, cluster_size=8, super_factor=4)


def _coincident():
    """Copies of one cube shell, each cluster a whole copy, some shifted
    along x: whole runs of clusters share one box (equal entry fields, the
    id breaks the tie) and overlapping boxes interleave in t."""
    rs = np.random.default_rng(9)
    q = np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    faces = []
    for axis in range(3):
        for side in (0.0, 1.0):
            f = np.roll(q, axis, axis=1)
            f[:, axis] = side
            faces += [f[[0, 1, 2]], f[[0, 2, 3]]]
    cube = np.stack(faces)  # 12 triangles, one cluster of width 16
    shifts = np.where(rs.random(24) < 0.5, 0.0, rs.integers(1, 4, 24) * np.float32(0.25))
    tris = np.concatenate([cube + np.float32([s, 0.0, 0.0]) for s in shifts])
    return _grid(tris, np.zeros(len(tris), np.int32), cluster_size=16, super_factor=4)


def _small():
    """Three clusters: fewer than most list lengths."""
    rs = np.random.default_rng(4)
    tris = rs.uniform(-1.0, 1.0, size=(20, 3, 3))
    return _grid(tris, np.zeros(20, np.int32), cluster_size=8, super_factor=2)


SCENES = {
    "showcase": lambda: _grid(*_shipped("showcase"), cluster_size=128),
    "gembox": lambda: _grid(*_shipped("gembox"), cluster_size=16, super_factor=4),
    "tiled": _tiled,
    "soup": lambda: _soup(1),
    "soup2": lambda: _soup(2),
    "coincident": _coincident,
    "small": _small,
}


def _rays(grid, seed, n=LANES):
    """Rays from around the scene box aimed at random points inside it,
    with per-lane bounds (a few lanes parked: t_lo EMPTY)."""
    rs = np.random.default_rng(seed)
    b = grid.bounds.numpy()
    real = b[:, 0] < 1e29
    lo, hi = b[real, 0:3].min(0), b[real, 3:6].max(0)
    mid, ext = (lo + hi) / 2, (hi - lo) / 2 + 0.1
    o = mid + ext * rs.uniform(-1.6, 1.6, (n, 3))
    d = mid + ext * rs.uniform(-0.9, 0.9, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bound = rs.uniform(0.2, 3.0, n) * np.linalg.norm(ext) * 2
    rays = torch.from_numpy(np.concatenate([o.T, d.T]).astype(np.float32)).contiguous()
    bound = torch.from_numpy(bound.astype(np.float32))
    tlo = torch.where(torch.from_numpy(rs.random(n) < 0.05), EMPTY, -1).to(torch.int32)
    return rays, bound, tlo


def _relist(grid, rays, bound, tlo):
    """The second generation's t_lo: each lane's second key."""
    return bt.listing_plain(grid, rays, bound, tlo, 2)[0][1].contiguous()


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    grid = SCENES[request.param]()
    rays, bound, tlo = _rays(grid, seed=len(request.param))
    return request.param, grid, rays, bound, tlo


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("group", GROUPS + (0,))
def test_tile_walk_matches_plain(case, group):
    name, grid, rays, bound, tlo = case
    for tname, t_lo in (("fresh", tlo), ("relisting", _relist(grid, rays, bound, tlo))):
        for L in LISTS:
            span = ct.LIST_CTA // group if group else None
            got = tile_walk(grid, rays, bound, t_lo, L, group, span)
            want = bt.listing_plain(grid, rays, bound, t_lo, L)
            assert torch.equal(got[0], want[0]), (name, tname, L, group)
            assert torch.equal(got[1], want[1]), (name, tname, L, group)


def test_scenes_exercise_the_walk(case):
    name, grid, rays, bound, tlo = case
    keys, tlim = bt.listing_plain(grid, rays, bound, tlo, 4)
    assert int((keys[0] != EMPTY).sum()) > LANES // 4, name
    if name == "small":
        assert grid.num_clusters < 4
    if name in ("tiled", "soup", "soup2"):
        assert grid.num_supers >= 8 and int((tlim != EMPTY).sum()) > LANES // 8, name
    if name == "coincident":
        # Equal entry fields among the listed keys of a lane.
        high = keys.to(torch.int64) & HIGH
        assert bool(((high[1:] == high[:-1]) & (keys[1:] != EMPTY)).any())


@pytest.mark.parametrize("L", (4, 8))
def test_sparse_relist_spreads_over_tiles(L):
    """A relist in which under 2% of the lanes list: each CTA holds a lane
    or two and the rule gives it a tile of 32 threads (the kernel's span at
    2,048 lanes of a grid of many supers is 8 lanes a CTA)."""
    grid = _tiled()
    rays, bound, tlo = _rays(grid, seed=21, n=2048)
    relist = _relist(grid, rays, bound, tlo)
    sparse = torch.where(torch.arange(2048) % 64 == 5, relist, EMPTY).to(torch.int32)
    assert 0 < int((sparse != EMPTY).sum()) < 0.02 * 2048
    assert ct.listing_group(2, grid.num_supers) == 32
    got = tile_walk(grid, rays, bound, sparse, L)
    want = bt.listing_plain(grid, rays, bound, sparse, L)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_walk_tests_fewer_boxes_on_many_supers():
    """On the tiled grid the tile walk tests fewer boxes than the one-thread
    walk: the group boxes spare most super tests, and the supers culled by
    the L-th key and the union's supers the tile does not need are never
    opened."""
    grid = _tiled()
    rays, bound, tlo = _rays(grid, seed=5)
    old = one_thread_work(grid, rays, bound, tlo)
    listing = int((tlo != EMPTY).sum())
    for L in (1, 4):
        work = {"groups": 0, "supers": 0, "clusters": 0}
        tile_walk(grid, rays, bound, tlo, L, group=1, span=ct.LIST_CTA, work=work)
        assert work["groups"] == listing * -(-grid.num_supers // ct.LIST_SUPER_GROUP)
        assert work["supers"] < listing * grid.num_supers / 2
        assert sum(work.values()) < old / 2


def test_listing_rules():
    # A CTA's G from its listing lanes: 256 threads over them, at most 32,
    # and no more than the grid's supers.
    assert [ct.listing_group(k, 172) for k in (256, 200, 128, 64, 40, 33, 32, 8, 2, 1)] == [
        1, 1, 2, 4, 4, 4, 8, 32, 32, 32]
    assert [ct.listing_group(k, 1) for k in (256, 64, 1)] == [1, 1, 1]
    assert [ct.listing_group(k, 3) for k in (256, 64, 1)] == [1, 2, 2]
    # The span from the launch width: a 65,536-lane pass at 64 lanes a CTA
    # (G = 4 where all list), at 128 (G = 2) on a grid of two supers.
    assert [bt.listing_split(n, 172) for n in (1 << 18, 65536, 8192, 1024)] == [
        (1, 256, 0), (1, 64, 0), (1, 8, 0), (1, 8, 0)]
    assert [bt.listing_span(n, 2) for n in (65536, 1024)] == [128, 128]
    assert bt.listing_span(65536, 1) == 256
    # A grid of a few supers (showcase: one) takes the one-thread walk, and
    # so does a grid of more supers than the tile walk's shared memory holds.
    assert [bt.listing_split(n, s) for n in (65536, 1024) for s in (1, 2, 7)] == [
        (0, 128, 0)] * 6
    assert bt.listing_split(65536, bt.LIST_ONE_THREAD_SUPERS + 1) == (1, 64, 0)
    assert bt.listing_split(65536, bt.MAX_SUPERS) == (1, 64, 0)
    assert [bt.listing_split(n, bt.MAX_SUPERS + 1) for n in (65536, 1024)] == [
        (0, 128, 0), (0, 128, 0)]
