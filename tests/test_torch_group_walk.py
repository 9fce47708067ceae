"""The group walk of the CUDA kernels K1 and K3, stated in plain PyTorch.

On the card a tile of G threads serves one ray (csrc/cluster_test.cuh,
``group_cluster_full`` and ``group_cluster_dnee``): thread k tests slots
k, k+G, ... of each run of a visited cluster, and after every cluster the
tile reduces to the state of the one-thread walk. The CUDA code cannot run
here, so this file states the same reduction over the plain tester's
per-slot values (``cluster_test._mt``, the arithmetic of every slot test)
and holds it, bit for bit, against the plain versions the kernels are
checked against on the card:

- 'full' (K3's additive edge epsilon) and 'dist' (K2's): each thread's
  strict walk over its own slots below the tile's bound as it stood at the
  cluster's start, then the lexicographic (t, slot) minimum over the tile,
  the payload taken from the thread that owns the winner; equal to
  ``trace_slots`` (the lowest slot of least t);
- 'nee': rounds of G slots; a media key is valid below the exclusive
  running minimum of the opaque hits in slot order (the carried t_opq and
  a scan over the round's earlier threads), the valid keys inserted in
  slot order into the K-list; equal to ``trace_slots(..., in_order=True)``.

G in {1, 2, 4, 8, 32}, on rays of showcase, gembox and a stack of
coincident planes made from a numpy seed. Also the choice of G from the
launch width (``group_size``).
"""

import os

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.scene import load_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = float(np.float32(1e-4))
GROUPS = (1, 2, 4, 8, 32)
LANES = 192
NEE_MAX_MEDIA = 4


def _scene(name):
    """(grid, media ids, scene box) of a shipped scene at the renderer's
    cluster width (128: four runs of 32 slots a cluster)."""
    obj = os.path.join(REPO, "scenes", f"{name}.obj")
    scene = load_scene(obj, RenderOptions(obj_path=obj))
    grid = device_cluster_grid(build_clusters(scene.triangles, scene.mat_ids, cluster_size=128),
                               "cpu")
    med_ids = [float(m) for m in scene.media.mat_id]
    tris = np.asarray(scene.triangles, np.float32).reshape(-1, 3)
    return grid, med_ids, tris.min(0), tris.max(0)


def _stack():
    """96 squares across z at random depths and xy offsets, each a medium
    (material 1) or opaque, every square twice (coincident slots tie on
    t): a ray along +z meets a random subset of them, so opaque and media
    hits of one round of G slots interleave in t and the in-order NEE keys
    depend on the scan."""
    rs = np.random.default_rng(3)
    tris, mats = [], []
    for k in range(96):
        cx, cy = rs.uniform(-0.5, 0.5, 2)
        x0, x1, y0, y1, z = cx - 0.6, cx + 0.6, cy - 0.6, cy + 0.6, rs.uniform(0.0, 5.0)
        quad = [[[x0, y0, z], [x1, y0, z], [x1, y1, z]], [[x0, y0, z], [x1, y1, z], [x0, y1, z]]]
        tris += quad * 2
        mats += [int(rs.random() < 0.5)] * 4
    tris = np.asarray(tris, np.float32)
    grid = device_cluster_grid(build_clusters(tris, np.int32(mats), cluster_size=128), "cpu")
    return grid, [1.0], None, None


@pytest.fixture(scope="module", params=["showcase", "gembox", "stack"])
def scene(request):
    return _stack() if request.param == "stack" else _scene(request.param)


def _rays(lo, hi, seed):
    """Rays from inside the scene box in random directions (for the stack:
    from below it, along +z), with a per-lane bound in [0.5, 20)."""
    rs = np.random.default_rng(seed)
    if lo is None:
        o = np.stack([rs.uniform(-0.9, 0.9, LANES), rs.uniform(-0.9, 0.9, LANES),
                      np.full(LANES, -0.5)], -1)
        d = np.stack([rs.normal(0, 0.02, LANES), rs.normal(0, 0.02, LANES), np.ones(LANES)], -1)
    else:
        o = lo + (hi - lo) * rs.uniform(0.05, 0.95, (LANES, 3))
        d = rs.normal(size=(LANES, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(0.5, 20.0, LANES)
    o, d, tmax = (torch.from_numpy(x.astype(np.float32)) for x in (o, d, tmax))
    return tuple(o.unbind(1)), tuple(d.unbind(1)), tmax


def _cluster_slots(grid, c):
    """The slot table of cluster c: runs of ``run_size`` slots in order."""
    w = grid.width
    return ct.slot_table(grid, c * w, (c + 1) * w)


def _payload(sl, uu, vv, tt, j):
    """The 'full' payload of slot column j (per lane): set_full."""
    rows = torch.arange(uu.shape[0])
    g = lambda a: a[j]  # noqa: E731
    u, v = uu[rows, j], vv[rows, j]
    e1x, e1y, e1z, e2x, e2y, e2z = (g(a) for a in (sl.e1x, sl.e1y, sl.e1z, sl.e2x, sl.e2y, sl.e2z))
    return (tt[rows, j], (j + sl.slot0).to(torch.float32), u, v,
            e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z, e1x * e2y - e1y * e2x, g(sl.mat),
            g(sl.ax) + u * e1x + v * e2x, g(sl.ay) + u * e1y + v * e2y,
            g(sl.az) + u * e1z + v * e2z)


def _tile_min(ts, ss):
    """Lexicographic minimum of (t, slot) over the threads of the tile."""
    t, s = ts[0], ss[0]
    for ot, os_ in zip(ts[1:], ss[1:]):
        take = (ot < t) | ((ot == t) & (os_ < s))
        t, s = torch.where(take, ot, t), torch.where(take, os_, s)
    return t, s


def closest_cluster(sl, O, D, t, slot, G, run, additive_eps=False, mine=None):
    """One cluster of the group walk's closest hit: each thread's strict
    walk over its own slots (k, k+G, ... of each run of ``run`` slots) below
    the tile's (t, slot) at the cluster's start, then the lexicographic
    minimum over the tile. ``mine`` (per thread, the 'full' payload of its
    own closest hit) is updated in place. Returns the tile's (t, slot)."""
    uu, vv, tt, inside = ct._mt(sl, O, D, additive_eps)
    ts, ss = [], []
    for k in range(G):
        bt, bs = t.clone(), slot.clone()
        for j in range(sl.ax.shape[0]):
            if (j % run) % G != k:
                continue
            ok = inside[:, j] & (tt[:, j] > T_MIN) & (tt[:, j] < bt)
            bt = torch.where(ok, tt[:, j], bt)
            bs = torch.where(ok, torch.full_like(bs, float(sl.slot0 + j)), bs)
            if mine is not None:
                col = torch.full((O[0].shape[0],), j, dtype=torch.int64)
                mine[k] = [torch.where(ok, a, b)
                           for a, b in zip(_payload(sl, uu, vv, tt, col), mine[k])]
        ts.append(bt)
        ss.append(bs)
    return _tile_min(ts, ss)


def owner_payload(mine, slot):
    """The 'full' state of the tile's hit ``slot``, from the first thread
    whose own closest hit it is (with no hit every thread holds the
    initial payload; thread 0 is taken)."""
    out = list(mine[0])
    for k in range(len(mine) - 1, -1, -1):
        own = mine[k][1] == slot
        out = [torch.where(own, a, b) for a, b in zip(mine[k], out)]
    return out


def group_closest(grid, O, D, tmax, G, full, additive_eps):
    """The group walk's closest hit over every cluster in order:
    (t, slot[, payload...]) as the tile holds it after the last cluster."""
    state0 = ct.payload_state0("full", tmax.clone())
    t, slot = state0[0], state0[1]
    mine = [list(state0) for _ in range(G)] if full else None
    for c in range(grid.num_clusters):
        t, slot = closest_cluster(_cluster_slots(grid, c), O, D, t, slot, G, grid.run_size,
                                  additive_eps, mine)
    if not full:
        return t, slot
    return (t, slot) + tuple(owner_payload(mine, slot)[2:])


def nee_cluster(sl, O, D, keys, opq, G, K, med_ids, run):
    """One cluster of the group walk's NEE set, in rounds of G slots of each
    run: returns (K keys, t_opq) as the tile holds them after it."""
    n = O[0].shape[0]
    keys = list(keys)
    _, _, tt, inside = ct._mt(sl, O, D)
    med = ct.media_index(sl.mat, med_ids) >= 0.0
    mat_i = torch.clamp(ct.media_index(sl.mat, med_ids), min=0.0).to(torch.int32)
    for r0 in range(0, sl.ax.shape[0], run):
        for j0 in range(0, run, G):
            cols = torch.arange(r0 + j0, r0 + min(j0 + G, run))  # thread k: column k
            t_r = tt[:, cols]
            valid_geom = inside[:, cols] & (t_r > T_MIN)
            own_opq = torch.where(valid_geom & ~med[cols], t_r, torch.full_like(t_r, np.inf))
            # t_opq before each thread's slot: the carried bound and the
            # round's earlier opaque hits (an exclusive prefix minimum).
            incl = torch.cummin(own_opq, dim=1).values
            excl = torch.cat([torch.full((n, 1), np.inf), incl[:, :-1]], dim=1)
            before = torch.minimum(opq[:, None], excl)
            valid = valid_geom & med[cols] & (t_r < before)
            key = (t_r.view(torch.int32) & ~ct.NEE_MAT_MASK) | mat_i[cols]
            for k in range(cols.shape[0]):  # the valid keys in slot order
                cand = torch.where(valid[:, k], key[:, k],
                                   torch.full_like(key[:, k], ct.KEY_EMPTY))
                for i in range(K):
                    keys[i], cand = torch.minimum(cand, keys[i]), torch.maximum(cand, keys[i])
            opq = torch.minimum(opq, incl[:, -1])
    return keys, opq


def group_nee(grid, O, D, tmax, G, K, med_ids):
    """The group walk's NEE set over every cluster in order: (K keys...,
    t_opq) as the tile holds it after the last cluster."""
    n = O[0].shape[0]
    keys = [torch.full((n,), ct.KEY_EMPTY, dtype=torch.int32) for _ in range(K)]
    opq = tmax.clone()
    for c in range(grid.num_clusters):
        keys, opq = nee_cluster(_cluster_slots(grid, c), O, D, keys, opq, G, K, med_ids,
                                grid.run_size)
    return tuple(keys) + (opq,)


@pytest.mark.parametrize("G", GROUPS)
def test_group_full_matches_trace_slots(scene, G):
    grid, _, lo, hi = scene
    O, D, tmax = _rays(lo, hi, seed=G)
    want = ct.trace_slots(ct.slot_table(grid), O + D, "full",
                          ct.payload_state0("full", tmax.clone()), T_MIN, additive_eps=True)
    got = group_closest(grid, O, D, tmax, G, full=True, additive_eps=True)
    assert int((got[1] >= 0).sum()) > LANES // 4
    for name, x, y in zip("t slot u v nx ny nz mat px py pz".split(), got, want):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("G", GROUPS)
def test_group_dist_matches_trace_slots(scene, G):
    grid, _, lo, hi = scene
    O, D, tmax = _rays(lo, hi, seed=10 + G)
    want = ct.trace_slots(ct.slot_table(grid), O + D, "dist",
                          ct.payload_state0("dist", tmax.clone()), T_MIN)
    got = group_closest(grid, O, D, tmax, G, full=False, additive_eps=False)
    assert int((got[1] >= 0).sum()) > 0
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("G", GROUPS)
def test_group_nee_matches_in_order_walk(scene, G):
    grid, med_ids, lo, hi = scene
    K = ct.nee_list_len(NEE_MAX_MEDIA)
    O, D, tmax = _rays(lo, hi, seed=20 + G)
    want = ct.trace_slots(ct.slot_table(grid), O + D, "nee",
                          ct.payload_state0("nee", tmax.clone(), K), T_MIN, K, med_ids,
                          in_order=True)
    got = group_nee(grid, O, D, tmax, G, K, med_ids)
    assert int((want[0] != ct.KEY_EMPTY).sum()) > 0
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_group_size_fills_the_card():
    widths = [1, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 1 << 18, 1 << 20]
    gs = [ct.group_size(n) for n in widths]
    assert all(g in ct.GROUP_SIZES for g in gs)
    assert gs == sorted(gs, reverse=True)  # wider launches take no more threads per ray
    for n, g in zip(widths, gs):
        assert n * g >= ct.FILL_THREADS or g == ct.GROUP_SIZES[-1]
        assert g == 1 or n * (g // 2) < ct.FILL_THREADS  # the smallest such G
    # The main path's widths (PERF.md): the widest launch, the compacted
    # phases and the 1,024-lane tail.
    assert [ct.group_size(n) for n in (65536, 16384, 4096, 1024)] == [4, 16, 32, 32]
