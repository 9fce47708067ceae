"""K1's group boxes over consecutive supers and the rule that picks its walk.

``kernels/cluster_grid.py`` builds the group boxes when a grid is laid out
(``super_groups`` at ``group_fanout``), and ``two_level_walk`` decides from
the super count whether K1's default walk tests them:

- every live super box lies inside its group's box, an empty super's
  far-point sentinel is left out of it, and a group of empty supers keeps
  the sentinel;
- the groups cover the supers in order and none straddles the opaque
  supers' cut;
- the fan-out is the power of two nearest the square root of the supers
  and the walk is flat up to 16 supers;
- the plain K1 and the launch take the rule's walk (the ablations the flat
  one), and the flat and two-level plain walks give the same state.
"""

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.kernels import cluster_grid as cgr
from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

SENTINEL = np.float32(1e30)


def _supers(s, empty=(), seed=0):
    """(s, 8) super boxes at random places, the ``empty`` ones the sentinel."""
    rs = np.random.default_rng(seed)
    sb = np.zeros((s, 8), np.float32)
    sb[:, 0:3] = rs.uniform(-50.0, 50.0, (s, 3))
    sb[:, 3:6] = sb[:, 0:3] + rs.uniform(0.0, 5.0, (s, 3))
    sb[list(empty), 0:6] = SENTINEL
    return sb


def _groups(boxes):
    """[(first super, end)] of each group box."""
    ends = [int(e) for e in boxes[:, 6]]
    return list(zip([0] + ends[:-1], ends))


@pytest.mark.parametrize("s, s_opq, fanout", [(172, 1, 16), (37, 5, 8), (40, 0, 8), (9, 9, 4),
                                              (1, 0, 1), (1024, 3, 32)])
def test_live_supers_lie_inside_their_group(s, s_opq, fanout):
    empty = set(range(3, s, 7))
    sb = _supers(s, empty, seed=s)
    boxes = cgr.super_groups(sb, s_opq, fanout)
    assert boxes.dtype == np.float32 and boxes.shape[1] == 8
    for g, (lo, hi) in enumerate(_groups(boxes)):
        live = [sp for sp in range(lo, hi) if sp not in empty]
        assert live, "these groups each hold a live super"
        assert np.array_equal(boxes[g, 0:3], sb[live, 0:3].min(axis=0))
        assert np.array_equal(boxes[g, 3:6], sb[live, 3:6].max(axis=0))
        assert (boxes[g, 0:3] <= sb[live, 0:3]).all() and (boxes[g, 3:6] >= sb[live, 3:6]).all()
        assert boxes[g, 7] == 0.0


@pytest.mark.parametrize("s, s_opq, fanout", [(172, 1, 16), (37, 5, 8), (40, 16, 8), (40, 0, 8),
                                              (12, 12, 4), (1, 1, 1)])
def test_groups_cover_the_supers_and_keep_the_opaque_cut(s, s_opq, fanout):
    boxes = cgr.super_groups(_supers(s), s_opq, fanout)
    spans = _groups(boxes)
    assert spans[0][0] == 0 and spans[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(0 < hi - lo <= fanout for lo, hi in spans)
    # No group straddles the cut: each holds opaque supers only or media only.
    assert all(hi <= s_opq or lo >= s_opq for lo, hi in spans)
    n_opq = -(-s_opq // fanout)
    assert len(spans) == n_opq + -(-(s - s_opq) // fanout)


def test_an_all_empty_group_keeps_the_sentinel():
    """Supers 4-7 empty: their group is the far point, which no ray meets;
    the group beside it leaves its empty super out."""
    sb = _supers(12, empty=(4, 5, 6, 7, 9))
    boxes = cgr.super_groups(sb, 0, 4)
    assert _groups(boxes) == [(0, 4), (4, 8), (8, 12)]
    assert (boxes[1, 0:6] == SENTINEL).all()
    assert np.array_equal(boxes[2, 0:3], sb[[8, 10, 11], 0:3].min(axis=0))
    assert np.array_equal(boxes[2, 3:6], sb[[8, 10, 11], 3:6].max(axis=0))
    o = tuple(torch.zeros(1) for _ in range(3))
    inv = tuple(torch.ones(1) for _ in range(3))
    bound = torch.full((1, 1), mk.T_MAX)
    assert not mk._slab(torch.from_numpy(boxes[1:2]), o, inv, bound).any()


@pytest.mark.parametrize("s, fanout, levels", [(1, 1, False), (2, 1, False), (10, 4, False),
                                               (16, 4, False), (17, 4, True), (40, 8, True),
                                               (100, 8, True), (172, 16, True), (600, 32, True),
                                               (1024, 32, True)])
def test_fanout_and_walk_follow_the_supers(s, fanout, levels):
    assert cgr.group_fanout(s) == fanout
    assert mk.two_level_walk(s) is levels
    assert (s > mk.FLAT_WALK_SUPERS) == levels


def _grid(tris, mats, **kw):
    return cgr.device_cluster_grid(build_clusters(tris, mats, **kw), "cpu")


def _soup(n, seed):
    rs = np.random.default_rng(seed)
    c = rs.uniform(-20.0, 20.0, (n, 1, 3))
    return (c + rs.normal(0.0, 0.4, (n, 3, 3))).astype(np.float32)


def test_the_grid_carries_its_group_boxes():
    """A grid of 40 supers (a soup of 640 triangles, 2 a cluster, 8
    clusters a super) carries 5 group boxes of 8 supers (the fan-out of
    40), each holding its supers' boxes; the plain K1 and a launch take the
    two-level walk there, the ablations the flat one."""
    grid = _grid(_soup(640, 1), np.zeros(640, np.int32), cluster_size=2, super_factor=8)
    assert grid.num_supers == 40 and grid.group_bounds.shape == (5, 8)
    want = cgr.super_groups(grid.super_bounds.numpy(), grid.num_opaque_supers, 8)
    assert torch.equal(grid.group_bounds, torch.from_numpy(want))
    assert mk._levels(grid, 0) and not mk._levels(grid, mk.ablation_mask("nofuse"))
    media9 = torch.zeros(1, 9)
    misc = torch.zeros(16)
    assert mk.plain_context(grid, media9, misc).group_bounds is grid.group_bounds
    assert mk.plain_context(grid, media9, misc, debug="cullonly").group_bounds is None


def test_flat_and_two_level_plain_walks_agree(monkeypatch):
    """The plain K1 over a grid of 40 supers, four bounces of 96 lanes from
    inside the soup: the two-level walk gives the flat walk's state, supers
    and clusters, and enters group boxes where the flat walk enters none."""
    from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays
    from complex_materials_renderer_tpu_torch.scene import MediaTable

    tris = _soup(640, 2)
    mats = (np.arange(640) % 5 == 0).astype(np.int32)
    grid = _grid(tris, mats, cluster_size=2, super_factor=8)
    media = MediaTable(mat_id=np.asarray([1], np.int32),
                       sigma_s=np.full((1, 3), 0.3, np.float32),
                       sigma_a=np.full((1, 3), 0.05, np.float32),
                       g=np.zeros((1, 3), np.float32), ior=np.full(1, 1.3, np.float32))
    arrays = make_scene_arrays(tris, mats, media, 1.0, 1, device="cpu")
    lights = make_lights((0.0, 40.0, 0.0), (0.8, 0.8, 0.6), 1000.0, device="cpu")
    media9 = mk.pack_media(arrays.media, arrays.scale)
    misc = mk.pack_misc(lights, arrays.world_lo, arrays.world_hi)
    rs = np.random.default_rng(3)
    n = 96
    o = rs.uniform(-15.0, 15.0, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = {}
    for levels in (False, True):
        monkeypatch.setattr(mk, "two_level_walk", lambda supers, levels=levels: levels)
        st = mk.from_jax_arrays(o, d, np.ones((n, 3)), np.zeros((n, 3)), np.arange(n),
                                np.zeros(n), np.ones(n, bool), np.zeros(n))
        walk = torch.zeros(pc.WALK_LEN, dtype=torch.int64)
        mk.trace_paths_mega_plain(grid, media9, misc, st, max_depth=8, nee_max_media=1,
                                  max_iters=4, walk=walk)
        out[levels] = st, walk.tolist()
    (flat, wf), (two, wt) = out[False], out[True]
    for f in mk.MegaState._fields:
        assert torch.equal(getattr(flat, f), getattr(two, f)), f
    assert wf[:3] == wt[:3] and wf[3] == 0
    assert wt[0] > n and 0 < wt[3] < wt[0] * 2 * grid.group_bounds.shape[0]
