"""The many-cluster scene on the port's normal path, and K1's walk counts.

- ``tools/make_scenes.py build_tiled`` writes showcase tiled a x b: the
  triangles read back are showcase's plus the tile offsets, bit for bit,
  and the committed 16 x 16 files are the generator's;
- at 3 x 4 tiles (130 clusters at width 128, so auto partitions them: 145
  clusters in 10 supers) the port's CPU path matches the benchmark's plain reference
  pixel for pixel;
- the plain K1's walk counts (bounces, super boxes entered, clusters
  tested, group boxes entered) equal a hand count on a two-super scene,
  and a walk over the boxes one cluster at a time on the 3 x 4 tiling,
  with the flat walk and with the two-level walk (the rule forced); the
  CPU executor moves them into the sites' fields;
- on the card, the CUDA counts equal the plain ones on the first
  65,536-lane launch of the 16 x 16 tiling and of showcase, and the flat
  and two-level walks give the same states and enter the same boxes.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import MediaTable, load_scene
from complex_materials_renderer_tpu_torch.tools.make_scenes import build_tiled

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "cmr_bench", "configs", "showcase-tiled-16x16.json")
T_MIN = mk.T_MIN


def _tiled(tmp_path, tiles):
    obj = build_tiled(str(tmp_path), tiles)
    return load_scene(obj, RenderOptions(obj_path=obj))


def _digest(tris) -> str:
    return hashlib.sha256(np.ascontiguousarray(tris, np.float32).tobytes()).hexdigest()


def test_build_tiled_is_showcase_plus_the_offsets(tmp_path):
    """2 x 2 tiles: showcase's triangles plus the offsets drawn from
    default_rng(6) on the (12.5, 9.5) pitch, and the tiled material ids."""
    showcase = load_scene(os.path.join(REPO, "scenes", "showcase.obj"), RenderOptions())
    rs = np.random.default_rng(6)
    offs = np.asarray([(12.5 * i + rs.uniform(0.0, 0.5), 0.0, -9.5 * j - rs.uniform(0.0, 0.5))
                       for i in range(2) for j in range(2)], np.float32)
    want = (showcase.triangles[None] + offs[:, None, None, :]).reshape(-1, 3, 3)
    got = _tiled(tmp_path, (2, 2))
    assert got.triangles.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    assert np.array_equal(got.mat_ids, np.tile(showcase.mat_ids, 4))
    assert got.options.camera_pos == (-20.0, 40.0, 30.0)
    assert got.options.camera_look_at == (6.25, 0.0, -4.75)  # the 2 x 2 grid's middle
    assert got.options.light_pos == (-40.0, 80.0, 50.0)
    assert got.options.light_intensity == 200000.0
    assert got.options.light_color == showcase.options.light_color
    assert np.array_equal(got.media.mat_id, showcase.media.mat_id)


def test_committed_scene_is_the_generators(tmp_path):
    committed = load_scene(os.path.join(REPO, "cmr_bench", "configs", "scenes",
                                        "showcase_tiled_16x16.obj"), RenderOptions())
    assert committed.triangles.shape == (352_768, 3, 3)
    assert _digest(committed.triangles) == _digest(_tiled(tmp_path, (16, 16)).triangles)
    for ext in ("mtl", "json"):
        with open(os.path.join(REPO, "cmr_bench", "configs", "scenes",
                               f"showcase_tiled_16x16.{ext}")) as a, \
                open(tmp_path / f"showcase_tiled_16x16.{ext}") as b:
            assert a.read() == b.read()


def test_tiled_reference_matches_port_pixel_for_pixel(tmp_path):
    """3 x 4 tiles (16,536 triangles, 130 clusters: a partitioned grid of
    145 clusters in several supers), 16x12 at 2 spp: the CPU path of the card's engine
    (the cluster grid and the plain K1) against the benchmark's plain
    float64 reference, every pixel."""
    import json

    from cmr_bench import check

    cfg = json.load(open(CONFIG))
    cfg["scene"] = build_tiled(str(tmp_path), (3, 4))
    scene = load_scene(cfg["scene"], RenderOptions())
    opts = dataclasses.replace(scene.options, **dict(cfg["options"], backend="cluster",
                                                     engine="mega"),
                               width=16, height=12, num_samples=2, device="cpu")
    r = Renderer(scene, opts)
    # 130 clusters unpartitioned (above 128: auto partitions), 145 partitioned.
    assert scene.triangles.shape[0] == 16_536 and -(-16_536 // r.accel.width) == 130
    assert r.accel.num_clusters == 145 and r.accel.num_opaque_supers > 0
    assert r.accel.num_supers > 2
    img = r.render()
    ys, xs = np.mgrid[0:12, 0:16]
    pix = np.stack([xs.ravel(), ys.ravel()], 1)
    traffic = {"width": 16, "height": 12, "samples": 2}
    ref = check.reference(cfg, traffic, 0.0, pix, "cpu")
    prog = img.reshape(-1, 3).astype(np.float64)
    rel = np.abs(prog - ref).max(-1) / np.maximum(np.abs(ref).max(-1), check.FLOOR)
    assert (np.abs(ref).max(-1) > 0).sum() > 40
    # A rounding decision (a Fresnel or roulette draw at its threshold) may
    # send a pixel's later samples elsewhere: at most 2 of the 192 flip.
    assert (rel > check.FLIP).sum() <= 2 and np.median(rel) < 1e-6


def _no_media():
    return MediaTable(mat_id=np.zeros(0, np.int32), sigma_s=np.zeros((0, 3), np.float32),
                      sigma_a=np.zeros((0, 3), np.float32), g=np.zeros((0, 3), np.float32),
                      ior=np.zeros(0, np.float32))


@pytest.mark.parametrize("levels", [False, True])
def test_plain_walk_counts_match_a_hand_count(monkeypatch, levels):
    """Two walls side by side facing +z, each a cluster of its own super.
    A lane aimed at a wall enters its super and tests its cluster, whatever
    the walk's order; a lane aimed between them or at the sky enters none.
    The shadow rays start on a wall's flat box and leave it toward a light
    in front: they enter no box. The flat walk (two supers: the rule's)
    enters no group; the two-level walk, forced, enters the wall's group
    (one super a group at two supers) with its super."""
    monkeypatch.setattr(mk, "two_level_walk", lambda supers: levels)
    def wall(x0, x1):
        return [[[x0, 0, 0], [x1, 0, 0], [x1, 2, 0]], [[x0, 0, 0], [x1, 2, 0], [x0, 2, 0]]]

    tris = np.asarray(wall(-3, -1) + wall(1, 3), np.float32)
    mats = np.zeros(4, np.int32)
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=2, super_factor=1), "cpu")
    assert (grid.num_clusters, grid.num_supers) == (2, 2)
    arrays = make_scene_arrays(tris, mats, _no_media(), 1.0, 1, device="cpu")
    lights = make_lights((0.0, 1.0, 10.0), (0.8, 0.8, 0.6), 100.0, device="cpu")
    media9 = mk.pack_media(arrays.media, arrays.scale)
    misc = mk.pack_misc(lights, arrays.world_lo, arrays.world_hi)
    # (x, y) where each lane's ray, from (x, 1, 5), meets the walls' plane.
    aims = [(-2.0, 1.0), (-1.5, 0.5), (2.0, 1.5), (2.5, 0.3), (0.0, 1.0), (-2.0, 50.0)]
    o = np.asarray([[x, 1.0, 5.0] for x, _ in aims], np.float32)
    d = np.asarray([[0.0, y - 1.0, -5.0] for _, y in aims], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = len(aims)
    st = mk.from_jax_arrays(o, d, np.ones((n, 3)), np.zeros((n, 3)), np.arange(n), np.zeros(n),
                            np.ones(n, bool), np.zeros(n))
    assert grid.group_bounds.shape == (2, 8)
    walk = torch.zeros(pc.WALK_LEN, dtype=torch.int64)
    mk.trace_paths_mega_plain(grid, media9, misc, st, max_iters=1, walk=walk)
    assert walk.tolist() == [6, 4, 4, 4 if levels else 0]


def _rays(r, n, seed):
    """Lanes from points above the tiles' floor in random directions, and
    toward the light, with random bounds, some of them empty."""
    rs = np.random.default_rng(seed)
    lo = r.scene_arrays.world_lo.numpy()
    hi = r.scene_arrays.world_hi.numpy()
    o = lo + rs.uniform(0.0, 1.0, (n, 3)) * (hi - lo) * [1.0, 0.2, 1.0] + [0.0, 0.05, 0.0]
    da = rs.normal(size=(n, 3))
    da /= np.linalg.norm(da, axis=1, keepdims=True)
    light = np.asarray([[-1.6, 4.5, 4.2]])
    db = light - o
    dist = np.linalg.norm(db, axis=1)
    # Half the set-B rays run level along the rows of tiles, through many
    # media boundaries, so that the K-th key bounds their walks.
    level = rs.uniform(size=n) < 0.5
    o[level, 1] = rs.uniform(0.3, 1.1, int(level.sum()))
    db[level] = [1.0, 0.0, 0.0] + rs.normal(size=(int(level.sum()), 3)) * [0.0, 0.01, 0.03]
    dist[level] = 40.0
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    tmax_a = t(np.where(rs.uniform(size=n) < 0.3, 0.0, rs.uniform(0.5, 60.0, n)))
    tmax_b = t(np.where(rs.uniform(size=n) < 0.2, 0.0, dist))
    return (tuple(t(o[:, i]) for i in range(3)), tuple(t(da[:, i]) for i in range(3)), tmax_a,
            tuple(t(db[:, i]) for i in range(3)), tmax_b)


def _box_walk(grid, O, sets, K, med_ids, levels=False):
    """The linear walk of K1 over the boxes, one cluster at a time:
    ``sets`` holds (direction, payload, state) of each ray set; a box is
    entered when a set with a bound above T_MIN meets it under its bound as
    it stands, and an entered cluster's slots update every set's state.
    With ``levels`` a super is tested only in a group box entered, each
    group's box tested before its first super. Returns (supers entered,
    clusters tested, groups entered)."""
    SF, W = grid.super_factor, grid.width
    n = O[0].shape[0]
    need = [ct.payload_bound(p, s, K) > T_MIN for _, p, s in sets]
    ends = [int(e) for e in grid.group_bounds[:, 6]]
    supers = clusters = groups = 0
    in_group = torch.ones(n, dtype=torch.bool)
    for sp in range(grid.num_supers):
        def meets(box):
            hit = torch.zeros(n, dtype=torch.bool)
            for (D, p, s), m in zip(sets, need):
                inv = tuple(mk._safe_inv(x) for x in D)
                bound = ct.payload_bound(p, s, K)[:, None]
                hit |= m & mk._slab(box[None], O, inv, bound)[:, 0]
            return hit

        if levels and sp in [0] + ends[:-1]:
            in_group = meets(grid.group_bounds[([0] + ends).index(sp)])
            groups += int(in_group.sum())
        s_hit = in_group & meets(grid.super_bounds[sp])
        supers += int(s_hit.sum())
        for c in range(sp * SF, min((sp + 1) * SF, grid.num_clusters)):
            c_hit = s_hit & meets(grid.bounds[c])
            clusters += int(c_hit.sum())
            act = c_hit.nonzero()[:, 0]
            if act.numel() == 0:
                continue
            sl = ct.slot_table(grid, c * W, (c + 1) * W)
            for i, (D, p, s) in enumerate(sets):
                got = ct.trace_slots(sl, tuple(x[act] for x in O + D), p,
                                     tuple(x[act] for x in s), T_MIN, K, med_ids, in_order=True)
                s = tuple(x.clone() for x in s)
                for x, y in zip(s, got):
                    x[act] = y
                sets[i] = (D, p, s)
    return supers, clusters, groups


@pytest.fixture(scope="module")
def tiled_3x4(tmp_path_factory):
    scene = _tiled(tmp_path_factory.mktemp("tiled"), (3, 4))
    r = Renderer(scene, dataclasses.replace(scene.options, backend="cluster", engine="mega",
                                            device="cpu"))
    media9 = mk.pack_media(r.scene_arrays.media, r.scene_arrays.scale)
    misc = mk.pack_misc(r.lights, r.scene_arrays.world_lo, r.scene_arrays.world_hi)
    return scene, r, mk.plain_context(r.accel, media9, misc)


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("nee_max_media", [1, 4])
def test_plain_walk_counts_match_a_walk_over_the_boxes(tiled_3x4, nee_max_media, levels):
    """The plain 'full' and fused 'dnee' walks' counts (from the bound
    before each box) against the walk over the boxes cluster by cluster,
    on the partitioned 3 x 4 tiling; with a K-list of 4 keys (one medium
    pair) and of 10, so that the K-th key bounds some walks. The tiling's
    10 supers take the flat walk; with ``levels`` the two-level walk's
    group count (groups of 4 supers, the opaque ones apart) is held too,
    and the supers and clusters are the flat walk's."""
    _, r, cx = tiled_3x4
    grid = r.accel
    assert not mk._levels(grid, 0) and cx.group_bounds is None
    cx = cx._replace(K=ct.nee_list_len(nee_max_media), nee_max_media=nee_max_media,
                     group_bounds=grid.group_bounds if levels else None)
    O, DA, TMAX_A, DB, TMAX_B = _rays(r, 160, seed=3 + nee_max_media)
    walk = torch.zeros(pc.WALK_LEN, dtype=torch.int64)
    mk._trace_full(cx, O, DA, torch.full_like(TMAX_A, mk.T_MAX), walk=walk)
    inv = tuple(mk._safe_inv(x) for x in DA)
    t0 = mk._box_clamp(cx, O, inv, torch.full_like(TMAX_A, mk.T_MAX))
    sets = [(DA, "dist", ct.payload_state0("dist", t0))]
    want = _box_walk(grid, O, list(sets), cx.K, cx.med_ids, levels)
    assert want[:2] == _box_walk(grid, O, list(sets), cx.K, cx.med_ids)[:2]
    assert walk[1:].tolist() == list(want) and want[1] > 160
    assert (want[2] > 0) == levels and want[2] < 160 * grid.group_bounds.shape[0] / 2

    walk.zero_()
    mk._trace_dnee(cx, O, DA, TMAX_A, DB, TMAX_B, walk)
    ta = mk._box_clamp(cx, O, inv, TMAX_A)
    sets = [(DA, "dist", ct.payload_state0("dist", ta)),
            (DB, "nee", ct.payload_state0("nee", TMAX_B, cx.K))]
    want = _box_walk(grid, O, list(sets), cx.K, cx.med_ids, levels)
    assert want[:2] == _box_walk(grid, O, list(sets), cx.K, cx.med_ids)[:2]
    assert walk[1:].tolist() == list(want) and want[1] > 160
    assert (want[2] > 0) == levels


def test_cpu_executor_fills_the_walk_fields(tiled_3x4):
    """A render by the CPU executor: every K1 launch's walk counts land in
    a K1 site's fields, the accumulator is left empty, and the bounces
    counted at the sites are the walk's."""
    scene, r, _ = tiled_3x4
    r = Renderer(scene, dataclasses.replace(r.options, width=8, height=6, num_samples=2))
    counts = pc.device_counts("cpu")
    before = counts.clone()
    r.render()
    delta = (counts - before).tolist()
    assert delta[pc.CNT_WALK:pc.CNT_WALK + pc.WALK_LEN] == [0] * pc.WALK_LEN
    assert counts[pc.CNT_WALK:pc.CNT_WALK + pc.WALK_LEN].tolist() == [0] * pc.WALK_LEN
    sites = pc.site_counts(delta)
    kinds = {s.label: s.kind for s in pc.sites()}
    k1 = [f for label, f in sites.items() if kinds[label] == "k1"]
    rest = [f for label, f in sites.items() if kinds[label] != "k1"]
    assert all(f[pc.SITE_BOUNCES:pc.SITE_NS] == [0] * pc.WALK_LEN for f in rest)
    assert all(sum(f[i] for f in k1) > 0 for i in (pc.SITE_BOUNCES, pc.SITE_SUPERS,
                                                   pc.SITE_CLUSTERS))
    # Every live lane of a launch runs a bounce at least.
    assert all(f[pc.SITE_BOUNCES] >= f[pc.SITE_LIVE] for f in k1)
    assert "K1's walk by site" in r.timer.report()


@pytest.mark.gpu
@pytest.mark.parametrize("G", [None, 1, 32])
@pytest.mark.parametrize("name", ["tiled 16x16", "showcase"])
def test_cuda_walk_counts_equal_plain(tmp_path, monkeypatch, name, G):
    """On the card: the CUDA K1's walk counts equal the plain version's on
    the main path's first launch (65,536 lanes, one bounce) of the 16 x 16
    tiling and of showcase, at the launch's own G and at G = 1 and 32, all
    four counts (the tiling's 172 supers take the two-level walk, showcase's
    one super the flat walk); the states bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card present")
    from complex_materials_renderer_tpu_torch.render.megarender import first_pass_state

    if name == "showcase":
        obj = os.path.join(REPO, "scenes", "showcase.obj")
    else:
        obj = build_tiled(str(tmp_path), (16, 16))
    scene = load_scene(obj, RenderOptions(obj_path=obj))
    r = Renderer(scene, dataclasses.replace(scene.options, width=512, height=512,
                                            num_samples=16, rng="parity", device="cuda"))
    if name != "showcase":
        assert r.accel.num_supers > 100 and r.accel.num_opaque_supers > 0
    state, _ = first_pass_state(r.camera, (512, 128), 16, "parity", full_resolution=(512, 512))
    assert state.org.shape[0] == 65_536
    media9 = mk.pack_media(r.scene_arrays.media, r.scene_arrays.scale, device=r.device)
    misc = mk.pack_misc(r.lights, r.scene_arrays.world_lo, r.scene_arrays.world_hi,
                        device=r.device)
    opt = r.options
    kw = dict(background=opt.background, max_depth=opt.max_depth, rr_depth=opt.rr_depth,
              nee_max_media=opt.nee_max_media, max_iters=1)
    if G is not None:
        monkeypatch.setattr(mk, "group_size", lambda lanes: G)
    a = mk.MegaState(*(x.clone() for x in state))
    b = mk.MegaState(*(x.clone() for x in state))
    wa = torch.zeros(pc.WALK_LEN, dtype=torch.int64, device=r.device)
    wb = torch.zeros_like(wa)
    mk.trace_paths_mega(r.accel, media9, misc, a, walk=wa, **kw)
    torch.cuda.synchronize()
    mk.trace_paths_mega_plain(r.accel, media9, misc, b, walk=wb, **kw)
    for f in mk.MegaState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert wa.tolist() == wb.tolist()
    assert wa[0] == 65_536 and wa[1] > 0 and wa[2] > 0
    assert (wa[3] > 0) == (name != "showcase")


@pytest.mark.gpu
@pytest.mark.parametrize("G", [None, 1, 32])
def test_cuda_flat_and_two_level_walks_agree(tmp_path, monkeypatch, G):
    """On the card, on the 16 x 16 tiling run to the end (65,536 lanes of
    the main path's first launch): the flat walk and the two-level walk,
    each forced through the rule, give bit-equal states and enter the same
    super and cluster boxes; the flat walk enters no group box, and each
    walk's counts equal the plain version's of that walk."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card present")
    from complex_materials_renderer_tpu_torch.render.megarender import first_pass_state

    obj = build_tiled(str(tmp_path), (16, 16))
    scene = load_scene(obj, RenderOptions(obj_path=obj))
    r = Renderer(scene, dataclasses.replace(scene.options, width=512, height=512,
                                            num_samples=16, rng="parity", device="cuda"))
    assert mk._levels(r.accel, 0)
    state, _ = first_pass_state(r.camera, (512, 128), 16, "parity", full_resolution=(512, 512))
    media9 = mk.pack_media(r.scene_arrays.media, r.scene_arrays.scale, device=r.device)
    misc = mk.pack_misc(r.lights, r.scene_arrays.world_lo, r.scene_arrays.world_hi,
                        device=r.device)
    opt = r.options
    kw = dict(background=opt.background, max_depth=opt.max_depth, rr_depth=opt.rr_depth,
              nee_max_media=opt.nee_max_media)
    if G is not None:
        monkeypatch.setattr(mk, "group_size", lambda lanes: G)
    out = {}
    for levels in (False, True):
        monkeypatch.setattr(mk, "two_level_walk", lambda supers, levels=levels: levels)
        st = mk.MegaState(*(x.clone() for x in state))
        w = torch.zeros(pc.WALK_LEN, dtype=torch.int64, device=r.device)
        mk.trace_paths_mega(r.accel, media9, misc, st, walk=w, **kw)
        torch.cuda.synchronize()
        out[levels] = st, w.tolist()
        if G is None:  # one plain bounce of each walk
            a, b = (mk.MegaState(*(x.clone() for x in state)) for _ in range(2))
            wa, wb = (torch.zeros(pc.WALK_LEN, dtype=torch.int64, device=r.device)
                      for _ in range(2))
            mk.trace_paths_mega(r.accel, media9, misc, a, walk=wa, max_iters=1, **kw)
            mk.trace_paths_mega_plain(r.accel, media9, misc, b, walk=wb, max_iters=1, **kw)
            assert wa.tolist() == wb.tolist() and (wa[3] > 0) == levels
    (flat, wf), (two, wt) = out[False], out[True]
    for f in mk.MegaState._fields:
        assert torch.equal(getattr(flat, f), getattr(two, f)), f
    assert wf[:3] == wt[:3] and wf[3] == 0 and 0 < wt[3] < wt[1] * 4
