"""Kernel-against-plain tests of the PyTorch port that need a CUDA card.

They carry the ``gpu`` marker and skip where no card is present. This
file imports neither JAX nor the test helpers, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py

Tolerance of the megakernel K1 against its plain version on the same
card: rng, depth and alive equal except on at most 1e-3 of the lanes
(flip lanes, where depth or alive differ), the float state within atol
1e-4 and rtol 1e-4 elsewhere (the smoke test's gate; on the card the two
agree to the bit in practice); each CMR_MEGA_DEBUG ablation instance of K1
and its plain version: every output equal. The closest-hit kernel K3 and its plain
version: every output equal (both round every operation once, in the
same order); so are the listing (K4, its one-thread walk and its tile
walk at every G, on a soup and on a tiled showcase of many supers, with
fresh, relisting and sparse relisting t_lo; the one-thread walk the rule
takes on a grid of more than 1,024 supers), the round (K5) and the pair
sweep (K6) and theirs. At every group size G (threads per ray of K1 and K3,
forced through the wrappers' ``group_size``) K1 and K3 equal their plain
versions to the bit, and so do K5 at every (G, S) (``round_split``) and K6
at every G. Renders on the card against the CPU: at most 2 flip pixels,
atol 1e-4 elsewhere; AOVs: the same sky pixels, values within atol 1e-5
(the camera rays of the two devices may differ by an ulp). On the card,
``render_samples_mega`` at the uniform (pixel, sample) pairs equals
``render_beauty_mega`` bit for bit on every mega-family engine, and four
logical shards on the one card render the single image bit for bit in
parity (atol 1e-6 for a sample split in counter); a sharded band over
every visible card (or four logical shards on the one card) replays with
no synchronising operation and no capture, and the sharded Renderer's
second render captures nothing. The mega pass captured
as a CUDA graph (render/megarender.py, the default executor on the card)
equals the eager executor (the same steps driven from the host) bit for
bit, with as many K1 launches (counted on the card); K1 with the pass
control block and the control kernel equal their plain versions. So do
the wavefront, binned and pair engines' calls as CUDA graphs (their loops
and guards conditional nodes) and the eager executor's, with as many K3,
K4, K5 and K6 launches (counted on the card); K5 and K6 with their counts
from the control block equal their plain versions at every rung of their
launch-shape ladders."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.kernels.cluster_test import GROUP_SIZES
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import MediaTable, load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card present")
    return torch.device("cuda")


def _k1_launches():
    """K1's launches: its wrapper's and those of graph replays, which the
    control kernel counts on the card."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    return mk.trace_paths_mega.launches + int(pc.device_counts("cuda")[0])


def _kernel_launches():
    """K3, K4, K5 and K6's launches: their wrappers' and those of graph
    replays, counted on the card (``pass_control.kernel_counts``)."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    card = pc.kernel_counts("cuda").tolist()
    host = (ctr.trace_core.launches, bt.listing.launches, bt.run_round.launches,
            ps.sweep.launches)
    return dict(zip(pc.COUNTED_KERNELS, (a + b for a, b in zip(host, card))))


def _box(c, h):
    x0, x1, y0, y1, z0, z1 = c[0] - h, c[0] + h, c[1] - h, c[1] + h, c[2] - h, c[2] + h
    quads = [
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        ([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),
        ([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),
        ([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
    ]
    return [t for p in quads for t in ([p[0], p[1], p[2]], [p[0], p[2], p[3]])]


def _scene(device, duplicate_shell=False, quads=False, media_mats=None):
    """A floor (opaque) and a medium box, the shape of tests/helpers.py;
    ``media_mats`` partitions the grid into opaque and media supers."""
    floor = [[[-10, 0, 10], [10, 0, 10], [10, 0, -10]], [[-10, 0, 10], [10, 0, -10], [-10, 0, -10]]]
    box = _box([0.0, 1.0, 0.0], 0.8)
    if duplicate_shell:
        box = box + box
    tris = np.asarray(floor + box, np.float32)
    mats = np.asarray([0, 0] + [1] * len(box), np.int32)
    media = MediaTable(
        mat_id=np.array([1], np.int32),
        sigma_s=np.array([[0.08, 0.08, 0.08]], np.float32),
        sigma_a=np.array([[0.02, 0.03, 0.04]], np.float32),
        g=np.array([[0.6, 0.6, 0.6]], np.float32),
        ior=np.array([1.33], np.float32),
    )
    scene = make_scene_arrays(tris, mats, media, 1.0, 1, device=device)
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8, quads=quads,
                                              media_mats=media_mats), device)
    lights = make_lights((2.0, 4.0, 3.0), (0.8, 0.8, 0.6), 100.0, device=device)
    return scene, grid, lights


def _state(n, device, seed, ld=False):
    rs = np.random.default_rng(seed)
    org = np.tile(np.array([[0.0, 1.5, 5.0]], np.float32), (n, 1))
    d = rs.normal(size=(n, 3)) * [0.3, 0.3, 1.0] - [0.0, 0.1, 1.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rng = rs.integers(0, 2**30 if ld else 2**32, n, dtype=np.uint32)
    aux = rs.integers(0, 2**32, n, dtype=np.uint32) if ld else np.zeros(n, np.uint32)
    return mk.from_jax_arrays(org, d, np.ones((n, 3), np.float32), np.zeros((n, 3), np.float32),
                              rng, np.zeros(n, np.int32), np.ones(n, bool), aux, device=device)


def _close(a, b):
    flip = (a.depth != b.depth) | (a.alive != b.alive)
    n = a.depth.shape[0]
    assert int(flip.sum()) <= 1e-3 * n
    keep = ~flip
    assert torch.equal(a.rng[keep], b.rng[keep])
    for f in ("org", "dir", "thr", "rad"):
        x, y = getattr(a, f)[keep], getattr(b, f)[keep]
        assert torch.isfinite(x).all()
        assert torch.all((x - y).abs() <= 1e-4 + 1e-4 * y.abs()), f


CASES = [
    ("parity", dict(nee_max_media=4)),
    ("parity nee 1", dict(nee_max_media=1)),
    ("parity nee 8", dict(nee_max_media=8)),
    ("parity nee 10", dict(nee_max_media=10)),
    ("counter one bounce", dict(nee_max_media=4, max_iters=1, live_blocks=3)),
    ("ld", dict(nee_max_media=4, ld=True, dim0=2)),
    ("tir kill analytic", dict(nee_max_media=4, tir_kill=True, analytic_direct=True)),
    ("shell", dict(nee_max_media=1, shell=True)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, kw):
    kw = dict(kw)
    scene, grid, lights = _scene(cuda, duplicate_shell=kw.pop("shell", False))
    media9 = mk.pack_media(scene.media, scene.scale, device=cuda)
    misc = mk.pack_misc(lights, scene.world_lo, scene.world_hi, device=cuda)
    st = _state(4096, cuda, seed=len(name), ld=kw.get("ld", False))
    a = mk.MegaState(*(x.clone() for x in st))
    b = mk.MegaState(*(x.clone() for x in st))
    before = mk.trace_paths_mega.launches
    mk.trace_paths_mega(grid, media9, misc, a, max_depth=8, rr_depth=4, **kw)
    torch.cuda.synchronize()
    assert mk.trace_paths_mega.launches == before + 1
    mk.trace_paths_mega_plain(grid, media9, misc, b, max_depth=8, rr_depth=4, **kw)
    _close(a, b)
    if "live_blocks" in kw:
        lanes = kw["live_blocks"] * mk.BLOCK
        for f in ("org", "rad", "rng", "depth", "alive"):
            assert torch.equal(getattr(a, f)[lanes:], getattr(st, f)[lanes:])


@pytest.mark.parametrize("case", ["plain grid", "partitioned grid", "analytic"])
@pytest.mark.parametrize("debug", mk.ABLATION_SETS)
def test_ablation_matches_plain(cuda, debug, case):
    """Each CMR_MEGA_DEBUG instance of K1 against its plain version: every
    output equal. Lanes 0-299 and the last 1,024-lane block start dead
    (nophys's block lockstep); on the plain grid, the opaque/media
    partitioned one, and with the analytic direct term and TIR kill."""
    scene, grid, lights = _scene(cuda, media_mats={1} if case == "partitioned grid" else None)
    if case == "partitioned grid":
        assert grid.num_opaque_supers > 0
    media9 = mk.pack_media(scene.media, scene.scale, device=cuda)
    misc = mk.pack_misc(lights, scene.world_lo, scene.world_hi, device=cuda)
    st = _state(4096, cuda, seed=7)
    st.alive[:300] = False
    st.alive[3072:] = False
    kw = dict(max_depth=8, rr_depth=4, nee_max_media=4, debug=debug)
    if case == "analytic":
        kw.update(analytic_direct=True, tir_kill=True)
    a = mk.MegaState(*(x.clone() for x in st))
    b = mk.MegaState(*(x.clone() for x in st))
    before = mk.trace_paths_mega.launches
    mk.trace_paths_mega(grid, media9, misc, a, **kw)
    torch.cuda.synchronize()
    assert mk.trace_paths_mega.launches == before + 1
    mk.trace_paths_mega_plain(grid, media9, misc, b, **kw)
    for f in mk.MegaState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert bool((a.depth > 0).any())


@pytest.fixture
def force_group(monkeypatch):
    """Makes K1 and K3 launch with G threads per ray, whatever their width."""

    def force(g):
        monkeypatch.setattr(mk, "group_size", lambda lanes: g)
        monkeypatch.setattr(ctr, "group_size", lambda lanes: g)

    return force


@pytest.mark.parametrize("nee", [1, 10])
@pytest.mark.parametrize("G", GROUP_SIZES)
def test_kernel_matches_plain_at_group_size(cuda, force_group, G, nee):
    """K1 at every group size on a narrow launch (1,024 lanes, the main
    path's tail width) run to termination: bit-equal to the plain version.
    At --nee-bound 1 the scene's medium box has a duplicate shell, so the
    NEE K-list fills up and drops keys."""
    scene, grid, lights = _scene(cuda, duplicate_shell=nee == 1)
    media9 = mk.pack_media(scene.media, scene.scale, device=cuda)
    misc = mk.pack_misc(lights, scene.world_lo, scene.world_hi, device=cuda)
    st = _state(1024, cuda, seed=G + nee)
    a = mk.MegaState(*(x.clone() for x in st))
    b = mk.MegaState(*(x.clone() for x in st))
    force_group(G)
    mk.trace_paths_mega(grid, media9, misc, a, max_depth=8, rr_depth=4, nee_max_media=nee)
    torch.cuda.synchronize()
    mk.trace_paths_mega_plain(grid, media9, misc, b, max_depth=8, rr_depth=4, nee_max_media=nee)
    for f in mk.MegaState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert bool((a.depth > 1).any())


@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("G", GROUP_SIZES)
def test_cluster_trace_matches_plain_at_group_size(cuda, force_group, G, quads):
    """K3 at every group size on 1,024 rays: every output equal."""
    _, grid, _ = _scene(cuda, quads=quads)
    rs = np.random.default_rng(G)
    n = 1024
    o = np.stack([rs.uniform(-3, 3, n), rs.uniform(0.01, 3, n), rs.uniform(-3, 3, n)], -1)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (o, d))
    t_max = torch.from_numpy(rs.uniform(0.05, 20.0, n).astype(np.float32)).to(cuda)
    active = torch.from_numpy(rs.random(n) < 0.66).to(cuda)
    force_group(G)
    got = ctr.trace_core(o, d, grid, 1e-4, t_max, active)
    torch.cuda.synchronize()
    want = ctr.trace_core_plain(o, d, grid, torch.where(active, t_max, torch.zeros_like(t_max)))
    for name, x, y in zip("t slot u v nx ny nz mat px py pz".split(), got, want):
        assert torch.equal(x, y.to(x.dtype)), name
    assert int((got[1] >= 0).sum()) > 0


def test_wrapper_refuses_bad_inputs(cuda):
    scene, grid, lights = _scene(cuda)
    media9 = mk.pack_media(scene.media, scene.scale, device=cuda)
    misc = mk.pack_misc(lights, scene.world_lo, scene.world_hi, device=cuda)
    st = _state(1024, cuda, seed=1)
    with pytest.raises(ValueError, match="nee-bound"):
        mk.trace_paths_mega(grid, media9, misc, st, nee_max_media=-1)
    with pytest.raises(TypeError):
        mk.trace_paths_mega(grid, media9.double(), misc, st)
    bad = st._replace(org=st.org.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        mk.trace_paths_mega(grid, media9, misc, bad)
    with pytest.raises(ValueError, match="expected"):
        mk.trace_paths_mega(grid, media9.cpu(), misc, st)


def test_renderer_cuda_matches_cpu(cuda):
    obj = os.path.join(REPO, "scenes", "gembox.obj")
    # The megakernel on both devices (``auto`` takes it on the card only).
    kw = dict(width=48, height=32, num_samples=4, shard="none", backend="cluster", engine="mega")
    scene = load_scene(obj, RenderOptions(obj_path=obj, **kw))
    opt = dataclasses.replace(scene.options, **kw)
    before = _k1_launches()
    img_gpu = Renderer(scene, opt, device="cuda").render()
    assert _k1_launches() > before
    img_cpu = Renderer(scene, opt, device="cpu").render()
    diff = np.abs(img_gpu - img_cpu).max(-1)
    assert int((diff > 1e-2).sum()) <= 2
    np.testing.assert_allclose(img_gpu[diff <= 1e-2], img_cpu[diff <= 1e-2], atol=1e-4)


@pytest.mark.parametrize("quads", [False, True])
def test_cluster_trace_matches_plain(cuda, quads):
    _, grid, _ = _scene(cuda, quads=quads)
    rs = np.random.default_rng(5)
    n = 8192
    o = np.stack([rs.uniform(-3, 3, n), rs.uniform(0.01, 3, n), rs.uniform(-3, 3, n)], -1)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (o, d))
    t_max = torch.from_numpy(rs.uniform(0.05, 20.0, n).astype(np.float32)).to(cuda)
    active = torch.from_numpy(rs.random(n) < 0.66).to(cuda)
    before = ctr.trace_core.launches
    got = ctr.trace_core(o, d, grid, 1e-4, t_max, active)
    torch.cuda.synchronize()
    assert ctr.trace_core.launches == before + 1
    eff = torch.where(active, t_max, torch.zeros_like(t_max))
    want = ctr.trace_core_plain(o, d, grid, eff)
    for name, x, y in zip("t slot u v nx ny nz mat px py pz".split(), got, want):
        assert torch.equal(x, y.to(x.dtype)), name
    assert int((got[1] >= 0).sum()) > 0 and bool((got[1][~active] == -1).all())


def test_cluster_trace_refuses_bad_inputs(cuda):
    _, grid, _ = _scene(cuda)
    o = torch.zeros((64, 3), device=cuda)
    d = torch.ones((64, 3), device=cuda)
    with pytest.raises(ValueError, match="t_min"):
        ctr.trace_core(o, d, grid, 1e-3, 1e4)
    with pytest.raises(TypeError, match="expected"):
        ctr.trace_core(o, d.double(), grid, 1e-4, 1e4)
    with pytest.raises(ValueError, match="expected"):
        ctr.trace_core(o, d.cpu(), grid, 1e-4, 1e4)


def _gembox(device, **kw):
    obj = os.path.join(REPO, "scenes", "gembox.obj")
    # The cluster grid on both devices unless a test names the backend
    # (``auto`` takes it on the card only).
    kw = {**dict(width=48, height=32, num_samples=4, shard="none", backend="cluster"), **kw}
    scene = load_scene(obj, RenderOptions(obj_path=obj, **kw))
    return Renderer(scene, dataclasses.replace(scene.options, **kw), device=device)


@pytest.mark.parametrize("backend", ["cluster", "bvh"])
def test_wavefront_cuda_matches_cpu(cuda, backend):
    before = _kernel_launches()["K3"]
    img_gpu = _gembox("cuda", engine="wavefront", backend=backend).render()
    assert (_kernel_launches()["K3"] > before) == (backend == "cluster")
    img_cpu = _gembox("cpu", engine="wavefront", backend=backend).render()
    diff = np.abs(img_gpu - img_cpu).max(-1)
    assert int((diff > 1e-2).sum()) <= 2
    np.testing.assert_allclose(img_gpu[diff <= 1e-2], img_cpu[diff <= 1e-2], atol=1e-4)


@pytest.mark.parametrize("kind", ["depth", "normal", "topology"])
def test_aov_cuda_matches_cpu(cuda, kind):
    img_gpu = _gembox("cuda", aov=kind).render()
    img_cpu = _gembox("cpu", aov=kind).render()
    sky = np.float32([0.0, 0.0, 0.5])
    np.testing.assert_array_equal(np.all(img_gpu == sky, -1), np.all(img_cpu == sky, -1))
    np.testing.assert_allclose(img_gpu, img_cpu, atol=1e-5, rtol=1e-6)


# --- The binned and pair engines' kernels (K4, K5, K6) ---------------------


def _soup(device, n=160, seed=0):
    """Random triangles in [-2.5, 2.5]^3, every third a medium, at cluster
    width 8 in supers of 4 (20 clusters, 5 supers)."""
    rs = np.random.default_rng(seed)
    tris = (rs.uniform(-2.0, 2.0, (n, 1, 3)) + rs.uniform(-0.5, 0.5, (n, 3, 3))).astype(np.float32)
    mats = (np.arange(n) % 3 == 0).astype(np.int32)
    media = MediaTable(
        mat_id=np.array([1], np.int32), sigma_s=np.full((1, 3), 0.3, np.float32),
        sigma_a=np.full((1, 3), 0.1, np.float32), g=np.zeros((1, 3), np.float32),
        ior=np.full((1,), 1.33, np.float32),
    )
    scene = make_scene_arrays(tris, mats, media, 1.0, 1, device=device)
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8, super_factor=4), device)
    return scene, grid


def _trace_inputs(device, n, seed, nee=False):
    """Rays from [-4, 4]^3 aimed at random points of the triangles' region,
    with per-lane bounds and some parked lanes: (rays (6, n), bound (n,))."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-4.0, 4.0, (n, 3))
    d = rs.uniform(-2.5, 2.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bound = rs.uniform(0.5, 8.0, n) if nee else np.full(n, 1e4)
    bound[::13] = 0.0
    rays = torch.from_numpy(np.concatenate([o.T, d.T]).astype(np.float32)).to(device)
    return rays.contiguous(), torch.from_numpy(bound.astype(np.float32)).to(device)


def _binned_setup(device, payload, n=8192, L=4, nee_max_media=2, seed=3):
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct

    scene, grid = _soup(device)
    media9 = mk.pack_media(scene.media, scene.scale, device=device)
    K = ct.nee_list_len(nee_max_media)
    rays, bound = _trace_inputs(device, n, seed, nee=payload == "nee")
    eff = torch.where(bound > 1e-4, bound, torch.zeros_like(bound))
    if payload in ("full", "dist"):
        eff = bt.scene_box_clamp(eff, rays[:3].t(), rays[3:].t(), scene.world_lo, scene.world_hi)
    state = bt.state_bits(ct.payload_state0(payload, eff, K))
    tlo = torch.where(eff > 1e-4, -1, bt.EMPTY).to(torch.int32)
    bnd = ct.payload_bound(payload, bt.state_fields(state, payload, K), K).contiguous()
    keys, _ = bt.listing_plain(grid, rays, bnd, tlo, L)
    return grid, media9, K, rays, bnd, tlo, keys, state


def _tiled_showcase(device, tiles=4, **kw):
    """Showcase's triangles tiled ``tiles`` x ``tiles`` on the ground plane
    at width 32: a grid of hundreds of clusters in tens of supers (at the
    default fan-out; ``kw`` goes to ``build_clusters``)."""
    obj = os.path.join(REPO, "scenes", "showcase.obj")
    scene = load_scene(obj, RenderOptions(obj_path=obj))
    offs = np.asarray([(12.5 * i, 0.0, -9.5 * k) for i in range(tiles) for k in range(tiles)],
                      np.float32)
    tris = (scene.triangles[None] + offs[:, None, None, :]).reshape(-1, 3, 3)
    return device_cluster_grid(
        build_clusters(tris, np.tile(scene.mat_ids, tiles * tiles), cluster_size=32, **kw),
        device)


def _listing_setup(device, scene, n=8192, seed=4):
    """(grid, rays (6, n), bound, fresh t_lo) of a listing: the soup's
    closest-trace inputs, or rays over a tiled showcase from around its
    box, aimed at random points in it (every 13th lane parked): "tiled" 4
    x 4 at the default fan-out, "supers" 6 x 6 at one cluster a super
    (1,551 supers, more than the tile walk's shared memory holds)."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    if scene == "soup":
        grid, _, _, rays, bnd, tlo, _, _ = _binned_setup(device, "full")
        return grid, rays, bnd, tlo
    grid = _tiled_showcase(device) if scene == "tiled" else _tiled_showcase(device, 6,
                                                                           super_factor=1)
    rs = np.random.default_rng(seed)
    b = grid.bounds.cpu().numpy()
    real = b[:, 0] < 1e29
    lo, hi = b[real, 0:3].min(0), b[real, 3:6].max(0)
    o = lo + (hi - lo) * rs.uniform(-0.1, 1.1, (n, 3))
    o[:, 1] = rs.uniform(0.5, 8.0, n)
    d = lo + (hi - lo) * rs.uniform(0.0, 1.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.concatenate([o.T, d.T]).astype(np.float32)).to(device)
    bound = np.full(n, 1e3, np.float32)
    bound[::13] = 0.0
    bound = torch.from_numpy(bound).to(device)
    tlo = torch.where(bound > 1e-4, -1, bt.EMPTY).to(torch.int32)
    return grid, rays.contiguous(), bound, tlo


# Each K4 instance as ``listing_split`` gives it: the one-thread walk, the
# tile walk at every G (LIST_CTA / G lanes a CTA), and None: the rule.
LISTING_SPLITS = [(0, 128, 0)] + [(1, 256 // g, g) for g in GROUP_SIZES] + [None]


@pytest.mark.parametrize("split", LISTING_SPLITS, ids=lambda s: "rule" if s is None else
                         f"v{s[0]}-G{s[2]}")
@pytest.mark.parametrize("scene", ["soup", "tiled"])
@pytest.mark.parametrize("L", [2, 8, 12])
def test_listing_matches_plain(cuda, monkeypatch, L, scene, split):
    """K4 at each instance, on fresh, relisting and sparse relisting t_lo
    (under 2% of the lanes list): keys and tlim equal on every lane."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    if split is not None:
        monkeypatch.setattr(bt, "listing_split", lambda n, supers: split)
    grid, rays, bnd, fresh = _listing_setup(cuda, scene)
    relist = bt.listing_plain(grid, rays, bnd, fresh, 2)[0][1].contiguous()
    lane = torch.arange(fresh.shape[0], device=cuda)
    sparse = torch.where(lane % 64 == 5, relist, bt.EMPTY).to(torch.int32).contiguous()
    for name, tlo in (("fresh", fresh), ("relisting", relist), ("sparse", sparse)):
        listing = int((tlo != bt.EMPTY).sum())
        before = bt.listing.launches
        keys, tlim = bt.listing(grid, rays, bnd, tlo, L)
        torch.cuda.synchronize()
        assert bt.listing.launches == before + 1
        want_keys, want_tlim = bt.listing_plain(grid, rays, bnd, tlo, L)
        assert torch.equal(keys, want_keys) and torch.equal(tlim, want_tlim), name
        listed = int((keys[0] != bt.EMPTY).sum())
        if scene == "soup" and name != "sparse":
            assert listed > (1000 if name == "relisting" else 4000), name
        else:
            assert listed > listing // 4, name
        if name == "sparse":
            assert 0 < listing < 0.02 * fresh.shape[0]
        else:
            assert listing > (1000 if name == "relisting" else 4000), name
    if scene == "tiled":
        assert grid.num_supers >= 16


@pytest.mark.parametrize("L", [2, 8])
def test_listing_many_supers_matches_plain(cuda, L):
    """K4 on a grid of more supers than the tile walk holds: the rule
    launches the one-thread walk, equal to the plain version on every lane
    with fresh and relisting t_lo; the tile walk forced there is refused."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    grid, rays, bnd, fresh = _listing_setup(cuda, "supers")
    assert grid.num_supers > bt.MAX_SUPERS
    assert bt.listing_split(rays.shape[1], grid.num_supers)[0] == 0
    relist = bt.listing_plain(grid, rays, bnd, fresh, 2)[0][1].contiguous()
    for name, tlo in (("fresh", fresh), ("relisting", relist)):
        before = bt.listing.launches
        keys, tlim = bt.listing(grid, rays, bnd, tlo, L)
        torch.cuda.synchronize()
        assert bt.listing.launches == before + 1
        want_keys, want_tlim = bt.listing_plain(grid, rays, bnd, tlo, L)
        assert torch.equal(keys, want_keys) and torch.equal(tlim, want_tlim), name
        assert int((keys[0] != bt.EMPTY).sum()) > int((tlo != bt.EMPTY).sum()) // 4, name
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bt, "listing_split", lambda n, supers: (1, 64, 0))
        with pytest.raises(RuntimeError, match="listing kernel launch failed"):
            bt.listing(grid, rays, bnd, fresh, L)


def _round_check(cuda, payload):
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    grid, media9, K, rays, _, _, keys, state = _binned_setup(cuda, payload)
    live, keys, rays, state = bt.regroup(keys, rays, state)
    blocks = -(-int(live) // bt.BLOCK)
    assert blocks >= 2
    for lb, cap in ((blocks, 12), (blocks - 1, 2)):
        want = bt.round_plain(grid, media9, lb, rays, keys, state, payload, K, cap)
        before = bt.run_round.launches
        got = bt.run_round(grid, media9, lb, rays, keys.clone(), state.clone(), payload, K, cap)
        torch.cuda.synchronize()
        assert bt.run_round.launches == before + 1
        for name, x, y in zip(("keys", "state", "iters"), got, want):
            assert torch.equal(x, y), (name, lb, cap)
        assert int(got[2].max()) > 1 and not torch.equal(got[1], state)


@pytest.mark.parametrize("payload", ["full", "dist", "occl", "nee"])
def test_round_matches_plain(cuda, payload):
    _round_check(cuda, payload)


@pytest.mark.parametrize("payload", ["full", "dist", "occl", "nee"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_round_matches_plain_at_split(cuda, monkeypatch, G, payload):
    """K5 with G threads per lane in clusters of 2G CTAs, whatever the
    live width."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    monkeypatch.setattr(bt, "round_split", lambda lb: (G, bt.BLOCK * G // bt.ROUND_CTA))
    _round_check(cuda, payload)


def _sweep_check(cuda, payload, shuffle=False):
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    # A fresh lane's seed is its bound: its t (closest payloads) or t_opq.
    grid, media9, K, rays, bnd, _, keys, _ = _binned_setup(cuda, payload)
    pair_rays, cid, _ = ps.expand_pairs(keys, rays, bnd, chunk_blocks=2)
    if shuffle:  # each block's pairs in a random order: the kernel does not rely on it
        g = torch.Generator().manual_seed(5)
        perm = torch.cat([b * bt.BLOCK + torch.randperm(bt.BLOCK, generator=g)
                          for b in range(cid.shape[0] // bt.BLOCK)]).to(cuda)
        pair_rays, cid = pair_rays[:, perm].contiguous(), cid[perm].contiguous()
    before = ps.sweep.launches
    got = ps.sweep(grid, media9, pair_rays, cid, payload, K, int((cid < bt.BIGC).sum()))
    torch.cuda.synchronize()
    assert ps.sweep.launches == before + 1
    assert torch.equal(got, ps.sweep_plain(grid, media9, pair_rays, cid, payload, K))


@pytest.mark.parametrize("payload", ["dist", "occl", "nee"])
def test_sweep_matches_plain(cuda, payload):
    _sweep_check(cuda, payload)


@pytest.mark.parametrize("payload", ["dist", "occl", "nee"])
@pytest.mark.parametrize("G", GROUP_SIZES)
def test_sweep_matches_plain_at_group_size(cuda, monkeypatch, G, payload):
    """K6 with G threads per pair, on the listed pairs and on the same
    pairs shuffled within their blocks."""
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    monkeypatch.setattr(ps, "group_size", lambda pairs: G)
    _sweep_check(cuda, payload)
    _sweep_check(cuda, payload, shuffle=True)


def test_binned_kernels_refuse_bad_inputs(cuda):
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    grid, media9, K, rays, bnd, tlo, keys, state = _binned_setup(cuda, "dist", n=2048)
    with pytest.raises(TypeError, match="expected"):
        bt.listing(grid, rays, bnd.double(), tlo, 4)
    with pytest.raises(ValueError, match="expected"):
        bt.listing(grid, rays, bnd, tlo.cpu(), 4)
    with pytest.raises(ValueError, match="whole blocks"):
        bt.run_round(grid, media9, 2, rays[:, :1000], keys[:, :1000], state[:, :1000], "dist",
                     K, 4)
    with pytest.raises(ValueError, match="expected"):
        bt.run_round(grid, media9, 2, rays, keys.cpu(), state, "dist", K, 4)
    with pytest.raises(ValueError, match="live blocks"):
        bt.run_round(grid, media9, torch.tensor([2], dtype=torch.int32, device=cuda), rays, keys,
                     state, "dist", K, 4)
    cid = torch.full((2048,), bt.BIGC, dtype=torch.int32, device=cuda)
    seeds = torch.cat([rays, bnd[None]]).contiguous()
    with pytest.raises(TypeError, match="expected"):
        ps.sweep(grid, media9, seeds, cid.long(), "dist", K)


def _gembox_engine(device, engine):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _gembox(device, engine=engine).render()


@pytest.mark.parametrize("engine", ["binned", "pair"])
def test_engine_cuda_matches_cpu(cuda, engine):
    order = ("K4", "K5", "K6", "K3")
    before = [_kernel_launches()[k] for k in order]
    img_gpu = _gembox_engine("cuda", engine)
    after = [_kernel_launches()[k] for k in order]
    launched = [a > b for a, b in zip(after, before)]
    assert launched == ([True, True, False, False] if engine == "binned"
                        else [True, False, True, True])
    img_cpu = _gembox_engine("cpu", engine)
    diff = np.abs(img_gpu - img_cpu).max(-1)
    assert int((diff > 1e-2).sum()) <= 2
    np.testing.assert_allclose(img_gpu[diff <= 1e-2], img_cpu[diff <= 1e-2], atol=1e-4)


# --- Adaptive sampling and sharding on the card -----------------------------


@pytest.mark.parametrize("engine", ["mega", "binned", "pair"])
@pytest.mark.parametrize("rng", ["counter", "ld"])
def test_render_samples_cuda_matches_uniform(cuda, engine, rng):
    """render_samples_mega at exactly the uniform (pixel, sample) pairs,
    averaged per pixel, equals render_beauty_mega on the card bit for bit."""
    import warnings

    from complex_materials_renderer_tpu_torch.render import megarender as mr

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = _gembox("cuda", engine=engine, rng=rng)
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(rng_mode=rng, trace_engine=engine, max_depth=8, rr_depth=4)
    img = mr.render_beauty_mega(*objs, (32, 16), 2, **kw).cpu().numpy()
    ys, xs = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    pix = np.repeat(np.stack([xs.reshape(-1), ys.reshape(-1)], -1), 2, axis=0)
    sidx = np.tile(np.arange(2), 32 * 16)
    rad = mr.render_samples_mega(*objs, torch.from_numpy(pix), torch.from_numpy(sidx),
                                 torch.ones(len(sidx), dtype=torch.bool), (32, 16), **kw)
    assert rad.device.type == "cuda"
    per_px = rad.cpu().numpy().reshape(-1, 2, 3).mean(1).reshape(16, 32, 3)
    np.testing.assert_array_equal(per_px, img)


@pytest.mark.parametrize("engine", ["mega", "binned"])
def test_sharded_cuda_tile_split_matches_single(cuda, engine):
    """Four logical shards on the one card render the single image bit for
    bit in parity (a tile split) and within atol 1e-6 in counter (2 x 2)."""
    from complex_materials_renderer_tpu_torch.parallel.sharding import (
        make_render_mesh,
        render_beauty_sharded,
    )
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    r = _gembox("cuda")
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(max_depth=8, rr_depth=4)
    mesh = make_render_mesh([cuda] * 4)
    ref = mr.render_beauty_mega(*objs, (48, 32), 2, trace_engine=engine, **kw)
    img = render_beauty_sharded(*objs, (48, 32), 2, mesh=mesh, engine=engine, **kw)
    np.testing.assert_array_equal(img.cpu().numpy(), ref.cpu().numpy())
    ref = mr.render_beauty_mega(*objs, (48, 32), 4, rng_mode="counter", trace_engine=engine, **kw)
    img = render_beauty_sharded(*objs, (48, 32), 4, rng_mode="counter", engine=engine, **kw,
                                mesh=make_render_mesh([cuda] * 4, sample_parallel=2))
    np.testing.assert_allclose(img.cpu().numpy(), ref.cpu().numpy(), atol=1e-6)


# --- The sharded render as one program over the cards -------------------------


def _band_devices(cuda):
    """Every visible card, or four logical shards on the one card there is."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else [cuda] * 4


def test_sharded_band_makes_no_sync_and_no_capture(cuda):
    """A sharded band over every visible card (four logical shards on the
    one card where there is one), called again after a first call: no
    synchronising operation under sync-debug 'error' from the first card's
    first launch to the combined image, no graph captured on any card, the
    first call's image."""
    from complex_materials_renderer_tpu_torch.parallel.sharding import (
        make_render_mesh,
        render_beauty_sharded,
    )
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    r = _gembox("cuda")
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    mesh = make_render_mesh(_band_devices(cuda))

    def band():
        return render_beauty_sharded(*objs, (48, 32), 2, mesh=mesh, engine="mega", max_depth=8,
                                     rr_depth=4)

    want = band().cpu()
    n_captures = len(mr.captures)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = band()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(mr.captures) == n_captures
    assert torch.equal(img.cpu(), want)


@pytest.mark.parametrize("rng", ["parity", "counter"])
def test_sharded_renderer_replays_and_matches_single(cuda, monkeypatch, rng):
    """The Renderer's sharded band loop over every visible card (four
    logical shards on the one card where there is one) equals ``--shard
    none`` bit for bit in parity (atol 1e-6 in counter), and its second
    render captures no graph on any card and gives the same image."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    single = _gembox("cuda", rng=rng).render()
    monkeypatch.setattr(Renderer, "_shard_devices", lambda self: _band_devices(cuda))
    r = _gembox("cuda", rng=rng, shard="auto")
    first = r.render()
    n_captures = len(mr.captures)
    second = r.render()
    assert len(mr.captures) == n_captures
    np.testing.assert_array_equal(first, second)
    if rng == "parity":
        np.testing.assert_array_equal(first, single)
    else:
        np.testing.assert_allclose(first, single, atol=1e-6)


# --- The mega pass as one device program -------------------------------------


def _counted(fn):
    """(result, K1 launches) of ``fn()``."""
    before = _k1_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _k1_launches() - before


@pytest.mark.parametrize("mode,schedule", [("off", ""), ("off", "1:1,8:1,32:2"), ("all", ""),
                                           ("hybrid", "")])
@pytest.mark.parametrize("rng", ["parity", "counter", "ld"])
def test_graph_matches_eager(cuda, rng, mode, schedule):
    """The graph executor against the eager executor: image and RNG words
    bit-equal, and the K1 launches that the replay ran (counted on the
    card) equal to the eager executor's."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    r = _gembox("cuda", rng=rng)
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(rng_mode=rng, schedule_mode=mode, schedule=schedule, max_depth=8, rr_depth=4,
              full_resolution=(48, 32), return_rng=True)
    (want, n_eager) = _counted(lambda: mr.render_beauty_mega(*objs, (48, 32), 4,
                                                             executor="eager", **kw))
    mr.render_beauty_mega(*objs, (48, 32), 4, **kw)  # captures
    (got, n_graph) = _counted(lambda: mr.render_beauty_mega(*objs, (48, 32), 4, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert n_graph == n_eager > 0


def test_graph_replays_with_new_inputs(cuda):
    """One graph serves every call of a shape: two replays with other rows,
    sample offsets and RNG words equal the eager executor's calls; the
    adaptive and per-pixel entry points likewise."""
    from complex_materials_renderer_tpu_torch.ops import rng as rng_ops
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    r = _gembox("cuda")
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(max_depth=8, rr_depth=4, full_resolution=(48, 64), return_rng=True)
    n_captures = len(mr.captures)
    for row0, offset in ((0, 0), (16, 3), (32, 8)):
        for rng in ("parity", "counter"):
            words = rng_ops.seed_from_pixel(torch.arange(48 * 16, device=cuda) * 7 + row0)
            args = (*objs, (48, 16), 2)
            call = dict(kw, rng_mode=rng, row_offset=row0, sample_offset=offset,
                        rng_state=words)
            want = mr.render_beauty_mega(*args, executor="eager", **call)
            got = mr.render_beauty_mega(*args, **call)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(mr.captures) - n_captures == 2  # one graph a mode
    pix = torch.tensor([[3, 4], [40, 60], [47, 0]], device=cuda)
    kwp = dict(max_depth=8, rr_depth=4, return_rng=True)
    for seed in (0, 5):
        want = mr.render_pixels_mega(*objs, pix + seed, 3, (48, 64), executor="eager", **kwp)
        got = mr.render_pixels_mega(*objs, pix + seed, 3, (48, 64), **kwp)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        sidx = torch.tensor([0, 1, 9], device=cuda) + seed
        valid = torch.tensor([True, seed > 0, True], device=cuda)
        kws = dict(max_depth=8, rr_depth=4)
        want = mr.render_samples_mega(*objs, pix, sidx, valid, (48, 64), executor="eager", **kws)
        got = mr.render_samples_mega(*objs, pix, sidx, valid, (48, 64), **kws)
        assert torch.equal(got, want)


def test_graph_call_makes_no_sync(cuda):
    """A replayed call raises nothing under sync-debug 'error': no value
    goes to the host between its first launch and its last."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    r = _gembox("cuda")
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    for rng in ("parity", "ld"):
        kw = dict(rng_mode=rng, max_depth=8, rr_depth=4, full_resolution=(48, 32),
                  sample_offset=2, return_rng=True)
        mr.render_beauty_mega(*objs, (48, 32), 2, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            img, _ = mr.render_beauty_mega(*objs, (48, 32), 2, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(img).all()


@pytest.mark.parametrize("live,dim0,run", [(1, 2, 1), (2, 5000, 1), (2, 0, 0)])
def test_kernel_with_control_block_matches_plain(cuda, live, dim0, run):
    """K1 with the pass control block equals its plain version with the
    same block (ld, one bounce), and leaves the lanes beyond its live
    blocks as they were."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    scene, grid, lights = _scene(cuda)
    media9 = mk.pack_media(scene.media, scene.scale, device=cuda)
    misc = mk.pack_misc(lights, scene.world_lo, scene.world_hi, device=cuda)
    st = _state(2048 + 512, cuda, 5, ld=True)
    ctrl = pc.new_ctrl(cuda)
    ctrl[:3] = torch.tensor([live, dim0, run], dtype=torch.int32)
    kw = dict(max_depth=8, rr_depth=4, nee_max_media=4, max_iters=1, ld=True, ctrl=ctrl)
    got = mk.trace_paths_mega(grid, media9, misc, mk.MegaState(*(x.clone() for x in st)), **kw)
    want = mk.trace_paths_mega_plain(grid, media9, misc,
                                     mk.MegaState(*(x.clone() for x in st)), **kw)
    kept = live * 1024 if run else 0
    for a, b, x in zip(got, want, st):
        assert torch.equal(a, b)
        assert torch.equal(a[kept:], x[kept:])


@pytest.mark.parametrize("n", [65536, 49920, 3072, 65541])
def test_control_kernel_matches_plain(cuda, n):
    """The control kernel equals its plain version on the card (the alive
    count read 16 bytes at a time, and the tail byte by byte), also where
    it counts at a site (SITE_COUNT: visits, K1 launches, live and covered
    lanes; the card's clock, the last stamp and the sites' ns, aside)."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    gen = torch.Generator(device="cuda").manual_seed(n)
    alive = torch.rand(n, device=cuda, generator=gen) < 0.4
    clock = torch.zeros(pc.CNT_LEN, dtype=torch.bool, device=cuda)
    clock[pc.CNT_LAST] = True
    clock[pc.CNT_SITES + pc.SITE_NS::pc.SITE_FIELDS] = True
    for flags, kw in ((pc.INIT | pc.COND | pc.DEVICE_COUNT, dict(dim0=2, threshold=1024)),
                      (pc.AFTER_K1 | pc.SET_LIVE | pc.COND | pc.DEVICE_COUNT,
                       dict(advance=8, threshold=0)),
                      (pc.SET_FULL | pc.AFTER_K1, dict(advance=256))):
        for site in (0, 0), (pc.SITE_COUNT, 7):
            f = flags | site[0]
            ctrl = torch.tensor([3, 10, 1, 777, 0, 0, 0, 0], dtype=torch.int32, device=cuda)
            counts = torch.zeros(pc.CNT_LEN, dtype=torch.int64, device=cuda)
            ctrl_p, counts_p = ctrl.clone(), counts.clone()
            for _ in range(2):
                pc.pass_control(alive, ctrl, counts, f, site=site[1], **kw)
                pc.pass_control_plain(alive, ctrl_p, counts_p, f, site=site[1], **kw)
            assert torch.equal(ctrl, ctrl_p), f
            assert torch.equal(counts.masked_fill(clock, 0), counts_p.masked_fill(clock, 0)), f
            assert bool(counts[pc.CNT_SITES + 7 * pc.SITE_FIELDS]) == bool(site[0])


def test_many_graphs_capture(cuda):
    """More captures than torch's stream pool holds streams (32 a device):
    the conditional bodies are captured on a stream of the port's own, so
    no capture finds its own stream handed out for a body."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    r = _gembox("cuda")
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(max_depth=8, rr_depth=4, full_resolution=(48, 64), schedule="1:1,8:1,32:2")
    n_captures = len(mr.captures)
    for rows in range(1, 41):
        got = mr.render_beauty_mega(*objs, (48, rows), 1, **kw)
    assert len(mr.captures) - n_captures == 40
    assert torch.equal(got, mr.render_beauty_mega(*objs, (48, 40), 1, executor="eager", **kw))


# --- The wavefront, binned and pair engines as device programs -----------------


def _engine_call(r, engine, executor, **kw):
    """One tile call of ``engine`` over the Renderer ``r``'s tables."""
    from complex_materials_renderer_tpu_torch.render import integrator as it
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    call = dict(max_depth=8, rr_depth=4, full_resolution=(48, 32), return_rng=True,
                executor=executor, **kw)
    args = (r.camera, r.scene_arrays, r.accel, r.lights, (48, 32), 2)
    if engine == "wavefront":
        return it.render_beauty(*args, **call)
    return mr.render_beauty_mega(*args, trace_engine=engine, **call)


def _counted_all(fn):
    """(result, K1 and K3-K6 launches) of ``fn()``."""
    before = dict(_kernel_launches(), K1=_k1_launches())
    out = fn()
    torch.cuda.synchronize()
    after = dict(_kernel_launches(), K1=_k1_launches())
    return out, {k: after[k] - before[k] for k in after}


ENGINE_CASES = [("wavefront", "cluster", {}), ("wavefront", "bvh", {}),
                ("binned", "cluster", {}), ("binned", "cluster", dict(schedule_mode="all")),
                ("pair", "cluster", {}), ("pair", "cluster", dict(schedule_mode="all"))]


@pytest.mark.parametrize("rng", ["parity", "counter", "ld"])
@pytest.mark.parametrize("engine,backend,kw", ENGINE_CASES,
                         ids=[f"{e}-{b}-{kw.get('schedule_mode', 'auto')}"
                              for e, b, kw in ENGINE_CASES])
def test_engine_graph_matches_eager(cuda, engine, backend, kw, rng):
    """Each engine's call as a CUDA graph (the default on the card) against
    the eager executor (host reads, host ints to K5 and K6): image and RNG
    words bit-equal, and every kernel's launches that the replay ran
    (counted on the card) equal to the eager executor's."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = _gembox("cuda", engine=engine, backend=backend)
    want, n_eager = _counted_all(lambda: _engine_call(r, engine, "eager", rng_mode=rng, **kw))
    _engine_call(r, engine, "auto", rng_mode=rng, **kw)  # captures
    got, n_graph = _counted_all(lambda: _engine_call(r, engine, "auto", rng_mode=rng, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert n_graph == n_eager
    used = {"wavefront": ["K3"] if backend == "cluster" else [], "binned": ["K4", "K5"],
            "pair": ["K3", "K4", "K6"]}[engine]
    assert all(n_graph[k] > 0 for k in used) and n_graph["K1"] == 0


@pytest.mark.parametrize("engine,backend", [("wavefront", "cluster"), ("wavefront", "bvh"),
                                            ("binned", "cluster"), ("pair", "cluster")])
def test_engine_graph_call_makes_no_sync(cuda, engine, backend):
    """A replayed call of each engine raises nothing under sync-debug
    'error': no value goes to the host between its first launch and its
    last."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = _gembox("cuda", engine=engine, backend=backend)
    want, _ = _engine_call(r, engine, "auto", rng_mode="ld", sample_offset=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, _ = _engine_call(r, engine, "auto", rng_mode="ld", sample_offset=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(img, want) and torch.isfinite(img).all()


@pytest.mark.parametrize("payload", ["full", "nee"])
def test_round_with_control_block_matches_plain(cuda, payload):
    """K5 taking its live blocks from the control block, at every rung of
    its (G, S) ladder with the live blocks at the rung's most (at most the
    round's own), equals the plain round at those live blocks; 0 live
    blocks serve nothing."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    grid, media9, K, rays, _, _, keys, state = _binned_setup(cuda, payload)
    live, keys, rays, state = bt.regroup(keys, rays, state)
    blocks = -(-int(live) // bt.BLOCK)
    n_blocks = keys.shape[1] // bt.BLOCK
    ran = 0
    for a, b, G in bt.round_ladder(n_blocks):
        lb = min(b, blocks)
        if lb < a:
            continue
        want = bt.round_plain(grid, media9, lb, rays, keys, state, payload, K, 12)
        ctrl = pc.new_ctrl(cuda)
        ctrl[pc.CTRL_LIVE] = lb
        got = bt.run_round(grid, media9, None, rays, keys.clone(), state.clone(), payload, K,
                           12, ctrl=ctrl, group=G)
        torch.cuda.synchronize()
        for name, x, y in zip(("keys", "state", "iters"), got, want):
            assert torch.equal(x, y), (name, G, lb)
        ran += 1
    assert ran >= 1
    k0, s0 = keys.clone(), state.clone()
    got = bt.run_round(grid, media9, None, rays, k0, s0, payload, K, 12, ctrl=pc.new_ctrl(cuda),
                       group=bt.round_ladder(n_blocks)[0][2])
    torch.cuda.synchronize()
    assert torch.equal(k0, keys) and torch.equal(s0, state) and int(got[2].sum()) == 0


@pytest.mark.parametrize("payload", ["dist", "occl", "nee"])
def test_sweep_with_control_block_matches_plain(cuda, payload):
    """K6 taking its pair count from the control block, at every rung of
    its G ladder (the count set to the sweep's own at its rung, else to the
    rung's most: the output does not depend on the split), equals the
    plain sweep; 0 pairs keep every pair's seed state."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    grid, media9, K, rays, bnd, _, keys, _ = _binned_setup(cuda, payload)
    pair_rays, cid, _ = ps.expand_pairs(keys, rays, bnd, chunk_blocks=2)
    pairs = int((cid < bt.BIGC).sum())
    want = ps.sweep_plain(grid, media9, pair_rays, cid, payload, K)
    P = cid.shape[0]
    for a, b, G in ps.sweep_ladder(P):
        ctrl = pc.new_ctrl(cuda)
        ctrl[pc.CTRL_NALIVE] = pairs if a <= pairs <= b else min(b, P)
        got = ps.sweep(grid, media9, pair_rays, cid, payload, K, ctrl=ctrl, group=G)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (G, int(ctrl[pc.CTRL_NALIVE]))
    before = ps.sweep.launches
    got = ps.sweep(grid, media9, pair_rays, cid, payload, K, 0)
    assert ps.sweep.launches == before
    assert torch.equal(got, ps.seed_state_bits(pair_rays, payload, K))


@pytest.mark.parametrize("n", [65536, 3072, 65541])
def test_control_kernel_extensions_match_plain(cuda, n):
    """The control kernel's iteration counter, cap, grace, rungs on the
    count and on the extent equal their plain versions on the card."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    gen = torch.Generator(device="cuda").manual_seed(n)
    alive = torch.rand(n, device=cuda, generator=gen) < 0.01
    cases = ((pc.COND | pc.ITER_RESET | pc.ITER_CAP, dict(cap=3)),
             (pc.COND | pc.ITER_STEP | pc.ITER_GRACE, dict(cap=1, threshold=n // 4)),
             (pc.RUNGS | pc.SET_LIVE, dict(edges=[1, 100, 700, n + 1])),
             (pc.RUNGS | pc.EXTENT, dict(edges=[0, n // 64 + 1, n // 8 + 1, n + 1])),
             (pc.AFTER_K1 | pc.NOT_K1 | pc.DEVICE_COUNT, dict(advance=8)))
    for flags, kw in cases:
        ctrl = torch.tensor([3, 10, 1, 0, 0, 2, 0, 0], dtype=torch.int32, device=cuda)
        counts = torch.zeros(pc.CNT_LEN, dtype=torch.int64, device=cuda)
        ctrl_p, counts_p = ctrl.clone(), counts.clone()
        pc.pass_control(alive, ctrl, counts, flags, **kw)
        pc.pass_control_plain(alive, ctrl_p, counts_p, flags, **kw)
        assert torch.equal(ctrl, ctrl_p) and torch.equal(counts, counts_p), flags
