"""Kernel-against-plain tests of the PyTorch port that need a CUDA card.

They carry the ``gpu`` marker and skip where no card is present. This
file imports neither JAX nor the test helpers, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py

Tolerance of the megakernel K1 against its plain version on the same
card: rng, depth and alive equal except on at most 1e-3 of the lanes
(flip lanes, where depth or alive differ), the float state within atol
1e-4 and rtol 1e-4 elsewhere (the smoke test's gate; on the card the two
agree to the bit in practice). The closest-hit kernel K3 and its plain
version: every output equal (both round every operation once, in the
same order); so are the listing (K4), the round (K5) and the pair sweep
(K6) and theirs. At every group size G (threads per ray of K1 and K3,
forced through the wrappers' ``group_size``) K1 and K3 equal their plain
versions to the bit, and so do K5 at every (G, S) (``round_split``) and K6
at every G. Renders on the card against the CPU: at most 2 flip pixels,
atol 1e-4 elsewhere; AOVs: the same sky pixels, values within atol 1e-5
(the camera rays of the two devices may differ by an ulp)."""

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


def _scene(device, duplicate_shell=False, quads=False):
    """A floor (opaque) and a medium box, the shape of tests/helpers.py."""
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
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8, quads=quads), device)
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
    kw = dict(width=48, height=32, num_samples=4, shard="none")
    scene = load_scene(obj, RenderOptions(obj_path=obj, **kw))
    opt = dataclasses.replace(scene.options, **kw)
    before = mk.trace_paths_mega.launches
    img_gpu = Renderer(scene, opt, device="cuda").render()
    assert mk.trace_paths_mega.launches > before
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
    kw = dict(width=48, height=32, num_samples=4, shard="none", **kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **kw))
    return Renderer(scene, dataclasses.replace(scene.options, **kw), device=device)


@pytest.mark.parametrize("backend", ["cluster", "bvh"])
def test_wavefront_cuda_matches_cpu(cuda, backend):
    before = ctr.trace_core.launches
    img_gpu = _gembox("cuda", engine="wavefront", backend=backend).render()
    assert (ctr.trace_core.launches > before) == (backend == "cluster")
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


@pytest.mark.parametrize("L", [2, 8, 12])
def test_listing_matches_plain(cuda, L):
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    grid, _, _, rays, bnd, tlo, _, _ = _binned_setup(cuda, "full")
    for relist in (False, True):
        if relist:
            tlo = bt.listing_plain(grid, rays, bnd, tlo, 2)[0][1].contiguous()
        before = bt.listing.launches
        keys, tlim = bt.listing(grid, rays, bnd, tlo, L)
        torch.cuda.synchronize()
        assert bt.listing.launches == before + 1
        want_keys, want_tlim = bt.listing_plain(grid, rays, bnd, tlo, L)
        assert torch.equal(keys, want_keys) and torch.equal(tlim, want_tlim)
        assert int((keys[0] != bt.EMPTY).sum()) > (1000 if relist else 4000)


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
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    before = (bt.listing.launches, bt.run_round.launches, ps.sweep.launches,
              ctr.trace_core.launches)
    img_gpu = _gembox_engine("cuda", engine)
    after = (bt.listing.launches, bt.run_round.launches, ps.sweep.launches,
             ctr.trace_core.launches)
    launched = [a > b for a, b in zip(after, before)]
    assert launched == ([True, True, False, False] if engine == "binned"
                        else [True, False, True, True])
    img_cpu = _gembox_engine("cpu", engine)
    diff = np.abs(img_gpu - img_cpu).max(-1)
    assert int((diff > 1e-2).sum()) <= 2
    np.testing.assert_allclose(img_gpu[diff <= 1e-2], img_cpu[diff <= 1e-2], atol=1e-4)
