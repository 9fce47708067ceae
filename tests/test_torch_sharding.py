"""The port's tile and sample sharding (parallel/sharding.py) and its
multi-process path (parallel/multihost.py) on the CPU, mirroring
tests/test_sharding.py: a mesh of 8 logical shards on the one CPU (each
appearance of a device is a shard; the JAX suite runs 8 virtual CPU
devices) against the port's single-device renders, bit for bit for tile
splits and within atol 1e-6 for sample splits (only the mean's sums move);
the sharded wavefront against the JAX package's on its 8 devices; the
Renderer's sharded band loop; the reference's two quirks (ROADMAP R5:
pair renders through the wavefront loop under sharding; R6: ``tir`` is
not passed to the shards); and a real two-process gloo job."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.parallel.sharding import make_render_mesh as jax_mesh
from complex_materials_renderer_tpu.parallel.sharding import (
    render_beauty_sharded as jax_render_beauty_sharded,
)
from complex_materials_renderer_tpu_torch import renderer as trenderer
from complex_materials_renderer_tpu_torch.accel import build_bvh, build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.kernels.traverse import device_bvh
from complex_materials_renderer_tpu_torch.parallel import multihost, sharding
from complex_materials_renderer_tpu_torch.parallel.sharding import (
    make_render_mesh,
    render_beauty_sharded,
)
from complex_materials_renderer_tpu_torch.render.integrator import render_beauty
from complex_materials_renderer_tpu_torch.render.megarender import render_beauty_mega
from complex_materials_renderer_tpu_torch.render.hitinfo import make_scene_arrays
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene.scene import Scene
from complex_materials_renderer_tpu_torch.scene.medium import MediaTable

from helpers import fixture_camera, fixture_lights, make_test_scene
from test_torch_support import check_image, port_camera, port_lights, scene_accels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8
MEGA_KW = dict(max_depth=4, rr_depth=2, nee_max_media=1)


@pytest.fixture(scope="module")
def setup():
    """(scene, BVH, camera, lights) of the helpers scene on the CPU."""
    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, MediaTable(*media), 1.0, 1, device="cpu")
    bvh = device_bvh(build_bvh(tris, leaf_size=4), tris, 4, "cpu")
    return scene, bvh, port_camera(), port_lights()


@pytest.fixture(scope="module")
def grid():
    tris, mats, _ = make_test_scene()
    return device_cluster_grid(build_clusters(tris, mats, cluster_size=8), "cpu")


def test_eight_logical_shards_and_absent_devices():
    mesh = make_render_mesh(CPU8)
    assert mesh.shape == {"sample": 1, "tile": 8}
    assert make_render_mesh(CPU8, sample_parallel=4).shape == {"sample": 4, "tile": 2}
    with pytest.raises(ValueError, match="divisible"):
        make_render_mesh(CPU8[:6], sample_parallel=4)
    # No fallback: a mesh that names a card which is not there raises.
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="cuda"):
            make_render_mesh(["cuda:7"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_render_mesh()


def test_tile_sharded_bit_identical_parity(setup):
    scene, bvh, cam, lights = setup
    ref = render_beauty(cam, scene, bvh, lights, (32, 32), 4, **MEGA_KW)
    img = render_beauty_sharded(cam, scene, bvh, lights, (32, 32), 4, mesh=make_render_mesh(CPU8),
                                **MEGA_KW)
    np.testing.assert_array_equal(ref.numpy(), img.numpy())


def test_sample_and_tile_sharded_counter(setup):
    scene, bvh, cam, lights = setup
    ref = render_beauty(cam, scene, bvh, lights, (32, 32), 8, rng_mode="counter", **MEGA_KW)
    img = render_beauty_sharded(cam, scene, bvh, lights, (32, 32), 8, rng_mode="counter",
                                mesh=make_render_mesh(CPU8, sample_parallel=4), **MEGA_KW)
    # The same samples; only the mean's summation order differs.
    np.testing.assert_allclose(ref.numpy(), img.numpy(), atol=1e-6)


def test_non_divisible_height_pads(setup):
    scene, bvh, cam, lights = setup
    ref = render_beauty(cam, scene, bvh, lights, (16, 30), 2, **MEGA_KW)
    img = render_beauty_sharded(cam, scene, bvh, lights, (16, 30), 2, mesh=make_render_mesh(CPU8),
                                **MEGA_KW)
    assert tuple(img.shape) == (30, 16, 3)
    np.testing.assert_array_equal(ref.numpy(), img.numpy())


def test_sample_parallel_requires_counter(setup):
    scene, bvh, cam, lights = setup
    with pytest.raises(ValueError, match="order-independent"):
        render_beauty_sharded(cam, scene, bvh, lights, (16, 16), 8, rng_mode="parity",
                              mesh=make_render_mesh(CPU8, sample_parallel=2))
    with pytest.raises(ValueError, match="not divisible"):
        render_beauty_sharded(cam, scene, bvh, lights, (16, 16), 3, rng_mode="counter",
                              mesh=make_render_mesh(CPU8, sample_parallel=2))


@pytest.mark.parametrize("engine", ["mega", "binned"])
def test_tile_sharded_mega_family(setup, grid, engine):
    """The megarender pass loop per shard equals its single render bit for
    bit: sharding only partitions rows, and the engines' lane sorts are
    shard-local."""
    scene, _, cam, lights = setup
    ref = render_beauty_mega(cam, scene, grid, lights, (16, 16), 1, trace_engine=engine,
                             **MEGA_KW)
    img = render_beauty_sharded(cam, scene, grid, lights, (16, 16), 1, engine=engine,
                                mesh=make_render_mesh(CPU8), **MEGA_KW)
    np.testing.assert_array_equal(ref.numpy(), img.numpy())


def _spy_replicate(monkeypatch) -> list:
    """Record every ``sharding.replicate`` call's result."""
    copies = []
    real = sharding.replicate

    def spy(objs, devices):
        out = real(objs, devices)
        copies.append(out)
        return out

    monkeypatch.setattr(sharding, "replicate", spy)
    return copies


TWO_DEVICES = ["cpu", "cpu:0"]  # two devices to the mesh: tables copied to the second


def _fresh_tables():
    """(camera, scene, grid, lights) of the helpers scene, made for one test
    alone, so that no other test holds them or their copies."""
    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, MediaTable(*media), 1.0, 1, device="cpu")
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8), "cpu")
    return port_camera(), scene, grid, port_lights()


def test_every_shard_dispatched_before_collect(setup, grid, monkeypatch):
    """dispatch then collect: every shard's call is made before
    ``combine_cells`` takes the first image, and the image is the single
    render's bit for bit."""
    scene, _, cam, lights = setup
    events = []
    real_mega = render_beauty_mega
    real_combine = sharding.combine_cells

    def mega(*a, **k):
        events.append(("call", k["row_offset"]))
        return real_mega(*a, **k)

    def combine(*a, **k):
        events.append(("combine", None))
        return real_combine(*a, **k)

    monkeypatch.setattr("complex_materials_renderer_tpu_torch.render.megarender."
                        "render_beauty_mega", mega)
    monkeypatch.setattr(sharding, "combine_cells", combine)
    img = render_beauty_sharded(cam, scene, grid, lights, (16, 16), 1, engine="mega",
                                mesh=make_render_mesh(TWO_DEVICES * 4), **MEGA_KW)
    ref = real_mega(cam, scene, grid, lights, (16, 16), 1, **MEGA_KW)
    np.testing.assert_array_equal(ref.numpy(), img.numpy())
    assert [e for e, _ in events] == ["call"] * 8 + ["combine"]


@pytest.mark.parametrize("sample_parallel,rng", [(1, "parity"), (2, "counter")])
def test_shards_of_one_device_keep_mesh_order(setup, grid, monkeypatch, sample_parallel, rng):
    """The shards of each device are queued together, in mesh order
    (sample-major), each from its own device's tables: the source's on
    "cpu", which holds them, a copy on "cpu:0"; the image is the single
    render's (a sample split within atol 1e-6)."""
    import threading

    scene, _, cam, lights = setup
    calls = []
    real_mega = render_beauty_mega

    def mega(*a, **k):
        calls.append((k["sample_offset"], k["row_offset"], a[2], threading.current_thread()))
        return real_mega(*a, **k)

    monkeypatch.setattr("complex_materials_renderer_tpu_torch.render.megarender."
                        "render_beauty_mega", mega)
    copies = _spy_replicate(monkeypatch)
    mesh = make_render_mesh(TWO_DEVICES * 4, sample_parallel=sample_parallel)
    img = render_beauty_sharded(cam, scene, grid, lights, (16, 16), 2, engine="mega",
                                rng_mode=rng, mesh=mesh, **MEGA_KW)
    ref = real_mega(cam, scene, grid, lights, (16, 16), 2, rng_mode=rng, **MEGA_KW)
    np.testing.assert_allclose(ref.numpy(), img.numpy(), atol=0 if rng == "parity" else 1e-6)
    assert len(copies) == 1 and sorted(map(str, copies[0])) == TWO_DEVICES
    tables = {str(d): objs[2] for d, objs in copies[0].items()}
    assert tables["cpu"] is grid
    assert tables["cpu:0"] is not grid
    assert tables["cpu:0"].run_rows.data_ptr() != grid.run_rows.data_ptr()
    n_tile = mesh.shape["tile"]
    rows = 16 // n_tile
    cells = [(s, t) for s in range(sample_parallel) for t in range(n_tile)]
    # Shard (s, t) lies on "cpu" when its flat index is even.
    want = [c for c in cells if (c[0] * n_tile + c[1]) % 2 == 0] + \
           [c for c in cells if (c[0] * n_tile + c[1]) % 2 == 1]
    assert [(so, ro) for so, ro, _, _ in calls] == [(s * (2 // sample_parallel), t * rows)
                                                    for s, t in want]
    for (s, t), (_, _, g, thread) in zip(want, calls):
        assert g is tables["cpu" if (s * n_tile + t) % 2 == 0 else "cpu:0"]
        assert thread is threading.current_thread()


def _count_copies(monkeypatch) -> list:
    """Record every object that ``to_device`` copies."""
    made = []
    real = sharding._moved

    def moved(obj, device):
        made.append((type(obj).__name__, str(device)))
        return real(obj, device)

    monkeypatch.setattr(sharding, "_moved", moved)
    return made


def _count_pass_caches(monkeypatch) -> list:
    """Record every ``PassCache`` made."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    made = []

    class Counted(mr.PassCache):
        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    monkeypatch.setattr(mr, "PassCache", Counted)
    return made


@pytest.mark.parametrize("entry", ["render_beauty_sharded", "Renderer.render", "render_multihost"])
def test_second_call_reuses_device_tables(monkeypatch, tmp_path, entry):
    """A second sharded call over the same tables copies nothing and makes
    no ``PassCache``: ``replicate`` gives the same per-device objects and
    ``pass_cache`` the same caches (on the card, the same CUDA graphs):
    through ``render_beauty_sharded``, a ``Renderer``'s sharded band loop
    and ``render_multihost`` in a one-process gloo world."""
    import torch.distributed as dist

    from complex_materials_renderer_tpu_torch.render import megarender as mr

    copies = _count_copies(monkeypatch)
    caches = _count_pass_caches(monkeypatch)
    if entry == "Renderer.render":
        base, opt = _helpers_scene(rng="counter", num_samples=2)
        monkeypatch.setattr(Renderer, "_shard_devices", lambda self: TWO_DEVICES * 2)
        r = Renderer(base, dataclasses.replace(opt, shard="auto"))
        objs = (r.camera, r.scene_arrays, r.accel, r.lights)
        call = r.render
    else:
        objs = _fresh_tables()
        kw = dict(rng_mode="counter", engine="mega", **MEGA_KW)
        if entry == "render_beauty_sharded":
            mesh = make_render_mesh(TWO_DEVICES * 2)

            def call():
                return render_beauty_sharded(*objs, (16, 16), 2, mesh=mesh, **kw).numpy()
        else:
            multihost.init_distributed("file://" + str(tmp_path / "store"), 1, 0)

            def call():
                return multihost.render_multihost(*objs, (16, 16), 2, devices=TWO_DEVICES, **kw)
    try:
        first = call()
        tables = sharding.replicate(objs, [torch.device(d) for d in TWO_DEVICES])
        passes = {d: mr.pass_cache(*t[1:]) for d, t in tables.items()}
        assert copies and len(caches) == 2  # the copies on "cpu:0"; a cache a device
        del copies[:], caches[:]
        second = call()
        again = sharding.replicate(objs, [torch.device(d) for d in TWO_DEVICES])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert copies == [] and caches == []
    assert all(a is b for d in tables for a, b in zip(tables[d], again[d]))
    assert tables[torch.device("cpu")] == list(objs)  # the device that holds them: themselves
    assert all(mr.pass_cache(*again[d][1:]) is passes[d] for d in passes)
    if entry == "Renderer.render":
        assert all(r._shard_passes[d] is passes[d] for d in passes)
    np.testing.assert_array_equal(first, second)


def test_device_copies_released_with_their_source():
    """The per-device copies live as long as their source: once the source
    tables are dropped (and the pass loop no longer keeps their cache),
    the copies and the cache of the copies go, though that cache was
    used more recently."""
    import gc
    import weakref

    from complex_materials_renderer_tpu_torch.render import megarender as mr

    objs = _fresh_tables()
    mesh = make_render_mesh(TWO_DEVICES)
    render_beauty_sharded(*objs, (16, 16), 1, engine="mega", mesh=mesh, **MEGA_KW)
    copy = sharding.replicate(objs, [torch.device("cpu", 0)])[torch.device("cpu", 0)]
    assert all(a is not b for a, b in zip(copy, objs))
    gone = [weakref.ref(copy[1]), weakref.ref(copy[2]), weakref.ref(mr.pass_cache(*copy[1:]))]
    source = weakref.ref(objs[1])
    del copy, objs
    # The other table sets push the source's cache (the oldest) out of the
    # ones kept; the copies' cache, touched last above, would stay.
    others = [_fresh_tables() for _ in range(mr.kept_tables() - 1)]
    for o in others:
        mr.pass_cache(*o[1:])
    gc.collect()
    assert source() is None
    assert [ref() for ref in gone] == [None, None, None]


def test_sample_sharded_mega_counter(setup, grid):
    scene, _, cam, lights = setup
    ref = render_beauty_mega(cam, scene, grid, lights, (16, 16), 4, rng_mode="counter",
                             **MEGA_KW)
    img = render_beauty_sharded(cam, scene, grid, lights, (16, 16), 4, rng_mode="counter",
                                engine="mega", mesh=make_render_mesh(CPU8[:4], 2), **MEGA_KW)
    np.testing.assert_allclose(ref.numpy(), img.numpy(), atol=1e-6)


def test_pair_shards_render_wavefront(setup, grid):
    """R5: under sharding the pair engine renders through the wavefront
    loop, as sharding.py:103-116 of the JAX package does."""
    scene, _, cam, lights = setup
    mesh = make_render_mesh(CPU8[:4])
    pair = render_beauty_sharded(cam, scene, grid, lights, (16, 16), 2, engine="pair",
                                 mesh=mesh, **MEGA_KW)
    wave = render_beauty_sharded(cam, scene, grid, lights, (16, 16), 2, engine="wavefront",
                                 mesh=mesh, **MEGA_KW)
    np.testing.assert_array_equal(pair.numpy(), wave.numpy())
    assert np.array_equal(wave.numpy(), render_beauty(cam, scene, grid, lights, (16, 16), 2,
                                                      **MEGA_KW).numpy())


def test_sharded_matches_jax_sharded():
    """The port's sharded wavefront over 8 logical CPU shards against the
    JAX package's over its 8 virtual devices, BVH backend, with the
    tolerance of the port's wavefront tests (atol 1e-5 but at most 2 flip
    pixels of 256)."""
    import jax

    assert len(jax.devices()) == 8
    tris, mats, media = make_test_scene()
    jscene, jbvh, tscene, tbvh = scene_accels(tris, mats, media, "bvh")
    kw = dict(max_depth=8, rr_depth=4, nee_max_media=4, rng_mode="counter")
    ref = np.asarray(jax_render_beauty_sharded(fixture_camera(), jscene, jbvh, fixture_lights(),
                                               (16, 16), 4, mesh=jax_mesh(sample_parallel=2),
                                               **kw))
    img = render_beauty_sharded(port_camera(), tscene, tbvh, port_lights(), (16, 16), 4,
                                mesh=make_render_mesh(CPU8, sample_parallel=2), **kw)
    check_image(img.numpy(), ref, max_flips=2)


def _helpers_scene(**kw):
    """(Scene, options) of the helpers scene at 16x24@4 on the BVH."""
    tris, mats, media = make_test_scene()
    kw = {**dict(width=16, height=24, num_samples=4), **kw}
    opt = RenderOptions(backend="bvh", device="cpu", camera_pos=(0.0, 1.5, 5.0),
                        camera_look_at=(0.0, 1.0, 0.0), camera_fov=36.0, scale=1.0, **MEGA_KW,
                        **kw)
    return Scene(tris, mats, MediaTable(*media), opt, []), opt


@pytest.mark.parametrize("rng,lanes", [("parity", 1 << 16), ("counter", 16 * 2)])
def test_sharded_chunked_renderer_matches_single(monkeypatch, rng, lanes):
    """The Renderer's sharded band and sample-chunk loop (8 shards patched
    in as the visible devices) reproduces the single-device render; in
    counter mode with bands of 16 rows and one-sample chunks."""
    base, opt = _helpers_scene(rng=rng)
    single = Renderer(base, dataclasses.replace(opt, shard="none")).render()
    monkeypatch.setattr(Renderer, "_shard_devices", lambda self: CPU8)
    monkeypatch.setattr(trenderer, "LANES_PER_PASS", lanes)
    monkeypatch.setattr(trenderer, "PATHS_PER_PASS", lanes)
    seen = []
    real = sharding.dispatch_cells

    def spy(cells, *a, **kw):
        seen.append(len(cells))
        return real(cells, *a, **kw)

    monkeypatch.setattr(sharding, "dispatch_cells", spy)
    copies = _spy_replicate(monkeypatch)
    sharded = Renderer(base, dataclasses.replace(opt, shard="auto")).render()
    # One band of every sample (parity); two 16-row bands of four 1-sample calls (counter).
    assert seen == [8] * {"parity": 1, "counter": 8}[rng]
    assert [list(c) for c in copies] == [[torch.device("cpu")]]  # once, not once a band
    np.testing.assert_allclose(sharded, single, atol=1e-6)


def test_sharded_renderer_ignores_tir(monkeypatch, setup):
    """R6: the shards never get ``tir``, so ``--tir kill`` renders the
    default ``reflect`` image under sharding."""
    base, opt = _helpers_scene(rng="counter", num_samples=2)
    monkeypatch.setattr(Renderer, "_shard_devices", lambda self: CPU8[:4])
    kill = Renderer(base, dataclasses.replace(opt, shard="auto", tir="kill")).render()
    reflect = Renderer(base, dataclasses.replace(opt, shard="auto")).render()
    np.testing.assert_array_equal(kill, reflect)


def test_shard_auto_on_one_device_renders_alone(monkeypatch):
    """With one device ``--shard auto`` takes the single-device path, as
    the JAX package does with one device."""
    base, opt = _helpers_scene(rng="counter")
    monkeypatch.setattr(sharding, "dispatch_cells", lambda *a, **kw: pytest.fail("sharded"))
    r = Renderer(base, dataclasses.replace(opt, shard="auto"))
    assert r._shard_devices() == [torch.device("cpu")]
    assert r.render().shape == (24, 16, 3)


@pytest.mark.parametrize("width,height,spp,n_tile,rng,sample_chunk,band,chunk", [
    (128, 128, 256, 1, "parity", 0, 512, 64),
    (128, 128, 256, 1, "counter", 0, 512, 64),
    (128, 128, 256, 4, "parity", 0, 128, 256),
    (128, 128, 256, 4, "counter", 0, 128, 64),
    (1920, 1080, 256, 1, "parity", 0, 34, 16),
    (1920, 1080, 256, 1, "counter", 0, 34, 16),
    (1920, 1080, 256, 4, "parity", 0, 136, 256),
    (1920, 1080, 256, 4, "counter", 0, 136, 16),
    (10000, 4, 256, 1, "parity", 0, 6, 26),
    (10000, 4, 256, 1, "counter", 0, 6, 26),
    (10000, 4, 256, 4, "parity", 0, 4, 256),
    (10000, 4, 256, 4, "counter", 0, 4, 26),
    (1920, 1080, 256, 1, "parity", 3, 34, 3),
    (1920, 1080, 256, 4, "counter", 3, 136, 3),
    (1920, 1080, 256, 4, "parity", 3, 136, 256),
    (1920, 1080, 256, 1, "counter", 1000, 34, 256),
    (1920, 1080, 256, 4, "ld", 1000, 136, 256),
    (128, 128, 8, 4, "counter", 0, 128, 8),
])
def test_band_plan(monkeypatch, width, height, spp, n_tile, rng, sample_chunk, band, chunk):
    """The band loop's rows and samples a call at the default pass shape,
    written out from the JAX package's two loops (renderer.py:246-258 and
    :334-336): one card's band unclamped and its samples chunked over the
    frame's lanes; four tiles' band clamped to the frame, counter and ld
    chunked over the band's lanes, parity's samples all in one call."""
    monkeypatch.setattr(trenderer, "LANES_PER_PASS", 1 << 16)
    monkeypatch.setattr(trenderer, "PATHS_PER_PASS", 1 << 20)
    opt = RenderOptions(width=width, height=height, num_samples=spp, rng=rng,
                        sample_chunk=sample_chunk)
    assert trenderer._band_plan(opt, n_tile) == (band, chunk)


def test_multihost_single_process(setup):
    """Without a process group render_multihost is the sharded render."""
    scene, bvh, cam, lights = setup
    multihost.init_distributed()  # no-op: one process, no coordinator
    assert not multihost.is_initialized()
    img = multihost.render_multihost(cam, scene, bvh, lights, (16, 16), 2, devices=CPU8,
                                     **MEGA_KW)
    ref = render_beauty_sharded(cam, scene, bvh, lights, (16, 16), 2, mesh=make_render_mesh(CPU8),
                                **MEGA_KW)
    np.testing.assert_array_equal(img, ref.numpy())


def test_multihost_backend_follows_devices(setup, tmp_path, monkeypatch):
    """init_distributed serves CPU tensors with gloo (and CUDA ones with
    NCCL where there is CUDA), so CPU shards gather over gloo on any host;
    a group that gives the shards' device type another backend is
    refused."""
    import torch.distributed as dist

    scene, bvh, cam, lights = setup
    multihost.init_distributed("file://" + str(tmp_path / "store"), 1, 0)
    try:
        assert multihost.group_backend("cpu") == "gloo"
        img = multihost.render_multihost(cam, scene, bvh, lights, (16, 16), 1,
                                         devices=CPU8[:2], **MEGA_KW)
        ref = render_beauty_sharded(cam, scene, bvh, lights, (16, 16), 1,
                                    mesh=make_render_mesh(CPU8[:2]), **MEGA_KW)
        np.testing.assert_array_equal(img, ref.numpy())
        monkeypatch.setattr(dist, "get_backend", lambda *a: "cuda:nccl")
        with pytest.raises(ValueError, match="gloo"):
            multihost.render_multihost(cam, scene, bvh, lights, (16, 16), 1, devices=CPU8[:2],
                                       **MEGA_KW)
    finally:
        dist.destroy_process_group()


_WORKER = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from complex_materials_renderer_tpu_torch.accel import build_bvh
from complex_materials_renderer_tpu_torch.kernels.traverse import device_bvh
from complex_materials_renderer_tpu_torch.ops.camera import make_camera
from complex_materials_renderer_tpu_torch.parallel import multihost
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays
from complex_materials_renderer_tpu_torch.scene.medium import MediaTable

rank, world, store, data, out, sample_parallel = sys.argv[1:7]
with np.load(data) as z:
    tris, mats = z["tris"], z["mats"]
    media = MediaTable(*(z[f] for f in MediaTable._fields))
scene = make_scene_arrays(tris, mats, media, 1.0, 1, device="cpu")
bvh = device_bvh(build_bvh(tris, leaf_size=4), tris, 4, "cpu")
cam = make_camera((0.0, 1.5, 5.0), (0.0, 1.0, 0.0), 36.0)
lights = make_lights((2.0, 4.0, 3.0), (0.8, 0.8, 0.6), 100.0)
multihost.init_distributed(store, int(world), int(rank))
multihost.init_distributed(store, int(world), int(rank))  # a second call is a no-op
assert multihost.group_backend("cpu") == "gloo"
img = multihost.render_multihost(cam, scene, bvh, lights, (16, 16), 2, devices=["cpu", "cpu"],
                                 sample_parallel=int(sample_parallel), rng_mode="counter",
                                 max_depth=4, rr_depth=2, nee_max_media=1)
np.save(out, img)
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("sample_parallel", [1, 2])
def test_multihost_two_processes(setup, tmp_path, sample_parallel):
    """A real two-process job: two interpreters join a gloo group through a
    file:// store, 2 logical CPU shards each (a global mesh of 4 tiles, or
    2 x 2 with the 'sample' axis across the processes), and both return
    the full frame, equal to the one-process render."""
    scene, bvh, cam, lights = setup
    tris, mats, media = make_test_scene()
    data = str(tmp_path / "scene.npz")
    np.savez(data, tris=tris, mats=mats, **dict(zip(MediaTable._fields, media)))
    store = "file://" + str(tmp_path / "store")
    outs = [str(tmp_path / f"img{i}.npy") for i in range(2)]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(i), "2", store, data, outs[i],
                               str(sample_parallel)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    imgs = [np.load(o) for o in outs]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    ref = render_beauty_sharded(cam, scene, bvh, lights, (16, 16), 2, rng_mode="counter",
                                mesh=make_render_mesh(CPU8[:4], sample_parallel), **MEGA_KW)
    assert imgs[0].shape == (16, 16, 3)
    np.testing.assert_array_equal(imgs[0], ref.numpy())
