"""The port's default command at its full size against the JAX package, on
the CPU with no card.

``python -m complex_materials_renderer_tpu_torch`` with no argument renders
showcase at the reference's default workload (config.py's defaults:
1920x1080, 256 spp, parity RNG, depth 32, Russian roulette from 16). The
single-device loop cuts that frame into 32 row blocks of 34 rows (the
last one 26) and each block into 16 passes of 16 samples: 512 passes.

- the schedule: with ``render_beauty_mega`` replaced in both packages by
  a recorder, the two ``Renderer.render()`` loops make the same 512 calls
  (row offset, rows, sample offset, samples, frame size), carry the same
  RNG state from call to call and accumulate the same image, byte for
  byte;
- the 32x32 tile order of a 34-row and a 26-row block, bit for bit;
- the lanes: the state of the first megakernel call of the first, a
  middle and the last row block, in parity, counter and ld, is the JAX
  package's first call's state (integer fields, the seeding pixel and
  sample ids and the camera pixels bit for bit, origins and directions
  within 4 ulp of each vector's largest component), and
  ``first_pass_state`` builds it;
- ``render_pixels_mega``, the parity pass over chosen pixels that checks
  the card's frame pixel by pixel, is the uniform parity render at those
  pixels bit for bit, and agrees with the JAX ``render_beauty_mega``
  there within the per-pixel tolerance of tests/test_torch_render.py.

The JAX pass loop is a private copy of its render/megarender.py (ROADMAP R1),
run with ``jax.disable_jit()`` up to its first kernel call; it goes into
``sys.modules`` only through ``monkeypatch``.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu import renderer as jrenderer
from complex_materials_renderer_tpu.accel.clusters import build_clusters as jax_build_clusters
from complex_materials_renderer_tpu.config import RenderOptions as JaxOptions
from complex_materials_renderer_tpu.kernels.pallas_trace import device_cluster_grid as jax_grid
from complex_materials_renderer_tpu.ops.camera import make_camera as jax_make_camera
from complex_materials_renderer_tpu.render.hitinfo import make_scene_arrays as jax_scene_arrays
from complex_materials_renderer_tpu.scene.scene import Scene as JaxScene
from complex_materials_renderer_tpu_torch import renderer as trenderer
from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import megakernel as tmk
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.ops.camera import make_camera
from complex_materials_renderer_tpu_torch.render import megarender as tmr
from complex_materials_renderer_tpu_torch.render.hitinfo import make_scene_arrays
from complex_materials_renderer_tpu_torch.scene.medium import MediaTable
from complex_materials_renderer_tpu_torch.scene.scene import Scene

from helpers import fixture_camera, fixture_lights, make_test_scene
from test_torch_render import _check
from test_torch_support import load_jax_megarender, port_camera, port_lights

torch.set_num_threads(1)

JAX_MEGARENDER = "complex_materials_renderer_tpu.render.megarender"
W, H, SPP = 1920, 1080, 256
ROWS = 34  # rows of a block: LANES_PER_PASS // W
CHUNK = 16  # samples of a pass: PATHS_PER_PASS // LANES_PER_PASS
BLOCKS = -(-H // ROWS)
LAST = (BLOCKS - 1) * ROWS  # first row of the 26-row block
ROW_BLOCKS = {"first": 0, "middle": (BLOCKS // 2) * ROWS, "last": LAST}
ULP = 4  # origins and directions: the camera's float ops in two libraries


def test_defaults_are_the_reference_workload():
    """Both packages default to 1920x1080 at 256 spp, depth 32, RR from 16,
    parity; the loop cuts that into 32 blocks of 34 rows, 16 samples a
    pass."""
    t, j = RenderOptions(), JaxOptions()
    keys = ("width", "height", "num_samples", "max_depth", "rr_depth", "rng", "engine",
            "backend", "shard", "spp_mode", "sample_chunk", "obj_path")
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
    assert (t.width, t.height, t.num_samples, t.max_depth, t.rr_depth, t.rng) == (
        W, H, SPP, 32, 16, "parity")
    assert trenderer._auto_sample_chunk(W, H) == jrenderer._auto_sample_chunk(W, H) == CHUNK
    assert trenderer._auto_row_chunk(W) == jrenderer._auto_row_chunk(W) == ROWS
    assert (BLOCKS, H - LAST) == (32, 26)


def _opts(cls, **over):
    kw = dict(width=W, height=H, num_samples=SPP, rng="parity", shard="none",
              backend="cluster", engine="mega", cluster_size=8, camera_pos=(0.0, 1.5, 5.0),
              camera_look_at=(0.0, 1.0, 0.0), camera_fov=36.0, scale=1.0)
    if cls is RenderOptions:
        kw["device"] = "cpu"
    kw.update(over)
    return cls(**kw)


def _band_value(row_offset, sample_offset):
    """The stand-in radiance of a call: one float32 per (block, chunk)."""
    return np.float32((1 + sample_offset) / 7.0 + row_offset * 1e-3)


@pytest.mark.parametrize("rng", ["parity", "counter"])
def test_schedule_matches_jax(monkeypatch, rng):
    """The single-device loop at the default size: with render_beauty_mega
    replaced by a recorder, the port makes the JAX package's 512 calls in
    its order, hands each call the state the previous call of its block
    returned, and accumulates the same image byte for byte."""
    calls = {"jax": [], "port": []}

    def recorder(name, full, tensor):
        def stub(camera, scene, grid, lights, resolution, num_samples, *, row_offset,
                 full_resolution, sample_offset, rng_state, return_rng, **kw):
            carried = None if rng_state is None else tuple(np.asarray(rng_state).tolist())
            calls[name].append((row_offset, resolution[1], sample_offset, num_samples,
                                tuple(full_resolution), resolution[0], carried, kw["rng_mode"]))
            img = full((resolution[1], resolution[0], 3),
                       _band_value(row_offset, sample_offset))
            return img, tensor([row_offset, sample_offset + num_samples])
        return stub

    jax_stub = types.ModuleType(JAX_MEGARENDER)
    jax_stub.render_beauty_mega = recorder(
        "jax", lambda s, v: jnp.full(s, v, jnp.float32), lambda x: jnp.asarray(x, jnp.int32))
    monkeypatch.setitem(sys.modules, JAX_MEGARENDER, jax_stub)
    monkeypatch.setattr(tmr, "render_beauty_mega", recorder(
        "port", lambda s, v: torch.full(s, float(v), dtype=torch.float32),
        lambda x: torch.tensor(x, dtype=torch.int64)))

    tris, mats, media = make_test_scene()
    jopt, topt = _opts(JaxOptions, rng=rng), _opts(RenderOptions, rng=rng)
    img_jax = jrenderer.Renderer(JaxScene(tris, mats, media, jopt, []), jopt).render()
    img_port = trenderer.Renderer(Scene(tris, mats, MediaTable(*media), topt, []), topt).render()
    monkeypatch.undo()
    assert JAX_MEGARENDER not in sys.modules

    assert len(calls["port"]) == len(calls["jax"]) == BLOCKS * (SPP // CHUNK) == 512
    assert calls["port"] == calls["jax"]
    # Blocks in row order, each one's chunks in sample order, the state
    # carried within a block and fresh at its first chunk.
    want = [(row0, min(ROWS, H - row0), s, CHUNK, (W, H), W,
             None if s == 0 else (row0, s), rng)
            for row0 in range(0, H, ROWS) for s in range(0, SPP, CHUNK)]
    assert calls["port"] == want
    assert img_port.dtype == np.asarray(img_jax).dtype == np.float32
    assert img_port.shape == (H, W, 3)
    assert img_port.tobytes() == np.asarray(img_jax).tobytes()


@pytest.mark.parametrize("rows", [ROWS, H - LAST])
def test_tile_perm_of_the_row_blocks(rows):
    """A block 1920 wide and 34 rows tall (60 tiles of 32x32, then a
    partial tile row of 2 rows) or 26 rows tall (one row of partial
    tiles): both packages' order and inverse equal, bit for bit."""
    jmr = load_jax_megarender()
    pa, ia = jmr._tile_perm(W, rows)
    pb, ib = tmr._tile_perm(W, rows)
    assert pb.dtype == np.asarray(pa).dtype
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(pb[ib], np.arange(W * rows))
    # The first tile is the block's top-left 32 x min(32, rows) pixels; in
    # a 34-row block the partial tile row starts after 60 full tiles.
    first = (np.arange(min(32, rows))[:, None] * W + np.arange(32)[None, :]).reshape(-1)
    np.testing.assert_array_equal(pb[:first.size], first)
    if rows > 32:
        assert pb[60 * 1024] == 32 * W


class _SeedRecorder:
    """A module's rng ops with every seeding call's integer arguments
    recorded (the pixel ids and sample ids of the lanes)."""

    def __init__(self, ops):
        self._ops = ops
        self.seeds = []

    def __getattr__(self, name):
        f = getattr(self._ops, name)
        if not name.startswith("seed_"):
            return f

        def seeded(*args):
            self.seeds.append((name, [np.asarray(a).astype(np.int64) for a in args]))
            return f(*args)

        return seeded


class _Stop(Exception):
    pass


def _first_call(module, seen, name):
    """A stand-in for ``module``'s kernel wrapper that records the state of
    its first call and stops the render there. The port's pass plan gives
    K1 its ld base in the pass control block (``ctrl``), the JAX pass loop
    as ``dim0``."""
    def first(grid, media9, misc, state, **kw):
        dim0 = kw["ctrl"][1] if kw.get("ctrl") is not None else kw.get("dim0", 0)
        seen[name] = ([np.asarray(x) for x in state], int(np.asarray(dim0)))
        raise _Stop
    return first


def _camera_recorder(seen, name, generate):
    def rec(camera, pixel_xy, jitter, full_resolution):
        seen[name + " pixels"] = np.asarray(pixel_xy).astype(np.int64)
        return generate(camera, pixel_xy, jitter, full_resolution)
    return rec


@pytest.fixture(scope="module")
def scene_objects():
    """Both packages' camera (the default options'), scene tables, cluster
    grid and lights over the helpers scene: the first kernel call's state
    is the camera's and the seeds', whatever the scene."""
    d = RenderOptions()
    tris, mats, media = make_test_scene()
    jax_objs = (jax_make_camera(d.camera_pos, d.camera_look_at, d.camera_fov),
                jax_scene_arrays(tris, mats, media, 1.0, 1),
                jax_grid(jax_build_clusters(tris, mats, cluster_size=8)), fixture_lights())
    port_objs = (make_camera(d.camera_pos, d.camera_look_at, d.camera_fov),
                 make_scene_arrays(tris, mats, MediaTable(*media), 1.0, 1, device="cpu"),
                 device_cluster_grid(build_clusters(tris, mats, cluster_size=8), "cpu"),
                 port_lights())
    return jax_objs, port_objs


@pytest.mark.parametrize("block", sorted(ROW_BLOCKS))
@pytest.mark.parametrize("rng", ["parity", "counter", "ld"])
def test_first_pass_state_matches_jax(monkeypatch, scene_objects, rng, block):
    """The first megakernel call of a row block of the 1080p frame gets the
    JAX package's state: integer fields, seeds and camera pixels bit for
    bit, origins and directions within ULP ulp of each vector's largest
    component; ``first_pass_state`` of that block builds it."""
    jax_objs, port_objs = scene_objects
    row0 = ROW_BLOCKS[block]
    rows = min(ROWS, H - row0)
    kw = dict(max_depth=32, rr_depth=16, nee_max_media=4, rng_mode=rng, row_offset=row0,
              full_resolution=(W, H), schedule_mode="off")
    seen = {}
    jmr = load_jax_megarender()
    jmr.trace_paths_mega = _first_call(jmr, seen, "jax")
    jmr.generate_rays = _camera_recorder(seen, "jax", jmr.generate_rays)
    jmr.rng_ops = jseeds = _SeedRecorder(jmr.rng_ops)
    tseeds = _SeedRecorder(tmr.rng_ops)
    monkeypatch.setattr(tmr, "trace_paths_mega", _first_call(tmr, seen, "port"))
    monkeypatch.setattr(tmr, "generate_rays", _camera_recorder(seen, "port", tmr.generate_rays))
    monkeypatch.setattr(tmr, "rng_ops", tseeds)
    with jax.disable_jit(), pytest.raises(_Stop):
        jmr.render_beauty_mega(*jax_objs, (W, rows), SPP, **kw)
    with pytest.raises(_Stop):
        tmr.render_beauty_mega(*port_objs, (W, rows), SPP, **kw)
    monkeypatch.undo()

    lanes = -(-W * rows // 1024) * 1024  # at most STEP_LANES: one pass a block
    (jstate, jdim0), (tstate, tdim0) = seen["jax"], seen["port"]
    assert tdim0 == jdim0 == (2 if rng == "ld" else 0)
    np.testing.assert_array_equal(seen["port pixels"], seen["jax pixels"])
    assert [n for n, _ in tseeds.seeds] == [n for n, _ in jseeds.seeds]
    for (_, targs), (_, jargs) in zip(tseeds.seeds, jseeds.seeds):
        for a, b in zip(targs, jargs):
            np.testing.assert_array_equal(a, b)
    # The seeds are the block's pixels (frame ids), and in the packed
    # modes its first pixel group's first 16 samples.
    pixel_ids = tseeds.seeds[0][1][0]
    assert pixel_ids.min() >= row0 * W and pixel_ids.max() < (row0 + rows) * W
    if rng != "parity":
        assert set(tseeds.seeds[0][1][1].tolist()) == set(range(CHUNK))
    for name, t, j in zip(tmk.MegaState._fields, tstate, jstate):
        assert t.shape[0] == j.shape[0] == lanes, name
        if name in ("org", "dir"):
            # A component near 0 comes from a cancellation: the ulp is
            # that of the vector's largest component.
            scale = np.abs(j).max(axis=-1, keepdims=True).astype(np.float32)
            err = np.abs(t.astype(np.float64) - j)
            assert np.all(err <= ULP * np.spacing(scale)), (name, float(err.max()))
        elif name in ("rng", "aux"):
            np.testing.assert_array_equal(t, j.astype(np.uint32).astype(np.int64), err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)

    built, dim0 = tmr.first_pass_state(port_objs[0], (W, rows), SPP, rng, full_resolution=(W, H),
                                       row_offset=row0)
    assert dim0 == tdim0
    for name, x, y in zip(tmk.MegaState._fields, built, tstate):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=name)


KW = dict(max_depth=4, rr_depth=2, nee_max_media=1)


@pytest.fixture(scope="module")
def helper_objects():
    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, MediaTable(*media), 1.0, 1, device="cpu")
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8), "cpu")
    return port_camera(), scene, grid, port_lights()


def _pixels(w, h, n, seed):
    rs = np.random.default_rng(seed)
    ids = rs.permutation(w * h)[:n]
    return np.stack([ids % w, ids // w], -1).astype(np.int64)


def test_render_pixels_is_the_uniform_parity_pass(helper_objects):
    """Scattered pixels of a 48x40 frame (1,920 lanes) get the uniform
    parity render's values bit for bit, also when their streams are carried
    over two calls of 2 samples each and accumulated as the single-device
    loop accumulates."""
    w, h = 48, 40
    full = tmr.render_beauty_mega(*helper_objects, (w, h), 4, **KW).numpy()
    a, rng_a = tmr.render_beauty_mega(*helper_objects, (w, h), 2, return_rng=True, **KW)
    b = tmr.render_beauty_mega(*helper_objects, (w, h), 2, rng_state=rng_a, sample_offset=2,
                               **KW)
    chunked = a.numpy() * np.float32(0.5)
    chunked += b.numpy() * np.float32(0.5)
    pix = _pixels(w, h, w * h, 3)
    got = tmr.render_pixels_mega(*helper_objects, torch.from_numpy(pix), 4, (w, h),
                                 **KW).numpy()
    np.testing.assert_array_equal(got, full[pix[:, 1], pix[:, 0]])
    first, rng_p = tmr.render_pixels_mega(*helper_objects, torch.from_numpy(pix), 2, (w, h),
                                          return_rng=True, **KW)
    second = tmr.render_pixels_mega(*helper_objects, torch.from_numpy(pix), 2, (w, h),
                                    rng_state=rng_p, **KW)
    np.testing.assert_array_equal(rng_p.numpy(), rng_a.numpy()[pix[:, 1] * w + pix[:, 0]])
    acc = first.numpy() * np.float32(0.5)
    acc += second.numpy() * np.float32(0.5)
    np.testing.assert_array_equal(acc, chunked[pix[:, 1], pix[:, 0]])


def test_render_pixels_matches_jax(helper_objects):
    """128 pixels of a 16x16 frame through the port's render_pixels_mega
    against the JAX render_beauty_mega of the frame (its megakernel
    interpreted) at those pixels, parity, 2 spp."""
    tris, mats, media = make_test_scene()
    jmr = load_jax_megarender()
    ref = np.asarray(jmr.render_beauty_mega(
        fixture_camera(), jax_scene_arrays(tris, mats, media, 1.0, 1),
        jax_grid(jax_build_clusters(tris, mats, cluster_size=8)), fixture_lights(), (16, 16), 2,
        rng_mode="parity", **KW))
    pix = _pixels(16, 16, 128, 5)
    got = tmr.render_pixels_mega(*helper_objects, torch.from_numpy(pix), 2, (16, 16),
                                 **KW).numpy()
    _check(got.reshape(16, 8, 3), ref[pix[:, 1], pix[:, 0]].reshape(16, 8, 3).astype(np.float64),
           max_flips=2)


def test_first_pass_state_row_offset_default(helper_objects):
    """``row_offset`` defaults to the frame's first row."""
    cam = helper_objects[0]
    a, _ = tmr.first_pass_state(cam, (64, 8), 4, "parity", full_resolution=(64, 64))
    b, _ = tmr.first_pass_state(cam, (64, 8), 4, "parity", full_resolution=(64, 64),
                                row_offset=0)
    c, _ = tmr.first_pass_state(cam, (64, 8), 4, "parity", full_resolution=(64, 64),
                                row_offset=8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.rng, c.rng)
