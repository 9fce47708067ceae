"""The port's megakernel beauty pass (plain K1 on the CPU) against the
JAX package's wavefront engine (bvh backend, pure XLA) on the helpers
scene, for the three RNG modes and the three schedule modes; and the
pass's helpers against a private copy of the JAX render/megarender.py.

Image tolerance: atol 1e-5 per pixel except flip pixels (|diff| > 1e-2,
one sample's path decision resolved the other way by a last-ulp
difference), at most 2 of 256."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from complex_materials_renderer_tpu.kernels import megakernel as jmk
from complex_materials_renderer_tpu.render.hitinfo import make_scene_arrays as jax_scene_arrays
from complex_materials_renderer_tpu.render.integrator import render_beauty
from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.kernels import megakernel as tmk
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.ops.camera import make_camera
from complex_materials_renderer_tpu_torch.render import megarender as tmr
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays

from helpers import assemble, fixture_camera, fixture_lights, make_test_scene
from test_torch_support import load_jax_megarender

torch.set_num_threads(1)

KW = dict(max_depth=8, rr_depth=4, nee_max_media=4)
SPP = 4
_JAX_IMAGES: dict = {}


def _jax_image(rng, res):
    key = (rng, res)
    if key not in _JAX_IMAGES:
        tris, mats, media = make_test_scene()
        scene, bvh = assemble(tris, mats, media)
        _JAX_IMAGES[key] = np.asarray(render_beauty(
            fixture_camera(), scene, bvh, fixture_lights(), res, SPP, rng_mode=rng, **KW))
    return _JAX_IMAGES[key]


def _port_objects(width=8):
    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, media, 1.0, 1, device="cpu")
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=width), "cpu")
    camera = make_camera((0.0, 1.5, 5.0), (0.0, 1.0, 0.0), 36.0)
    lights = make_lights((2.0, 4.0, 3.0), (0.8, 0.8, 0.6), 100.0)
    return camera, scene, grid, lights


def _check(img, ref, max_flips):
    img = np.asarray(img, np.float64)
    diff = np.abs(img - ref).max(-1)
    flips = int((diff > 1e-2).sum())
    assert flips <= max_flips, flips
    keep = diff <= 1e-2
    np.testing.assert_allclose(img[keep], ref[keep], atol=1e-5)
    assert np.isfinite(img).all() and img.mean() > 0


@pytest.mark.parametrize("rng", ["parity", "counter", "ld"])
@pytest.mark.parametrize("schedule_mode", ["all", "hybrid", "off"])
def test_mega_pass_matches_wavefront(rng, schedule_mode):
    res = (16, 16)
    before = tmk.trace_paths_mega.launches
    img = tmr.render_beauty_mega(*_port_objects(), res, SPP, rng_mode=rng,
                                 schedule_mode=schedule_mode, **KW)
    assert tmk.trace_paths_mega.launches == before  # the CPU runs no kernel
    assert tuple(img.shape) == (16, 16, 3) and img.dtype == torch.float32
    _check(img.numpy(), _jax_image(rng, res), max_flips=2)


@pytest.mark.parametrize("rng", ["parity", "counter"])
def test_static_schedule_two_widths(rng):
    # 64x32 = 2048 lanes: the static schedule shrinks 2048 -> 1024 lanes
    # with a compaction between the phases.
    res = (64, 32)
    assert len(tmr._phase_schedule(2048, KW["max_depth"])) == 2
    img = tmr.render_beauty_mega(*_port_objects(), res, SPP, rng_mode=rng,
                                 schedule_mode="off", **KW)
    _check(img.numpy(), _jax_image(rng, res), max_flips=2 * 8)


def test_parity_rng_carry_and_offsets():
    """Two 2-sample chunks carrying the parity stream equal one 4-sample
    pass; a tile placed by row_offset equals that band of the full frame."""
    objs = _port_objects()
    full, rng_full = tmr.render_beauty_mega(*objs, (16, 16), 4, return_rng=True, **KW)
    a, rng_a = tmr.render_beauty_mega(*objs, (16, 16), 2, return_rng=True, **KW)
    b, rng_b = tmr.render_beauty_mega(*objs, (16, 16), 2, rng_state=rng_a, return_rng=True,
                                      sample_offset=2, **KW)
    np.testing.assert_allclose(((a + b) / 2).numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_array_equal(rng_b.numpy(), rng_full.numpy())
    band = tmr.render_beauty_mega(*objs, (16, 8), 4, row_offset=8, full_resolution=(16, 16), **KW)
    np.testing.assert_allclose(band.numpy(), full[8:].numpy(), atol=1e-6)


@pytest.mark.parametrize("rng", ["parity", "counter", "ld"])
def test_first_pass_state_is_the_first_kernel_input(rng, monkeypatch):
    """first_pass_state builds the state and ld base of the pass's first
    kernel call, as render_beauty_mega does."""

    class Stop(Exception):
        pass

    seen = []

    def first_call(grid, media9, misc, state, **kw):
        # The pass plan gives K1 its ld base in the pass control block.
        seen.append((tmk.MegaState(*(x.clone() for x in state)), int(kw["ctrl"][1])))
        raise Stop

    objs = _port_objects()
    monkeypatch.setattr(tmr, "trace_paths_mega", first_call)
    with pytest.raises(Stop):
        tmr.render_beauty_mega(*objs, (64, 32), SPP, rng_mode=rng, schedule_mode="off",
                               full_resolution=(64, 64), **KW)
    state, dim0 = tmr.first_pass_state(objs[0], (64, 32), SPP, rng, full_resolution=(64, 64))
    want, want_dim0 = seen[0]
    assert dim0 == want_dim0 == (2 if rng == "ld" else 0)
    for name, x, y in zip(tmk.MegaState._fields, state, want):
        assert torch.equal(x, y), name


def test_debug_knob_refused():
    """CMR_MEGA_DEBUG is ported: 'ordered' (the nearest-first walk, exact)
    renders the default image; an unknown token is refused."""
    ref = tmr.render_beauty_mega(*_port_objects(), (8, 8), 1, **KW)
    img = tmr.render_beauty_mega(*_port_objects(), (8, 8), 1, debug="ordered", **KW)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="unknown CMR_MEGA_DEBUG token"):
        tmr.render_beauty_mega(*_port_objects(), (8, 8), 1, debug="ordred", **KW)


@pytest.fixture(scope="module")
def jmr():
    return load_jax_megarender()


def test_private_loader_leaves_sys_modules(jmr):
    import sys

    assert jmr.STEP_LANES == tmr.STEP_LANES
    assert "complex_materials_renderer_tpu.render._megarender_private" not in sys.modules


@pytest.mark.parametrize("w,h", [(32, 32), (64, 48), (17, 9), (100, 33), (512, 128)])
def test_tile_perm_matches(jmr, w, h):
    pa, ia = jmr._tile_perm(w, h)
    pb, ib = tmr._tile_perm(w, h)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("rp,max_depth,schedule", [
    (65536, 32, ""), (2048, 8, ""), (1024, 32, ""), (7 * 1024, 16, ""),
    (65536, 32, "1:2,4:3,16:1"), (4096, 32, "2:1,2:1,8:5"),
])
def test_phase_schedule_matches(jmr, rp, max_depth, schedule):
    assert jmr._phase_schedule(rp, max_depth, schedule) == tmr._phase_schedule(rp, max_depth, schedule)


def test_resolve_dynamic_matches(jmr):
    class G:
        def __init__(self, c):
            self.num_clusters = c

    for mode in ("auto", "1", "all", "hybrid", "off"):
        for c in (12, 128, 129, 5000):
            assert jmr._resolve_dynamic(mode, G(c)) == tmr._resolve_dynamic(mode, G(c))


@pytest.mark.parametrize("sortkey", ["dir", "pos"])
def test_partition_live_matches(jmr, sortkey):
    rs = np.random.default_rng(21)
    r = 4096
    tris, mats, media = make_test_scene()
    jscene = jax_scene_arrays(tris, mats, media, 1.0, 1)
    _, tscene, _, _ = _port_objects()
    f = dict(
        org=rs.uniform(-12, 12, (r, 3)).astype(np.float32),
        dir=rs.normal(size=(r, 3)).astype(np.float32),
        thr=rs.random((r, 3)).astype(np.float32),
        rad=rs.random((r, 3)).astype(np.float32),
        rng=rs.integers(0, 2**32, r, dtype=np.uint32),
        depth=rs.integers(0, 9, r).astype(np.int32),
        alive=rs.random(r) < 0.4,
        aux=rs.integers(0, 2**32, r, dtype=np.uint32),
    )
    f["org"][:64] = f["org"][64:128]  # equal keys: the sort must be stable
    f["dir"][:64] = f["dir"][64:128]
    lane = np.arange(r, dtype=np.int32)
    js, jl = jmr._partition_live(jmk.MegaState(**{k: jnp.asarray(v) for k, v in f.items()}),
                                 jnp.asarray(lane), jscene, sortkey)
    ts, tl = tmr._partition_live(tmk.from_jax_arrays(**f), torch.from_numpy(lane.astype(np.int64)),
                                 tscene, sortkey)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    for name in ("org", "dir", "rad", "depth", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)), getattr(ts, name).numpy())
