"""The port's adaptive sampling (``--spp-mode adaptive``) on the CPU,
mirroring tests/test_adaptive.py:

- ``render_samples_mega`` (render/megarender.py), the per-lane entry
  point: at exactly the uniform (pixel, sample) pairs, averaged per
  pixel, it is ``render_beauty_mega`` bit for bit on the mega, binned and
  pair engines; against the JAX function (a private copy of the JAX
  megarender, ROADMAP R1) it agrees within atol 1e-5 on all but at most 2
  flip lanes of 128, the tolerance of tests/test_torch_render.py; invalid
  lanes are 0 and parity is refused;
- ``Renderer.render_adaptive``, the allocation: with ``render_samples_mega``
  replaced in both packages by one numpy function of (pixel, sample), the
  port issues the JAX package's lanes call for call, takes the same
  snapshots and returns the same image, byte for byte; end to end it
  spends the exact budget with every pixel sampled;
- the guards, in the JAX package's order with its exception types.
"""

import dataclasses
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.accel.clusters import build_clusters as jax_build_clusters
from complex_materials_renderer_tpu.config import RenderOptions as JaxOptions
from complex_materials_renderer_tpu.kernels.pallas_trace import device_cluster_grid as jax_grid
from complex_materials_renderer_tpu.render.hitinfo import make_scene_arrays as jax_scene_arrays
from complex_materials_renderer_tpu.renderer import Renderer as JaxRenderer
from complex_materials_renderer_tpu.scene.scene import Scene as JaxScene
from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions, parse_argv
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.render import megarender as tmr
from complex_materials_renderer_tpu_torch.render.hitinfo import make_scene_arrays
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene.medium import MediaTable
from complex_materials_renderer_tpu_torch.scene.scene import Scene

from helpers import fixture_camera, fixture_lights, make_test_scene
from test_torch_render import _check
from test_torch_support import load_jax_megarender, port_camera, port_lights

torch.set_num_threads(1)

KW = dict(max_depth=4, rr_depth=2, nee_max_media=1)
JAX_MEGARENDER = "complex_materials_renderer_tpu.render.megarender"


@pytest.fixture(scope="module")
def port_objs():
    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, MediaTable(*media), 1.0, 1, device="cpu")
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8), "cpu")
    return port_camera(), scene, grid, port_lights()


def _uniform_lanes(w, h, spp):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    return np.repeat(pix, spp, axis=0), np.tile(np.arange(spp, dtype=np.int64), w * h)


@pytest.mark.parametrize("engine,res", [("mega", 8), ("binned", 4), ("pair", 4)])
@pytest.mark.parametrize("rng_mode", ["counter", "ld"])
def test_render_samples_matches_uniform(port_objs, engine, res, rng_mode):
    """A lane list of exactly the uniform (pixel, sample) pairs reproduces
    render_beauty_mega bit for bit: the streams are keyed by (pixel,
    sample), not by lane position."""
    img = tmr.render_beauty_mega(*port_objs, (res, res), 2, rng_mode=rng_mode,
                                 trace_engine=engine, **KW).numpy()
    pix, sidx = _uniform_lanes(res, res, 2)
    rad = tmr.render_samples_mega(*port_objs, torch.from_numpy(pix), torch.from_numpy(sidx),
                                  torch.ones(len(sidx), dtype=torch.bool), (res, res),
                                  rng_mode=rng_mode, trace_engine=engine, **KW)
    assert tuple(rad.shape) == (len(sidx), 3) and rad.dtype == torch.float32
    per_px = rad.numpy().reshape(res * res, 2, 3).mean(1).reshape(res, res, 3)
    np.testing.assert_array_equal(per_px, img)


@pytest.mark.parametrize("rng_mode", ["counter", "ld"])
def test_render_samples_waves_match_uniform(port_objs, rng_mode):
    """The loop over waves: 36 x 30 @ 2 = 2,160 lanes in waves of 1,024
    lanes (three waves, the last one 112 lanes padded to a block) give
    render_beauty_mega's image bit for bit, and each lane's radiance is
    that of one wave of every lane."""
    w, h = 36, 30
    img = tmr.render_beauty_mega(*port_objs, (w, h), 2, rng_mode=rng_mode, **KW).numpy()
    pix, sidx = map(torch.from_numpy, _uniform_lanes(w, h, 2))
    val = torch.ones(len(sidx), dtype=torch.bool)
    waves = tmr.render_samples_mega(*port_objs, pix, sidx, val, (w, h), rng_mode=rng_mode,
                                    chunk_lanes=1024, **KW)
    one = tmr.render_samples_mega(*port_objs, pix, sidx, val, (w, h), rng_mode=rng_mode, **KW)
    np.testing.assert_array_equal(waves.numpy(), one.numpy())
    per_px = waves.numpy().reshape(w * h, 2, 3).mean(1).reshape(h, w, 3)
    np.testing.assert_array_equal(per_px, img)


@pytest.mark.parametrize("rng_mode", ["counter", "ld"])
def test_render_samples_matches_jax(port_objs, rng_mode):
    """The same 128 random lanes (pixels of an 8x8 frame, sample indices
    up to 2^31) through the JAX render_samples_mega (its megakernel
    interpreted) and the port's."""
    rs = np.random.default_rng(7)
    pix = rs.integers(0, 8, (128, 2)).astype(np.int32)
    sidx = rs.integers(0, 2**31, 128).astype(np.uint32)
    tris, mats, media = make_test_scene()
    jmr = load_jax_megarender()
    ref = np.asarray(jmr.render_samples_mega(
        fixture_camera(), jax_scene_arrays(tris, mats, media, 1.0, 1),
        jax_grid(jax_build_clusters(tris, mats, cluster_size=8)), fixture_lights(),
        jnp.asarray(pix), jnp.asarray(sidx), jnp.ones(128, bool), (8, 8),
        rng_mode=rng_mode, **KW))
    rad = tmr.render_samples_mega(*port_objs, torch.from_numpy(pix),
                                  torch.from_numpy(sidx.astype(np.int64)),
                                  torch.ones(128, dtype=torch.bool), (8, 8), rng_mode=rng_mode,
                                  **KW).numpy()
    # _check's per-pixel gate, here per lane: 128 lanes as a 16 x 8 image.
    _check(rad.reshape(16, 8, 3), ref.reshape(16, 8, 3).astype(np.float64), max_flips=2)


def test_render_samples_invalid_lanes_and_parity(port_objs):
    pix = torch.tensor([[4, 4]] * 8, dtype=torch.int32)
    sidx = torch.arange(8, dtype=torch.int64)
    val = torch.tensor([True, False] * 4)
    rad = tmr.render_samples_mega(*port_objs, pix, sidx, val, (8, 8), **KW).numpy()
    assert np.all(rad[~val.numpy()] == 0.0) and np.isfinite(rad).all()
    # The valid lanes are those of an all-valid call.
    full = tmr.render_samples_mega(*port_objs, pix, sidx, torch.ones(8, dtype=torch.bool), (8, 8),
                                   **KW).numpy()
    np.testing.assert_array_equal(rad[val.numpy()], full[val.numpy()])
    with pytest.raises(ValueError, match="stateless"):
        tmr.render_samples_mega(*port_objs, pix, sidx, val, (8, 8), rng_mode="parity")


def _opts(cls, **over):
    """The adaptive options of tests/test_adaptive.py for either package."""
    kw = dict(width=8, height=8, num_samples=4, rng="counter", shard="none", backend="cluster",
              engine="mega", spp_mode="adaptive", cluster_size=8, camera_pos=(0.0, 1.5, 5.0),
              camera_look_at=(0.0, 1.0, 0.0), camera_fov=36.0, scale=1.0, **KW)
    if cls is RenderOptions:
        kw["device"] = "cpu"
    kw.update(over)
    return cls(**kw)


def _port_renderer(**over):
    tris, mats, media = make_test_scene()
    opt = _opts(RenderOptions, **over)
    return Renderer(Scene(tris, mats, MediaTable(*media), opt, []), opt)


def _jax_renderer(**over):
    tris, mats, media = make_test_scene()
    opt = _opts(JaxOptions, **over)
    return JaxRenderer(JaxScene(tris, mats, media, opt, []), opt)


def _radiance(pix, sidx):
    """Stand-in radiance: a deterministic numpy function of (pixel, sample),
    noisier at the frame's right (so the allocation moves lanes there)."""
    x = pix[:, 0].astype(np.float64)
    y = pix[:, 1].astype(np.float64)
    s = sidx.astype(np.float64)
    h = np.sin(x * 12.9898 + y * 78.233 + s * 0.61803) * 43758.5453
    noise = h - np.floor(h)
    return (0.2 + 0.05 * y[:, None] + (1.0 + x[:, None]) * noise[:, None]
            * np.array([1.0, 0.7, 0.4])).astype(np.float32)


@pytest.mark.parametrize("w,h,spp", [(8, 8, 4), (12, 10, 7), (16, 16, 64)])
@pytest.mark.parametrize("sample_base", [0, 1000])
def test_allocation_matches_jax(monkeypatch, w, h, spp, sample_base):
    """With render_samples_mega replaced by one numpy function in both
    packages, the port's allocation is the JAX package's: every call's
    lanes, the snapshots and the image are equal, byte for byte."""
    calls = {"jax": [], "port": []}

    def jax_stub(camera, scene, grid, lights, pixel_xy, sample_idx, valid, full_resolution,
                 **kw):
        pix, sidx, val = np.asarray(pixel_xy), np.asarray(sample_idx), np.asarray(valid)
        calls["jax"].append((pix, sidx.astype(np.int64), val, tuple(full_resolution)))
        return jnp.asarray(_radiance(pix, sidx))

    def port_stub(camera, scene, grid, lights, pixel_xy, sample_idx, valid, full_resolution,
                  **kw):
        pix, sidx, val = pixel_xy.numpy(), sample_idx.numpy(), valid.numpy()
        calls["port"].append((pix, sidx, val, tuple(full_resolution)))
        return torch.from_numpy(_radiance(pix, sidx.astype(np.uint32)))

    stub = types.ModuleType(JAX_MEGARENDER)
    stub._tile_perm = load_jax_megarender()._tile_perm
    stub.render_samples_mega = jax_stub
    monkeypatch.setitem(sys.modules, JAX_MEGARENDER, stub)
    monkeypatch.setattr(tmr, "render_samples_mega", port_stub)

    snaps = {"jax": [], "port": []}
    imgs = {}
    for name, make in (("jax", _jax_renderer), ("port", _port_renderer)):
        r = make(width=w, height=h, num_samples=spp)
        imgs[name] = r.render_adaptive(
            snapshot_cb=lambda avg, f, name=name: snaps[name].append((avg, f().tobytes())),
            sample_base=sample_base)
    monkeypatch.undo()
    assert JAX_MEGARENDER not in sys.modules

    assert len(calls["port"]) == len(calls["jax"]) >= 2
    for a, b in zip(calls["jax"], calls["port"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert snaps["port"] == snaps["jax"]
    assert abs(snaps["port"][-1][0] - spp) < 1e-9
    assert imgs["port"].dtype == imgs["jax"].dtype == np.float32
    assert imgs["port"].tobytes() == imgs["jax"].tobytes()


def test_adaptive_render_budget_and_estimate():
    """End to end: the exact total budget, every count >= 1 (the warmup
    and the uniform floor), a finite image, and a monotone snapshot
    sequence that ends at -s."""
    r = _port_renderer()
    seen = []
    img = r.render_adaptive(snapshot_cb=lambda avg, f: seen.append(avg))
    assert img.shape == (8, 8, 3) and img.dtype == np.float32
    assert np.isfinite(img).all() and img.mean() > 0
    assert int(r.sample_counts.sum()) == 8 * 8 * 4
    assert int(r.sample_counts.min()) >= 1
    assert seen == sorted(seen) and abs(seen[-1] - 4) < 1e-9


def test_adaptive_snapshot_stops_early():
    r = _port_renderer(num_samples=64)
    seen = []
    r.render_adaptive(snapshot_cb=lambda avg, f: seen.append(avg) or len(seen) == 2)
    assert len(seen) == 2 and int(r.sample_counts.sum()) == int(seen[-1] * 64)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares whatever is raised
        return type(e), str(e)
    return None


@pytest.mark.parametrize("over,word", [
    (dict(checkpoint="ck.npz", rng="parity", engine="wavefront"), "checkpoint"),
    (dict(rng="parity", engine="wavefront", shard="auto"), "stateless"),
    (dict(rng="ld", engine="wavefront", shard="auto"), "mega"),
    (dict(shard="auto"), "single-device"),
])
def test_adaptive_option_guards(monkeypatch, tmp_path, over, word):
    """Each guard raises what the JAX package raises, in its order:
    --checkpoint, then parity, then an engine outside the mega family,
    then --shard auto over several devices (the JAX suite's 8 virtual
    devices; 8 CPU shards patched in for the port)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(Renderer, "_shard_devices", lambda self: [torch.device("cpu")] * 8)
    want = _error(lambda: _jax_renderer(**over).render())
    got = _error(lambda: _port_renderer(**over).render())
    assert want is not None and want[0] is ValueError
    assert got == want
    assert word in got[1]


def test_adaptive_renders_through_render(monkeypatch):
    """--spp-mode adaptive goes through Renderer.render to render_adaptive."""
    seen = []
    real = Renderer.render_adaptive

    def spy(self, *a, **k):
        seen.append(self.options.spp_mode)
        return real(self, *a, **k)

    monkeypatch.setattr(Renderer, "render_adaptive", spy)
    img = _port_renderer(engine="pair", rng="ld", width=4, height=4, num_samples=2).render()
    assert seen == ["adaptive"] and img.shape == (4, 4, 3) and np.isfinite(img).all()


def test_spp_mode_cli_parse():
    opt = parse_argv(["--spp-mode", "adaptive", "--device", "cpu"])
    assert opt.spp_mode == "adaptive"
    with pytest.raises(ValueError):
        parse_argv(["--spp-mode", "bogus"])
    assert dataclasses.replace(opt).spp_mode == "adaptive"
