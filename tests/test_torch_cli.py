"""The port's Renderer and CLI on the CPU: the hermetic goldens pass the
flip-budgeted gate of bench.py (non-flip RMSE <= 1e-3, at most 24 pixels
with |diff| > 1e-2) through the megakernel engine and through the
wavefront engine on both backends, chunked and checkpointed renders equal
a monolithic one, ``python -m complex_materials_renderer_tpu_torch``
writes a readable .hdr (also through the binned and pair engines) and on
the CPU with default flags passes the gate against the JAX package's CLI,
``auto`` picks as the JAX package does, and ``--spp-mode adaptive``
renders through the mega-family engines and refuses the others."""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch import renderer as trenderer
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.io import read_hdr
from complex_materials_renderer_tpu_torch.render import megarender as tmr
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import load_scene

from test_torch_support import flip_gate

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLIP_BUDGET = 24


def _golden_render(name, spp, golden_name=None, **extra):
    obj = os.path.join(REPO, "scenes", f"{name}.obj")
    kw = dict(width=64, height=64, num_samples=spp, shard="none", rng="parity", device="cpu",
              **extra)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **kw))
    img = Renderer(scene, dataclasses.replace(scene.options, **kw)).render()
    with np.load(os.path.join(REPO, "tests", "golden", f"{golden_name or name}.npz")) as z:
        ref = np.asarray(z["img"], np.float32)
    return img, ref


@pytest.mark.parametrize("name", ["isobox", "gembox", "vessel"])
def test_golden_gate(name):
    img, ref = _golden_render(name, 2, backend="cluster", engine="mega")
    assert img.shape == ref.shape and img.dtype == np.float32
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


@pytest.mark.parametrize("name,spp,backend", [
    ("isobox", 2, "bvh"), ("isobox", 2, "cluster"), ("gembox", 2, "cluster"),
    ("vessel", 2, "cluster"), ("showcase", 4, "cluster"),
])
def test_wavefront_golden_gate(name, spp, backend):
    """The goldens were rendered by the JAX wavefront engine on its BVH
    backend: the port's wavefront engine passes the same gate on both."""
    img, ref = _golden_render(name, spp, engine="wavefront", backend=backend)
    assert img.shape == ref.shape and img.dtype == np.float32
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


@pytest.mark.parametrize("name,spp,engine", [
    ("isobox", 2, "binned"), ("isobox", 2, "pair"), ("gembox", 2, "binned"),
    ("gembox", 2, "pair"),
])
def test_binned_pair_golden_gate(name, spp, engine):
    """The binned and pair engines share the wavefront's physics and RNG
    streams: they pass the same gate."""
    img, ref = _golden_render(name, spp, engine=engine, backend="cluster")
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


@pytest.mark.slow
def test_showcase_gate_golden():
    img, ref = _golden_render("showcase", 32, "showcase_gate", backend="cluster", engine="mega")
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


def _isobox(**kw):
    obj = os.path.join(REPO, "scenes", "isobox.obj")
    # The cluster grid and the megakernel, which ``auto`` takes on the card
    # only.
    base = dict(width=24, height=20, num_samples=4, shard="none", device="cpu",
                backend="cluster", engine="mega")
    base.update(kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **base))
    return Renderer(scene, dataclasses.replace(scene.options, **base))


@pytest.mark.parametrize("rng", ["parity", "counter"])
def test_chunked_equals_monolithic(rng, monkeypatch):
    mono = _isobox(rng=rng, sample_chunk=4).render()
    # Rows in bands of 8 (3 bands of the 20-row frame), samples in 1s.
    monkeypatch.setattr(trenderer, "LANES_PER_PASS", 8 * 24)
    chunked = _isobox(rng=rng, sample_chunk=1).render()
    np.testing.assert_allclose(chunked, mono, atol=1e-6)


def test_wavefront_chunked_and_checkpointed(tmp_path, monkeypatch):
    """The wavefront engine in bands of 8 rows and 1-sample chunks, and
    resumed from a checkpoint, equals its monolithic render."""
    from complex_materials_renderer_tpu_torch.render import integrator

    kw = dict(engine="wavefront")
    mono = _isobox(sample_chunk=4, **kw).render()
    monkeypatch.setattr(trenderer, "LANES_PER_PASS", 8 * 24)
    np.testing.assert_allclose(_isobox(sample_chunk=1, **kw).render(), mono, atol=1e-6)
    ck = str(tmp_path / "render.ckpt.npz")
    real = integrator.render_beauty
    calls = {"n": 0}

    def interrupted(*a, **k):
        calls["n"] += 1
        if calls["n"] == 5:
            raise KeyboardInterrupt
        return real(*a, **k)

    monkeypatch.setattr(integrator, "render_beauty", interrupted)
    with pytest.raises(KeyboardInterrupt):
        _isobox(sample_chunk=1, **kw).render(checkpoint_path=ck)
    monkeypatch.setattr(integrator, "render_beauty", real)
    resumed = _isobox(sample_chunk=1, **kw).render(checkpoint_path=ck)
    assert not os.path.exists(ck)
    np.testing.assert_allclose(resumed, mono, atol=1e-6)


def test_checkpoint_resumes_to_same_image(tmp_path, monkeypatch):
    monkeypatch.setattr(trenderer, "LANES_PER_PASS", 8 * 24)
    mono = _isobox(sample_chunk=1).render()
    ck = str(tmp_path / "render.ckpt.npz")
    calls = {"n": 0}
    real = tmr.render_beauty_mega

    def interrupted(*a, **k):
        calls["n"] += 1
        if calls["n"] == 6:
            raise KeyboardInterrupt
        return real(*a, **k)

    monkeypatch.setattr(tmr, "render_beauty_mega", interrupted)
    with pytest.raises(KeyboardInterrupt):
        _isobox(sample_chunk=1).render(checkpoint_path=ck)
    assert os.path.exists(ck)
    monkeypatch.setattr(tmr, "render_beauty_mega", real)
    resumed = _isobox(sample_chunk=1).render(checkpoint_path=ck)
    assert not os.path.exists(ck)
    np.testing.assert_allclose(resumed, mono, atol=1e-6)
    # A checkpoint of another render is refused.
    monkeypatch.setattr(tmr, "render_beauty_mega", interrupted)
    calls["n"] = 0
    with pytest.raises(KeyboardInterrupt):
        _isobox(sample_chunk=1).render(checkpoint_path=ck)
    monkeypatch.setattr(tmr, "render_beauty_mega", real)
    with pytest.raises(ValueError, match="fingerprint"):
        _isobox(sample_chunk=1, num_samples=3).render(checkpoint_path=ck)


def _write_tiny_scene(tmp_path):
    (tmp_path / "tiny.mtl").write_text("newmtl walls\nKd 0.8 0.8 0.8\nnewmtl goo\nKd 1 1 1\n")
    (tmp_path / "tiny.obj").write_text(
        "mtllib tiny.mtl\nv -5 0 5\nv 5 0 5\nv 5 0 -5\nv -5 0 -5\nusemtl walls\nf 1 2 3 4\n"
        "v -0.5 0.2 0.5\nv 0.5 0.2 0.5\nv 0.0 1.2 0.0\nusemtl goo\nf 5 6 7\n"
    )
    (tmp_path / "tiny.json").write_text(json.dumps({
        "scene": {"camera": [0.0, 1.0, 4.0], "cameraLookAt": [0.0, 0.5, 0.0], "fov": 36.0,
                  "lightPos": [1.0, 3.0, 2.0], "lightColor": [0.8, 0.8, 0.6],
                  "lightIntensity": 60.0, "scale": 1.0},
        "1": {"sigma_s": [0.2, 0.2, 0.2], "sigma_a": [0.05, 0.05, 0.05],
              "g": [0.4, 0.4, 0.4], "ior": 1.2},
    }))
    return str(tmp_path / "tiny.obj")


def test_module_cli_writes_hdr(tmp_path):
    obj = _write_tiny_scene(tmp_path)
    out = str(tmp_path / "render")
    proc = subprocess.run(
        [sys.executable, "-m", "complex_materials_renderer_tpu_torch", obj, "-s", "2",
         "--width", "24", "--height", "16", "-o", out, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert "device=cpu" in proc.stdout
    img = read_hdr(out + ".hdr")
    assert img.shape == (16, 24, 3)
    assert np.isfinite(img).all() and img.max() > 0


def test_cli_main_matches_renderer(tmp_path, monkeypatch):
    from complex_materials_renderer_tpu_torch.cli import main
    from complex_materials_renderer_tpu_torch.io import write_hdr

    obj = _write_tiny_scene(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main([obj, "-s", "2", "--width", "24", "--height", "16", "-o", "a", "--device", "cpu"]) == 0
    opt = RenderOptions(obj_path=obj, num_samples=2, width=24, height=16, device="cpu")
    scene = load_scene(obj, opt)
    write_hdr("b.hdr", Renderer(scene, scene.options).render())
    assert (tmp_path / "a.hdr").read_bytes() == (tmp_path / "b.hdr").read_bytes()


@pytest.mark.parametrize("kw,match", [
    (dict(spp_mode="adaptive", rng="counter"), None),
    (dict(spp_mode="adaptive", rng="ld", engine="wavefront"), "mega"),
    (dict(spp_mode="adaptive", rng="counter", engine="binned"), None),
    (dict(spp_mode="adaptive", rng="ld", engine="pair"), None),
])
def test_unported_paths_raise(kw, match):
    """The paths that raised before adaptive sampling was ported: the
    mega-family engines render with the exact budget, the wavefront
    engine is refused as in the JAX package (renderer.py:449-453)."""
    r = _isobox(width=8, height=8, **kw)
    if match:
        with pytest.raises(ValueError, match=match):
            r.render()
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img = r.render()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0
    assert int(r.sample_counts.sum()) == 8 * 8 * 4 and int(r.sample_counts.min()) >= 1


def test_unported_backend_and_debug_raise(monkeypatch):
    """The megakernel family needs the cluster grid (renderer.py:632-633
    of the JAX package); an unknown backend is refused; the Renderer reads
    CMR_MEGA_DEBUG: 'ordered' renders the default image, 'nonee' another,
    and an unknown token raises."""
    for engine in ("mega", "binned", "pair"):
        with pytest.raises(ValueError, match="requires --backend cluster"):
            _isobox(backend="bvh", engine=engine).render()
    with pytest.raises(ValueError, match="backend"):
        _isobox(backend="kd-tree")
    small = dict(width=8, height=8, num_samples=1)
    ref = _isobox(**small).render()
    monkeypatch.setenv("CMR_MEGA_DEBUG", "ordered")
    np.testing.assert_allclose(_isobox(**small).render(), ref, atol=1e-6)
    monkeypatch.setenv("CMR_MEGA_DEBUG", "nonee")
    assert not np.allclose(_isobox(**small).render(), ref)
    monkeypatch.setenv("CMR_MEGA_DEBUG", "notoken")
    with pytest.raises(ValueError, match="unknown CMR_MEGA_DEBUG token"):
        _isobox(**small).render()


def test_engine_auto_resolution():
    """auto as in the JAX package (renderer.py:92-95, :626-631) with the
    card in the TPU's role: on the CPU the BVH and the wavefront loop; the
    megakernel only on the card with the cluster grid."""
    from complex_materials_renderer_tpu_torch.kernels.cluster_grid import DeviceClusterGrid
    from complex_materials_renderer_tpu_torch.kernels.traverse import DeviceBVH

    r = _isobox(backend="auto", engine="auto")
    assert isinstance(r.accel, DeviceBVH) and r._resolve_engine() == "wavefront"
    r = _isobox(backend="cluster", engine="auto")
    assert isinstance(r.accel, DeviceClusterGrid) and r._resolve_engine() == "wavefront"
    r.device = torch.device("cuda")  # the rule alone; nothing is launched
    assert r._resolve_engine() == "mega"
    r = _isobox(backend="bvh", engine="auto")
    r.device = torch.device("cuda")
    assert r._resolve_engine() == "wavefront"
    assert _isobox(engine="wavefront")._resolve_engine() == "wavefront"
    assert _isobox(engine="mega")._resolve_engine() == "mega"


def test_default_cli_matches_jax_cli(tmp_path, monkeypatch):
    """The port's CLI on the CPU with default flags (the BVH and the
    wavefront loop) against the JAX package's CLI with default flags
    (its BVH and wavefront loop, sharded over the JAX suite's 8 CPU
    devices): the golden gate on the written .hdr files."""
    from complex_materials_renderer_tpu.cli import main as jax_main
    from complex_materials_renderer_tpu_torch.cli import main

    obj = _write_tiny_scene(tmp_path)
    monkeypatch.chdir(tmp_path)
    flags = [obj, "-s", "2", "--width", "24", "--height", "16"]
    assert main(flags + ["-o", "port", "--device", "cpu"]) == 0
    assert jax_main(flags + ["-o", "jax"]) == 0
    img, ref = read_hdr("port.hdr"), read_hdr("jax.hdr")
    assert img.shape == ref.shape == (16, 24, 3)
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= 2, (nonflip, flips)


def test_pass_shaping_reads_environment(tmp_path):
    """CMR_LANES_PER_PASS, CMR_PATHS_PER_PASS and CMR_STEP_LANES (read at
    import, as in the JAX package) reach the pass shape: 8-row bands,
    one-sample chunks and 1,024-lane steps instead of one band, one chunk
    and 3,072 lanes; the image stays the same."""
    code = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from complex_materials_renderer_tpu_torch import renderer
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.render import megarender
from complex_materials_renderer_tpu_torch.scene import load_scene
shapes = []
real = megarender._pass_plan
def spy(*a):
    plan = real(*a)
    shapes.append(plan.sched[0][0])
    return plan
megarender._pass_plan = spy
kw = dict(width=48, height=48, num_samples=2, rng="counter", shard="none", device="cpu",
          backend="cluster", engine="mega")
scene = load_scene("scenes/isobox.obj", RenderOptions(obj_path="scenes/isobox.obj", **kw))
img = renderer.Renderer(scene, scene.options).render()
np.save(sys.argv[1], img)
print(renderer.LANES_PER_PASS, renderer.PATHS_PER_PASS, megarender.STEP_LANES,
      renderer._auto_row_chunk(48), renderer._auto_sample_chunk(48, 48), len(shapes), max(shapes))
"""
    outs = {}
    for name, env in (("default", {}), ("changed", {"CMR_LANES_PER_PASS": str(8 * 48),
                                                   "CMR_PATHS_PER_PASS": str(8 * 48),
                                                   "CMR_STEP_LANES": "1024"})):
        base = {k: v for k, v in os.environ.items() if not k.startswith("CMR_")}
        proc = subprocess.run(
            [sys.executable, "-c", code, str(tmp_path / f"{name}.npy")], cwd=REPO,
            capture_output=True, text=True, env={**base, "PYTHONPATH": REPO, **env},
        )
        assert proc.returncode == 0, proc.stderr
        outs[name] = proc.stdout.split()
    # Defaults: bands of 1,365 rows (one for the 48-row frame), both samples
    # in one call, lanes padded to 3,072.
    assert outs["default"] == ["65536", "1048576", "65536", "1365", "455", "1", "3072"]
    # Changed: six 8-row bands of 384 pixels, one sample a call, 1,024 lanes.
    assert outs["changed"] == ["384", "384", "1024", "8", "1", "12", "1024"]
    np.testing.assert_allclose(np.load(tmp_path / "changed.npy"),
                               np.load(tmp_path / "default.npy"), atol=1e-6)


@pytest.mark.parametrize("flags", [
    ["--engine", "wavefront", "--backend", "bvh"],
    ["--engine", "wavefront", "--backend", "cluster"],
    ["--aov", "normal", "--backend", "bvh"],
    ["--aov", "topology", "--backend", "cluster"],
    ["--engine", "binned", "--backend", "cluster"],
    ["--engine", "pair", "--backend", "cluster"],
])
def test_cli_new_paths_write_hdr(tmp_path, monkeypatch, flags):
    from complex_materials_renderer_tpu_torch.cli import main

    obj = _write_tiny_scene(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main([obj, "-s", "2", "--width", "24", "--height", "16", "-o", "a",
                 "--device", "cpu", *flags]) == 0
    img = read_hdr(str(tmp_path / "a.hdr"))
    assert img.shape == (16, 24, 3) and np.isfinite(img).all() and img.max() > 0


def test_binned_and_pair_engines_resolve_warn_and_read_knobs(monkeypatch):
    """--engine binned|pair run under the megakernel's pass loop with their trace
    engine (renderer.py:303-316 of the JAX package), warn that they are not
    the fast path, and the binned engine reads CMR_BINNED_LIST and
    CMR_BINNED_CAP."""
    seen = []
    real = tmr.render_beauty_mega

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)

    monkeypatch.setattr(tmr, "render_beauty_mega", spy)
    monkeypatch.setenv("CMR_BINNED_LIST", "3")
    monkeypatch.setenv("CMR_BINNED_CAP", "5")
    for engine in ("binned", "pair"):
        r = _isobox(engine=engine, width=8, height=8, num_samples=1)
        with pytest.warns(UserWarning, match="not the fast path"):
            assert r._resolve_engine() == engine
        with pytest.warns(UserWarning):
            img = r.render()
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert [k["trace_engine"] for k in seen] == ["binned", "pair"]
    assert (seen[0]["binned_list"], seen[0]["binned_cap"]) == (3, 5)
    assert "binned_list" not in seen[1]
