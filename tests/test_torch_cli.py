"""The port's Renderer and CLI on the CPU: the hermetic goldens pass the
flip-budgeted gate of bench.py (non-flip RMSE <= 1e-3, at most 24 pixels
with |diff| > 1e-2) through the megakernel engine and through the
wavefront engine on both backends, chunked and checkpointed renders equal
a monolithic one, ``python -m complex_materials_renderer_tpu_torch``
writes a readable .hdr (also through the binned and pair engines), and the
paths that are not ported yet refuse to run."""

import dataclasses
import json
import os
import subprocess
import sys

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


@pytest.mark.parametrize("name", ["isobox", "gembox"])
def test_golden_gate(name):
    img, ref = _golden_render(name, 2)
    assert img.shape == ref.shape and img.dtype == np.float32
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


@pytest.mark.parametrize("name,spp,backend", [
    ("isobox", 2, "bvh"), ("isobox", 2, "cluster"), ("gembox", 2, "cluster"),
    ("showcase", 4, "cluster"),
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
    img, ref = _golden_render(name, spp, engine=engine)
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


@pytest.mark.slow
def test_showcase_gate_golden():
    img, ref = _golden_render("showcase", 32, "showcase_gate")
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


def _isobox(**kw):
    obj = os.path.join(REPO, "scenes", "isobox.obj")
    base = dict(width=24, height=20, num_samples=4, shard="none", device="cpu")
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
    (dict(spp_mode="adaptive", rng="counter"), "item 11"),
    (dict(spp_mode="adaptive", rng="ld", engine="wavefront"), "item 11"),
    (dict(spp_mode="adaptive", rng="counter", engine="binned"), "item 11"),
    (dict(spp_mode="adaptive", rng="ld", engine="pair"), "item 11"),
])
def test_unported_paths_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        _isobox(**kw).render()


def test_unported_backend_and_debug_raise(monkeypatch):
    """The megakernel family needs the cluster grid (renderer.py:632-633
    of the JAX package); an unknown backend is refused; the TPU timing
    ablations are not ported."""
    for engine in ("mega", "binned", "pair"):
        with pytest.raises(ValueError, match="requires --backend cluster"):
            _isobox(backend="bvh", engine=engine).render()
    with pytest.raises(ValueError, match="backend"):
        _isobox(backend="kd-tree")
    monkeypatch.setenv("CMR_MEGA_DEBUG", "ordered")
    with pytest.raises(NotImplementedError, match="CMR_MEGA_DEBUG"):
        _isobox().render()


def test_engine_auto_resolution():
    """auto: the megakernel on the cluster grid, the wavefront loop on the
    BVH; the BVH backend builds a threaded BVH."""
    from complex_materials_renderer_tpu_torch.kernels.traverse import DeviceBVH

    assert _isobox()._resolve_engine() == "mega"
    r = _isobox(backend="bvh")
    assert isinstance(r.accel, DeviceBVH) and r._resolve_engine() == "wavefront"
    assert _isobox(engine="wavefront")._resolve_engine() == "wavefront"


@pytest.mark.parametrize("flags", [
    ["--engine", "wavefront", "--backend", "bvh"],
    ["--engine", "wavefront"],
    ["--aov", "normal", "--backend", "bvh"],
    ["--aov", "topology"],
    ["--engine", "binned"],
    ["--engine", "pair"],
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
