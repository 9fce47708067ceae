"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points refuse to run without a card unless the CPU is asked for."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys

def banned(name):
    return (name == "jax" or name.startswith("jax.") or name.startswith("jaxlib")
            or name == "complex_materials_renderer_tpu"
            or name.startswith("complex_materials_renderer_tpu."))

# Whatever the interpreter preloaded is dropped, and any later import of a
# banned module raises, so an indirect import cannot hide behind a cache.
for name in [m for m in sys.modules if banned(m)]:
    del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())

import complex_materials_renderer_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if info.name.endswith("__main__"):
        continue
    importlib.import_module(info.name)
    names.append(info.name)
left = sorted(m for m in sys.modules if banned(m))
assert not left, left
for name in ("render.integrator", "render.aov", "kernels.traverse", "kernels.cluster_trace",
             "kernels.intersect", "accel.bvh", "ops.fresnel", "ops.phase", "ops.diffuse",
             "ops.medium", "kernels.binned_trace", "kernels.pairsweep", "render.binnedrender",
             "render.pairrender", "parallel", "parallel.sharding", "parallel.multihost",
             "tools", "tools.compare", "tools.goldens", "tools.make_scenes",
             "tools.make_showcase", "tools.mat_parser", "native"):
    assert f"{pkg.__name__}.{name}" in names, name
print(len(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    # Every module of the port was imported, the wavefront, binned and pair
    # engines, the AOVs, the BVH backend, the wrappers of the closest-hit,
    # listing, round and sweep kernels, the sharding and multi-process
    # modules, the tools and the host library's bindings among them.
    assert int(proc.stdout.split()[-1]) >= 52


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_renderer_raises_without_card(monkeypatch):
    from complex_materials_renderer_tpu_torch.config import RenderOptions
    from complex_materials_renderer_tpu_torch.renderer import Renderer
    from complex_materials_renderer_tpu_torch.scene import load_scene

    _no_card(monkeypatch)
    opt = RenderOptions(width=8, height=8, num_samples=1)
    scene = load_scene(os.path.join(REPO, "scenes", "isobox.obj"), opt)
    assert scene.options.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(scene, scene.options)
    # Asked for explicitly, the CPU works.
    assert Renderer(scene, scene.options, device="cpu").device.type == "cpu"


def test_cli_raises_without_card(monkeypatch, tmp_path):
    from complex_materials_renderer_tpu_torch.cli import main

    _no_card(monkeypatch)
    obj = os.path.join(REPO, "scenes", "isobox.obj")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([obj, "-s", "1", "--width", "8", "--height", "8", "-o", str(tmp_path / "x")])


def test_grid_and_camera_default_to_cuda(monkeypatch):
    from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
    from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
    from complex_materials_renderer_tpu_torch.utils.device import resolve_device

    _no_card(monkeypatch)
    tris = torch.rand(4, 3, 3, generator=torch.Generator().manual_seed(0)).numpy()
    host = build_clusters(tris, [0, 0, 0, 0], cluster_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_cluster_grid(host)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert device_cluster_grid(host, "cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")
