"""The port's AOV passes (render/aov.py) against the JAX package's
``render_aov``: depth, normal and topology on the helpers scene, on the
BVH backend and on the cluster backend (the JAX K3 interpreted, the
port's K3 plain version), and through ``Renderer`` with ``--aov``.

Tolerance: the miss mask (sky pixels) equal; depth and normal within
atol 1e-6 + rtol 1e-6; topology within atol 5e-6 (barycentrics carry the
ulp differences of XLA's FMA contraction through 1/det)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.render.aov import render_aov as jax_render_aov
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.render.aov import render_aov
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import load_scene

from helpers import fixture_camera, make_test_scene
from test_torch_support import port_camera, scene_accels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(depth=1e-6, normal=1e-6, topology=5e-6)


def _check(img, ref, kind):
    assert img.shape == ref.shape and img.dtype == np.float32
    sky = np.all(ref == np.float32([0.0, 0.0, 0.5]), axis=-1)
    if kind != "depth":
        np.testing.assert_array_equal(np.all(img == np.float32([0.0, 0.0, 0.5]), axis=-1), sky)
    np.testing.assert_allclose(img, ref, atol=TOL[kind], rtol=1e-6)


@pytest.mark.parametrize("backend", ["bvh", "cluster"])
@pytest.mark.parametrize("kind", ["depth", "normal", "topology"])
def test_render_aov_matches(backend, kind):
    tris, mats, media = make_test_scene()
    _, jacc, _, tacc = scene_accels(tris, mats, media, backend)
    img = render_aov(tris, port_camera(), tacc, (24, 20), kind).numpy()
    ref = np.asarray(jax_render_aov(jnp.asarray(tris), fixture_camera(), jacc, (24, 20), kind))
    _check(img, ref, kind)
    sky = np.all(ref == np.float32([0.0, 0.0, 0.5]), axis=-1)
    assert 0 < sky.sum() < sky.size or kind == "depth"


def test_unknown_aov_kind_raises():
    tris, mats, media = make_test_scene()
    _, _, _, tacc = scene_accels(tris, mats, media, "bvh")
    with pytest.raises(ValueError, match="unknown AOV"):
        render_aov(tris, port_camera(), tacc, (8, 8), "albedo")


@pytest.mark.parametrize("backend", ["bvh", "cluster"])
def test_renderer_aov_matches_jax_renderer(backend):
    """``--aov`` through both packages' Renderer on isobox (the JAX one on
    its BVH backend; the port's cluster grid is built without quads)."""
    from complex_materials_renderer_tpu.config import RenderOptions as JaxOptions
    from complex_materials_renderer_tpu.renderer import Renderer as JaxRenderer
    from complex_materials_renderer_tpu.scene import load_scene as jax_load_scene

    obj = os.path.join(REPO, "scenes", "isobox.obj")
    for kind in ("depth", "normal", "topology"):
        kw = dict(width=32, height=24, num_samples=1, aov=kind)
        scene = load_scene(obj, RenderOptions(obj_path=obj, device="cpu", backend=backend, **kw))
        r = Renderer(scene, dataclasses.replace(scene.options, device="cpu", backend=backend, **kw))
        if backend == "cluster":
            assert bool((r.accel.qa == 0.5).all())  # quads off for AOVs
        img = r.render()
        jscene = jax_load_scene(obj, JaxOptions(obj_path=obj, backend="bvh", **kw))
        ref = JaxRenderer(jscene, dataclasses.replace(jscene.options, backend="bvh", **kw)).render()
        _check(img, np.asarray(ref), kind)
