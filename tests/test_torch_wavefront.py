"""Whole wavefront renders of the port (render/integrator.py
``render_beauty``) against the JAX package's on the helpers scene, on
both backends, in the parity, counter and ld RNG modes and with
``tir='kill'`` + ``direct='analytic'``. The JAX cluster backend runs its
Pallas kernel K3 interpreted on the CPU; the port's runs K3's plain
version.

Tolerance: atol 1e-5 per pixel except flip pixels (|diff| > 1e-2: one
sample's path decision resolved the other way by a last-ulp difference),
at most 2 of 256."""

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.render import integrator as jint
from complex_materials_renderer_tpu_torch.render import integrator as tint

from helpers import fixture_camera, fixture_lights, make_test_scene
from test_torch_support import check_image, port_camera, port_lights, scene_accels

torch.set_num_threads(1)

KW = dict(max_depth=8, rr_depth=4, nee_max_media=4)


@pytest.mark.parametrize("backend", ["bvh", "cluster"])
@pytest.mark.parametrize("rng_mode,opts", [
    ("parity", {}),
    ("counter", {}),
    ("ld", {}),
    ("parity", dict(tir="kill", direct="analytic")),
])
def test_render_beauty_matches(backend, rng_mode, opts):
    res, spp = (16, 16), 4
    tris, mats, media = make_test_scene()
    jscene, jacc, tscene, tacc = scene_accels(tris, mats, media, backend)
    img = tint.render_beauty(port_camera(), tscene, tacc, port_lights(), res, spp,
                             rng_mode=rng_mode, **KW, **opts)
    assert tuple(img.shape) == (16, 16, 3) and img.dtype == torch.float32
    ref = np.asarray(jint.render_beauty(fixture_camera(), jscene, jacc, fixture_lights(), res,
                                        spp, rng_mode=rng_mode, **KW, **opts))
    check_image(img.numpy(), ref, max_flips=2)
