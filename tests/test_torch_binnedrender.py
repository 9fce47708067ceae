"""The port's binned and pair engines (render/binnedrender.py,
render/pairrender.py) on the CPU: the K-list march against the JAX one,
and an 8x8 frame through ``render_beauty_mega(trace_engine=...)`` against
the JAX ``render_beauty_mega`` (a private copy of render/megarender.py,
ROADMAP R1) with
the same engine, in parity and counter modes; a 2-slot list with 2
servings a round gives the same image as the default list.

Tolerance of the images: atol 1e-5 per pixel except flip pixels (|diff| >
1e-2: one sample's path decision resolved the other way by a last-ulp
difference), at most 1 of the 64 (the wavefront tests' 2 per 256, rounded
up). The march: atol 1e-6 (exp differs by an ulp between the backends)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.accel.clusters import build_clusters as jax_build_clusters
from complex_materials_renderer_tpu.kernels.pallas_trace import device_cluster_grid
from complex_materials_renderer_tpu.ops.medium import MediaTable as JaxMediaTable
from complex_materials_renderer_tpu.render import binnedrender as jbr
from complex_materials_renderer_tpu.render.hitinfo import make_scene_arrays as jax_scene_arrays
from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.kernels import binned_trace as tbt
from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
from complex_materials_renderer_tpu_torch.kernels import pairsweep as tps
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid as \
    port_device_grid
from complex_materials_renderer_tpu_torch.kernels.megakernel import pack_media
from complex_materials_renderer_tpu_torch.render import binnedrender as tbr
from complex_materials_renderer_tpu_torch.render import megarender as tmr
from complex_materials_renderer_tpu_torch.render.hitinfo import make_scene_arrays
from complex_materials_renderer_tpu_torch.scene.medium import MediaTable

from helpers import fixture_camera, fixture_lights, make_test_scene
from test_torch_support import check_image, load_jax_megarender, port_camera, port_lights

torch.set_num_threads(1)

KW = dict(max_depth=4, rr_depth=2, nee_max_media=2)
RES = (8, 8)
_JAX_IMAGES: dict = {}


def _jax_image(engine, rng):
    key = (engine, rng)
    if key not in _JAX_IMAGES:
        jmr = load_jax_megarender()
        tris, mats, media = make_test_scene()
        scene = jax_scene_arrays(tris, mats, media, 1.0, 1)
        grid = device_cluster_grid(jax_build_clusters(tris, mats, cluster_size=8))
        _JAX_IMAGES[key] = np.asarray(jmr.render_beauty_mega(
            fixture_camera(), scene, grid, fixture_lights(), RES, 2, trace_engine=engine,
            rng_mode=rng, **KW))
    return _JAX_IMAGES[key]


def _port_render(engine, rng="parity", **kw):
    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, MediaTable(*media), 1.0, 1, device="cpu")
    grid = port_device_grid(build_clusters(tris, mats, cluster_size=8), "cpu")
    return tmr.render_beauty_mega(port_camera(), scene, grid, port_lights(), RES, 2,
                                  trace_engine=engine, rng_mode=rng, **KW, **kw)


def test_march_klist_matches_jax():
    rs = np.random.default_rng(3)
    R, K = 512, 6
    ldist = rs.uniform(0.5, 6.0, R).astype(np.float32)
    active = rs.random(R) < 0.8
    eff = np.where(active, ldist, 0.0).astype(np.float32)
    ts = np.sort(rs.uniform(0.0, 7.0, (K, R)), axis=0).astype(np.float32)
    dup = rs.random(R) < 0.3
    ts[1, dup] = ts[0, dup] + np.float32(5e-5)  # a duplicate boundary within T_MIN
    ts = np.where(ts > ldist, eff, ts).astype(np.float32)  # empty slots read eff
    ms = np.where(ts < eff, 0.0, -1.0).astype(np.float32)
    t_opq = np.where(rs.random(R) < 0.3, rs.uniform(0.0, 6.0, R), ldist).astype(np.float32)
    tris, mats, media = make_test_scene()
    want = np.asarray(jbr._march_klist(
        [jnp.asarray(t) for t in ts], [jnp.asarray(m) for m in ms], jnp.asarray(t_opq),
        jnp.asarray(ldist), jnp.asarray(eff), jnp.asarray(active), JaxMediaTable(*media), 1.0))
    T = torch.from_numpy
    got = tbr._march_klist([T(t) for t in ts], [T(m) for m in ms], T(t_opq), T(ldist), T(eff),
                           T(active), MediaTable(*media), 1.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (want == 0).all(-1).sum() > 10 and ((want > 0) & (want < 1)).all(-1).sum() > 10


@pytest.mark.parametrize("engine", ["binned", "pair"])
@pytest.mark.parametrize("rng", ["parity", "counter"])
def test_engine_matches_jax_megarender(engine, rng):
    counts = (tbt.listing.launches, tbt.run_round.launches, tps.sweep.launches,
              ctr.trace_core.launches)
    img = _port_render(engine, rng)
    # The CPU runs the plain versions: no kernel launches.
    assert (tbt.listing.launches, tbt.run_round.launches, tps.sweep.launches,
            ctr.trace_core.launches) == counts
    assert tuple(img.shape) == (8, 8, 3) and img.dtype == torch.float32
    check_image(img.numpy(), _jax_image(engine, rng), max_flips=1)


def test_binned_tight_list_same_image():
    """A 2-slot list with 2 servings a round (relisting in every trace)
    gives the image of the default list (tests/test_binnedrender.py:76)."""
    a = _port_render("binned", binned_list=2, binned_cap=2)
    b = _port_render("binned")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_unknown_trace_engine_raises():
    with pytest.raises(ValueError, match="trace engine"):
        _port_render("wavefront")


@pytest.mark.parametrize("engine", ["binned", "pair"])
def test_engine_matches_port_mega_ld(engine):
    """In ld mode the engines read the pass loop's Sobol dimension base: their
    image is the port megakernel's (plain K1 on the CPU)."""
    check_image(_port_render(engine, "ld").numpy(), _port_render("mega", "ld").numpy(),
                max_flips=1)


def test_pair_closest_modes_agree():
    """``closest_mode='pair'`` (the pair sweep with the shading payload
    derived from the winning slot) against the default block-shared
    closest trace (K3): the same hits and materials, t and the normal of
    the hits within atol 1e-5 (K2's and K3's far-edge epsilons differ by 1e-6 of an
    edge, which no ray of this set straddles)."""
    from complex_materials_renderer_tpu_torch.render.pairrender import make_pair_tracer

    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, MediaTable(*media), 1.0, 1, device="cpu")
    grid = port_device_grid(build_clusters(tris, mats, cluster_size=8), "cpu")
    media9 = pack_media(scene.media, scene.scale)
    rs = np.random.default_rng(8)
    org = torch.from_numpy(rs.uniform(-3, 3, (700, 3)).astype(np.float32))
    org[:, 1] = org[:, 1].abs() + 0.01
    d = torch.from_numpy(rs.normal(size=(700, 3)).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    alive = torch.from_numpy(rs.random(700) < 0.8)
    hits = [make_pair_tracer(grid, scene, port_lights(), media9, 2, closest_mode=m).closest(
        org, d, alive) for m in ("shared", "pair")]
    a, b = hits
    assert torch.equal(a.hit, b.hit) and int(a.hit.sum()) > 100
    assert torch.equal(a.mat_id, b.mat_id)
    # On a miss t is each trace's own bound (pairrender.py:91-114 passes
    # K3 the scene-box clamp); only hits are compared.
    hit = a.hit.numpy()
    np.testing.assert_allclose(b.t.numpy()[hit], a.t.numpy()[hit], atol=1e-5)
    np.testing.assert_allclose(b.normal.numpy()[hit], a.normal.numpy()[hit], atol=1e-5)
    with pytest.raises(ValueError, match="closest_mode"):
        make_pair_tracer(grid, scene, port_lights(), media9, 2, closest_mode="union")
