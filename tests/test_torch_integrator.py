"""The port's wavefront integrator (render/integrator.py) against the JAX
package's, on both backends: the NEE march through 0, 1 and 2 media, one
``_bounce`` step from the same mid-flight ``_State``, the compaction
order, and whole ``render_beauty`` images in the parity, counter and ld
RNG modes, with ``tir='kill'`` and ``direct='analytic'``
(test_torch_wavefront.py).

The JAX cluster backend runs its Pallas kernel K3 interpreted on the CPU
(as tests/test_pallas_trace.py does); the port's runs K3's plain version.

Tolerances:
- march light: rtol 1e-5 + atol 1e-6 (transmittances of float32 exps);
- bounce: rng, depth and alive equal on every lane; floats within atol
  1e-5 (positions carry the ulps of t times the direction);
- images (the two-phase test; the rest are in test_torch_wavefront.py):
  atol 1e-5 per pixel except flip pixels (|diff| > 1e-2: one sample's
  path decision resolved the other way by a last-ulp difference), at
  most 2 of 256."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.render import integrator as jint
from complex_materials_renderer_tpu_torch.render import integrator as tint
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights

from helpers import box_triangles, fixture_camera, fixture_lights, make_test_scene, quad
from test_torch_support import check_image, port_camera, port_lights, scene_accels

torch.set_num_threads(1)

KW = dict(max_depth=8, rr_depth=4, nee_max_media=4)


def _two_media_scene():
    """A floor and two medium boxes stacked toward the light."""
    floor = np.asarray(quad([-10, -8, 10], [10, -8, 10], [10, -8, -10], [-10, -8, -10]), np.float32)
    box_a = box_triangles([0.0, 0.0, 0.0], 1.0)
    box_b = box_triangles([0.0, 0.0, 4.0], 1.0)
    tris = np.concatenate([floor, box_a, box_b]).astype(np.float32)
    mats = np.concatenate([np.full(2, 5, np.int32), np.zeros(len(box_a), np.int32),
                           np.ones(len(box_b), np.int32)])
    media = (np.array([0, 1], np.int32),
             np.array([[0.1, 0.1, 0.1], [0.2, 0.3, 0.2]], np.float32),
             np.array([[0.05, 0.05, 0.05], [0.1, 0.1, 0.2]], np.float32),
             np.zeros((2, 3), np.float32), np.ones(2, np.float32))
    return tris, mats, media


@pytest.mark.parametrize("backend", ["bvh", "cluster"])
@pytest.mark.parametrize("max_media", [1, 4])
def test_sample_direct_light_matches(backend, max_media):
    tris, mats, media = _two_media_scene()
    jscene, jacc, tscene, tacc = scene_accels(tris, mats, media, backend)
    rs = np.random.default_rng(max_media)
    n = 1024
    pos = np.stack([rs.uniform(-1.6, 1.6, n), rs.uniform(-1.6, 1.6, n),
                    rs.uniform(-6.0, 2.0, n)], -1).astype(np.float32)
    # Lanes whose shadow ray toward (0, 0, 10) crosses 0, 1 and 2 boxes.
    groups = (slice(0, 32), slice(32, 64), slice(64, 96))
    pos[groups[0]] = [4.0, 4.0, -6.0]
    pos[groups[1]] = [0.3, 0.3, 2.0]
    pos[groups[2]] = [0.2, 0.2, -5.0]
    pos[:96, :2] += rs.uniform(-0.05, 0.05, (96, 2)).astype(np.float32)
    active = rs.random(n) < 0.9
    active[:96] = True
    jl = jint.Lights(position=jnp.array([0.0, 0.0, 10.0]), intensity=jnp.array([100.0, 90.0, 80.0]))
    tl = make_lights((0.0, 0.0, 10.0), (1.0, 0.9, 0.8), 100.0)
    want = np.asarray(jint.sample_direct_light(jnp.asarray(pos), jscene, jacc, jl,
                                               jnp.asarray(active), max_media))
    got = tint.sample_direct_light(torch.from_numpy(pos), tscene, tacc, tl,
                                   torch.from_numpy(active), max_media).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # A march that ends inside its bound of steps resolves; crossing k
    # boxes takes k + 1 steps, so one step lights only the lanes that
    # cross none.
    lit = got.max(-1) > 0
    assert lit[groups[0]].all()
    for g in groups[1:]:
        assert lit[g].all() if max_media == 4 else not lit[g].any()


def _mid_flight_state(jscene, jacc, n, rng_mode, seed, bounces=2):
    """A JAX ``_State`` of camera rays advanced ``bounces`` bounces."""
    from complex_materials_renderer_tpu.ops import rng as jrng
    from complex_materials_renderer_tpu.ops.camera import generate_rays

    rs = np.random.default_rng(seed)
    w = 32
    pix = np.stack([np.arange(n) % w, np.arange(n) // w], -1).astype(np.int32)
    linear = jnp.asarray(pix[:, 1] * w + pix[:, 0])
    if rng_mode == "ld":
        words = jrng.seed_ld(linear, 3)
    else:
        words = jnp.asarray(rs.integers(0, 2**32, n, dtype=np.uint32))
    words, j1 = jrng.next_float(words)
    words, j2 = jrng.next_float(words)
    o, d = generate_rays(fixture_camera(), jnp.asarray(pix), jnp.stack([j1, j2], -1), (w, n // w))
    st = jint._State(org=o, dir=d, thr=jnp.ones((n, 3)), rad=jnp.zeros((n, 3)), rng=words,
                     depth=jnp.zeros(n, jnp.int32), alive=jnp.ones(n, bool),
                     lane=jnp.arange(n, dtype=jnp.int32))
    step = _jax_bounce()
    for _ in range(bounces):
        st = step(st, jscene, jacc, fixture_lights())
    return st


_JAX_BOUNCE: dict = {}


def _jax_bounce(**opts):
    """JAX ``_bounce`` under jit, one per option set (the interpreted
    Pallas kernel runs far faster compiled than op by op)."""
    import jax

    key = tuple(sorted(opts.items()))
    if key not in _JAX_BOUNCE:
        _JAX_BOUNCE[key] = jax.jit(
            lambda st, sc, acc, li: jint._bounce(st, sc, acc, li, **KW, **opts))
    return _JAX_BOUNCE[key]


def _np_state(st):
    out = {f: np.array(getattr(st, f)) for f in jint._State._fields}
    out["rng"] = out["rng"].astype(np.int64) & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("backend,rng_mode,opts", [
    ("bvh", "parity", {}),
    ("cluster", "parity", {}),
    ("cluster", "ld", {}),
    ("bvh", "parity", dict(tir="kill", direct="analytic")),
])
def test_bounce_matches(backend, rng_mode, opts):
    tris, mats, media = make_test_scene()
    jscene, jacc, tscene, tacc = scene_accels(tris, mats, media, backend)
    jst = _mid_flight_state(jscene, jacc, 1024, rng_mode, seed=len(opts))
    assert 0 < int(jst.alive.sum()) < 1024
    want = _np_state(_jax_bounce(**opts)(jst, jscene, jacc, fixture_lights()))
    f = _np_state(jst)
    tst = tint.state_from_jax_arrays(**f)
    got = {k: v.numpy() for k, v in tint._bounce(tst, tscene, tacc, port_lights(), **KW,
                                                 **opts)._asdict().items()}
    for name in ("rng", "depth", "alive", "lane"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("org", "dir", "thr", "rad"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0, err_msg=name)


def test_compact_order_matches():
    tris, mats, media = make_test_scene()
    jscene, jacc, tscene, _ = scene_accels(tris, mats, media, "bvh")
    jst = _mid_flight_state(jscene, jacc, 2048, "parity", seed=3, bounces=1)
    f = _np_state(jst)
    f["org"][:64] = f["org"][64:128]  # equal keys: the sort must be stable
    f["dir"][:64] = f["dir"][64:128]
    want = jint._compact(jint._State(**{k: jnp.asarray(v) for k, v in f.items()}), jscene)
    got = tint._compact(tint.state_from_jax_arrays(**f), tscene)
    np.testing.assert_array_equal(got.lane.numpy(), np.asarray(want.lane))


def test_two_phase_loop_and_rng_carry():
    """A 96x96 tile (9,216 lanes) takes the two-phase loop (full width,
    then the r/8 narrow state); two 1-sample chunks carrying the parity
    stream equal one 2-sample pass, bit for bit, and the JAX image."""
    tris, mats, media = make_test_scene()
    _, _, tscene, tacc = scene_accels(tris, mats, media, "cluster")
    args = (port_camera(), tscene, tacc, port_lights(), (96, 96))
    kw = dict(max_depth=4, rr_depth=2, nee_max_media=1)
    full, rng_full = tint.render_beauty(*args, 2, return_rng=True, **kw)
    a, rng_a = tint.render_beauty(*args, 1, return_rng=True, **kw)
    b, rng_b = tint.render_beauty(*args, 1, rng_state=rng_a, sample_offset=1, return_rng=True,
                                  **kw)
    np.testing.assert_allclose(((a + b) / 2).numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_array_equal(rng_b.numpy(), rng_full.numpy())
    jscene, jbvh, _, _ = scene_accels(tris, mats, media, "bvh")
    ref = np.asarray(jint.render_beauty(fixture_camera(), jscene, jbvh, fixture_lights(),
                                        (96, 96), 2, **kw))
    check_image(full.numpy(), ref, max_flips=2 * 36)
