"""The port's physics ops (ops/fresnel.py, ops/phase.py, ops/diffuse.py,
ops/medium.py) and ``shade_color`` against the JAX package's, on the same
seeded numpy inputs, TIR lanes and g = 0 included.

Tolerance: atol 1e-6 on float outputs (a few ulp of values of order 1:
the two libraries' acos/asin/sin/cos/exp/log may differ in the last
bits); masks, row indices and lookups exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.ops import diffuse as jdiffuse
from complex_materials_renderer_tpu.ops import fresnel as jfresnel
from complex_materials_renderer_tpu.ops import medium as jmedium
from complex_materials_renderer_tpu.ops import phase as jphase
from complex_materials_renderer_tpu.render.hitinfo import shade_color as jshade_color
from complex_materials_renderer_tpu_torch.ops import diffuse, fresnel, medium, phase
from complex_materials_renderer_tpu_torch.render.hitinfo import shade_color
from complex_materials_renderer_tpu_torch.scene.medium import MediaTable

torch.set_num_threads(1)

ATOL = 1e-6
N = 4096


def _close(port, ref, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, atol=atol, rtol=0)


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _dirs_normals(seed):
    rs = np.random.default_rng(seed)
    d = _unit(rs, N)
    n = _unit(rs, N)
    ior = rs.choice(np.float32([1.0, 1.33, 1.5, 1.77, 2.4]), N).astype(np.float32)
    return d, n, ior


T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731 - a writable copy
J = jnp.asarray


def test_reflect_refract_match():
    d, n, ior = _dirs_normals(0)
    _close(fresnel.reflect(T(d), T(n)), jfresnel.reflect(J(d), J(n)))
    for n1, n2 in ((ior, np.ones_like(ior)), (np.ones_like(ior), ior)):
        out, tir = fresnel.refract(T(d), T(n), T(n1), T(n2))
        jout, jtir = jfresnel.refract(J(d), J(n), J(n1), J(n2))
        _close(tir, jtir)
        _close(out, jout)
    # Glass to air at grazing angles: many lanes under TIR.
    assert bool(fresnel.refract(T(d), T(n), T(ior), 1.0)[1].any())


@pytest.mark.parametrize("fast", [False, True])
def test_fresnel_r_match(fast):
    """Near the critical angle (sin_t within 3% of 1) the acos -> sin ->
    asin -> cos chain is ill-conditioned: a last-ulp difference of the two
    libraries' transcendentals moved R by up to 1.2e-5 on 13 of 4096
    lanes, all with sin_t in [0.976, 0.999]. Those lanes are held to atol
    5e-5, every other lane to 1e-6."""
    d, n, ior = _dirs_normals(1)
    cos1 = np.clip(np.abs((d * n).sum(-1)), 0.0, 1.0)
    for n1, n2 in ((ior, 1.0), (1.0, ior)):
        a = fresnel.fresnel_r(T(np.asarray(n1, np.float32)), T(np.asarray(n2, np.float32)),
                              T(d), T(n), fast=fast).numpy()
        b = np.asarray(jfresnel.fresnel_r(J(n1), J(n2), J(d), J(n), fast=fast))
        edge = np.abs(np.asarray(n1) / np.asarray(n2) * np.sqrt(1.0 - cos1 * cos1) - 1.0) < 0.03
        _close(a[~edge], b[~edge])
        _close(a[edge], b[edge], atol=5e-5)
    # Under TIR the full form is exactly 0.
    r = fresnel.fresnel_r(T(ior), 1.0, T(d), T(n))
    _, tir = fresnel.refract(T(d), T(n), T(ior), 1.0)
    if not fast:
        assert bool((r[tir] == 0.0).all()) and bool(tir.any())


def _g(rs):
    g = rs.uniform(-0.95, 0.95, size=(N, 3)).astype(np.float32)
    g[: N // 8] = 0.0  # isotropic lanes: the uniform-sphere fallback
    g[N // 8: N // 4] = 0.6  # equal channels, the shipped scenes' case
    return g


def test_phase_match():
    rs = np.random.default_rng(2)
    g3 = _g(rs)
    _close(phase.g_mean(T(g3)), jphase.g_mean(J(g3)))
    g = np.asarray(jphase.g_mean(J(g3)))
    a, b = _unit(rs, N), _unit(rs, N)
    _close(phase.hg_eval(T(a), T(b), T(g)), jphase.hg_eval(J(a), J(b), J(g)))
    _close(phase.hg_eval_zero(T(g)), jphase.hg_eval_zero(J(g)))
    s, t = phase._ortho_frame(T(a))
    js, jt = jphase._ortho_frame(J(a))
    _close(s, js)
    _close(t, jt)
    r1 = rs.random(N).astype(np.float32)
    r2 = rs.random(N).astype(np.float32)
    out, w = phase.hg_sample(T(a), T(g), T(r1), T(r2))
    jout, jw = jphase.hg_sample(J(a), J(g), J(r1), J(r2))
    _close(out, jout)
    _close(w, jw)


def test_diffuse_match():
    rs = np.random.default_rng(3)
    r1 = rs.random(N).astype(np.float32)
    r2 = rs.random(N).astype(np.float32)
    r1[:4], r2[:4] = 0.5, np.float32([0.5, 0.2, 0.5, 0.9])  # u == 0 and the centre
    wi, n = _unit(rs, N), _unit(rs, N)
    x, y = diffuse.concentric_disk(T(r1), T(r2))
    jx, jy = jdiffuse.concentric_disk(J(r1), J(r2))
    _close(x, jx)
    _close(y, jy)
    wo, val = diffuse.diffuse_sample(T(wi), T(n), T(r1), T(r2))
    jwo, jval = jdiffuse.diffuse_sample(J(wi), J(n), J(r1), J(r2))
    _close(wo, jwo)
    _close(val, jval)
    _close(diffuse.diffuse_eval(T(wi), wo, T(n)), jdiffuse.diffuse_eval(J(wi), jwo, J(n)))


def _tables():
    arrays = dict(
        mat_id=np.array([0, 2, 3, 2, -1], np.int32),
        sigma_s=np.array([[1.0, 2.0, 3.0], [0.1, 0.1, 0.1], [0.0, 0.0, 0.0],
                          [9.0, 9.0, 9.0], [0.3, 0.0, 0.5]], np.float32),
        sigma_a=np.array([[0.5, 0.5, 0.5], [0.2, 0.2, 0.2], [1.0, 1.0, 1.0],
                          [9.0, 9.0, 9.0], [0.0, 0.0, 0.2]], np.float32),
        g=np.array([[0.9, 0.9, 0.9], [0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                    [0.1, 0.2, 0.3], [0.0, 0.0, 0.0]], np.float32),
        ior=np.array([1.33, 1.5, 1.77, 2.0, 1.1], np.float32),
    )
    return MediaTable(**arrays), jmedium.MediaTable(**{k: J(v) for k, v in arrays.items()})


def _lanes(a):
    return [getattr(a, f) for f in ("has_medium", "sigma_s", "sigma_a", "g", "ior")]


def test_medium_lookup_match():
    """First matching row wins (mat 2 sits in rows 1 and 3); -1 matches the
    padding row, as in the JAX lookup."""
    table, jtable = _tables()
    rs = np.random.default_rng(4)
    mats = rs.integers(-1, 5, N).astype(np.int32)
    for a, b in zip(_lanes(medium.lookup(T(mats), table, 10.0)),
                    _lanes(jmedium.lookup(J(mats), jtable, jnp.float32(10.0)))):
        _close(a, b)
    rows = rs.integers(-1, 5, N).astype(np.int32)
    for a, b in zip(_lanes(medium.lookup_index(T(rows), table, 10.0)),
                    _lanes(jmedium.lookup_index(J(rows), jtable, jnp.float32(10.0)))):
        _close(a, b)


def _media_lanes(seed):
    rs = np.random.default_rng(seed)
    ss = rs.uniform(0, 3, (N, 3)).astype(np.float32)
    sa = rs.uniform(0, 3, (N, 3)).astype(np.float32)
    ss[: N // 8] = 0.0  # purely absorbing
    sa[N // 8: N // 4] = 0.0
    ss[N // 4: N // 4 + 64] = 0.0  # vacuum: no extinction at all
    sa[N // 4: N // 4 + 64] = 0.0
    ss[N // 2: N // 2 + 64, 1] = 0.0  # one channel without extinction
    sa[N // 2: N // 2 + 64, 1] = 0.0
    dist = rs.uniform(0, 5, N).astype(np.float32)
    rand = rs.random(N).astype(np.float32)
    return ss, sa, dist, rand


def test_medium_sampling_match():
    ss, sa, dist, rand = _media_lanes(5)
    _close(medium.eval_transmittance(T(dist), T(ss), T(sa)),
           jmedium.eval_transmittance(J(dist), J(ss), J(sa)))
    _close(medium.free_flight_candidate(T(rand), T(ss), T(sa)),
           jmedium.free_flight_candidate(J(rand), J(ss), J(sa)), atol=1e-5)
    gate, scale = medium.analytic_direct_scale(T(ss), T(sa), T(dist))
    jgate, jscale = jmedium.analytic_direct_scale(J(ss), J(sa), J(dist))
    _close(gate, jgate)
    _close(scale, jscale)
    a = medium.sample_distance(T(rand), T(ss), T(sa), T(dist))
    b = jmedium.sample_distance(J(rand), J(ss), J(sa), J(dist))
    for f in ("success", "t", "prob_fail", "prob_success", "transmittance"):
        _close(getattr(a, f), getattr(b, f))
    assert medium.NO_INTERACTION == jmedium.NO_INTERACTION
    assert medium.LN_CLAMP == jmedium.LN_CLAMP


@pytest.mark.parametrize("background", [0, 1, 2])
def test_shade_color_match(background):
    """Negative floors included: the checkerboard takes jnp.mod's sign."""
    rs = np.random.default_rng(6)
    pos = rs.uniform(-6, 6, (N, 3)).astype(np.float32)
    n = _unit(rs, N)
    n[:64] = [1.0, 0.0, 0.0]
    n[64:128] = [-1.0, 0.0, 0.0]
    _close(shade_color(T(pos), T(n), background), jshade_color(J(pos), J(n), background))
