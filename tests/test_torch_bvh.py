"""The port's BVH backend against the JAX package: ``build_bvh`` (the host
library's C++ builder) byte-equal to the JAX package's native one and
``_build_bvh_python`` to the JAX numpy builder, the threaded-BVH walk over
the tree both packages build, ``ray_triangle``, ``ray_aabb`` and the
brute-force oracle ``trace_naive``.

Tolerances: host arrays byte-equal; prim and hit masks equal; t within
atol 1e-6 + rtol 1e-6, u and v within atol 5e-6. The float32 operations
are the same and in the same order, but XLA's CPU backend contracts
``a*b + c`` into FMAs, so a dot product can differ by an ulp of its terms;
u and v carry that through 1/det (worst seen: 1.4e-6)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.accel.bvh import _build_bvh_python as jax_build_bvh_python
from complex_materials_renderer_tpu.accel.bvh import build_bvh as jax_build_bvh
from complex_materials_renderer_tpu.kernels import intersect as jintersect
from complex_materials_renderer_tpu.kernels.traverse import _trace_closest_bvh as jax_trace_bvh
from complex_materials_renderer_tpu.kernels.traverse import device_bvh as jax_device_bvh
from complex_materials_renderer_tpu_torch.accel.bvh import _build_bvh_python, build_bvh
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import intersect, traverse
from complex_materials_renderer_tpu_torch.scene import load_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
UV_ATOL = 5e-6


def _random_tris(n, seed=0, spread=2.0, size=0.4):
    rs = np.random.default_rng(seed)
    base = rs.uniform(-spread, spread, size=(n, 1, 3))
    return (base + rs.uniform(-size, size, size=(n, 3, 3))).astype(np.float32)


def _random_rays(n, seed=1):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _showcase_tris():
    obj = os.path.join(REPO, "scenes", "showcase.obj")
    return load_scene(obj, RenderOptions(obj_path=obj, device="cpu")).triangles


def _bvh_case(which, leaf_size):
    if which == "random":
        return _random_tris(333, seed=leaf_size)
    if which == "degenerate":
        # Coincident centroids: the median-split fallbacks.
        return np.repeat(_random_tris(1, seed=5), 37, axis=0)
    return _showcase_tris()


def _same_tree(a, b):
    for name in ("bmin", "bmax", "left", "count", "miss", "tri_order"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("which", ["random", "degenerate", "showcase"])
def test_build_bvh_byte_equal(which, leaf_size):
    """The numpy builders of both packages (the CMR_NO_NATIVE path)."""
    tris = _bvh_case(which, leaf_size)
    _same_tree(_build_bvh_python(tris, leaf_size=leaf_size),
               jax_build_bvh_python(tris, leaf_size=leaf_size))


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("which", ["random", "degenerate", "showcase"])
def test_build_bvh_native_byte_equal(which, leaf_size):
    """The C++ builders of both packages, as their renderers call them."""
    tris = _bvh_case(which, leaf_size)
    _same_tree(build_bvh(tris, leaf_size=leaf_size), jax_build_bvh(tris, leaf_size=leaf_size))


def _both_bvhs(tris, leaf_size):
    flat = jax_build_bvh(tris, leaf_size=leaf_size)
    jb = jax_device_bvh(flat, tris, leaf_size=leaf_size)
    tb = traverse.device_bvh(build_bvh(tris, leaf_size=leaf_size), tris, leaf_size, "cpu")
    return jb, tb


def _hits_close(a, b):
    np.testing.assert_array_equal(a.prim.numpy(), np.asarray(b.prim))
    np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), atol=ATOL, rtol=1e-6)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                   atol=UV_ATOL, rtol=0, err_msg=f)


@pytest.mark.parametrize("num_tris,leaf_size", [(1, 4), (7, 1), (128, 4), (1000, 8)])
def test_trace_closest_bvh_matches(num_tris, leaf_size):
    tris = _random_tris(num_tris, seed=num_tris + 7)
    o, d = _random_rays(512, seed=num_tris)
    jb, tb = _both_bvhs(tris, leaf_size)
    rs = np.random.default_rng(num_tris)
    active = rs.random(512) < 0.7
    t_max = rs.uniform(0.5, 9.0, 512).astype(np.float32)
    for act, tmax in ((None, 1e4), (active, t_max)):
        got = traverse._trace_closest_bvh(torch.from_numpy(o), torch.from_numpy(d), tb, 1e-4,
                                          torch.from_numpy(tmax) if act is not None else tmax,
                                          active=None if act is None else torch.from_numpy(act))
        want = jax_trace_bvh(jnp.asarray(o), jnp.asarray(d), jb, 1e-4, jnp.asarray(tmax),
                             active=None if act is None else jnp.asarray(act))
        _hits_close(got, want)
    # The JAX device BVH converts to the port's and traces the same.
    tb2 = traverse.device_bvh_from_jax(jb)
    got = traverse.trace_closest(torch.from_numpy(o), torch.from_numpy(d), tb2, 1e-4, 1e4)
    _hits_close(got, jax_trace_bvh(jnp.asarray(o), jnp.asarray(d), jb, 1e-4, 1e4))


def test_trace_shaded_bvh_matches():
    from complex_materials_renderer_tpu.kernels.traverse import trace_shaded as jax_trace_shaded

    tris = _random_tris(200, seed=3)
    mats = np.random.default_rng(3).integers(0, 4, 200).astype(np.int32)
    o, d = _random_rays(512, seed=9)
    jb, tb = _both_bvhs(tris, 4)
    T = torch.from_numpy
    a = traverse.trace_shaded(T(o), T(d), tb, T(tris[:, 0].copy()), T(tris[:, 1].copy()),
                              T(tris[:, 2].copy()), T(mats), 1e-4, 1e4)
    b = jax_trace_shaded(jnp.asarray(o), jnp.asarray(d), jb, jnp.asarray(tris[:, 0]),
                         jnp.asarray(tris[:, 1]), jnp.asarray(tris[:, 2]), jnp.asarray(mats),
                         1e-4, 1e4)
    for f in ("hit", "mat_id"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
    for f in ("t", "u", "v", "normal", "position"):
        np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                   atol=UV_ATOL, rtol=1e-6, err_msg=f)


def test_ray_triangle_and_aabb_match():
    rs = np.random.default_rng(11)
    tris = _random_tris(256, seed=11)
    o, d = _random_rays(256, seed=12)
    # Half the rays aimed at the triangles' centroids, so most of them hit.
    o[:128] = tris[:128, 0] + np.float32([0, 0, 3])
    c = tris[:128].mean(axis=1)
    d[:128] = (c - o[:128]) / np.linalg.norm(c - o[:128], axis=1, keepdims=True)
    T, J = torch.from_numpy, jnp.asarray
    got = intersect.ray_triangle(T(o), T(d), T(tris[:, 0].copy()), T(tris[:, 1].copy()),
                                 T(tris[:, 2].copy()), 1e-4, 1e4)
    want = jintersect.ray_triangle(J(o), J(d), J(tris[:, 0]), J(tris[:, 1]), J(tris[:, 2]),
                                   1e-4, 1e4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    hit = got[0].numpy()
    assert hit[:128].all()
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_allclose(x.numpy()[hit], np.asarray(y)[hit], atol=UV_ATOL, rtol=1e-6)
    bmin = rs.uniform(-3, 0, (256, 3)).astype(np.float32)
    bmax = bmin + rs.uniform(0, 3, (256, 3)).astype(np.float32)
    d[:16, 0] = 0.0  # axis-parallel rays: the nudged reciprocal
    inv = intersect.safe_inv_dir(T(d))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jintersect.safe_inv_dir(J(d))))
    np.testing.assert_array_equal(
        intersect.ray_aabb(T(o), inv, T(bmin), T(bmax), 1e-4, 1e4).numpy(),
        np.asarray(jintersect.ray_aabb(J(o), J(inv.numpy()), J(bmin), J(bmax), 1e-4, 1e4)))


@pytest.mark.parametrize("num_tris", [5, 600])
def test_trace_naive_matches(num_tris):
    tris = _random_tris(num_tris, seed=num_tris)
    o, d = _random_rays(300, seed=num_tris + 1)
    got = intersect.trace_naive(torch.from_numpy(o), torch.from_numpy(d), tris, 1e-4, 1e4)
    want = jintersect.trace_naive(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), 1e-4, 1e4)
    _hits_close(got, want)
    # And the BVH walk agrees with the oracle.
    _, tb = _both_bvhs(tris, 4)
    walk = traverse.trace_closest(torch.from_numpy(o), torch.from_numpy(d), tb, 1e-4, 1e4)
    np.testing.assert_array_equal(walk.prim.numpy(), got.prim.numpy())
    np.testing.assert_allclose(walk.t.numpy(), got.t.numpy(), atol=ATOL, rtol=1e-6)
