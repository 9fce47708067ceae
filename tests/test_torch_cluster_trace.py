"""The plain version of the closest-hit kernel K3 (``trace_core_plain``,
through ``trace_shaded_clusters`` and ``trace_closest_clusters``) against
the JAX K3 (the Pallas kernel, interpreted on the CPU) on random
triangles and rays, quad and triangle-only grids, an opaque/media
partitioned grid, an active mask and a per-lane t_max; K3's additive
far-edge epsilon against K2's scaled one; and K3 against the port's BVH
walk and the brute-force oracle.

Tolerance: slot, prim, hit and material equal on every lane; t and the
normal within atol 1e-6 + rtol 1e-6; u, v and the position within atol
5e-6. The float32 operations are the same and in the same order, but
XLA's CPU backend contracts a product and a sum into one FMA, which moves
a dot product by an ulp of its terms; u and v carry that through 1/det
(worst seen: 2.6e-6 on 2 of 3072 position components)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.kernels.pallas_trace import (
    trace_closest_clusters as jax_trace_closest,
    trace_shaded_clusters as jax_trace_shaded,
)
from complex_materials_renderer_tpu_torch.accel.bvh import build_bvh
from complex_materials_renderer_tpu_torch.kernels import cluster_test as tct
from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
from complex_materials_renderer_tpu_torch.kernels import intersect, traverse

from test_torch_support import grids, helper_scene

torch.set_num_threads(1)

ATOL = RTOL = 1e-6
UV_ATOL = 5e-6


def _random_tris(n, seed, spread=2.0, size=0.4):
    rs = np.random.default_rng(seed)
    base = rs.uniform(-spread, spread, size=(n, 1, 3))
    return (base + rs.uniform(-size, size, size=(n, 3, 3))).astype(np.float32)


def _rays(n, seed, box=4.0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-box, box, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _scene_rays(n, seed):
    """Rays of the helpers scene: a quarter from inside the medium box."""
    rs = np.random.default_rng(seed)
    o = np.stack([rs.uniform(-3, 3, n), rs.uniform(0.01, 3, n), rs.uniform(-3, 3, n)], -1)
    o[: n // 4] = rs.uniform(0.3, 1.7, (n // 4, 3)) - [1.0, 0.0, 1.0]
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _close(a, b, name):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        atol = UV_ATOL if name in ("u", "v", "position") else ATOL
        np.testing.assert_allclose(a, b, atol=atol, rtol=RTOL, err_msg=name)


def _check(jgrid, tgrid, o, d, t_max=1e4, active=None):
    T, J = torch.from_numpy, jnp.asarray
    tm_t = T(t_max) if isinstance(t_max, np.ndarray) else t_max
    tm_j = J(t_max) if isinstance(t_max, np.ndarray) else t_max
    act_t = None if active is None else T(active)
    act_j = None if active is None else J(active)
    a = ctr.trace_shaded_clusters(T(o), T(d), tgrid, 1e-4, tm_t, active=act_t)
    b = jax_trace_shaded(J(o), J(d), jgrid, 1e-4, tm_j, active=act_j)
    for f in ("hit", "mat_id", "t", "u", "v", "normal", "position"):
        _close(getattr(a, f), getattr(b, f), f)
    a = ctr.trace_closest_clusters(T(o), T(d), tgrid, 1e-4, tm_t, active=act_t)
    b = jax_trace_closest(J(o), J(d), jgrid, 1e-4, tm_j, active=act_j)
    for f in ("prim", "t", "u", "v"):
        _close(getattr(a, f), getattr(b, f), f)
    # The raw slot (what the wrapper maps to prim) is equal too.
    raw = ctr.trace_core(T(o), T(d), tgrid, 1e-4, tm_t, active=act_t)
    from complex_materials_renderer_tpu.kernels.pallas_trace import _trace_core as jax_core

    _close(raw[1], jax_core(J(o), J(d), jgrid, 1e-4, tm_j, act_j)[1], "slot")
    return a


@pytest.mark.parametrize("num_tris,width", [(5, 8), (61, 8), (300, 16)])
def test_random_triangles_match_jax(num_tris, width):
    tris = _random_tris(num_tris, seed=num_tris)
    jgrid, tgrid = grids(tris, np.arange(num_tris, dtype=np.int32) % 5, cluster_size=width)
    o, d = _rays(512, seed=num_tris + 1)
    hit = _check(jgrid, tgrid, o, d)
    assert (num_tris < 60 or int((hit.prim >= 0).sum()) > 0) and int((hit.prim >= 0).sum()) < 512


@pytest.mark.parametrize("build", ["triangles", "quads", "partitioned", "quads, partitioned"])
def test_scene_grids_match_jax(build):
    tris, mats, _ = helper_scene()
    kw = dict(cluster_size=8, quads="quads" in build,
              media_mats={1} if "partitioned" in build else None)
    jgrid, tgrid = grids(tris, mats, **kw)
    if "quads" in build:
        assert bool((tgrid.qa != 0.5).any())  # some slots are merged quads
    if "partitioned" in build:
        assert tgrid.num_opaque_supers > 0
    o, d = _scene_rays(1024, seed=len(build))
    _check(jgrid, tgrid, o, d)


def test_active_mask_and_per_lane_tmax():
    tris, mats, _ = helper_scene()
    jgrid, tgrid = grids(tris, mats, cluster_size=8, quads=True)
    o, d = _scene_rays(1024, seed=7)
    rs = np.random.default_rng(8)
    active = rs.random(1024) < 0.66
    t_max = rs.uniform(0.05, 6.0, 1024).astype(np.float32)
    hit = _check(jgrid, tgrid, o, d, t_max=t_max, active=active)
    assert bool((hit.prim[torch.from_numpy(~active)] == -1).all())
    np.testing.assert_array_equal(hit.t.numpy()[~active], t_max[~active])
    # The whole block parked: every lane misses at its own t_max.
    hit = _check(jgrid, tgrid, o, d, t_max=t_max, active=np.zeros(1024, bool))
    assert bool((hit.prim == -1).all())


def test_additive_epsilon_is_k3s_own():
    """A ray at u + v = 1 + 1.5e-6 on a triangle slot: K3 (u/2 + v/2 <=
    0.5 + 1e-6) accepts it, K2's scaled test (<= 0.5 (1 + 1e-6)) does not,
    and the JAX K3 agrees with the port's."""
    tris = np.float32([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    jgrid, tgrid = grids(tris, np.zeros(1, np.int32), cluster_size=8)
    u = np.float32(0.5 + 0.75e-6)
    o = np.float32([[u, u, 1.0]])
    d = np.float32([[0.0, 0.0, -1.0]])
    hit = _check(jgrid, tgrid, o, d)
    assert int(hit.prim[0]) == 0 and float(hit.u[0] + hit.v[0]) > 1.0 + 1e-6
    sl = tct.slot_table(tgrid)
    rays = tuple(torch.from_numpy(x) for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))
    k2 = tct.trace_slots(sl, rays, "full", tct.payload_state0("full", torch.full((1,), 1e4)), 1e-4)
    assert float(k2[1][0]) == -1.0


@pytest.mark.parametrize("num_tris", [7, 200])
def test_plain_k3_matches_bvh_and_naive(num_tris):
    """Triangle-only grids: K3, the BVH walk and the brute-force oracle
    give the same prim on every lane (no lane lands within 2e-6 of an
    edge here) and t within the tolerance."""
    tris = _random_tris(num_tris, seed=30 + num_tris)
    _, tgrid = grids(tris, np.zeros(num_tris, np.int32), cluster_size=8)
    o, d = _rays(1024, seed=num_tris)
    T = torch.from_numpy
    k3 = ctr.trace_closest_clusters(T(o), T(d), tgrid, 1e-4, 1e4)
    bvh = traverse.device_bvh(build_bvh(tris, 4), tris, 4, "cpu")
    for other in (traverse.trace_closest(T(o), T(d), bvh, 1e-4, 1e4),
                  intersect.trace_naive(T(o), T(d), tris, 1e-4, 1e4)):
        np.testing.assert_array_equal(k3.prim.numpy(), other.prim.numpy())
        np.testing.assert_allclose(k3.t.numpy(), other.t.numpy(), atol=ATOL, rtol=RTOL)
    assert int((k3.prim >= 0).sum()) > 0
