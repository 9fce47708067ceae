"""The plain version of the triangle tester (K2) against a brute-force
numpy Moller-Trumbore over every triangle slot: closest hits ('full',
'dist', 'occl'), the sorted NEE K-list with its opaque bound ('nee'), and
the fused pair ('dnee'); results do not depend on the cluster width or on
quad slots."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from complex_materials_renderer_tpu.kernels import cluster_test as jct
from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.kernels import cluster_test as tct
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid

from test_torch_support import helper_scene

torch.set_num_threads(1)

T_MIN = np.float32(1e-4)
MEDIA_IDS = [1.0]  # the helpers scene's box is medium 1 (media row 0)


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    o = np.stack([rs.uniform(-3, 3, n), rs.uniform(0.01, 3, n), rs.uniform(-3, 3, n)], -1)
    # A quarter of the rays start inside the medium box.
    o[: n // 4] = rs.uniform(0.3, 1.7, (n // 4, 3)) * [1, 1, 1] - [1.0, 0.0, 1.0]
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(0.5, 20.0, n)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


def _grid(width=8, quads=False, shell=False):
    tris, mats, _ = helper_scene(duplicate_shell=shell)
    return device_cluster_grid(build_clusters(tris, mats, cluster_size=width, quads=quads), "cpu")


def _np_mt(grid, o, d):
    """Moller-Trumbore of every lane against every slot in float32 numpy,
    in the tester's operation order; returns (u, v, t, inside) of (N, S)."""
    c = {k: getattr(grid, k).reshape(-1).numpy()[None, :] for k in (
        "v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z", "qa", "qb")}
    OX, OY, OZ = (o[:, i:i + 1] for i in range(3))
    DX, DY, DZ = (d[:, i:i + 1] for i in range(3))
    px = DY * c["e2z"] - DZ * c["e2y"]
    py = DZ * c["e2x"] - DX * c["e2z"]
    pz = DX * c["e2y"] - DY * c["e2x"]
    det = c["e1x"] * px + c["e1y"] * py + c["e1z"] * pz
    inv = np.float32(1.0) / np.where(np.abs(det) > np.float32(1e-12), det, np.float32(1e30))
    sx, sy, sz = OX - c["v0x"], OY - c["v0y"], OZ - c["v0z"]
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * c["e1z"] - sz * c["e1y"]
    qy = sz * c["e1x"] - sx * c["e1z"]
    qz = sx * c["e1y"] - sy * c["e1x"]
    v = (DX * qx + DY * qy + DZ * qz) * inv
    t = (c["e2x"] * qx + c["e2y"] * qy + c["e2z"] * qz) * inv
    eps = np.float32(1e-6)
    one_eps = np.float32(1.0) + eps
    qa, qb = c["qa"], c["qb"]
    inside = ((u >= -eps) & (v >= -eps)
              & (u * qb + v * (np.float32(1.0) - qa) <= qb * one_eps)
              & (u * (np.float32(1.0) - qb) + v * qa <= qa * one_eps))
    return u, v, t, inside


def _np_closest(grid, o, d, tmax):
    u, v, t, inside = _np_mt(grid, o, d)
    ok = inside & (t > T_MIN) & (t < tmax[:, None])
    tm = np.where(ok, t, np.inf)
    j = np.argmin(tm, axis=1)  # first (lowest) slot on ties
    hit = ok.any(axis=1)
    rows = np.arange(len(o))
    return hit, np.where(hit, tm[rows, j], tmax), np.where(hit, j, -1), u[rows, j], v[rows, j]


def _np_nee(grid, o, d, tmax, K):
    _, _, t, inside = _np_mt(grid, o, d)
    mat = grid.mat.reshape(-1).numpy()[None, :]
    med = np.isin(mat, MEDIA_IDS)
    ok = inside & (t > T_MIN)
    t_opq = np.minimum(tmax, np.where(ok & ~med, t, np.inf).min(axis=1))
    keys = np.full((len(o), K), tct.KEY_EMPTY, np.int64)
    for i in range(len(o)):
        sel = ok[i] & med[0] & (t[i] < t_opq[i])
        k = np.sort((t[i][sel].view(np.int32) & ~63).astype(np.int64))[:K]  # media row 0
        keys[i, : len(k)] = k
    return keys, t_opq


def _trace(grid, payload, o, d, tmax, K=0, db=None, tmax_b=None):
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    rays = (*T(o).unbind(1), *T(d).unbind(1))
    if db is not None:
        rays = rays + tuple(T(db).unbind(1))
    st0 = tct.payload_state0(payload, T(tmax), K, TMAX_B=None if tmax_b is None else T(tmax_b))
    return tct.trace_slots(tct.slot_table(grid), rays, payload, st0, float(T_MIN), K, MEDIA_IDS)


@pytest.mark.parametrize("shell", [False, True])
def test_full_dist_occl_match_brute_force(shell):
    grid = _grid(shell=shell)
    o, d, tmax = _rays(1500, 1)
    hit, t, slot, u, v = _np_closest(grid, o, d, tmax)
    assert 100 < hit.sum() < len(o)
    full = _trace(grid, "full", o, d, tmax)
    np.testing.assert_array_equal(full[0].numpy(), t)
    np.testing.assert_array_equal(full[1].numpy(), slot.astype(np.float32))
    np.testing.assert_array_equal(full[2].numpy()[hit], u[hit])
    np.testing.assert_array_equal(full[3].numpy()[hit], v[hit])
    g = lambda k: getattr(grid, k).reshape(-1).numpy()[slot[hit]]  # noqa: E731
    n = np.stack([g("e1y") * g("e2z") - g("e1z") * g("e2y"),
                  g("e1z") * g("e2x") - g("e1x") * g("e2z"),
                  g("e1x") * g("e2y") - g("e1y") * g("e2x")], -1)
    np.testing.assert_array_equal(torch.stack(full[4:7], -1).numpy()[hit], n)
    np.testing.assert_array_equal(full[7].numpy()[hit], g("mat"))
    assert (full[7].numpy()[~hit] == -1).all()
    pos = np.stack([g("v0x") + u[hit] * g("e1x") + v[hit] * g("e2x"),
                    g("v0y") + u[hit] * g("e1y") + v[hit] * g("e2y"),
                    g("v0z") + u[hit] * g("e1z") + v[hit] * g("e2z")], -1)
    np.testing.assert_array_equal(torch.stack(full[8:11], -1).numpy()[hit], pos)
    dist = _trace(grid, "dist", o, d, tmax)
    np.testing.assert_array_equal(dist[0].numpy(), t)
    np.testing.assert_array_equal(dist[1].numpy(), slot.astype(np.float32))
    (occl,) = _trace(grid, "occl", o, d, tmax)
    np.testing.assert_array_equal(occl.numpy(), t)


@pytest.mark.parametrize("shell,nee_max_media", [(False, 1), (True, 1), (True, 4)])
def test_nee_keys_match_sorted_brute_force(shell, nee_max_media):
    grid = _grid(shell=shell)
    K = tct.nee_list_len(nee_max_media)
    o, d, tmax = _rays(1500, 2)
    keys, t_opq = _np_nee(grid, o, d, tmax, K)
    out = _trace(grid, "nee", o, d, tmax, K)
    got = torch.stack(out[:K], 1).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, keys)
    np.testing.assert_array_equal(out[K].numpy(), t_opq)
    n_keys = (keys != tct.KEY_EMPTY).sum(1)
    assert n_keys.max() >= (4 if shell else 2)
    if shell:
        # Every boundary of the doubled shell comes twice, within T_MIN.
        tk = tct.nee_unpack_t(torch.from_numpy(got[:, :2].astype(np.int32)), -1.0).numpy()
        both = n_keys >= 2
        assert (np.abs(tk[both, 1] - tk[both, 0]) <= T_MIN).all()


def test_dnee_is_dist_plus_nee():
    grid = _grid(shell=True)
    K = tct.nee_list_len(2)
    o, da, ta = _rays(1200, 3)
    _, db, tb = _rays(1200, 4)
    out = _trace(grid, "dnee", o, da, ta, K, db=db, tmax_b=tb)
    a = _trace(grid, "dist", o, da, ta)
    b = _trace(grid, "nee", o, db, tb, K)
    assert len(out) == 2 + K + 1
    for x, y in zip(out, a + b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("width,quads", [(16, False), (32, False), (8, True), (32, True)])
def test_width_and_quad_invariance(width, quads):
    base = _grid()
    other = _grid(width=width, quads=quads)
    o, d, tmax = _rays(1500, 5)
    fa = _trace(base, "full", o, d, tmax)
    fb = _trace(other, "full", o, d, tmax)
    hit = fa[1].numpy() >= 0
    np.testing.assert_array_equal(hit, fb[1].numpy() >= 0)
    np.testing.assert_allclose(fb[0].numpy(), fa[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(fa[7].numpy(), fb[7].numpy())
    np.testing.assert_allclose(torch.stack(fb[8:11], -1).numpy(), torch.stack(fa[8:11], -1).numpy(),
                               rtol=1e-5, atol=1e-5)
    K = tct.nee_list_len(1)
    na = _trace(base, "nee", o, d, tmax, K)
    nb = _trace(other, "nee", o, d, tmax, K)
    for ka, kb in zip(na[:K], nb[:K]):
        np.testing.assert_array_equal(tct.nee_unpack_mat(ka).numpy(), tct.nee_unpack_mat(kb).numpy())
        np.testing.assert_allclose(tct.nee_unpack_t(kb, -1.0).numpy(),
                                   tct.nee_unpack_t(ka, -1.0).numpy(), rtol=2e-5)
    np.testing.assert_allclose(nb[K].numpy(), na[K].numpy(), rtol=1e-5)


def test_key_helpers_match_jax():
    rs = np.random.default_rng(6)
    t = rs.uniform(1e-4, 1e3, 4096).astype(np.float32)
    keys = (t.view(np.int32) & ~63) | rs.integers(0, 63, 4096).astype(np.int32)
    keys[::7] = tct.KEY_EMPTY
    miss = rs.uniform(0, 10, 4096).astype(np.float32)
    kt, mt = torch.from_numpy(keys), torch.from_numpy(miss)
    np.testing.assert_array_equal(np.asarray(jct.nee_unpack_t(jnp.asarray(keys), jnp.asarray(miss))),
                                  tct.nee_unpack_t(kt, mt).numpy())
    np.testing.assert_array_equal(np.asarray(jct.nee_unpack_mat(jnp.asarray(keys))),
                                  tct.nee_unpack_mat(kt).numpy())
    assert tct.nee_list_len(4) == jct.nee_list_len(4) == 10
    assert (tct.NEE_MAT_BITS, tct.KEY_EMPTY, tct.NEE_DUP_SPARE) == (
        jct.NEE_MAT_BITS, int(jct.KEY_EMPTY), jct.NEE_DUP_SPARE)
    K = 6
    for payload in ("full", "dist", "occl", "nee", "dnee"):
        a = jct.payload_state0(payload, jnp.asarray(miss), K, TMAX_B=jnp.asarray(miss * 2))
        b = tct.payload_state0(payload, mt, K, TMAX_B=mt * 2)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    st = tuple(torch.from_numpy(np.sort(keys.reshape(-1, 1)[:4096], 0)[:, 0]) for _ in range(K)) + (mt,)
    stj = tuple(jnp.asarray(x.numpy()) for x in st)
    np.testing.assert_array_equal(np.asarray(jct.payload_bound("nee", stj, K)),
                                  tct.payload_bound("nee", st, K).numpy())
