"""The port's binned tracer (kernels/binned_trace.py) against the JAX
package's on the CPU: the plain listing (K4; also on a stack of coincident
boxes, whose keys tie on their entry) and the plain round (K5) against the
JAX kernels run interpreted, key for key and lane for lane;
``trace_binned`` for 'full', 'dist' and 'nee'; the overflow generations;
the guards.

Tolerance: listing keys, iteration counts, slots, materials and NEE media
rows equal on every lane; t and the normal within atol 1e-6 + rtol 1e-6,
u, v and the position within atol 5e-6 (the float32 operations are the
same and in the same order, but XLA's CPU backend contracts a product and
a sum into one FMA: test_torch_cluster_trace.py); NEE boundaries within
rtol 2e-5 (a key keeps t rounded down to 64 ulps, so an ulp of t can move
it by one such step: up to 1.5e-5 of t)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from complex_materials_renderer_tpu.kernels import binned_trace as jbt
from complex_materials_renderer_tpu.kernels.megakernel import pack_media as jax_pack_media
from complex_materials_renderer_tpu.ops.medium import MediaTable as JaxMediaTable
from complex_materials_renderer_tpu_torch.kernels import binned_trace as tbt
from complex_materials_renderer_tpu_torch.kernels import cluster_test as tct

from test_torch_support import assert_trace_close, grids

torch.set_num_threads(1)

_W = 8  # narrow clusters keep the Pallas interpreter fast
T_MIN = np.float32(1e-4)


def _scene(n=60, seed=0, media_every=3):
    """Random triangles, every ``media_every``-th a medium (mat 1), as the
    JAX package's tests/test_binned_trace.py builds them; both grids."""
    rs = np.random.default_rng(seed)
    base = rs.uniform(-2.0, 2.0, size=(n, 1, 3))
    tris = (base + rs.uniform(-0.5, 0.5, size=(n, 3, 3))).astype(np.float32)
    mats = (np.arange(n) % media_every == 0).astype(np.int32)
    jgrid, tgrid = grids(tris, mats, cluster_size=_W, super_factor=4)
    media = JaxMediaTable(
        mat_id=np.array([1], np.int32), sigma_s=np.full((1, 3), 0.3, np.float32),
        sigma_a=np.full((1, 3), 0.1, np.float32), g=np.zeros((1, 3), np.float32),
        ior=np.full((1,), 1.33, np.float32),
    )
    media9 = jax_pack_media(media, 1.0)
    wlo, whi = tris.min(axis=(0, 1)), tris.max(axis=(0, 1))
    return tris, jgrid, tgrid, media9, torch.from_numpy(np.array(media9)), wlo, whi


def _rays(n, seed):
    """Rays from the box [-4, 4]^3, each aimed at a random point of the
    triangles' region [-2.5, 2.5]^3, so that most lanes list clusters."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    d = rs.uniform(-2.5, 2.5, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _unpacked(payload, K, bits):
    """A round's (ns, n) state bits as ``trace_binned``'s result fields."""
    fields = tbt.state_fields(torch.from_numpy(bits), payload, K)
    if payload != "nee":
        return [f.numpy() for f in fields]
    miss = torch.full_like(fields[K], -1.0)
    return ([tct.nee_unpack_t(k, miss).numpy() for k in fields[:K]]
            + [tct.nee_unpack_mat(k).numpy() for k in fields[:K]] + [fields[K].numpy()])


def _jax_listing(jgrid, rays6, bound, tlo, L):
    """The JAX listing kernel, called as trace_binned calls it."""
    n = rays6.shape[1]
    blocks = n // tbt.BLOCK
    kern = jbt._make_listing_kernel(jgrid.num_clusters, jgrid.num_supers, blocks, jbt._T_MIN, L,
                                    jgrid.super_factor)
    smem = lambda shape: pl.BlockSpec(shape, lambda: (0,) * len(shape),  # noqa: E731
                                      memory_space=pltpu.SMEM)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    i32s = jax.ShapeDtypeStruct((blocks * 8, 128), jnp.int32)
    outs = pl.pallas_call(
        kern, in_specs=[smem((jgrid.num_clusters, 8)), smem((jgrid.num_supers, 8))] + [vmem] * 8,
        out_specs=[vmem] * (L + 1), out_shape=[i32s] * (L + 1), interpret=True,
    )(jgrid.bounds, jgrid.super_bounds, *(jnp.asarray(x).reshape(blocks * 8, 128) for x in rays6),
      jnp.asarray(bound).reshape(blocks * 8, 128), jnp.asarray(tlo).reshape(blocks * 8, 128))
    return np.stack([np.asarray(x).reshape(n) for x in outs[:L]]), np.asarray(outs[L]).reshape(n)


def _jax_round(jgrid, media9, payload, K, lb, rays6, keys, state, cap_iters):
    """The JAX round kernel, called as trace_binned calls it."""
    L, n = keys.shape
    blocks = n // tbt.BLOCK
    ns = state.shape[0]
    M = media9.shape[0]
    kern = jbt._make_round_kernel(payload, jgrid.num_clusters, blocks, jgrid.runs_per_cluster,
                                  jgrid.run_size, K, M, jbt._T_MIN, L, cap_iters)
    smem = lambda shape: pl.BlockSpec(shape, lambda: (0,) * len(shape),  # noqa: E731
                                      memory_space=pltpu.SMEM)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    tile = lambda x: jnp.asarray(x).reshape(blocks * 8, 128)  # noqa: E731
    dts = jbt._state_dtypes(payload, K)
    st = [tile(state[i].view(np.float32) if dt == jnp.float32 else state[i])
          for i, dt in enumerate(dts)]
    i32s = jax.ShapeDtypeStruct((blocks * 8, 128), jnp.int32)
    outs = pl.pallas_call(
        kern, in_specs=[smem((M, 9)), smem((1,)), vmem] + [vmem] * (6 + L + ns),
        out_specs=[vmem] * (L + ns + 1),
        out_shape=[i32s] * L + [jax.ShapeDtypeStruct((blocks * 8, 128), dt) for dt in dts] + [i32s],
        input_output_aliases={3 + 6 + i: i for i in range(L + ns)}, interpret=True,
    )(media9, jnp.asarray([lb], jnp.int32), jgrid.run_rows, *(tile(x) for x in rays6),
      *(tile(k) for k in keys), *st)
    keys_j = np.stack([np.asarray(x).reshape(n) for x in outs[:L]])
    state_j = np.stack([np.asarray(x).reshape(n).view(np.int32) for x in outs[L:L + ns]])
    return keys_j, state_j, np.asarray(outs[L + ns])[::8, 0]


def _lanes(n, seed, bound_hi=1e4, parked_every=17):
    o, d = _rays(n, seed)
    rs = np.random.default_rng(seed + 100)
    bound = rs.uniform(0.5, 8.0, n).astype(np.float32) if bound_hi is None else \
        np.full(n, bound_hi, np.float32)
    bound[::parked_every] = 0.0
    return o, d, bound


@pytest.mark.parametrize("L", [2, 8])
@pytest.mark.parametrize("relist", [False, True])
def test_listing_plain_matches_jax_kernel(L, relist):
    _, jgrid, tgrid, *_ = _scene()
    n = 1024
    o, d, bound = _lanes(n, seed=3, bound_hi=None)
    rays6 = np.ascontiguousarray(np.concatenate([o.T, d.T]))
    tlo = np.where(bound > T_MIN, -1, tbt.EMPTY).astype(np.int32)
    if relist:
        # The second generation's t_lo: each lane's 2nd key (EMPTY when the
        # lane listed fewer).
        first, _ = tbt.listing(tgrid, torch.from_numpy(rays6), torch.from_numpy(bound),
                               torch.from_numpy(tlo), 2)
        tlo = first[1].numpy()
        assert (tlo != tbt.EMPTY).sum() > 50
    keys_t, tlim_t = tbt.listing(tgrid, torch.from_numpy(rays6), torch.from_numpy(bound),
                                 torch.from_numpy(tlo), L)
    keys_j, tlim_j = _jax_listing(jgrid, rays6, bound, tlo, L)
    np.testing.assert_array_equal(keys_t.numpy(), keys_j)
    np.testing.assert_array_equal(tlim_t.numpy(), tlim_j)
    assert (keys_j[0] != tbt.EMPTY).sum() > (40 if relist else 100)


def _coincident_stack():
    """Copies of one unit cube shell (12 triangles, a cluster each at width
    16), some shifted along x by 0.25-0.75: runs of clusters share one box,
    so many listing keys tie on their entry field and the id decides."""
    rs = np.random.default_rng(9)
    q = np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    faces = []
    for axis in range(3):
        for side in (0.0, 1.0):
            f = np.roll(q, axis, axis=1)
            f[:, axis] = side
            faces += [f[[0, 1, 2]], f[[0, 2, 3]]]
    cube = np.stack(faces)
    shifts = np.where(rs.random(24) < 0.5, 0.0, rs.integers(1, 4, 24) * np.float32(0.25))
    tris = np.concatenate([cube + np.float32([s, 0.0, 0.0]) for s in shifts])
    return grids(tris, np.zeros(len(tris), np.int32), cluster_size=16, super_factor=4)


@pytest.mark.parametrize("L", [4, 12])
def test_listing_plain_matches_jax_kernel_on_coincident_boxes(L):
    """The coincident-box stack: equal entry fields among a lane's keys,
    broken by the cluster id, fresh and relisting."""
    jgrid, tgrid = _coincident_stack()
    n = 1024
    rs = np.random.default_rng(13)
    o = rs.uniform(-1.5, 2.5, size=(n, 3)).astype(np.float32)
    d = rs.uniform(0.1, 0.9, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays6 = np.ascontiguousarray(np.concatenate([o.T, d.T]))
    bound = np.full(n, 1e4, np.float32)
    tlo = np.full(n, -1, np.int32)
    for relist in (False, True):
        if relist:
            first, _ = tbt.listing(tgrid, torch.from_numpy(rays6), torch.from_numpy(bound),
                                   torch.from_numpy(tlo), 2)
            tlo = first[1].numpy()
        keys_t, tlim_t = tbt.listing(tgrid, torch.from_numpy(rays6), torch.from_numpy(bound),
                                     torch.from_numpy(tlo), L)
        keys_j, tlim_j = _jax_listing(jgrid, rays6, bound, tlo, L)
        np.testing.assert_array_equal(keys_t.numpy(), keys_j)
        np.testing.assert_array_equal(tlim_t.numpy(), tlim_j)
    high = keys_j.astype(np.int64) & ~tbt.ID_MASK
    ties = (high[1:] == high[:-1]) & (keys_j[1:] != tbt.EMPTY)
    assert ties.any(axis=0).sum() > 100  # lanes whose keys tie on the entry


@pytest.mark.parametrize("payload", ["full", "dist", "nee"])
def test_round_plain_matches_jax_kernel(payload):
    _, jgrid, tgrid, media9_j, media9, wlo, whi = _scene(seed=5, media_every=2)
    n, L, K, cap = 2048, 4, tct.nee_list_len(2), 3
    o, d, bound = _lanes(n, seed=6, bound_hi=None if payload == "nee" else 1e4)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    eff = torch.where(torch.from_numpy(bound) > float(T_MIN), torch.from_numpy(bound),
                      torch.zeros(n))
    if payload != "nee":
        eff = tbt.scene_box_clamp(eff, o_t, d_t, wlo, whi)
    rays = torch.cat([o_t.t(), d_t.t()]).contiguous()
    state = tbt.state_bits(tct.payload_state0(payload, eff, K))
    tlo = torch.where(eff > float(T_MIN), -1, tbt.EMPTY).to(torch.int32)
    keys, _ = tbt.listing(tgrid, rays, tct.payload_bound(payload, tbt.state_fields(state, payload, K),
                                                         K).contiguous(), tlo, L)
    live, keys, rays, state = tbt.regroup(keys, rays, state)
    lb = int((live + tbt.BLOCK - 1) // tbt.BLOCK)
    assert lb == 2
    keys_t, state_t, iters_t = tbt.round_plain(tgrid, media9, torch.tensor([lb], dtype=torch.int32),
                                               rays, keys, state, payload, K, cap)
    keys_j, state_j, iters_j = _jax_round(jgrid, media9_j, payload, K, lb, rays.numpy(),
                                          keys.numpy(), state.numpy(), cap)
    np.testing.assert_array_equal(iters_t.numpy(), iters_j)
    np.testing.assert_array_equal(keys_t.numpy(), keys_j)
    assert_trace_close(payload, K, _unpacked(payload, K, state_t.numpy()),
                         _unpacked(payload, K, state_j))
    assert (state_t.numpy() != state.numpy()).any()


def _both_traces(payload, n=200, seed=7, **kw):
    tris, jgrid, tgrid, media9_j, media9, wlo, whi = _scene(seed=11, media_every=2)
    o, d, bound = _lanes(n, seed, bound_hi=None if payload == "nee" else 1e4)
    world = dict(world_lo=tuple(map(float, wlo)), world_hi=tuple(map(float, whi)))
    if payload == "nee":
        world = {}
        kw = dict(kw, nee_max_media=2)
    want = jbt.trace_binned(jgrid, media9_j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(bound),
                            payload, **world, **kw)
    got = tbt.trace_binned(tgrid, media9, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(bound), payload, **world, **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("payload", ["full", "dist", "nee"])
def test_trace_binned_matches_jax(payload):
    want, got = _both_traces(payload, list_len=4, cap_iters=4)
    assert len(got) == len(want)
    assert_trace_close(payload, tct.nee_list_len(2), got, want)
    if payload == "nee":
        assert (want[0] < want[-1]).sum() > 10  # lanes with a boundary
    else:
        assert (want[1] >= 0).sum() > 20


def test_overflow_generations_match():
    """A 2-slot list with at most 3 servings a round forces relisting; the
    result equals a 16-slot run bit for bit (binned_trace.py:192-206)."""
    tris, _, tgrid, _, media9, wlo, whi = _scene(n=120, seed=21)
    o, d = _rays(128, seed=22)
    args = (tgrid, media9, torch.from_numpy(o), torch.from_numpy(d), torch.full((128,), 1e4))
    kw = dict(world_lo=wlo, world_hi=whi)
    tight, stats = tbt.trace_binned(*args, "full", list_len=2, cap_iters=3, debug_stats=True,
                                    **kw)
    roomy = tbt.trace_binned(*args, "full", list_len=16, **kw)
    assert int(stats[0]) > 1  # more than one generation
    for a, b in zip(tight, roomy):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_nee_overflow_matches():
    """The march reads t_opq and the boundaries below it; both equal
    between a 2-slot, 2-serving run and a 16-slot run."""
    _, _, tgrid, _, media9, _, _ = _scene(n=120, seed=31, media_every=2)
    o, d = _rays(96, seed=32)
    args = (tgrid, media9, torch.from_numpy(o), torch.from_numpy(d), torch.full((96,), 8.0))
    tight = [x.numpy() for x in tbt.trace_binned(*args, "nee", list_len=2, cap_iters=2)]
    roomy = [x.numpy() for x in tbt.trace_binned(*args, "nee", list_len=16)]
    K = tct.nee_list_len(4)
    np.testing.assert_array_equal(tight[2 * K], roomy[2 * K])
    opq = roomy[2 * K]
    ts_t, ts_r = np.stack(tight[:K], -1), np.stack(roomy[:K], -1)
    ms_t, ms_r = np.stack(tight[K:2 * K], -1), np.stack(roomy[K:2 * K], -1)
    for lane in range(96):
        n_t = int((ts_t[lane] < opq[lane]).sum())
        assert n_t == int((ts_r[lane] < opq[lane]).sum()), lane
        np.testing.assert_array_equal(ts_t[lane][:n_t], ts_r[lane][:n_t])
        np.testing.assert_array_equal(ms_t[lane][:n_t], ms_r[lane][:n_t])


def test_guards_raise():
    _, _, tgrid, _, media9, _, _ = _scene()
    o, d = (torch.from_numpy(x) for x in _rays(8, seed=1))
    bound = torch.full((8,), 1e4)
    big = dataclasses.replace(tgrid, num_clusters=(1 << tbt.ID_BITS) + 1)
    with pytest.raises(ValueError, match="14-bit"):
        tbt.trace_binned(big, media9, o, d, bound, "occl")
    with pytest.raises(ValueError, match="63"):
        tbt.trace_binned(tgrid, media9.repeat(64, 1), o, d, bound, "occl")
    with pytest.raises(ValueError, match="payload"):
        tbt.trace_binned(tgrid, media9, o, d, bound, "dnee")
