"""The port's pair sweep (kernels/pairsweep.py) on the CPU, as the JAX
package's tests/test_pairsweep.py holds its own: ``trace_pairs`` against
the JAX ``trace_pairs`` (Pallas interpreted) and against the port's
``trace_binned``, bit for bit for 'dist', 'occl' and 'nee'; 'full' against
the binned trace; a 1-slot list against an 8-slot one; ``chunk_blocks``
invariance; the plain sweep's block-faithful serving.

Tolerance against JAX: slots and media rows equal; t within atol 1e-6 +
rtol 1e-6 and NEE boundaries within rtol 2e-5 (XLA's CPU backend contracts
products and sums into FMAs: test_torch_support.assert_trace_close). Between the
port's own traces: equal, except the shading payload of 'full', which the
pair trace recomputes from the winning slot (atol 1e-6)."""

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.accel.clusters import build_clusters as jax_build_clusters
from complex_materials_renderer_tpu.kernels.megakernel import pack_media as jax_pack_media
from complex_materials_renderer_tpu.kernels.pairsweep import trace_pairs as jax_trace_pairs
from complex_materials_renderer_tpu.kernels.pallas_trace import device_cluster_grid
from complex_materials_renderer_tpu_torch.kernels import binned_trace as tbt
from complex_materials_renderer_tpu_torch.kernels import cluster_grid as tcg
from complex_materials_renderer_tpu_torch.kernels import cluster_test as tct
from complex_materials_renderer_tpu_torch.kernels import pairsweep as tps

from helpers import make_test_scene
from test_torch_support import assert_trace_close

torch.set_num_threads(1)


def _trace_setup(seed=0, R=100):
    """The helpers scene at cluster width 16 in supers of 2 and R random
    rays (tests/test_pairsweep.py:31-42)."""
    tris, mats, media = make_test_scene()
    jgrid = device_cluster_grid(jax_build_clusters(tris, mats, cluster_size=16, super_factor=2),
                                interpret=True)
    media9 = jax_pack_media(media, 1.0)
    rs = np.random.default_rng(seed)
    o = rs.uniform(-2, 3, (R, 3)).astype(np.float32)
    d = rs.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wlo = tris.reshape(-1, 3).min(0)
    whi = tris.reshape(-1, 3).max(0)
    return jgrid, tcg.from_jax_arrays(jgrid), media9, torch.from_numpy(np.array(media9)), o, d, \
        wlo, whi


def _bound(payload, R):
    return np.where(np.arange(R) % 7 == 0, 0.0, 6.0 if payload == "nee" else 1e4).astype(
        np.float32)


def _port(fn, tgrid, media9, o, d, bound, payload, **kw):
    out = fn(tgrid, media9, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(bound),
             payload, **kw)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("payload", ["dist", "nee", "occl"])
def test_trace_pairs_bitexact_vs_binned(payload):
    jgrid, tgrid, media9_j, media9, o, d, wlo, whi = _trace_setup()
    bound = _bound(payload, o.shape[0])
    kw = dict(world_lo=wlo, world_hi=whi) if payload == "dist" else {}
    rb = _port(tbt.trace_binned, tgrid, media9, o, d, bound, payload, list_len=4, **kw)
    rp = _port(tps.trace_pairs, tgrid, media9, o, d, bound, payload, list_len=4, chunk_blocks=1,
               **kw)
    assert len(rb) == len(rp)
    for i, (a, b) in enumerate(zip(rb, rp)):
        np.testing.assert_array_equal(a, b, err_msg=f"field {i}")
    if payload == "nee":
        assert (rp[0] < rp[-1]).sum() >= 3
    else:
        assert (rp[0] < bound).sum() > 5
    rj = [np.asarray(x) for x in jax_trace_pairs(jgrid, media9_j, o, d, bound, payload,
                                                  list_len=4, chunk_blocks=1, **kw)]
    assert_trace_close(payload, tct.nee_list_len(4), rp, rj)


def test_trace_pairs_full_matches_binned():
    _, tgrid, _, media9, o, d, wlo, whi = _trace_setup(seed=1)
    bound = _bound("full", o.shape[0])
    kw = dict(world_lo=wlo, world_hi=whi, list_len=4)
    rb = _port(tbt.trace_binned, tgrid, media9, o, d, bound, "full", **kw)
    rp = _port(tps.trace_pairs, tgrid, media9, o, d, bound, "full", chunk_blocks=1, **kw)
    for i in (0, 1, 7):  # t, slot, material decide the control flow: exact
        np.testing.assert_array_equal(rb[i], rp[i], err_msg=f"field {i}")
    for i in (2, 3, 4, 5, 6, 8, 9, 10):
        np.testing.assert_allclose(rp[i], rb[i], rtol=1e-5, atol=1e-6, err_msg=f"field {i}")
    assert (rp[1] >= 0).sum() > 20


def test_trace_pairs_overflow_generations():
    """A 1-slot list relists once per candidate cluster; the result equals
    an 8-slot run exactly (tests/test_pairsweep.py:88-112)."""
    _, tgrid, _, media9, o, d, wlo, whi = _trace_setup(seed=2)
    R = o.shape[0]
    kw = dict(world_lo=wlo, world_hi=whi, chunk_blocks=1)
    bound = np.full(R, 1e4, np.float32)
    tight = _port(tps.trace_pairs, tgrid, media9, o, d, bound, "dist", list_len=1, **kw)
    roomy = _port(tps.trace_pairs, tgrid, media9, o, d, bound, "dist", list_len=8, **kw)
    for a, b in zip(tight, roomy):
        np.testing.assert_array_equal(a, b)
    nb = np.full(R, 6.0, np.float32)
    tight = _port(tps.trace_pairs, tgrid, media9, o, d, nb, "nee", list_len=1, chunk_blocks=1)
    roomy = _port(tps.trace_pairs, tgrid, media9, o, d, nb, "nee", list_len=8, chunk_blocks=1)
    for a, b in zip(tight, roomy):
        np.testing.assert_array_equal(a, b)


def test_trace_pairs_chunking_invariant():
    """chunk_blocks only pads the pairs to whole steps."""
    _, tgrid, _, media9, o, d, wlo, whi = _trace_setup(seed=3, R=257)
    bound = np.full(257, 1e4, np.float32)
    kw = dict(world_lo=wlo, world_hi=whi, list_len=4)
    a = _port(tps.trace_pairs, tgrid, media9, o, d, bound, "dist", chunk_blocks=1, **kw)
    b = _port(tps.trace_pairs, tgrid, media9, o, d, bound, "dist", chunk_blocks=3, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_sweep_serves_each_block_smallest_first():
    """The plain sweep against a per-pair reference: on 'dist' every pair
    of a block meets every cluster served in its block; on 'nee' a pair
    inserts only its own cluster's boundaries."""
    _, tgrid, _, media9, o, d, _, _ = _trace_setup(seed=4, R=2048)
    rs = np.random.default_rng(5)
    cid = np.sort(rs.integers(0, tgrid.num_clusters, 2048)).astype(np.int32)
    cid[1900:] = tbt.BIGC  # padding pairs
    rays = torch.from_numpy(np.concatenate([o.T, d.T, np.full((1, 2048), 6.0, np.float32)]))
    W = tgrid.width
    for payload in ("dist", "nee"):
        K = tct.nee_list_len(1)
        got = tbt.state_fields(tps.sweep(tgrid, media9, rays, torch.from_numpy(cid), payload, K),
                               payload, K)
        for b in range(2):
            lanes = torch.arange(b * 1024, (b + 1) * 1024)
            served = sorted(set(cid[b * 1024:(b + 1) * 1024].tolist()) - {tbt.BIGC})
            st = tps._seed_state(payload, rays[6, lanes], K)
            for c in served:
                mask = torch.from_numpy(cid[b * 1024:(b + 1) * 1024] == c)
                st = tct.trace_slots(tct.slot_table(tgrid, c * W, (c + 1) * W),
                                     tuple(rays[a, lanes] for a in range(6)), payload, st,
                                     float(np.float32(1e-4)), K, media9[:, 0].tolist(),
                                     mask=mask, in_order=True)
            for x, y in zip(got, st):
                np.testing.assert_array_equal(x[lanes].numpy(), y.numpy())
    with pytest.raises(ValueError, match="sweep takes"):
        tps.sweep(tgrid, media9, rays, torch.from_numpy(cid), "full", 4)


def test_pass_width_guard():
    _, tgrid, _, media9, _, _, _, _ = _trace_setup()
    n = tps.MAX_LANES + 1
    o = torch.zeros((n, 3))
    d = torch.ones((n, 3))
    with pytest.raises(ValueError, match="65536 lanes"):
        tps.trace_pairs(tgrid, media9, o, d, torch.zeros(n), "occl")
