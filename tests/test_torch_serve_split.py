"""The serving kernels K5 (binned round) and K6 (pair sweep) of the CUDA
port, stated in plain PyTorch as the card runs them.

On the card both serve a cluster with the group walk of K2
(csrc/binned_common.cuh ``group_serve``): a tile of G threads per lane or
pair, 'dist' and 'occl' through the closest-hit walk, 'nee' through the
NEE walk and only where the serving accepts hits. The CUDA code cannot run
here, so this file states, over the plain tester's per-slot values
(``cluster_test._mt``, through the group statements of
test_torch_group_walk.py), what the kernels compute, and holds it bit for
bit against the plain versions they are checked against on the card:

- one serving by a tile of G threads, G in {1, 2, 4, 8, 16, 32}, for
  'dist', 'occl' and accept-flagged 'nee' (a lane that does not accept is
  skipped) against ``trace_slots(..., in_order=True)`` cluster by cluster,
  in a shuffled order, on showcase, gembox and a stack of coincident
  planes;
- K6 per pair (csrc/pair_sweep.cu): each pair's output is a fold over the
  ascending distinct cluster ids of its own 1024-pair block, every id for
  'dist' and 'occl', only the pair's own id for 'nee'; against
  ``sweep_plain`` on listed pairs, on the same pairs shuffled within their
  blocks (the kernel does not rely on the order), and on blocks of many
  distinct ids with padding among them;
- K5 per block (csrc/binned_round.cu): a 1024-lane block split over S CTAs
  of 1024 G / S lanes, one minimum per serving from the S partial minima
  (a lane whose list was empty before the clear offers BIGC + 1), 'nee'
  lanes that do not hold the served cluster skipped, 'full' keeping each
  thread's own hit until the store; against ``round_plain`` in keys, state
  and iterations, for every payload at every (G, S) the library holds;
- the rules that pick G (K6) and (G, S) (K5) from the launch width;
- the ctypes argument types of every kernel library's launch function
  against its C signature.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
from complex_materials_renderer_tpu_torch.kernels import build
from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
from test_torch_group_walk import (
    T_MIN,
    _cluster_slots,
    _scene,
    _stack,
    closest_cluster,
    nee_cluster,
    owner_payload,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (1, 2, 4, 8, 16, 32)
NEE_MAX_MEDIA = 4
K = ct.nee_list_len(NEE_MAX_MEDIA)
ROUND_SPLITS = [(g, bt.BLOCK * g // bt.ROUND_CTA) for g in bt.ROUND_GROUPS]


@pytest.fixture(scope="module", params=["showcase", "gembox", "stack"])
def scene(request):
    return _stack() if request.param == "stack" else _scene(request.param)


def _rays(lo, hi, n, seed):
    """n rays from inside the scene box in random directions (for the
    stack: from below it, along +z), with a per-lane bound in [0.5, 20)."""
    rs = np.random.default_rng(seed)
    if lo is None:
        o = np.stack([rs.uniform(-0.9, 0.9, n), rs.uniform(-0.9, 0.9, n), np.full(n, -0.5)], -1)
        d = np.stack([rs.normal(0, 0.02, n), rs.normal(0, 0.02, n), np.ones(n)], -1)
    else:
        o = lo + (hi - lo) * rs.uniform(0.05, 0.95, (n, 3))
        d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(0.5, 20.0, n)
    o, d, tmax = (torch.from_numpy(x.astype(np.float32)) for x in (o, d, tmax))
    return o, d, tmax


def group_serve(grid, c, O, D, state, payload, G, med_ids=(), accept=None, mine=None):
    """The state after one serving of cluster c by a tile of G threads per
    lane (``group_serve``): 'full' and 'dist' the tile's (t, slot) ('full'
    keeps the payloads in ``mine``, per thread), 'occl' the tile's t, 'nee'
    the NEE walk on the lanes that accept and nothing elsewhere."""
    sl = _cluster_slots(grid, c)
    run = grid.run_size
    if payload == "nee":
        keys, opq = nee_cluster(sl, O, D, state[:K], state[K], G, K, med_ids, run)
        return tuple(torch.where(accept, a, b) for a, b in zip(keys + [opq], state))
    if payload == "occl":
        return closest_cluster(sl, O, D, state[0], torch.full_like(state[0], -1.0), G, run)[:1]
    return closest_cluster(sl, O, D, state[0], state[1], G, run, mine=mine)


def _sub(state, idx):
    return tuple(x[idx] for x in state)


def _put(state, idx, sub):
    for x, y in zip(state, sub):
        x[idx] = y


# --------------------------------------------------------------------------
# One serving at every G
# --------------------------------------------------------------------------


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("payload", ["dist", "occl", "nee"])
def test_group_serve_matches_in_order_walk(scene, payload, G):
    grid, med_ids, lo, hi = scene
    o, d, tmax = _rays(lo, hi, 160, seed=30 + G)
    O, D = tuple(o.unbind(1)), tuple(d.unbind(1))
    rs = np.random.default_rng(G)
    state = ct.payload_state0(payload, tmax.clone(), K)
    want = state
    n_new = 0
    for c in rs.permutation(grid.num_clusters).tolist():
        accept = torch.from_numpy(rs.random(o.shape[0]) < 0.7)
        state = group_serve(grid, c, O, D, state, payload, G, med_ids, accept)
        before = want
        want = ct.trace_slots(_cluster_slots(grid, c), O + D, payload, want, T_MIN, K, med_ids,
                              mask=accept if payload == "nee" else None, in_order=True)
        n_new += sum(int((x != y).sum()) for x, y in zip(want, before))
        for x, y in zip(state, want):
            assert torch.equal(x, y), c
    assert n_new > 0


# --------------------------------------------------------------------------
# K6: each pair a fold over its block's ascending distinct ids
# --------------------------------------------------------------------------


def sweep_statement(grid, med_ids, rays, cid, payload, G):
    """The pair sweep as csrc/pair_sweep.cu computes it: per 1024-pair
    block the distinct ids below C in ascending order, then per pair 'dist'
    and 'occl' serve every id in order, 'nee' only the pair's own id."""
    P = cid.shape[0]
    state = [x.clone() for x in ps._seed_state(payload, rays[6], K)]
    for b in range(P // bt.BLOCK):
        blk = torch.arange(b * bt.BLOCK, (b + 1) * bt.BLOCK)
        own = cid[blk]
        ids = torch.unique(own[own < grid.num_clusters]).tolist()  # ascending
        O, D = tuple(rays[a, blk] for a in range(3)), tuple(rays[a, blk] for a in range(3, 6))
        sub = _sub(state, blk)
        for c in ids:
            sub = group_serve(grid, c, O, D, sub, payload, G, med_ids, accept=own == c)
        _put(state, blk, sub)
    return bt.state_bits(tuple(state))


def _pairs(grid, lo, hi, payload, seed):
    """Listed pairs of 1,024 lanes (list length 4), cluster-major, seeded
    with the lane's bound: (pair rays (7, P), cluster ids (P,))."""
    o, d, tmax = _rays(lo, hi, 1024, seed)
    rays = torch.cat([o.t(), d.t()]).contiguous()
    tlo = torch.full((1024,), -1, dtype=torch.int32)
    keys, _ = bt.listing_plain(grid, rays, tmax, tlo, 4)
    pair_rays, cid, _ = ps.expand_pairs(keys, rays, tmax, chunk_blocks=1)
    return pair_rays, cid


@pytest.mark.parametrize("case", ["listed", "shuffled", "many_ids"])
@pytest.mark.parametrize("payload", ["dist", "occl", "nee"])
def test_sweep_statement_matches_sweep_plain(scene, payload, case):
    grid, med_ids, lo, hi = scene
    media9 = torch.tensor([[m] + [0.0] * 8 for m in med_ids], dtype=torch.float32)
    pair_rays, cid = _pairs(grid, lo, hi, payload, seed=7)
    P = cid.shape[0]
    rs = np.random.default_rng(11)
    if case == "shuffled":  # each block's pairs in a random order, padding among them
        perm = torch.cat([b * bt.BLOCK + torch.from_numpy(rs.permutation(bt.BLOCK))
                          for b in range(P // bt.BLOCK)])
        pair_rays, cid = pair_rays[:, perm].contiguous(), cid[perm].contiguous()
    elif case == "many_ids":  # every cluster id in each block, a fifth padding
        ids = rs.integers(0, grid.num_clusters, P)
        ids[rs.random(P) < 0.2] = bt.BIGC
        cid = torch.from_numpy(ids.astype(np.int32))
    valid = int((cid < bt.BIGC).sum())
    assert valid and (cid == bt.BIGC).any()
    blocks = cid.view(-1, bt.BLOCK)
    if case == "shuffled":
        assert bool((blocks[:, 1:] < blocks[:, :-1]).any())
    if case == "many_ids":
        assert max(len(torch.unique(b)) for b in blocks) == grid.num_clusters + 1
    want = ps.sweep_plain(grid, media9, pair_rays, cid, payload, K)
    got = sweep_statement(grid, med_ids, pair_rays, cid, payload, ct.group_size(valid))
    assert torch.equal(got, want)
    assert not torch.equal(want, bt.state_bits(ps._seed_state(payload, pair_rays[6], K)))


# --------------------------------------------------------------------------
# K5: one block over S CTAs
# --------------------------------------------------------------------------


def round_statement(grid, med_ids, lb, rays, keys, state, payload, cap_iters, G, S):
    """The binned round as csrc/binned_round.cu computes it: (keys, state,
    iters). Each serving, every lane clears its own list, then one minimum
    over the block, taken as the minimum of the S CTAs' partial minima of
    1024 / S lanes each, is both the loop condition (above BIGC: no lane
    listed a cluster) and the served cluster c; each lane's tile serves c
    ('nee': only the lanes whose list holds c); c leaves every list."""
    L, n = keys.shape
    keys = keys.clone()
    fields = [x.clone() for x in bt.state_fields(state, payload, K)]
    mine = [list(fields) for _ in range(G)] if payload == "full" else None
    iters = torch.zeros((n // bt.BLOCK,), dtype=torch.int32)
    rays6 = tuple(rays[a] for a in range(6))
    for b in range(lb):
        blk = torch.arange(b * bt.BLOCK, (b + 1) * bt.BLOCK)
        k = keys[:, blk]
        st = _sub(fields, blk)
        my = [_sub(m, blk) for m in mine] if mine else None
        O, D = rays6[:3], rays6[3:]
        O, D = tuple(x[blk] for x in O), tuple(x[blk] for x in D)
        it = 0
        while it < cap_iters:
            listed = k[0] != bt.EMPTY
            bound = ct.payload_bound(payload, st, K)
            k = torch.where((listed & (bt.entry_of(k[0]) >= bound))[None], bt.EMPTY, k)
            head = torch.where(k[0] != bt.EMPTY, k[0] & bt.ID_MASK, bt.BIGC)
            offer = torch.where(listed, head, bt.BIGC + 1)
            c = int(offer.view(S, bt.BLOCK // S).amin(dim=1).amin())
            if c > bt.BIGC:
                break
            match = (k != bt.EMPTY) & ((k & bt.ID_MASK) == c)
            if c < bt.BIGC:
                served = group_serve(grid, min(c, grid.num_clusters - 1), O, D, st, payload, G,
                                     med_ids, accept=match.any(dim=0), mine=my)
                st = served + tuple(st[len(served):])
            shift = torch.cummax(match.to(torch.int32), dim=0).values.bool()
            k = torch.where(shift, torch.cat([k[1:], torch.full_like(k[:1], bt.EMPTY)]), k)
            it += 1
        if payload == "full":
            st = tuple(st[:2]) + tuple(owner_payload(my, st[1])[2:])
        keys[:, blk] = k
        _put(fields, blk, st)
        iters[b] = it
    return keys, bt.state_bits(tuple(fields)), iters


def _round_inputs(grid, lo, hi, payload, n=3072, seed=5):
    """A first round as trace_binned builds it: the fresh state, the plain
    listing (list length 4) and the regroup sort."""
    o, d, tmax = _rays(lo, hi, n, seed)
    rays = torch.cat([o.t(), d.t()]).contiguous()
    state = bt.state_bits(ct.payload_state0(payload, tmax, K))
    bnd = ct.payload_bound(payload, bt.state_fields(state, payload, K), K).contiguous()
    keys, _ = bt.listing_plain(grid, rays, bnd, torch.full((n,), -1, dtype=torch.int32), 4)
    live, keys, rays, state = bt.regroup(keys, rays, state)
    return -(-int(live) // bt.BLOCK), rays, keys, state


@pytest.mark.parametrize("G,S", ROUND_SPLITS, ids=[f"G{g}S{s}" for g, s in ROUND_SPLITS])
@pytest.mark.parametrize("payload", ["full", "dist", "occl", "nee"])
def test_round_statement_matches_round_plain(payload, G, S):
    grid, med_ids, lo, hi = _scene("showcase")
    media9 = torch.tensor([[m] + [0.0] * 8 for m in med_ids], dtype=torch.float32)
    lb, rays, keys, state = _round_inputs(grid, lo, hi, payload)
    assert lb >= 2
    for blocks, cap in ((lb, 12), (lb - 1, 2)):
        want = bt.round_plain(grid, media9, blocks, rays, keys, state, payload, K, cap)
        got = round_statement(grid, med_ids, blocks, rays, keys, state, payload, cap, G, S)
        for name, x, y in zip(("keys", "state", "iters"), got, want):
            assert torch.equal(x, y), (name, blocks, cap)
        assert int(want[2].max()) > 1 and not torch.equal(want[1], state)


# --------------------------------------------------------------------------
# The rules
# --------------------------------------------------------------------------


def test_round_split_rule():
    # One pass of the binned engine holds 65,536 lanes: its rounds have 64
    # live blocks at most, down to 1.
    picks = {lb: bt.round_split(lb) for lb in (64, 48, 32, 17, 16, 8, 1)}
    for lb, (g, s) in picks.items():
        assert (g, s) in ROUND_SPLITS
        assert g == bt.ROUND_GROUPS[-1] or lb * bt.BLOCK * g >= bt.ROUND_FILL
        assert g == 1 or lb * bt.BLOCK * (g // 2) < bt.ROUND_FILL  # the smallest such G
    assert [picks[lb] for lb in (64, 32, 16, 1)] == [(2, 4), (4, 8), (8, 16), (8, 16)]


def test_sweep_group_rule():
    # The pair engine's sweeps: 42,987 NEE pairs of 65,536 shadow lanes at
    # list length 4, wider distance sweeps, and narrow late generations.
    assert [ct.group_size(p) for p in (262144, 131072, 65536, 42987, 8192, 1024, 1)] == [
        1, 2, 4, 8, 32, 32, 32]


@pytest.mark.parametrize("kind", sorted(build._KINDS))
def test_launch_argtypes_match_the_c_signatures(kind):
    """The ctypes argtypes of each library's launch function follow its C
    signature in csrc/: a pointer where the C parameter is one, a 64-bit
    int where it is an ``unsigned long long`` (a graph conditional handle),
    an int elsewhere (ctypes would pass a pointer as a 32-bit int and cut
    it)."""
    source, _, name, argtypes = build._KINDS[kind]
    with open(os.path.join(REPO, "complex_materials_renderer_tpu_torch", "csrc", source)) as f:
        params = re.search(r"int " + name + r"\(([^)]*)\)", f.read()).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p
            else ctypes.c_ulonglong if "unsigned long long" in p else ctypes.c_int
            for p in params]
    assert argtypes == want
