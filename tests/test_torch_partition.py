"""The pass plan's compaction sort (kernels/partition.py).

On the CPU: the 19-bit key the kernel sorts (a dead lane's 0xFFFFFFFF as
1 << 18, two stable digit passes of 10 and 9 bits) gives the stable
permutation of the 64-bit key, on random and adversarial lanes for both
sortkeys; CPU tensors take the plain route and launch nothing. The
``gpu`` tests, on a card: the kernel against the plain route on the
card's tensors, bit for bit (the permutation, every state field, the lane
ids and the bank rows of a phase shrink) at 1, 1,024, 16,384, 65,536 and
65,287 lanes, 0%, 40% and 100% alive, both sortkeys; a captured sort
replayed on new inputs; the pass plan's renders with ``torch.argsort``
raising on CUDA tensors, against the plain route. Neither JAX nor the
test helpers are imported, so the card runs this file with
``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_partition.py
"""

import dataclasses
import os
from functools import partial

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import build
from complex_materials_renderer_tpu_torch.kernels import partition as pt
from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
from complex_materials_renderer_tpu_torch.kernels.megakernel import MegaState
from complex_materials_renderer_tpu_torch.render import megarender as mr
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LO = np.array([-2.0, -1.0, -3.0], np.float32)
HI = np.array([3.0, 4.0, 1.0], np.float32)


def _lanes(n, alive_share, seed, device="cpu", adversarial=True):
    """A wavefront of ``n`` lanes (state, lane ids, world box) from
    ``seed``: origins around and outside the world box, directions with
    exact and negative zeros; with ``adversarial`` also 64 lanes of one key
    (stability) and, when any lane lives, the largest live key (cell (31,
    31, 31), octant 7) beside dead lanes."""
    rs = np.random.default_rng(seed)
    org = rs.uniform(LO - 1.5, HI + 1.5, (n, 3)).astype(np.float32)
    direction = rs.normal(size=(n, 3)).astype(np.float32)
    direction[rs.random((n, 3)) < 0.05] = 0.0
    direction[rs.random((n, 3)) < 0.05] = -0.0
    alive = rs.random(n) < alive_share
    if adversarial and n >= 256:
        org[64:128] = org[200]
        direction[64:128] = direction[200]
        alive[64:128] = alive_share > 0
    if adversarial and alive_share > 0 and n >= 8:
        org[5] = HI
        direction[5] = 1.0
        alive[5] = True
        alive[4] = alive[6] = False
    t = lambda a, dt=None: torch.from_numpy(a).to(device, dt)  # noqa: E731
    state = MegaState(
        org=t(org), dir=t(direction),
        thr=t(rs.random((n, 3)).astype(np.float32)),
        rad=t(rs.random((n, 3)).astype(np.float32)),
        rng=t(rs.integers(0, 2**32, n, dtype=np.int64)),
        depth=t(rs.integers(0, 33, n).astype(np.int32)),
        alive=t(alive),
        aux=t(rs.integers(0, 2**32, n, dtype=np.int64)),
    )
    return state, t(rs.permutation(n).astype(np.int64)), t(LO), t(HI)


def _key19(key):
    return torch.where(key == 0xFFFFFFFF, pt.DEAD_KEY, key)


def _digit_passes(key19):
    """The kernel's passes in plain PyTorch: stable by the low digit, then
    by the high one."""
    perm = torch.arange(key19.shape[0])
    shift = 0
    for bits in pt.DIGIT_BITS:
        digit = (key19[perm] >> shift) & ((1 << bits) - 1)
        perm = perm[torch.argsort(digit, stable=True)]
        shift += bits
    return perm


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("sortkey", ["dir", "pos"])
def test_19_bit_key_keeps_the_stable_order(sortkey, adversarial):
    for n, share, seed in ((4096, 0.4, 1), (4096, 1.0, 2), (4096, 0.0, 3), (1000, 0.9, 4)):
        state, _, lo, hi = _lanes(n, share, seed, adversarial=adversarial)
        key = pt.coherence_key(state.org, state.dir, state.alive, lo, hi, sortkey)
        live = key[state.alive]
        assert live.numel() == 0 or int(live.max()) < pt.DEAD_KEY
        key19 = _key19(key)
        assert int(key19.max()) < 1 << sum(pt.DIGIT_BITS)
        want = torch.argsort(key, stable=True)
        assert torch.equal(torch.argsort(key19, stable=True), want)
        assert torch.equal(_digit_passes(key19), want)
        if adversarial and share > 0:
            assert int(key[5]) == pt.DEAD_KEY - 1  # the largest live key


def test_cpu_tensors_take_the_plain_route(monkeypatch):
    def no_library():
        raise AssertionError("the CPU route built the partition library")

    monkeypatch.setattr(build, "partition", no_library)
    state, lane, lo, hi = _lanes(3000, 0.4, 5)
    want_state, want_lane = MegaState(*(x.clone() for x in state)), lane.clone()
    rad_bank, rng_bank = torch.zeros((3001, 3)), torch.zeros((3001,), dtype=torch.int64)
    want_banks = (rad_bank.clone(), rng_bank.clone(), 1024)
    want_perm = pt.partition_plain(want_state, want_lane, lo, hi, "pos", want_banks)
    before = pt.partition.launches
    perm = pt.partition(state, lane, lo, hi, "pos", banks=(rad_bank, rng_bank, 1024))
    assert pt.partition.launches == before
    assert torch.equal(perm, want_perm) and torch.equal(lane, want_lane)
    for got, want in zip(state, want_state):
        assert torch.equal(got, want)
    assert torch.equal(rad_bank, want_banks[0]) and torch.equal(rng_bank, want_banks[1])
    assert torch.equal(rng_bank[lane[1024:]], state.rng[1024:])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card present")
    return torch.device("cuda", torch.cuda.current_device())


def _assert_same(got, want):
    (gp, gs, gl, gb), (wp, ws, wl, wb) = got, want
    assert torch.equal(gp, wp)
    for name, x, y in zip(MegaState._fields, gs, ws):
        assert torch.equal(x, y), name
    assert torch.equal(gl, wl)
    assert torch.equal(gb[0], wb[0]) and torch.equal(gb[1], wb[1])


@pytest.mark.gpu
@pytest.mark.parametrize("sortkey", ["dir", "pos"])
@pytest.mark.parametrize("share", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("n", [1, 1024, 16384, 65536, 65280 + 7])
def test_kernel_equals_the_plain_route(cuda, n, share, sortkey):
    state, lane, lo, hi = _lanes(n, share, n + int(share * 10), cuda)
    keep = n // 2
    banks = (torch.zeros((n + 1, 3), device=cuda), torch.zeros((n + 1,), dtype=torch.int64,
                                                               device=cuda), keep)
    out = []
    for fn in (partial(pt.partition, scratch=pt.Scratch(cuda, n)), pt.partition_plain):
        s, l_ = MegaState(*(x.clone() for x in state)), lane.clone()
        b = (banks[0].clone(), banks[1].clone(), keep)
        perm = fn(s, l_, lo, hi, sortkey, b).to(torch.int64)
        out.append((perm.clone(), s, l_, b))
    torch.cuda.synchronize()
    _assert_same(*out)


@pytest.mark.gpu
def test_captured_sort_replays_on_new_inputs(cuda, monkeypatch):
    """One sort captured in a CUDA graph (its scratch made before, no
    argsort reached), replayed twice on new lanes copied into its inputs;
    no scratch is made inside a capture, and none is made for a sort on
    the card that brings none."""
    n = 16384
    scratch = pt.Scratch(cuda, n)
    state, lane, lo, hi = _lanes(n, 0.4, 11, cuda)
    rad_bank = torch.zeros((n + 1, 3), device=cuda)
    rng_bank = torch.zeros((n + 1,), dtype=torch.int64, device=cuda)

    def no_argsort(*args, **kw):
        raise AssertionError("torch.argsort reached during the capture")

    before = pt.partition.launches
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with monkeypatch.context() as m:
        m.setattr(torch, "argsort", no_argsort)
        with torch.cuda.graph(graph):
            perm = pt.partition(state, lane, lo, hi, "dir", (rad_bank, rng_bank, 4096), scratch)
    assert pt.partition.launches - before == pt.LAUNCHES_PER_SORT <= 5
    with pytest.raises(RuntimeError, match="before a capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            pt.Scratch(cuda, n)
    with pytest.raises(ValueError, match="takes a Scratch"):
        pt.partition(state, lane, lo, hi, "dir")
    for seed in (12, 13):
        new_state, new_lane, _, _ = _lanes(n, 0.4 + 0.2 * (seed - 12), seed, cuda)
        banks = (torch.zeros_like(rad_bank), torch.zeros_like(rng_bank), 4096)
        want = pt.partition_plain(MegaState(*(x.clone() for x in new_state)), new_lane.clone(),
                                  lo, hi, "dir", banks)
        for x, y in zip((*state, lane), (*new_state, new_lane)):
            x.copy_(y)
        rad_bank.zero_()
        rng_bank.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert pt.partition.launches - before == pt.LAUNCHES_PER_SORT  # replays launch nothing
        assert torch.equal(perm.to(torch.int64), want)
        for name, x, y in zip(MegaState._fields, state, new_state):
            assert torch.equal(x, y[want]), name
        assert torch.equal(lane, new_lane[want])
        assert torch.equal(rad_bank, banks[0]) and torch.equal(rng_bank, banks[1])


def _isobox(**kw):
    obj = os.path.join(REPO, "scenes", "isobox.obj")
    base = dict(width=32, height=16, num_samples=2, shard="none", device="cuda",
                backend="cluster", engine="mega", max_depth=4, rr_depth=2)
    base.update(kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **base))
    return Renderer(scene, dataclasses.replace(scene.options, **base))


def _one_call(r, executor, mode):
    return mr.render_beauty_mega(r.camera, r.scene_arrays, r.accel, r.lights, (48, 32), 4,
                                 max_depth=4, rr_depth=2, schedule_mode=mode,
                                 schedule="1:1,2:1" if mode == "off" else "",
                                 executor=executor)


def _sort_visits(before, after):
    kinds = {s.label: s.kind for s in pc.sites()}
    counts = pc.site_counts((after - before).tolist())
    return sum(v[pc.SITE_VISITS] for k, v in counts.items() if kinds[k] == "sort")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "all", "hybrid"])
def test_pass_plan_sorts_on_the_kernel(cuda, mode, monkeypatch):
    """The pass plan's renders, graph and eager, with ``torch.argsort``
    raising on CUDA tensors: four launches a sort, and the image of the
    plain route on the card bit for bit."""
    real = torch.argsort

    def argsort(x, *args, **kw):
        if x.is_cuda:
            raise AssertionError("torch.argsort reached on a CUDA tensor")
        return real(x, *args, **kw)

    r = _isobox()
    counts = pc.device_counts(cuda)
    with monkeypatch.context() as m:
        m.setattr(torch, "argsort", argsort)
        graph = _one_call(r, "auto", mode)  # the capture and a replay
        launches, b0 = pt.partition.launches, counts.clone()
        eager = _one_call(r, "eager", mode)
        sorts = _sort_visits(b0, counts.clone())
        assert sorts > 0 and pt.partition.launches - launches == pt.LAUNCHES_PER_SORT * sorts
    def plain_route(*args, scratch=None, **kw):
        return pt.partition_plain(*args, **kw)

    monkeypatch.setattr(pt, "partition", plain_route)
    plain = _one_call(r, "eager", mode)
    assert torch.equal(graph, eager) and torch.equal(eager, plain)
