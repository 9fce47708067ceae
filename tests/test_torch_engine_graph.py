"""The wavefront, binned and pair engines as device programs: the plans of
render/integrator.py (``render_beauty``), render/binnedrender.py and
render/pairrender.py (through ``render_beauty_mega``) and the loops of
kernels/binned_trace.py, kernels/pairsweep.py and kernels/traverse.py,
run by the CPU executor (kernels/pass_control.py ``HostLoop``), against
the JAX package; the extended plain control kernel; K5 and K6 with their
counts from the control block against their host-int calls.

The card runs the same plans as CUDA graphs whose loops and guards are
conditional nodes (tests/test_torch_gpu.py, chip_smoke.py); here the CPU
executor runs them with the plain kernels and reads only the loop, guard
and ladder conditions on the host.

Tolerance of the engines against JAX: that of tests/test_torch_wavefront.py
and tests/test_torch_binnedrender.py (atol 1e-5 per pixel except flip
pixels, |diff| > 1e-2: one sample's path decision resolved the other way
by a last-ulp difference between XLA and PyTorch), at most 2 of 256; the
RNG words equal except on those pixels' lanes."""

import contextlib

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.accel.clusters import build_clusters as jax_build_clusters
from complex_materials_renderer_tpu.kernels.pallas_trace import device_cluster_grid
from complex_materials_renderer_tpu.render import integrator as jint
from complex_materials_renderer_tpu.render.hitinfo import make_scene_arrays as jax_scene_arrays
from complex_materials_renderer_tpu_torch.kernels import binned_trace as tbt
from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
from complex_materials_renderer_tpu_torch.kernels import pairsweep as tps
from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
from complex_materials_renderer_tpu_torch.kernels.cluster_test import group_size, nee_list_len
from complex_materials_renderer_tpu_torch.kernels.megakernel import pack_media
from complex_materials_renderer_tpu_torch.render import integrator as tint
from complex_materials_renderer_tpu_torch.render import megarender as tmr

from helpers import fixture_camera, fixture_lights, make_test_scene
from test_torch_support import (
    check_image,
    load_jax_megarender,
    port_camera,
    port_lights,
    scene_accels,
)

torch.set_num_threads(1)

KW = dict(max_depth=4, rr_depth=2, nee_max_media=2)
RES, SPP = (16, 16), 2
ENGINES = ["wavefront-cluster", "wavefront-bvh", "binned", "pair"]


@pytest.fixture(scope="module")
def jmr():
    return load_jax_megarender()


def _tables(engine):
    tris, mats, media = make_test_scene()
    backend = "bvh" if engine == "wavefront-bvh" else "cluster"
    return scene_accels(tris, mats, media, backend)


def _port(engine, rng, tables=None, **kw):
    """(image, RNG words) of the port's plan of ``engine`` on the CPU
    executor, over ``tables`` (camera, scene, accel, lights) or new ones."""
    if tables is None:
        _, _, tscene, tacc = _tables(engine)
        tables = (port_camera(), tscene, tacc, port_lights())
    args = (*tables, RES, SPP)
    call = dict(rng_mode=rng, return_rng=True, **KW, **kw)
    if engine.startswith("wavefront"):
        return tint.render_beauty(*args, **call)
    return tmr.render_beauty_mega(*args, trace_engine=engine, **call)


def _jax(jmr, engine, rng):
    tris, mats, media = make_test_scene()
    call = dict(rng_mode=rng, return_rng=True, **KW)
    if engine.startswith("wavefront"):
        jscene, jacc, _, _ = _tables(engine)
        return jint.render_beauty(fixture_camera(), jscene, jacc, fixture_lights(), RES, SPP,
                                  **call)
    scene = jax_scene_arrays(tris, mats, media, 1.0, 1)
    grid = device_cluster_grid(jax_build_clusters(tris, mats, cluster_size=8))
    return jmr.render_beauty_mega(fixture_camera(), scene, grid, fixture_lights(), RES, SPP,
                                  trace_engine=engine, **call)


@pytest.mark.parametrize("rng", ["parity", "counter"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_plan_matches_jax(jmr, engine, rng):
    """Each engine's plan on the CPU executor against the JAX package at
    16x16@2: the image, and the next RNG words of every pixel that is no
    flip pixel."""
    img, words = _port(engine, rng)
    jimg, jwords = (np.asarray(x) for x in _jax(jmr, engine, rng))
    assert tuple(img.shape) == (16, 16, 3) and img.dtype == torch.float32
    check_image(img.numpy(), jimg, max_flips=2)
    flip = (np.abs(img.numpy() - jimg).max(-1) > 1e-2).reshape(-1)
    np.testing.assert_array_equal(words.numpy()[~flip],
                                  jwords.astype(np.int64).reshape(words.shape)[~flip])


# --- The extended control kernel (its plain version) --------------------------


def _ctrl_run(alive, flags, ctrl=None, **kw):
    ctrl = pc.new_ctrl("cpu") if ctrl is None else ctrl
    counts = torch.zeros(2, dtype=torch.int64)
    pc.pass_control_plain(alive, ctrl, counts, flags, **kw)
    return ctrl, counts


@pytest.mark.parametrize("cap", [1, 3])
def test_control_iteration_cap(cap):
    """ITER_RESET, ITER_STEP and ITER_CAP: a loop ``while gen < cap and
    any(x)`` runs ``cap`` times while ``x`` holds a true byte, and not at
    all without one."""
    alive = torch.zeros(3000, dtype=torch.bool)
    alive[2047] = True
    ctrl, _ = _ctrl_run(alive, pc.COND | pc.ITER_RESET | pc.ITER_CAP, cap=cap)
    runs = 0
    while bool(ctrl[pc.CTRL_COND]):
        runs += 1
        pc.pass_control_plain(alive, ctrl, torch.zeros(2, dtype=torch.int64),
                              pc.COND | pc.ITER_STEP | pc.ITER_CAP, cap=cap)
    assert runs == cap and int(ctrl[pc.CTRL_ITER]) == cap
    ctrl, _ = _ctrl_run(alive & False, pc.COND | pc.ITER_RESET | pc.ITER_CAP, cap=cap)
    assert int(ctrl[pc.CTRL_COND]) == 0


@pytest.mark.parametrize("n_alive,it,want", [(5, 0, 1), (5, 7, 1), (5, 8, 0), (0, 0, 0),
                                             (900, 8, 1), (800, 9, 0)])
def test_control_grace(n_alive, it, want):
    """ITER_GRACE, the wavefront's phase A (integrator.py:574-579): any
    lane alive during the first ``cap`` steps, then more than
    ``threshold``."""
    alive = torch.zeros(4096, dtype=torch.bool)
    alive[torch.randperm(4096, generator=torch.Generator().manual_seed(it))[:n_alive]] = True
    ctrl = pc.new_ctrl("cpu")
    ctrl[pc.CTRL_ITER] = it
    ctrl, _ = _ctrl_run(alive, pc.COND | pc.ITER_GRACE, ctrl=ctrl, cap=8, threshold=800)
    assert int(ctrl[pc.CTRL_COND]) == want
    assert int(ctrl[pc.CTRL_NALIVE]) == n_alive


def test_control_rungs_of_counts_and_extent():
    """RUNGS picks the rung whose edges hold the count (or, with EXTENT,
    the last true byte's index + 1), -1 below the first edge; a condition
    on a bool tensor that is no alive mask (a round's listed heads)."""
    keys = torch.full((4096,), tbt.EMPTY, dtype=torch.int32)
    keys[[3, 100, 2500]] = 7
    listed = keys != tbt.EMPTY
    edges = [1, 2, 3, 4]
    ctrl, counts = _ctrl_run(listed, pc.RUNGS | pc.COND | pc.DEVICE_COUNT, edges=edges)
    assert int(ctrl[pc.CTRL_RUNG]) == 2 and int(ctrl[pc.CTRL_NALIVE]) == 3
    assert int(ctrl[pc.CTRL_COND]) == 1 and counts.tolist() == [0, 1]
    ctrl, _ = _ctrl_run(listed, pc.RUNGS | pc.EXTENT, edges=[0, 65, 513, 4097])
    assert int(ctrl[pc.CTRL_EXTENT]) == 2501 and int(ctrl[pc.CTRL_RUNG]) == 2
    ctrl, _ = _ctrl_run(listed & False, pc.RUNGS | pc.EXTENT, edges=[0, 65, 513, 4097])
    assert int(ctrl[pc.CTRL_EXTENT]) == 0 and int(ctrl[pc.CTRL_RUNG]) == 0
    ctrl, _ = _ctrl_run(listed & False, pc.RUNGS, edges=edges)
    assert int(ctrl[pc.CTRL_RUNG]) == -1


def test_control_not_k1_keeps_the_k1_count():
    """AFTER_K1 with NOT_K1 (an engine's kern, not K1) advances the ld base
    and counts the control launch, not a K1 launch."""
    alive = torch.ones(1024, dtype=torch.bool)
    ctrl, counts = _ctrl_run(alive, pc.INIT | pc.DEVICE_COUNT, dim0=2)
    pc.pass_control_plain(alive, ctrl, counts, pc.AFTER_K1 | pc.NOT_K1 | pc.DEVICE_COUNT,
                          advance=8)
    assert int(ctrl[pc.CTRL_DIM0]) == 10 and counts.tolist() == [0, 2]


@pytest.mark.parametrize("rule,hi", [(lambda lb: tbt.round_split(lb)[0], 64),
                                     (lambda lb: tbt.round_split(lb)[0], 300),
                                     (group_size, 12 * 65536), (group_size, 3000)])
def test_ladders_follow_the_rules(rule, hi):
    """The ladders of K5's (G, S) and K6's G hold every count at its rule's
    value, and the control kernel's edges pick that rung."""
    rungs = pc.ladder(rule, hi)
    edges = pc.rung_edges(rungs)
    probe = sorted({1, 2, hi, hi - 1} | {a for a, _, _ in rungs} | {b for _, b, _ in rungs}
                   | set(np.random.default_rng(hi).integers(1, hi + 1, 40).tolist()))
    for c in probe:
        i = next(k for k, (a, b, _) in enumerate(rungs) if a <= c <= b)
        assert rungs[i][2] == rule(c)
        alive = torch.zeros(hi, dtype=torch.bool)
        alive[:c] = True
        ctrl, _ = _ctrl_run(alive, pc.RUNGS, edges=edges)
        assert int(ctrl[pc.CTRL_RUNG]) == i


# --- K5 and K6 with their counts from the control block -----------------------


def _case(payload, lanes=4096, seed=3):
    tris, mats, media = make_test_scene()
    _, _, tscene, grid = scene_accels(tris, mats, media, "cluster")
    media9 = pack_media(tscene.media, tscene.scale, device="cpu")
    rs = np.random.default_rng(seed)
    o = torch.from_numpy(np.tile(np.float32([[0.0, 1.5, 5.0]]), (lanes, 1)))
    d = rs.normal(size=(lanes, 3)) * [0.3, 0.3, 1.0] - [0.0, 0.1, 1.0]
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    eff = torch.full((lanes,), 20.0)
    return grid, media9, o, d, eff


@pytest.mark.parametrize("live", [0, 1, 3, 4])
@pytest.mark.parametrize("payload", ["full", "nee"])
def test_round_with_control_block_equals_host_int(payload, live):
    """The plain K5 with the live blocks in the control block (at the rung
    of its ladder that holds them) equals its call with them as a host int,
    0 live blocks included; ``iters`` is written in place."""
    grid, media9, o, d, eff = _case(payload)
    K = nee_list_len(2)
    rays = torch.cat([o.t(), d.t()]).contiguous()
    tlo = torch.full((4096,), -1, dtype=torch.int32)
    keys, _ = tbt.listing(grid, rays, eff, tlo, 4)
    state = tbt.state_bits(tbt.payload_state0(payload, eff, K))
    want = tbt.run_round(grid, media9, live, rays, keys, state, payload, K, 3)
    ctrl = pc.new_ctrl("cpu")
    ctrl[pc.CTRL_LIVE] = live
    rung = [g for a, b, g in tbt.round_ladder(4) if a <= max(live, 1) <= b][0]
    iters = torch.full((4,), 7, dtype=torch.int32)
    got = tbt.run_round(grid, media9, None, rays, keys, state, payload, K, 3, ctrl=ctrl,
                        group=rung, iters=iters)
    assert got[2] is iters
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[2].sum()) > 0 if live else int(want[2].sum()) == 0
    with pytest.raises(ValueError, match="no host live blocks"):
        tbt.run_round(grid, media9, 1, rays, keys, state, payload, K, 3, ctrl=ctrl, group=rung)


@pytest.mark.parametrize("payload", ["dist", "nee"])
@pytest.mark.parametrize("valid", [0, 700, 4096])
def test_sweep_with_control_block_equals_host_int(payload, valid):
    """The plain K6 with the pair count in the control block equals its
    call with the count as a host int, 0 pairs included (every pair keeps
    its seed state); ``out`` receives the state."""
    grid, media9, o, d, _ = _case(payload, lanes=4096)
    K = nee_list_len(2)
    rs = np.random.default_rng(valid)
    cid = np.full(4096, tbt.BIGC, np.int32)
    cid[:valid] = np.sort(rs.integers(0, grid.num_clusters, valid))
    seed = torch.from_numpy(rs.uniform(1.0, 20.0, 4096).astype(np.float32))
    rays = torch.cat([o.t(), d.t(), seed[None]]).contiguous()
    cid = torch.from_numpy(cid)
    want = tps.sweep(grid, media9, rays, cid, payload, K, valid)
    ctrl = pc.new_ctrl("cpu")
    pc.pass_control_plain(cid < tbt.BIGC, ctrl, torch.zeros(2, dtype=torch.int64), 0)
    rung = [g for a, b, g in tps.sweep_ladder(4096) if a <= max(valid, 1) <= b][0]
    out = tps.seed_state_bits(rays, payload, K)
    got = tps.sweep(grid, media9, rays, cid, payload, K, ctrl=ctrl, group=rung, out=out)
    assert got is out and torch.equal(got, want)
    if valid == 0:
        assert torch.equal(want, tps.seed_state_bits(rays, payload, K))


# --- The plans' steps make no host read ----------------------------------------


@contextlib.contextmanager
def _no_host_reads():
    """Tensor.item, __bool__, __int__, __index__ and tolist raise, except in
    the executor's loop, guard and ladder control (``HostLoop.read`` and
    ``read_field``) and in the kernels' plain versions, which stand for the
    kernels of the card; yields the count of the executor's reads."""
    allowed = [0]
    reads = [0]

    def guarded(name, orig):
        def f(self, *a, **k):
            if not allowed[0]:
                raise AssertionError(f"host read in a plan step: Tensor.{name}")
            return orig(self, *a, **k)
        return f

    def opened(fn, counted=False):
        def f(*a, **k):
            allowed[0] += 1
            try:
                reads[0] += counted
                return fn(*a, **k)
            finally:
                allowed[0] -= 1
        return f

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pc.HostLoop, "read", staticmethod(opened(pc.HostLoop.read, True)))
        mp.setattr(pc.HostLoop, "read_field",
                   staticmethod(opened(pc.HostLoop.read_field, True)))
        for mod, name in ((ctr, "trace_core_plain"), (tbt, "listing_plain"),
                          (tbt, "round_plain"), (tps, "sweep_plain")):
            mp.setattr(mod, name, opened(getattr(mod, name)))
        for name in ("item", "__bool__", "__int__", "__index__", "tolist"):
            mp.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
        yield reads
    finally:
        mp.undo()


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_plan_makes_no_host_read(engine):
    """Every step of each engine's plan (the bounce, the sorts, the
    tracers, the control launches) runs with the host reads patched to
    raise; only the executor reads a condition, and the result is the
    unpatched one."""
    _, _, tscene, tacc = _tables(engine)
    tables = (port_camera(), tscene, tacc, port_lights())
    want = _port(engine, "ld", tables)  # the tables' set-up (uploads, packed rows) first
    with _no_host_reads() as reads:
        got = _port(engine, "ld", tables)
    assert reads[0] > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_eager_executor_equals_cpu_executor(engine):
    """The eager executor (host ints to K5 and K6, host reads of every
    condition) and the CPU executor (the kernels read the control block)
    give the same image and words."""
    a = _port(engine, "parity")
    b = _port(engine, "parity", executor="eager")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
