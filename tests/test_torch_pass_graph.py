"""The mega pass as one device program: K1's control block, the pass
control kernel's plain version, and the pass plan's CPU executor
(render/megarender.py ``PassPlan``) against the JAX ``_make_advance``.

The card runs the plan as a CUDA graph whose loops are conditional nodes
(tests/test_torch_gpu.py); here the CPU executor runs the same steps with
the plain K1 and reads only the loop conditions on the host.

Tolerance of the plan against JAX: that of tests/test_torch_megakernel.py
(the plain K1 against the interpreted JAX K1). Banked rng words equal on
every lane except at most 2 flip lanes per 1024 (one path decision
resolved the other way by a last-ulp difference of expf, logf, sinf or cosf
between XLA and PyTorch); banked radiance within atol 1e-5 elsewhere."""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from complex_materials_renderer_tpu.kernels import megakernel as jmk
from complex_materials_renderer_tpu.render.hitinfo import make_scene_arrays as jax_scene_arrays
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import megakernel as tmk
from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
from complex_materials_renderer_tpu_torch.ops import rng as rng_ops
from complex_materials_renderer_tpu_torch.render import megarender as tmr
from complex_materials_renderer_tpu_torch.render.hitinfo import make_scene_arrays
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import load_scene

from helpers import fixture_lights
from test_torch_support import helper_scene, k1_case, load_jax_megarender, port_camera, port_lights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

KW = dict(max_depth=4, rr_depth=2, nee_max_media=1)
# The forced schedule of the card's comparison: on 2048 lanes one bounce at
# 2048, then the rest at 1024, so the first width spills until <= 1024 live.
SPILL = "1:1,8:1,32:2"


def _port_k1_state(fields):
    return tmk.from_jax_arrays(**fields)


@pytest.mark.parametrize("ctrl_row,host", [
    ((1, 0, 0), dict(live_blocks=0)),  # run flag 0: every lane keeps its state
    ((1, 0, 1), dict(live_blocks=1)),  # live_blocks below the block count: the tail kept
    ((2, 0, 1), dict(live_blocks=2)),
    ((2, 1024 - 8, 1), dict(live_blocks=2, dim0=1024 - 8)),  # the Sobol table's edge
    ((2, 5000, 1), dict(live_blocks=2, dim0=5000)),  # past it: clipped to 1024 - 8
    ((2, -3, 1), dict(live_blocks=2, dim0=-3)),  # below it: clipped to 0
])
def test_k1_control_block_equals_host_ints(ctrl_row, host):
    """The plain K1 with the control block is bit-equal to its call with
    the same live_blocks and dim0 as host ints (a run flag of 0 equal to no
    live block), over 2048 lanes in ld mode, one bounce a call."""
    _, tgrid, media9, misc, fields = k1_case(lanes=2048, seed=3, ld=True)
    media9, misc = torch.from_numpy(np.array(media9)), torch.from_numpy(np.array(misc))
    kw = dict(KW, max_iters=1, ld=True)
    want = tmk.trace_paths_mega(tgrid, media9, misc, _port_k1_state(fields), **kw, **host)
    ctrl = pc.new_ctrl("cpu")
    ctrl[pc.CTRL_LIVE], ctrl[pc.CTRL_DIM0], ctrl[pc.CTRL_RUN] = ctrl_row
    got = tmk.trace_paths_mega(tgrid, media9, misc, _port_k1_state(fields), ctrl=ctrl, **kw)
    before = _port_k1_state(fields)
    kept = ctrl_row[0] * 1024 if ctrl_row[2] else 0  # the lanes beyond the live blocks
    for name, a, b, x in zip(tmk.MegaState._fields, got, want, before):
        assert torch.equal(a, b), name
        assert torch.equal(a[kept:], x[kept:]), name
    # The ctrl block is read, never written, by K1; with it, live_blocks
    # and dim0 may not be given.
    assert ctrl[:3].tolist() == list(ctrl_row)
    for bad in (dict(live_blocks=1), dict(dim0=2)):
        with pytest.raises(ValueError, match="control block"):
            tmk.trace_paths_mega(tgrid, media9, misc, _port_k1_state(fields), ctrl=ctrl, **kw,
                                 **bad)


@pytest.mark.parametrize("n,p_alive", [(65536, 0.3), (3072, 0.0), (5000, 1.0), (1, 1.0)])
def test_control_plain_updates(n, p_alive):
    """The plain control kernel: the alive count, live_blocks, the run flag,
    the advance of dim0 only after a K1 call that ran, the K1 and control
    counts, and the loop condition."""
    alive = torch.from_numpy(np.random.default_rng(n).uniform(size=n) < p_alive)
    k = int(alive.sum())
    counts = torch.zeros(pc.CNT_LEN, dtype=torch.int64)
    ctrl = pc.new_ctrl("cpu")
    pc.pass_control_plain(alive, ctrl, counts, pc.INIT | pc.COND | pc.DEVICE_COUNT, dim0=2,
                          threshold=1024)
    assert ctrl[:5].tolist() == [-(-n // 1024), 2, 1, k, int(k > 1024)]
    assert counts[:2].tolist() == [0, 1]
    pc.pass_control_plain(alive, ctrl, counts, pc.AFTER_K1 | pc.SET_LIVE | pc.DEVICE_COUNT,
                          advance=8)
    assert ctrl[:4].tolist() == [-(-k // 1024), 10, int(k > 0), k]
    assert counts[:2].tolist() == [1, 2]
    # A K1 call over no live block did not run: dim0 and the count stay.
    pc.pass_control_plain(alive, ctrl, counts, pc.AFTER_K1 | pc.COND | pc.DEVICE_COUNT,
                          advance=8)
    assert ctrl[pc.CTRL_DIM0] == (18 if k else 10)
    assert counts[:2].tolist() == [2 if k else 1, 3] and not counts[2:].any()
    assert ctrl[pc.CTRL_COND] == int(k > 0)
    pc.pass_control_plain(alive[:0], ctrl, counts, pc.SET_FULL)
    assert ctrl[[pc.CTRL_LIVE, pc.CTRL_RUN, pc.CTRL_NALIVE]].tolist() == [0, 1, 0]


@pytest.fixture(scope="module")
def jmr():
    return load_jax_megarender()


def _plan_inputs(ld, lanes=2048, seed=5):
    tris, mats, media = helper_scene()
    jgrid, tgrid, jmedia9, jmisc, fields = k1_case(lanes=lanes, seed=seed, ld=ld)
    jscene = jax_scene_arrays(tris, mats, media, 1.0, 1)
    tscene = make_scene_arrays(tris, mats, media, 1.0, 1, device="cpu")
    return jgrid, tgrid, jscene, tscene, jmedia9, jmisc, fields


def _advances(jmr, mode, schedule, ld, lanes):
    jgrid, tgrid, jscene, tscene, jmedia9, jmisc, fields = _plan_inputs(ld, lanes)
    knobs = dict(trace_engine="mega", tir="reflect", direct="scatter",
                 rng_mode="ld" if ld else "parity", binned_list=8, binned_cap=12, debug="",
                 **KW)
    sched = tmr._phase_schedule(lanes, KW["max_depth"], schedule)
    assert sched == jmr._phase_schedule(lanes, KW["max_depth"], schedule)
    jkern = jmr._make_kern(jgrid, jscene, fixture_lights(), jmedia9, jmisc, **knobs)
    tkern = tmr._make_kern(tgrid, tscene, port_lights(), torch.from_numpy(np.array(jmedia9)),
                           torch.from_numpy(np.array(jmisc)), **knobs)
    jadv = jmr._make_advance(jkern, mode, sched, jscene, "dir", KW["max_depth"])
    tadv = tmr._make_advance(tkern, mode, sched, tscene, "dir", KW["max_depth"])
    return jadv, tadv, fields


@pytest.mark.parametrize("ld", [False, True], ids=["parity", "ld"])
@pytest.mark.parametrize("mode,schedule", [("off", SPILL), ("all", ""), ("hybrid", "")])
def test_plan_matches_jax_advance(jmr, mode, schedule, ld):
    """The CPU executor of the pass plan against the JAX ``_make_advance``
    on 2048 lanes of the helpers scene: the banked radiance and RNG words
    (the static schedule spills: more K1 calls ran than it has phases)."""
    jadv, tadv, f = _advances(jmr, mode, schedule, ld, 2048)
    d0 = 2 if ld else 0
    jstate = jmk.MegaState(**{k: jnp.asarray(v) for k, v in f.items()})
    lane = np.arange(2048, dtype=np.int32)
    jrad, jrng = jadv(jstate, jnp.asarray(lane), 2048, dim0=jnp.int32(d0))
    before = pc.device_counts("cpu").clone()
    trad, trng = tadv(tmk.from_jax_arrays(**f), torch.from_numpy(lane.astype(np.int64)), 2048,
                      dim0=d0)
    ran = int(pc.device_counts("cpu")[0] - before[0])
    assert ran > (len(tadv.sched) if mode == "off" else 1)
    jrng = np.asarray(jrng).astype(np.int64)
    flips = trng.numpy() != jrng
    assert flips.sum() <= 2 * 2, int(flips.sum())
    np.testing.assert_allclose(trad.numpy()[~flips], np.asarray(jrad)[~flips], atol=1e-5)
    assert np.abs(np.asarray(jrad)).max() > 0


@contextlib.contextmanager
def _no_host_reads():
    """Tensor.item, __bool__, __int__, __index__ and tolist raise, except
    inside the CPU executor's loop control (``HostLoop.read``); yields the
    count of those reads."""
    allowed = [False]
    reads = [0]

    def guarded(name, orig):
        def f(self, *a, **k):
            if not allowed[0]:
                raise AssertionError(f"host read in a plan step: Tensor.{name}")
            return orig(self, *a, **k)
        return f

    real_read = tmr.HostLoop.read

    def read(ctrl):
        allowed[0] = True
        try:
            reads[0] += 1
            return real_read(ctrl)
        finally:
            allowed[0] = False

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tmr.HostLoop, "read", staticmethod(read))
        for name in ("item", "__bool__", "__int__", "__index__", "tolist"):
            mp.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
        yield reads
    finally:
        mp.undo()


@pytest.mark.parametrize("mode,schedule", [("off", SPILL), ("all", ""), ("hybrid", "")])
def test_plan_steps_make_no_host_read(jmr, mode, schedule):
    """Every step of the plan (sorts, scatters, K1 with the control block,
    the control kernel) runs with the host reads patched to raise; only the
    loop control reads a condition, and the result is the unpatched one."""
    _, tadv, f = _advances(jmr, mode, schedule, True, 2048)
    lane = torch.arange(2048, dtype=torch.int64)
    want = tadv(tmk.from_jax_arrays(**f), lane, 2048, dim0=2)
    with _no_host_reads() as reads:
        got = tadv(tmk.from_jax_arrays(**f), lane, 2048, dim0=2)
    assert reads[0] > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _isobox(**kw):
    obj = os.path.join(REPO, "scenes", "isobox.obj")
    base = dict(width=24, height=20, num_samples=4, shard="none", device="cpu",
                backend="cluster", engine="mega", sample_chunk=1)
    base.update(kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **base))
    return Renderer(scene, dataclasses.replace(scene.options, **base))


@pytest.mark.parametrize("rng", ["parity", "counter", "ld"])
def test_tensor_call_inputs_and_checkpoint(tmp_path, monkeypatch, rng):
    """``render_beauty_mega`` with ``rng_state`` and ``sample_offset`` as
    tensors is bit-equal to the call with an int offset; a render stopped
    after a checkpoint and resumed is bit-equal to the uninterrupted one."""
    r = _isobox(rng=rng)
    args = (r.camera, r.scene_arrays, r.accel, r.lights, (24, 8), 2)
    kw = dict(rng_mode=rng, row_offset=4, full_resolution=(24, 20), return_rng=True, **KW)
    words = rng_ops.seed_from_pixel(torch.arange(24 * 8) + 7 * 24)
    img_i, rng_i = tmr.render_beauty_mega(*args, sample_offset=3, rng_state=words, **kw)
    img_t, rng_t = tmr.render_beauty_mega(*args, sample_offset=torch.tensor(3),
                                          rng_state=words.clone(), **kw)
    assert torch.equal(img_i, img_t) and torch.equal(rng_i, rng_t)
    mono = _isobox(rng=rng).render()
    ck = str(tmp_path / "render.ckpt.npz")
    calls = {"n": 0}
    real = tmr.render_beauty_mega

    def interrupted(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
        return real(*a, **k)

    monkeypatch.setattr(tmr, "render_beauty_mega", interrupted)
    with pytest.raises(KeyboardInterrupt):
        _isobox(rng=rng).render(checkpoint_path=ck)
    monkeypatch.setattr(tmr, "render_beauty_mega", real)
    resumed = _isobox(rng=rng).render(checkpoint_path=ck)
    assert not os.path.exists(ck)
    np.testing.assert_array_equal(resumed, mono)


@pytest.mark.parametrize("mode,schedule", [("off", ""), ("off", SPILL), ("all", ""),
                                           ("hybrid", "")])
def test_device_k1_count_equals_eager_launches(monkeypatch, mode, schedule):
    """The device count of the K1 calls that ran (the CPU executor's
    control launches) equals the calls that the eager executor makes with
    a nonzero lane count, over a render of the helpers scene; the images
    are bit-equal."""
    tris, mats, media = helper_scene()
    _, tgrid, _, _, _ = k1_case(lanes=1024)
    tscene = make_scene_arrays(tris, mats, media, 1.0, 1, device="cpu")
    args = (port_camera(), tscene, tgrid, port_lights(), (64, 40), 2)
    kw = dict(rng_mode="ld", schedule_mode=mode, schedule=schedule, **KW)
    eager_calls = [0]
    real = tmk.trace_paths_mega

    def counted(grid, media9, misc, state, **k):
        if k.get("ctrl") is None and k.get("live_blocks", 1) > 0:
            eager_calls[0] += 1
        return real(grid, media9, misc, state, **k)

    monkeypatch.setattr(tmr, "trace_paths_mega", counted)
    eager = tmr.render_beauty_mega(*args, executor="eager", **kw)
    counts = pc.device_counts("cpu")
    before = counts.clone()
    plan = tmr.render_beauty_mega(*args, **kw)
    assert torch.equal(plan, eager)
    ran, controls = (counts - before)[:2].tolist()
    assert ran == eager_calls[0] > 0
    assert controls > ran
