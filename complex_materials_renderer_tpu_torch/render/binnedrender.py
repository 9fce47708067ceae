"""Binned-trace engine: the wavefront bounce with every trace through the
binned tracer (kernels/binned_trace.py: K4 and K5).

Counterpart of complex_materials_renderer_tpu/render/binnedrender.py
(``_march_klist`` :40, ``make_binned_tracer`` :104, ``make_binned_kern``
:212). The bounce physics is the wavefront's ``_bounce``
(render/integrator.py) behind a swapped ``Tracer``, so the RNG streams are
the other engines'. Per bounce: one 'full' closest-hit trace, one 'dist'
trace bounded by the free-flight candidate (the draw is peeked from the
deterministic stream before ``_bounce`` consumes it), and one 'nee' sweep
whose K-list is marched here as the megakernel marches it.

``render_beauty_mega(trace_engine="binned")`` swaps its per-pass kernel for
``make_binned_kern``'s bounce loop and keeps its schedule, banking and
sample packing. The bounce loop (the JAX ``lax.while_loop``, :260-272),
the tracers' ``lax.cond`` guards and the binned trace's loops run on the
pass plan's executor (kernels/pass_control.py): on the card conditional
nodes of the pass's CUDA graph, their state updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import pass_control as pc
from ..kernels.binned_trace import trace_binned
from ..kernels.cluster_test import NEE_DUP_SPARE, nee_list_len
from ..kernels.cluster_trace import ShadedHit
from ..kernels.megakernel import MegaState
from ..ops import rng as rng_ops
from ..ops.medium import LN_CLAMP, free_flight_candidate, lookup_index, media_tensors
from ..ops.vec import safe_normalize
from .hitinfo import T_MAX, T_MIN, Lights, SceneArrays
from .integrator import Tracer, _bounce, _State, light_setup


def _march_klist(ts, ms, t_opq, ldist, eff, active, media, scale):
    """The megakernel's K-list march (binnedrender.py:40): (R, 3)
    transmittance. Enter legs get the 0.999 light-distance epsilon, exit
    legs the T_MIN floor; duplicates within T_MIN are skipped; the nearest
    opaque hit occludes inside a leg's window; an exhausted march, or one
    that spent its real-crossing budget, fails dark."""
    K = len(ts)
    R = ldist.shape[0]
    dev = ldist.device
    tr = torch.ones((R, 3), dtype=torch.float32, device=dev)
    running = active
    in_med = torch.zeros_like(active)
    ex = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    last_t = torch.zeros((R,), dtype=torch.float32, device=dev)
    n_real = torch.zeros((R,), dtype=torch.float32, device=dev)
    real_cap = float(K - NEE_DUP_SPARE)
    zero3 = torch.zeros_like(tr)

    for i in range(K):
        t_i = ts[i]
        rem = ldist - last_t
        dup = t_i <= last_t + T_MIN
        cut = torch.where(in_med, last_t + torch.clamp(rem, min=T_MIN), last_t + 0.999 * rem)
        window = torch.minimum(cut, eff)
        opq = running & (t_opq > last_t + T_MIN) & (t_opq < window) & (t_opq < t_i)
        tr = torch.where(opq[:, None], zero3, tr)
        running = running & ~opq
        consider = running & ~dup
        real = consider & (t_i < window)
        ended = consider & ~real
        med_i = lookup_index(ms[i].to(torch.int32), media, scale)
        exitl = real & in_med
        seg = torch.minimum(t_i - last_t, rem)
        att = 0.9 * torch.exp(-ex * seg[:, None])
        tr = torch.where(exitl[:, None], tr * att, tr)
        enterl = real & ~in_med
        ex = torch.where(enterl[:, None], med_i.sigma_s + med_i.sigma_a, ex)
        last_t = torch.where(real, t_i, last_t)
        in_med = in_med ^ real
        n_real = n_real + real.to(torch.float32)
        running = running & ~ended

    dark = running | (n_real >= real_cap)
    return torch.where(dark[:, None], zero3, tr)


def shaded_hit(t, slot, u, v, nx, ny, nz, mat, px, py, pz) -> ShadedHit:
    """A 'full' payload as the integrator's ShadedHit (binnedrender.py:124-137)."""
    hit = slot >= 0.0
    return ShadedHit(
        t=torch.where(hit, t, torch.full_like(t, T_MAX)), hit=hit, u=u, v=v,
        normal=safe_normalize(torch.stack([nx, ny, nz], dim=-1)),
        mat_id=torch.where(hit, mat, torch.full_like(mat, -1.0)).to(torch.int32),
        position=torch.stack([px, py, pz], dim=-1),
    )


def distance_bound(rngs, transmitted, med, direct_mode: str):
    """The 'dist' walk bound: the free-flight candidate PEEKED from the
    stream that ``_bounce`` consumes next (success compares sampled <
    dist, so a boundary beyond the candidate acts as a miss); with the
    analytic direct term, at least the transmittance-clamp depth
    (binnedrender.py:146-165)."""
    _, rand_d = rng_ops.next_float_masked(rngs, transmitted)
    cand = free_flight_candidate(rand_d, med.sigma_s, med.sigma_a)
    bound = torch.clamp(cand * 1.00001 + 10.0 * T_MIN, max=T_MAX)
    if direct_mode == "analytic":
        density = (med.sigma_s + med.sigma_a).amin(dim=-1)
        t_star = torch.where(
            density > 0.0,
            LN_CLAMP / torch.clamp(density, min=1e-30) * 1.00001 + 10.0 * T_MIN,
            torch.zeros_like(density),
        )
        bound = torch.clamp(torch.maximum(bound, t_star), max=T_MAX)
    return torch.where(transmitted, bound, torch.zeros_like(bound))


def guarded(ex, cond: torch.Tensor, out: torch.Tensor, fn) -> torch.Tensor:
    """``out``, overwritten with ``fn()`` under a guard on ``any(cond)`` (a
    JAX ``lax.cond`` whose other branch returns ``out``), by the executor
    ``ex``."""
    ex = pc.executor(cond.device, ex)
    ctrl = pc.new_ctrl(cond.device)

    def body(_h):
        out.copy_(fn())

    h = ex.cond()
    ex.control(cond, ctrl, pc.COND, handle=h)
    ex.guard(h, ctrl, body)
    return out


def make_binned_tracer(grid, scene: SceneArrays, lights: Lights, media9, nee_max_media: int,
                       list_len: int = 8, cap_iters: int = 12,
                       direct_mode: str = "scatter", ex=None) -> Tracer:
    wlo, whi = scene.world_lo, scene.world_hi
    K = nee_list_len(nee_max_media)

    def closest(org, direction, alive):
        bound = torch.where(alive, torch.full_like(org[:, 0], T_MAX), torch.zeros_like(org[:, 0]))
        out = trace_binned(grid, media9, org, direction, bound, "full", world_lo=wlo,
                           world_hi=whi, list_len=list_len, cap_iters=cap_iters, ex=ex)
        return shaded_hit(*out)

    def distance(position, dir_after, transmitted, rngs, med):
        def trace():
            bound = distance_bound(rngs, transmitted, med, direct_mode)
            dt, dslot = trace_binned(grid, media9, position, dir_after, bound, "dist",
                                     world_lo=wlo, world_hi=whi, list_len=list_len,
                                     cap_iters=cap_iters, ex=ex)
            return torch.where(dslot >= 0.0, dt, torch.full_like(dt, T_MAX))

        seg = torch.full(position.shape[:1], T_MAX, dtype=torch.float32, device=position.device)
        return guarded(ex, transmitted, seg, trace)

    def direct(position, active):
        light_value, ldir, ldist, eff = light_setup(position, lights, active)

        def trace():
            out = trace_binned(grid, media9, position, ldir, eff, "nee",
                               nee_max_media=nee_max_media, list_len=list_len,
                               cap_iters=cap_iters, ex=ex)
            tr = _march_klist(out[:K], out[K:2 * K], out[2 * K], ldist, eff, active, scene.media,
                              scene.scale)
            return light_value * tr

        return guarded(ex, active, light_value.clone(), trace)

    return Tracer(closest=closest, distance=distance, direct=direct)


def kern_state(state: MegaState, ld: bool, dim0) -> _State:
    """The integrator's state over a MegaState; in ld mode the rng rows
    are [shuffled sample, pixel hash, dim] with dim the pass loop's base
    (an int, or a 0-dim int32 tensor: the control block's)."""
    n = state.org.shape[0]
    rng = state.rng
    if ld:
        dim = (dim0.to(torch.int64).expand(n) if isinstance(dim0, torch.Tensor)
               else torch.full_like(state.rng, int(dim0)))
        rng = torch.stack([state.rng, state.aux, dim], dim=-1)
    return _State(org=state.org, dir=state.dir, thr=state.thr, rad=state.rad, rng=rng,
                  depth=state.depth, alive=state.alive,
                  lane=torch.arange(n, dtype=torch.int64, device=state.org.device))


def write_back(state: MegaState, st: _State, ld: bool) -> None:
    """Copy the bounced state into the pass loop's tensors:
    render/megarender.py expects its per-pass kernel to update the state
    in place."""
    state.org.copy_(st.org)
    state.dir.copy_(st.dir)
    state.thr.copy_(st.thr)
    state.rad.copy_(st.rad)
    state.rng.copy_(st.rng[:, 0] if ld else st.rng)
    state.depth.copy_(st.depth)
    state.alive.copy_(st.alive)


def bounce_kern(make_tracer, bounce, ld: bool, prepare):
    """megarender's per-pass kernel over a wavefront bounce: advance every
    live lane up to ``max_iters`` bounces (the JAX ``lax.while_loop`` on
    ``it < max_iters & any(alive)``), updating the state in place. It takes
    the pass plan's executor (``ex``) and control block (``ctrl``, whose
    ld base it reads; ``live_blocks`` is accepted and unused: the wavefront
    bounce compacts by sorting lanes with work first).
    ``make_tracer(ex)`` gives the tracer, ``bounce(ex, st, tracer)`` one
    bounce of ``st``."""

    def kern(state: MegaState, max_iters: int = 1, live_blocks=None, dim0=0, ctrl=None,
             ex=None):
        del live_blocks
        dev = state.org.device
        ex = pc.executor(dev, ex)
        st = kern_state(state, ld, ctrl[pc.CTRL_DIM0] if ctrl is not None else dim0)
        if ld:  # the ld rows are the loop's own: updated in place
            st = st._replace(rng=st.rng.contiguous())
        tracer = make_tracer(ex)
        loop_ctrl = pc.new_ctrl(dev)
        flags = pc.COND | pc.ITER_CAP

        def body(h):
            for x, y in zip(st, bounce(ex, st, tracer)):
                x.copy_(y)
            ex.control(st.alive, loop_ctrl, flags | pc.ITER_STEP, cap=max_iters, handle=h)

        h = ex.cond()
        ex.control(st.alive, loop_ctrl, flags | pc.ITER_RESET, cap=max_iters, handle=h)
        ex.loop(h, loop_ctrl, body)
        write_back(state, st, ld)
        return state

    kern.takes_executor = True
    kern.prepare = prepare
    return kern


def engine_prepare(*libraries, ld: bool):
    """A kern's ``prepare``: build the ``libraries`` (kernels.build
    functions with their arguments) and the pass control library, and make
    the Sobol rows in ld mode, before a capture."""

    def prepare(device, lanes: int) -> None:
        from ..kernels import build
        from ..ops import rng as rng_ops

        build.pass_control()
        for fn, *args in libraries:
            getattr(build, fn)(*args)
        if ld:
            rng_ops.sobol_table(device)

    return prepare


def make_binned_kern(grid, scene: SceneArrays, lights: Lights, media9, max_depth: int,
                     rr_depth: int, nee_max_media: int, tir: str, list_len: int = 8,
                     cap_iters: int = 12, direct: str = "scatter", ld: bool = False):
    """A drop-in for megarender's per-pass kernel (``bounce_kern``) with
    every trace through the binned tracer."""
    scene = dataclasses.replace(scene, media=media_tensors(scene.media, grid.device))

    def make_tracer(ex):
        return make_binned_tracer(grid, scene, lights, media9, nee_max_media, list_len,
                                  cap_iters, direct_mode=direct, ex=ex)

    def bounce(ex, st, tracer):
        return _bounce(st, scene, None, lights, max_depth, rr_depth, nee_max_media, tir,
                       tracer=tracer, direct=direct)

    prepare = engine_prepare(("binned_listing", list_len), ("binned_round", list_len,
                                                             nee_max_media), ld=ld)
    return bounce_kern(make_tracer, bounce, ld, prepare)
