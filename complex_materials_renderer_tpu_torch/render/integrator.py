"""Wavefront volumetric path-tracing integrator.

Counterpart of complex_materials_renderer_tpu/render/integrator.py
(:61-618): a batch of (pixel, sample) lanes advances bounce by bounce,
every physics op runs masked, and each RNG draw is gated by the same
masks, so each lane consumes its stream in the order the reference's
thread would (reference volpath.comp.glsl:564-805; see the JAX module for
the control-flow map and the parity quirks kept: NEE phase weight at
outDir = 0, scatter origin along the new direction, diffuse local-frame
direction used as world, the 0.9 per-boundary shadow factor).

The traces go through ``kernels/traverse.py``: on the cluster backend
they launch the closest-hit kernel K3 on the card, on the BVH backend
they run the plain threaded-BVH walk. Everything else is PyTorch on the
lanes. As the JAX package runs a tile render as one program, the loops
and guards run on an executor (kernels/pass_control.py): the sample loop,
the two-phase bounce loop's ``lax.while_loop``s (:569-601) and the BVH
walk are WHILE loops, the ``lax.cond`` guards (skip the distance trace
when no lane transmitted, :220; skip a march step when no lane has
distance left, :160) IF guards, their state updated in place. On the card
``render_beauty`` captures each call shape once as a CUDA graph whose
loops and guards are conditional nodes (render/megarender.py
``CallGraph``), so no value goes to the host between a call's first launch
and its last; on the CPU, and on the card with ``executor='eager'``, the
host reads each condition.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..kernels import pass_control as pc
from ..kernels.partition import coherence_key
from ..kernels.traverse import trace_shaded
from ..ops import rng as rng_ops
from ..ops.camera import Camera, generate_rays
from ..ops.diffuse import REFLECTANCE, diffuse_eval, diffuse_sample
from ..ops.fresnel import fresnel_r, reflect, refract
from ..ops.medium import analytic_direct_scale, eval_transmittance, lookup, sample_distance
from ..ops.phase import g_mean, hg_eval_zero, hg_sample
from ..ops.vec import dot, norm, safe_normalize
from .hitinfo import T_MAX, T_MIN, Lights, SceneArrays, shade_color

_norm = safe_normalize  # integrator.py:61


def _boundary_event(direction, normal, medium_ior):
    """Fresnel boundary quantities of both boundary events (volpath:635-667,
    :723-753): reflected and transmitted directions, the reflectance (0
    under TIR) and the TIR mask; under TIR the transmitted direction is the
    reflection."""
    going_out = dot(direction, normal) > 0.0
    air = torch.ones_like(medium_ior)
    from_ior = torch.where(going_out, medium_ior, air)
    to_ior = torch.where(going_out, air, medium_ior)
    refr, tir = refract(direction, normal, from_ior, to_ior)
    refr = _norm(torch.where(tir[:, None], normal, refr))
    refl = _norm(reflect(direction, normal))
    r = fresnel_r(from_ior, to_ior, direction, normal)
    transmitted_dir = torch.where(tir[:, None], refl, refr)
    return refl, transmitted_dir, r, tir


def light_setup(position, lights: Lights, active):
    """(light_value (R, 3), direction, distance, distance on active lanes
    else 0) of the NEE toward the point light (volpath:337-345)."""
    to_light = lights.position[None, :] - position
    light_dist = norm(to_light)
    inv = 1.0 / torch.clamp(light_dist, min=1e-20)
    light_value = lights.intensity[None, :] * (inv * inv)[:, None]
    ldir = to_light * inv[:, None]
    return light_value, ldir, light_dist, torch.where(active, light_dist,
                                                      torch.zeros_like(light_dist))


def sample_direct_light(position, scene: SceneArrays, accel, lights: Lights, active,
                        max_media: int, ex=None):
    """Next-event estimation toward the point light through at most
    ``max_media`` media boundary pairs, two traces per pair
    (volpath:337-426). Draws no RNG. A medium-less hit occludes; each
    medium segment multiplies Beer-Lambert transmittance and 0.9; a lane
    still mid-march after ``max_media`` pairs is dark. Each pair step runs
    under a guard on ``active & (remaining > 0)`` (the JAX ``lax.cond``,
    integrator.py:156-165), by the executor ``ex``."""
    ex = pc.executor(position.device, ex)
    light_value, ldir, _, remaining = light_setup(position, lights, active)
    # The march's carry, updated in place by the guarded steps.
    trans = torch.ones_like(position)
    origin = position.clone()
    remaining = remaining.clone()
    ctrl = pc.new_ctrl(position.device)

    def shaded(o, t_max, act):
        return trace_shaded(o, ldir, accel, scene.v0, scene.v1, scene.v2, scene.mat_ids,
                            T_MIN, t_max, active=act, ex=ex)

    def march_step(run, _h):
        h1 = shaded(origin, remaining * 0.999, run)
        med1 = lookup(h1.mat_id, scene.media, scene.scale)
        occluded = run & h1.hit & ~med1.has_medium
        tr = torch.where(occluded[:, None], torch.zeros_like(trans), trans)
        enter = run & h1.hit & med1.has_medium
        rem_after_enter = remaining - h1.t
        h2 = shaded(h1.position, torch.clamp(rem_after_enter, min=T_MIN), enter)
        med2 = lookup(h2.mat_id, scene.media, scene.scale)
        occluded2 = enter & h2.hit & ~med2.has_medium
        tr = torch.where(occluded2[:, None], torch.zeros_like(tr), tr)
        pair = enter & h2.hit & med2.has_medium
        seg = torch.minimum(h2.t, rem_after_enter)
        seg_tr = eval_transmittance(seg, med1.sigma_s, med1.sigma_a)
        trans.copy_(torch.where(pair[:, None], tr * 0.9 * seg_tr, tr))
        origin.copy_(torch.where(pair[:, None], h2.position, origin))
        remaining.copy_(torch.where(pair, rem_after_enter - h2.t, torch.zeros_like(remaining)))

    for _ in range(max_media):
        run = active & (remaining > 0.0)
        h = ex.cond()
        ex.control(run, ctrl, pc.COND, site="NEE march guard", handle=h)
        ex.guard(h, ctrl, partial(march_step, run))
    trans = torch.where((remaining > 0.0)[:, None], torch.zeros_like(trans), trans)
    return light_value * trans


class Tracer(NamedTuple):
    """Trace hooks of ``_bounce`` (integrator.py:177); none draws RNG.

    closest(org, dir, active) -> ShadedHit
    distance(position, dir, transmitted, rngs, med) -> seg_len (R,)
    direct(position, active) -> (R, 3) incident light after occlusion and
        media transmittance (the NEE march)
    """

    closest: object
    distance: object
    direct: object


def default_tracer(scene: SceneArrays, accel, lights: Lights, nee_max_media: int,
                   ex=None) -> Tracer:
    """Closest and distance traces via ``trace_shaded``, NEE via the
    per-leg chained march (``sample_direct_light``); ``ex`` runs the
    guards and the BVH walk's loop (``pass_control.executor``)."""

    def closest(org, direction, alive):
        return trace_shaded(org, direction, accel, scene.v0, scene.v1, scene.v2,
                            scene.mat_ids, T_MIN, T_MAX, active=alive, ex=ex)

    def distance(position, dir_after, transmitted, _rngs, _med):
        # Only medium-transmitted lanes need it: a guard on any(transmitted)
        # (the JAX ``lax.cond``, integrator.py:211-223).
        run = pc.executor(position.device, ex)
        seg = torch.full(position.shape[:1], T_MAX, dtype=torch.float32, device=position.device)
        ctrl = pc.new_ctrl(position.device)

        def dist_trace(_h):
            h = trace_shaded(position, dir_after, accel, scene.v0, scene.v1, scene.v2,
                             scene.mat_ids, T_MIN, T_MAX, active=transmitted, ex=run)
            seg.copy_(torch.where(h.hit, h.t, torch.full_like(h.t, T_MAX)))

        h = run.cond()
        run.control(transmitted, ctrl, pc.COND, site="distance trace guard", handle=h)
        run.guard(h, ctrl, dist_trace)
        return seg

    def direct(position, active):
        return sample_direct_light(position, scene, accel, lights, active, nee_max_media, ex=ex)

    return Tracer(closest=closest, distance=distance, direct=direct)


class _State(NamedTuple):
    org: torch.Tensor  # (R, 3)
    dir: torch.Tensor  # (R, 3)
    thr: torch.Tensor  # (R, 3)
    rad: torch.Tensor  # (R, 3)
    rng: torch.Tensor  # (R,) u32 words in int64; (R, 3) in ld mode
    depth: torch.Tensor  # (R,) int32
    alive: torch.Tensor  # (R,) bool
    lane: torch.Tensor  # (R,) int64 original lane id (compaction permutes)


def state_from_jax_arrays(org, dir, thr, rad, rng, depth, alive, lane, device="cpu") -> _State:
    """A ``_State`` from the JAX package's ``_State`` fields as numpy
    arrays (uint32 ``rng`` words become int64)."""
    import numpy as np

    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dt))).to(device)  # noqa: E731
    return _State(
        org=t(org, np.float32), dir=t(dir, np.float32), thr=t(thr, np.float32),
        rad=t(rad, np.float32), rng=t(np.asarray(rng, np.uint32), np.int64),
        depth=t(depth, np.int32), alive=t(alive, np.bool_), lane=t(lane, np.int64),
    )


def _compact(state: _State, scene: SceneArrays) -> _State:
    """Dead lanes last, live lanes sorted for ray coherence
    (integrator.py:256). The sort is stable, like ``jnp.argsort``."""
    key = coherence_key(state.org, state.dir, state.alive, scene.world_lo, scene.world_hi)
    order = torch.argsort(key, stable=True)
    return _State(*(x[order] for x in state))


def _bounce(state: _State, scene: SceneArrays, accel, lights: Lights, max_depth: int,
            rr_depth: int, nee_max_media: int, tir: str = "reflect",
            tracer: Tracer | None = None, direct: str = "scatter") -> _State:
    """One bounce of every lane (integrator.py:289)."""
    org, direction, thr, rad, rngs, depth, alive, lane_id = state
    if tracer is None:
        tracer = default_tracer(scene, accel, lights, nee_max_media)
    z3 = torch.zeros_like(thr)

    sh = tracer.closest(org, direction, alive)
    got_hit = alive & sh.hit
    position = sh.position
    normal = sh.normal
    med = lookup(sh.mat_id, scene.media, scene.scale)
    color = shade_color(position, normal, scene.background)
    has_med = got_hit & med.has_medium

    # Boundary event #1 (volpath:633-670).
    refl1, trans_dir1, r1, tir1 = _boundary_event(direction, normal, med.ior)
    rngs, rand_fresnel = rng_ops.next_float_masked(rngs, has_med)
    do_reflect = has_med & (rand_fresnel < r1)
    transmitted = has_med & ~do_reflect
    dir_after = torch.where(do_reflect[:, None], refl1,
                            torch.where(transmitted[:, None], trans_dir1, direction))
    org = torch.where(do_reflect[:, None], position, org)
    depth = depth + has_med.to(torch.int32)

    # Distance to the boundary (volpath:675-688) and free flight (:691).
    seg_len = tracer.distance(position, dir_after, transmitted, rngs, med)
    rngs, rand_dist = rng_ops.next_float_masked(rngs, transmitted)
    ms = sample_distance(rand_dist, med.sigma_s, med.sigma_a, seg_len)
    kill_tir = tir == "kill"
    scatter = transmitted & ms.success
    if kill_tir:
        scatter = scatter & ~tir1
    pass_med = transmitted & ~scatter

    # Diffuse gate (volpath:758-764).
    diffuse = got_hit & ~has_med
    backface = diffuse & (dot(direction, normal) > 0.0)
    shade = diffuse & ~backface

    # Shared NEE (volpath:697, :773); analytic: the closed-form direct term
    # on every transmitted segment of a scatterable medium.
    analytic = direct == "analytic"
    if analytic:
        ad_gate, ad_scale = analytic_direct_scale(med.sigma_s, med.sigma_a, seg_len)
        ad_gate = transmitted & ad_gate
        if kill_tir:
            ad_gate = ad_gate & ~tir1
        light = tracer.direct(position, ad_gate | shade)
    else:
        light = tracer.direct(position, scatter | shade)

    g = g_mean(med.g)
    phase_nee = hg_eval_zero(g)  # outDir still vec3(0) at eval time
    if analytic:
        rad = rad + torch.where(ad_gate[:, None], thr * ad_scale * light * phase_nee[:, None], z3)

    # Scatter branch (volpath:693-710).
    safe_ps = torch.where(ms.prob_success > 0.0, ms.prob_success, torch.ones_like(ms.prob_success))
    scatter_scale = med.sigma_s * ms.transmittance / safe_ps[:, None]
    scatter_scale = torch.where((ms.prob_success > 0.0)[:, None], scatter_scale, z3)
    thr = torch.where(scatter[:, None], thr * scatter_scale, thr)
    if not analytic:
        rad = rad + torch.where(scatter[:, None], thr * light * phase_nee[:, None], z3)
    rngs, r_ph1 = rng_ops.next_float_masked(rngs, scatter)
    rngs, r_ph2 = rng_ops.next_float_masked(rngs, scatter)
    hg_dir, _ = hg_sample(-dir_after, g, r_ph1, r_ph2)
    org = torch.where(scatter[:, None], position + hg_dir * ms.t[:, None], org)
    new_dir = torch.where(scatter[:, None], hg_dir, dir_after)

    # Pass-through branch (volpath:713-756), boundary #2 with the stale
    # entry normal.
    safe_pf = torch.where(ms.prob_fail > 0.0, ms.prob_fail, torch.ones_like(ms.prob_fail))
    pass_scale = ms.transmittance / safe_pf[:, None]
    pass_scale = torch.where((ms.prob_fail > 0.0)[:, None], pass_scale, z3)
    thr = torch.where(pass_med[:, None], thr * pass_scale, thr)
    pass_org = position + dir_after * ms.t[:, None]
    refl2, trans_dir2, r2, tir2 = _boundary_event(dir_after, normal, med.ior)
    rngs, rand_fresnel2 = rng_ops.next_float_masked(rngs, pass_med)
    pass_dir = torch.where((rand_fresnel2 < r2)[:, None], refl2, trans_dir2)
    org = torch.where(pass_med[:, None], pass_org, org)
    new_dir = torch.where(pass_med[:, None], pass_dir, new_dir)

    # Diffuse branch (volpath:758-779).
    rngs, r_d1 = rng_ops.next_float_masked(rngs, shade)
    rngs, r_d2 = rng_ops.next_float_masked(rngs, shade)
    wo_local, _bsdf = diffuse_sample(-direction, normal, r_d1, r_d2)
    thr = torch.where(shade[:, None], thr * REFLECTANCE, thr)
    deval = diffuse_eval(-direction, wo_local, normal)
    rad = rad + torch.where(shade[:, None], thr * light * deval * color, z3)
    wo_world = _norm(wo_local)  # the local->world quirk (volpath:777)
    org = torch.where(shade[:, None], position + wo_world * T_MIN, org)
    new_dir = torch.where(shade[:, None], wo_world, new_dir)

    redirected = do_reflect | scatter | pass_med | shade
    direction = torch.where(redirected[:, None], new_dir, direction)

    # Depth and Russian roulette (volpath:786-797).
    enders = scatter | shade
    depth = depth + (enders | pass_med).to(torch.int32)
    rr = enders & (depth > rr_depth)
    rngs, rand_rr = rng_ops.next_float_masked(rngs, rr)
    q = torch.clamp(thr.amax(dim=-1), max=0.95)
    survive = rand_rr <= q
    thr = torch.where((rr & survive)[:, None], thr / torch.clamp(q, min=1e-20)[:, None], thr)
    continuing = do_reflect | pass_med | (enders & (~rr | survive))
    alive = continuing & (depth < max_depth)
    if kill_tir:
        alive = alive & ~((transmitted & tir1) | (pass_med & tir2))
    return _State(org, direction, thr, rad, rngs, depth, alive, lane_id)


def _step_into(state: _State, step) -> None:
    """One loop step written back into ``state``'s tensors, so that a loop
    body of a graph finds them at the same addresses every iteration."""
    for x, y in zip(state, step(state)):
        x.copy_(y)


def _while_alive(ex, state: _State, step, cap: int = 0, threshold: int = 0) -> None:
    """``step`` ``state`` in place while a lane is alive; with ``cap``, as
    phase A (integrator.py:574-579): while a lane is alive for the first
    ``cap`` steps, then while more than ``threshold`` are."""
    ctrl = pc.new_ctrl(state.alive.device)
    flags = pc.COND | (pc.ITER_GRACE if cap else 0)
    kw = dict(cap=cap, threshold=threshold) if cap else {}

    def body(h):
        _step_into(state, step)
        ex.control(state.alive, ctrl, flags | pc.ITER_STEP, site="wavefront bounce step",
                   handle=h, **kw)

    h = ex.cond()
    ex.control(state.alive, ctrl, flags | pc.ITER_RESET, site="wavefront loop head", handle=h,
               **kw)
    ex.loop(h, ctrl, body)


def _wavefront_program(ex, *inputs, scene, accel, lights, width, height, num_samples,
                       rng_mode, full, max_depth, rr_depth, nee_max_media, compact, tir,
                       direct):
    """The device work of one ``render_beauty`` call: (image, next RNG
    words) from the camera, the pixels, their linear frame indices, the
    first RNG words and the sample offset. The sample loop is a counted
    WHILE loop (the JAX ``lax.scan``, integrator.py:604-609), so a graph
    captures its body once however many samples a call takes."""
    camera, (pixel_xy, linear, words0, offset) = Camera(*inputs[:5]), inputs[5:]
    dev = linear.device
    r = linear.shape[0]
    tracer = default_tracer(scene, accel, lights, nee_max_media, ex=ex)

    def step(s):
        s = _bounce(s, scene, accel, lights, max_depth, rr_depth, nee_max_media, tir,
                    tracer=tracer, direct=direct)
        return _compact(s, scene) if compact else s

    # The sample loop's carry: the summed radiance, the parity words and
    # the sample index, updated in place.
    acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    words = words0.clone()
    s_idx = offset.clone()
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    ctrl = pc.new_ctrl(dev)

    def one_sample(h):
        s_lane = s_idx & rng_ops.MASK32
        w = words
        if rng_mode == "counter":
            w = rng_ops.seed_counter(linear, s_lane)
        elif rng_mode == "ld":
            w = rng_ops.seed_ld(linear, s_lane)
        w, j1 = rng_ops.next_float(w)
        w, j2 = rng_ops.next_float(w)
        org, direction = generate_rays(camera, pixel_xy, torch.stack([j1, j2], dim=-1), full)
        state = _State(
            org=org.contiguous(), dir=direction.contiguous(),
            thr=torch.ones((r, 3), dtype=torch.float32, device=dev),
            rad=torch.zeros((r, 3), dtype=torch.float32, device=dev),
            rng=w, depth=torch.zeros((r,), dtype=torch.int32, device=dev),
            alive=torch.ones((r,), dtype=torch.bool, device=dev),
            lane=torch.arange(r, dtype=torch.int64, device=dev),
        )
        rad = torch.zeros((r, 3), dtype=torch.float32, device=dev)
        rng_out = torch.zeros_like(w)
        # Two-phase loop (integrator.py:561-601): full width until the live
        # set fits in r/8 (compaction keeps live lanes first, so a slice is
        # exact), then the narrow state to termination.
        if compact and r >= 8 * 1024:
            r2 = max(1024, r // 8)
            _while_alive(ex, state, step, cap=8, threshold=r2)
            rad[state.lane] = state.rad
            rng_out[state.lane] = state.rng
            state = _State(*(x[:r2] for x in state))
        _while_alive(ex, state, step)
        rad[state.lane] = state.rad
        rng_out[state.lane] = state.rng
        acc.add_(rad)
        words.copy_(rng_out)
        s_idx.add_(1)
        ex.control(one, ctrl, pc.COND | pc.ITER_STEP | pc.ITER_CAP,
                   site="wavefront sample loop step", cap=num_samples, handle=h)

    h = ex.cond()
    ex.control(one, ctrl, pc.COND | pc.ITER_RESET | pc.ITER_CAP,
               site="wavefront sample loop head", cap=num_samples, handle=h)
    ex.loop(h, ctrl, one_sample)
    img = (acc / float(num_samples)).reshape(height, width, 3)
    return img, words


class _WavefrontPrepare:
    """What a capture of a wavefront call launches, made before it: the
    libraries and the tables read on the device (``_execute``'s
    ``prepare``)."""

    def __init__(self, accel, rng_mode):
        self.accel, self.rng_mode = accel, rng_mode

    def __call__(self, device, lanes: int) -> None:
        from ..kernels import build
        from ..kernels.cluster_grid import DeviceClusterGrid

        build.pass_control()
        if isinstance(self.accel, DeviceClusterGrid):
            build.cluster_trace()
        if self.rng_mode == "ld":
            rng_ops.sobol_table(device)


def render_beauty(
    camera: Camera,
    scene: SceneArrays,
    accel,
    lights: Lights,
    resolution,
    num_samples: int,
    max_depth: int = 32,
    rr_depth: int = 16,
    nee_max_media: int = 4,
    rng_mode: str = "parity",
    pixel_offset=0,
    row_offset=0,
    full_resolution=None,
    sample_offset=0,
    rng_state=None,
    return_rng=False,
    compact: bool = True,
    tir: str = "reflect",
    direct: str = "scatter",
    executor: str = "auto",
):
    """Render an (H, W, 3) tile of the beauty pass with the wavefront
    engine, on the device of ``accel`` (integrator.py:472; same contract).

    The image is the mean over this call's samples. ``rng_state`` (u32
    words in int64; (R, 3) in ld mode) carries the parity stream across
    sample chunks and ``return_rng`` returns it; ``pixel_offset``,
    ``row_offset`` and ``full_resolution`` place the tile in the frame;
    ``sample_offset`` is an int or a tensor.

    On the card the call runs as one CUDA graph per call shape, its loops
    and guards conditional nodes, as the JAX ``jit`` runs it as one program;
    ``executor='eager'`` runs the same steps from the host instead (the
    comparison for the graph). On the CPU the host reads each condition.
    """
    from .megarender import _execute, _sample_offset_on, pass_cache

    if rng_mode not in ("parity", "counter", "ld"):
        raise ValueError(f"rng mode must be parity|counter|ld, got {rng_mode!r}")
    dev = accel.device
    cache = pass_cache(scene, accel, lights)
    width, height = resolution
    full = tuple(full_resolution) if full_resolution else (width, height)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int64, device=dev),
                            torch.arange(width, dtype=torch.int64, device=dev), indexing="ij")
    pixel_xy = torch.stack([xs.reshape(-1) + pixel_offset, ys.reshape(-1) + row_offset], dim=-1)
    linear = pixel_xy[:, 1] * full[0] + pixel_xy[:, 0]
    r = pixel_xy.shape[0]
    offset = _sample_offset_on(sample_offset, dev)
    if rng_state is not None:
        words = rng_ops.to_u32(rng_state.to(dev))
    elif rng_mode == "ld":
        words = rng_ops.seed_ld(linear, torch.zeros((1,), dtype=torch.int64, device=dev))
    else:
        words = rng_ops.seed_from_pixel(linear)
    knobs = dict(max_depth=max_depth, rr_depth=rr_depth, nee_max_media=nee_max_media,
                 rng_mode=rng_mode, compact=compact, tir=tir, direct=direct)
    program = partial(_wavefront_program, scene=cache.wave_scene, accel=accel, lights=lights,
                      width=width, height=height, num_samples=num_samples, full=full, **knobs)
    key = ("wavefront", width, height, num_samples, full, tuple(words.shape),
           tuple(sorted(knobs.items())))
    img, final_rng = _execute(scene, accel, lights, _WavefrontPrepare(accel, rng_mode), key,
                              program, (*camera, pixel_xy, linear, words, offset), executor, r)
    if return_rng:
        return img, final_rng
    return img
