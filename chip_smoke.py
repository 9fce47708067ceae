#!/usr/bin/env python3
"""Smoke test of complex_materials_renderer_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the CUDA kernels of
   ``csrc/`` with nvcc (one process per library, started together): the
   megakernel for ``--nee-bound`` 1, 4, 8 and 10 and the closest-hit
   kernel, each with its ptxas line (registers, spills);
2. holds the path-tracing kernel (K1, with the triangle tester K2
   inlined) against its plain PyTorch version on the card, from one
   65,536-lane state of the showcase scene, in six cases: parity to
   termination, counter with one iteration on part of the blocks, ld from
   Sobol dimension 2, TIR kill with the analytic direct term, an
   opaque/media partitioned grid, and ``--nee-bound 10``. rng, depth and
   alive must be equal on all lanes but the flip lanes (those whose depth
   or alive differ), at most 1e-3 of the lanes; rad, thr, org and dir
   within atol 1e-4 and rtol 1e-4 on the other lanes;
3. holds the closest-hit kernel (K3) against its plain version on the
   card: 65,536 showcase primary rays and 65,536 bounce-like rays (random
   directions from the primary hits, a third of the lanes parked, a
   per-lane t_max), on the default, the quads-off and the partitioned
   grid. Slot and material must be equal on every lane and the floats
   within atol 1e-6 (the worst error is printed; both round every
   operation once, in the same order). Against the BVH walk of the same
   rays on the quads-off grid (a merged quad slot reports one of its two
   triangles), prim must be equal on all but 1e-3 of the lanes (K3's
   additive far-edge epsilon admits hits up to 2e-6 past an edge);
4. drives the main path: a default (megakernel) render of
   scenes/showcase.obj at 512x512 with 16 samples per pixel (parity RNG)
   through ``Renderer``, timed after one warm-up, with K1's launch count;
   then the 64x64 at 32 spp render against tests/golden/showcase_gate.npz
   under the flip-budgeted gate (non-flip RMSE <= 1e-3, at most 24 pixels
   with |diff| > 1e-2);
5. drives the wavefront path: the same showcase render with ``--engine
   wavefront`` after a small warm-up, timed, with K3's launch count, held
   against the megakernel image (non-flip RMSE <= 1e-3, flip pixels at most
   0.6% of the image: the golden budget of 24 of 4,096, scaled); the
   showcase_gate golden through the wavefront engine; the depth, normal
   and topology AOVs of showcase at 512x512 through K3 against the same
   passes through its plain version on the card (equal); and
   scenes/isobox.obj at 64x64 with 2 spp through ``--backend bvh --engine
   wavefront`` on the card against tests/golden/isobox.npz (the gate);
6. times K1 and K3 with CUDA events at their widest launches on the main
   paths (65,536 fresh lanes: K1 one bounce, K3 the closest trace of the
   primary rays), times the plain versions on the same inputs, and
   computes each bound from its input: a plain pass finds, for each ray
   set, the clusters whose box the ray meets before its final hit (or its
   own bound), and counts their real slots and boxes at the f32
   operations of the CUDA tests;
7. prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero before the last line. ``--quick`` stops
after the first kernel comparisons; ``--profile`` adds a torch.profiler
breakdown of one main-path pass of each engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "complex_materials_renderer_tpu_torch"

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# H100 SXM float32 outside the tensor cores: 67 TFLOP/s counts an FMA as
# two operations. The kernel is built with --fmad=false and the counts
# below take each add, mul, min/max, abs, compare and divide as one
# operation, so they are held against one operation per core per clock.
PEAK_F32_OPS = 67e12 / 2
# f32 operations of the CUDA tests (csrc/cluster_test.cuh), counted from
# the source: slab_hit is 6 sub + 6 mul + 6 min/max per box, 4 to combine
# the axes, 2 clamps and 1 compare; origin_terms (shared by both ray sets
# of the fused walk) is 3 sub + 9 for q + 5 for the t numerator;
# direction_terms is 9 for p + 5 for det + 3 for 1/det + 6 + 6 + 1;
# inside is 2 sub + 2 compares + 2 x (4 + 1); the t window is 2 compares.
# The bounce's shading, the key insertion (integer) and the media lookup
# are left out, so the bound is a floor.
SLAB_OPS = 25
ORIGIN_OPS = 17
RAY_OPS = 30 + 14 + 2
# Per lane the parity call reads org, dir, thr, rad (12 f32), rng (int64),
# depth (int32) and alive (bool) once and writes them once.
STATE_BYTES = 12 * 4 + 8 + 4 + 1

# K3 moves 7 f32 per ray in (origin, direction, t_max) and 11 out (t,
# slot, u, v, normal, material, position).
K3_RAY_BYTES = (7 + 11) * 4

BAND_ROWS = 128  # rows of 512 pixels in one main-path pass: 65,536 lanes
FLIP_FRAC = 1e-3
ATOL = 1e-4
RTOL = 1e-4
K3_ATOL = 1e-6
WAVEFRONT_FLIP_FRAC = 24 / 4096  # the golden gate's flip budget, per pixel
# Device sleep queued ahead of each timed launch: about 10 ms at the H100's
# clock, far longer than a wrapper's host work.
SLEEP_CYCLES = 20_000_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper to 0."""
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    mk.trace_paths_mega.launches = 0
    ctr.trace_core.launches = 0


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def showcase_options(width, height, spp, obj="showcase", **kw):
    from complex_materials_renderer_tpu_torch.config import RenderOptions
    from complex_materials_renderer_tpu_torch.scene import load_scene

    obj = os.path.join(REPO, "scenes", f"{obj}.obj")
    base = dict(width=width, height=height, num_samples=spp, rng="parity", device="cuda")
    base.update(kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **base))
    return scene, dataclasses.replace(scene.options, **base)


def band_state(r, rng_mode):
    """The state of the main path's first kernel call over the first
    128 rows of showcase at 512x512, 16 spp (65,536 lanes), built by the
    renderer's own ``first_pass_state``."""
    from complex_materials_renderer_tpu_torch.render.megarender import first_pass_state

    opt = r.options
    state, _ = first_pass_state(r.camera, (opt.width, BAND_ROWS), opt.num_samples, rng_mode,
                                full_resolution=(opt.width, opt.height))
    return state


def clone_state(st):
    from complex_materials_renderer_tpu_torch.kernels.megakernel import MegaState

    return MegaState(*(x.clone() for x in st))


def compare_states(name, a, b):
    """Flip-budgeted comparison of kernel state ``a`` with plain ``b``;
    returns (flip lanes, worst float error on the other lanes)."""
    import torch

    n = a.depth.shape[0]
    flip = (a.depth != b.depth) | (a.alive != b.alive)
    n_flip = int(flip.sum())
    keep = ~flip
    rng_bad = int((a.rng[keep] != b.rng[keep]).sum())
    worst = 0.0
    bad_fields = []
    for f in ("rad", "thr", "org", "dir"):
        x, y = getattr(a, f)[keep], getattr(b, f)[keep]
        err = (x - y).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        if not torch.all(err <= ATOL + RTOL * y.abs()):
            bad_fields.append(f)
        if not torch.isfinite(x).all():
            bad_fields.append(f + " (not finite)")
    print(f"   {name}: lanes {n}, flip lanes {n_flip}, rng mismatches {rng_bad}, "
          f"worst float error {worst:.3e}, alive after {int(a.alive.sum())}", flush=True)
    if n_flip > FLIP_FRAC * n:
        fail(f"{name}: {n_flip} flip lanes exceed {FLIP_FRAC} of {n}")
    if rng_bad:
        fail(f"{name}: rng differs on {rng_bad} non-flip lanes")
    if bad_fields:
        fail(f"{name}: {bad_fields} outside atol {ATOL} rtol {RTOL}")
    return n_flip, worst


def kernel_vs_plain(r, r_part, quick):
    """K1 against its plain version on the card."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.kernels.megakernel import (
        pack_media, pack_misc, trace_paths_mega, trace_paths_mega_plain,
    )

    opt = r.options
    media9 = pack_media(r.scene_arrays.media, r.scene_arrays.scale, device=r.device)
    misc = pack_misc(r.lights, r.scene_arrays.world_lo, r.scene_arrays.world_hi, device=r.device)
    base = dict(background=opt.background, max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                nee_max_media=opt.nee_max_media)
    cases = [
        ("parity, max_iters=max_depth", r.accel, "parity", dict()),
        ("counter, max_iters=1, live_blocks=5/8 of the blocks", r.accel, "counter",
         dict(max_iters=1, live_blocks=BAND_ROWS * 512 // mk.BLOCK * 5 // 8)),
        ("ld, dim0=2", r.accel, "ld", dict(ld=True, dim0=2)),
        ("tir_kill + analytic_direct", r.accel, "parity", dict(tir_kill=True, analytic_direct=True)),
        ("partitioned grid", r_part.accel, "parity", dict()),
        ("nee_max_media=10", r.accel, "parity", dict(nee_max_media=10)),
    ]
    if quick:
        cases = cases[:1]
    worst = 0.0
    for name, grid, rng_mode, kw in cases:
        st = band_state(r, rng_mode)
        a, b = clone_state(st), clone_state(st)
        launches = mk.trace_paths_mega.launches
        trace_paths_mega(grid, media9, misc, a, **{**base, **kw})
        torch.cuda.synchronize()
        mk.trace_paths_mega.launches = launches  # comparison launches do not count
        trace_paths_mega_plain(grid, media9, misc, b, **{**base, **kw})
        torch.cuda.synchronize()
        _, err = compare_states(name, a, b)
        worst = max(worst, err)
        if "live_blocks" in kw:
            lanes = kw["live_blocks"] * mk.BLOCK
            for f in ("org", "rad", "rng", "depth", "alive"):
                if not torch.equal(getattr(a, f)[lanes:], getattr(st, f)[lanes:]):
                    fail(f"lanes beyond live_blocks changed ({f})")
    return worst, media9, misc, base


def main_path(r_opts):
    """Phase 4: the showcase render at 512x512, 16 spp."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = r_opts
    t0 = time.perf_counter()
    r = Renderer(scene, opt)
    print(f"   accel build + upload {time.perf_counter() - t0:.3f} s; clusters "
          f"{r.accel.num_clusters}, supers {r.accel.num_supers}, width {r.accel.width}", flush=True)
    t0 = time.perf_counter()
    r.render()  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mk.trace_paths_mega.launches
    paths = opt.width * opt.height * opt.num_samples
    mean = float(np.mean(img))
    print(f"   showcase {opt.width}x{opt.height}@{opt.num_samples} parity: warm-up {warm:.3f} s, "
          f"timed {dt:.3f} s = {paths / dt / 1e6:.4f} Mpaths/s; K1 launches {launches}; "
          f"image mean {mean:.6f}", flush=True)
    if launches <= 0:
        fail("the main path launched the megakernel no time")
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        fail("main-path image is not finite or has the wrong shape")
    return r, launches, img


def flip_gate(img, ref):
    """(non-flip RMSE, flip pixels): pixels with |diff| > 1e-2 are flips."""
    img, ref = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    flip = np.abs(img - ref).max(-1) > 1e-2
    nonflip = float(np.sqrt(((img - ref) ** 2)[~flip].mean()))
    return nonflip, int(flip.sum())


def golden_gate(name="showcase", golden="showcase_gate", size=64, spp=32, **kw):
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    img = Renderer(*showcase_options(size, size, spp, shard="none", obj=name, **kw)).render()
    with np.load(os.path.join(REPO, "tests", "golden", f"{golden}.npz")) as z:
        ref = np.asarray(z["img"], np.float64)
    nonflip, flips = flip_gate(img, ref)
    print(f"   {golden} {size}x{size}@{spp} parity {kw or ''}: non-flip RMSE {nonflip:.3e} "
          f"(limit 1e-3), flip pixels {flips} (budget 24)", flush=True)
    if not (nonflip <= 1e-3 and flips <= 24):
        fail(f"{golden} golden gate failed ({kw})")


def grid_counts(g):
    """(real slots per cluster, clusters per super) as float64 tensors."""
    import torch

    real = (g.tri_index.reshape(g.num_clusters, -1) >= 0).sum(1).to(torch.float64)
    sf, S, C = g.super_factor, g.num_supers, g.num_clusters
    per_super = torch.tensor([min(sf, C - s * sf) for s in range(S)], dtype=torch.float64,
                             device=real.device)
    return real, per_super


def boxes_met(g, rays, tmax, bound, chunk=8192):
    """(needs the set, supers met, clusters met) of rays (OX, OY, OZ, DX,
    DY, DZ) with bound ``tmax``: the boxes each ray meets within
    [T_MIN, its final ``bound``], in chunks of lanes."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    owner = torch.arange(g.num_clusters, device=tmax.device) // g.super_factor
    O = torch.stack(rays[:3], 1)
    INV = torch.stack([mk._safe_inv(d) for d in rays[3:]], 1)
    need = tmax > mk.T_MIN

    def hits(boxes, o, inv, b, nd):
        t0 = (boxes[None, :, 0:3] - o[:, None]) * inv[:, None]
        t1 = (boxes[None, :, 3:6] - o[:, None]) * inv[:, None]
        tn = torch.minimum(t0, t1).amax(-1).clamp(min=mk.T_MIN)
        tf = torch.minimum(torch.maximum(t0, t1).amin(-1), b[:, None])
        return (tn <= tf) & nd[:, None]

    sups, clus = [], []
    for lo in range(0, O.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        sup = hits(g.super_bounds, O[sl], INV[sl], bound[sl], need[sl])
        sups.append(sup)
        clus.append(hits(g.bounds, O[sl], INV[sl], bound[sl], need[sl]) & sup[:, owner])
    return need, torch.cat(sups), torch.cat(clus)


def needed_work(r, media9, misc, state, kw):
    """(slab tests, slot-test operations) that the kernel call on ``state``
    needs, from a plain pass over the same state: it runs the plain version
    once, records each ray set that the bounce traces (rays, own bound,
    final result) and counts, for each lane that needs the set, the boxes
    and the real (not padding) slots of the clusters whose box the ray
    meets before its final bound: the closest hit, or the set's own bound
    when nothing is hit. A walk that knew that bound in advance would test
    exactly these; the kernel tests at least these."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    g = r.accel
    records = []
    plain_trace = mk._subset_trace

    def recording(cx, rays, payload, st, tmax):
        out = plain_trace(cx, rays, payload, st, tmax)
        records.append((payload, rays, tmax, ct.payload_bound(payload, out, cx.K)))
        return out

    mk._subset_trace = recording
    try:
        mk.trace_paths_mega_plain(g, media9, misc, state, **kw)
    finally:
        mk._subset_trace = plain_trace

    real, per_super = grid_counts(g)
    S = g.num_supers

    def met(rays, tmax, bound):
        return boxes_met(g, rays, tmax, bound)

    slabs = slots_ops = 0.0
    i = 0
    while i < len(records):
        payload, rays, tmax, bound = records[i]
        if payload == "full":
            need, sup, clus = met(rays, tmax, bound)
            slabs += float(need.sum()) * S + float((sup.double() @ per_super).sum())
            slots_ops += (ORIGIN_OPS + RAY_OPS) * float((clus.double() @ real).sum())
            i += 1
            continue
        # The fused walk: set A ('dist') then set B ('nee') from one origin.
        _, rays_b, tmax_b, bound_b = records[i + 1]
        need_a, sup_a, clus_a = met(rays, tmax, bound)
        need_b, sup_b, clus_b = met(rays_b, tmax_b, bound_b)
        slabs += float((need_a | need_b).sum()) * S + float(((sup_a | sup_b).double() @ per_super).sum())
        slots_ops += ORIGIN_OPS * float(((clus_a | clus_b).double() @ real).sum())
        slots_ops += RAY_OPS * float(((clus_a.double() + clus_b.double()) @ real).sum())
        i += 2
    return slabs, slots_ops


def time_kernel(r, media9, misc, base):
    """K1 per launch at the main path's widest shape, the plain
    version on the same input, and the bound from the work that input
    needs."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    st = band_state(r, "parity")
    kw = dict(base, max_iters=1)
    g = r.accel
    slabs, slots_ops = needed_work(r, media9, misc, clone_state(st), kw)
    ops = slabs * SLAB_OPS + slots_ops
    lanes = st.org.shape[0]
    grid_bytes = sum(t.numel() * t.element_size() for t in (g.bounds, g.super_bounds, g.run_rows))
    nbytes = 2 * lanes * STATE_BYTES + grid_bytes + (media9.numel() + misc.numel()) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def timed(fn, reps):
        copies = [clone_state(st) for _ in range(reps)]
        return cuda_time(lambda i: fn(copies[i]), reps)

    before = mk.trace_paths_mega.launches
    kern = lambda s: mk.trace_paths_mega(g, media9, misc, s, **kw)  # noqa: E731
    plain = lambda s: mk.trace_paths_mega_plain(g, media9, misc, s, **kw)  # noqa: E731
    timed(kern, 3)  # warm-up
    ms = timed(kern, 20)
    plain_ms = timed(plain, 3)
    mk.trace_paths_mega.launches = before
    print(f"   K1 at {lanes} fresh lanes, one bounce: {ms:.4f} ms per launch; plain "
          f"{plain_ms:.3f} ms; needed work: {slabs:.0f} box tests, {slots_ops:.6e} slot-test "
          f"operations, {ops:.6e} f32 operations in all = {t_ops:.5f} ms at "
          f"{PEAK_F32_OPS:.3e} op/s; {nbytes} bytes = {t_bytes:.5f} ms; bound {bound_ms:.5f} ms "
          f"({bound_by}), kernel at {bound_ms / ms:.4f} of it", flush=True)
    return ms, plain_ms, bound_ms, bound_by


def primary_rays(r):
    """The camera rays of the main path's first pass (65,536 lanes)."""
    st = band_state(r, "parity")
    return st.org.contiguous(), st.dir.contiguous()


def bounce_rays(r, o, d, seed=7):
    """Bounce-like rays: random directions from the primary rays' hit
    points (misses start at the origin), a third of the lanes parked and a
    per-lane t_max in [0.05, 20)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr

    n = o.shape[0]
    hit = ctr.trace_shaded_clusters(o, d, r.accel, 1e-4, 1e4)
    gen = torch.Generator(device=o.device).manual_seed(seed)
    dirs = torch.randn((n, 3), generator=gen, device=o.device)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    org = torch.where(hit.hit[:, None], hit.position, o).contiguous()
    active = torch.rand((n,), generator=gen, device=o.device) >= 1.0 / 3.0
    t_max = 0.05 + 19.95 * torch.rand((n,), generator=gen, device=o.device)
    return org, dirs.contiguous(), t_max, active


def k3_vs_plain(r, r_quads_off, r_part):
    """K3 against its plain version and against the BVH walk."""
    import torch

    from complex_materials_renderer_tpu_torch.accel import build_bvh
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.kernels import traverse

    o, d = primary_rays(r)
    ob, db, tb, ab = bounce_rays(r, o, d)
    tri = r.triangles
    bvh = traverse.device_bvh(build_bvh(tri, 4), tri, 4, r.device)
    n = o.shape[0]
    ones = torch.ones((n,), dtype=torch.bool, device=o.device)
    worst = 0.0
    saved = ctr.trace_core.launches
    for gname, rr in (("default grid", r), ("quads off", r_quads_off), ("partitioned", r_part)):
        for rname, (oo, dd, tm, act) in (("primary", (o, d, 1e4, ones)),
                                          ("bounce-like", (ob, db, tb, ab))):
            got = ctr.trace_core(oo, dd, rr.accel, 1e-4, tm, act)
            torch.cuda.synchronize()
            eff = torch.where(act, torch.broadcast_to(torch.as_tensor(tm, device=o.device), (n,)),
                              torch.zeros((n,), device=o.device))
            want = ctr.trace_core_plain(oo, dd, rr.accel, eff)
            slot_bad = int((got[1] != want[1].to(torch.int32)).sum())
            mat_bad = int((got[7] != want[7].to(torch.int32)).sum())
            err = max(float((x - y).abs().max()) for i, (x, y) in enumerate(zip(got, want))
                      if i not in (1, 7))
            worst = max(worst, err)
            hits = int((got[1] >= 0).sum())
            print(f"   K3 {gname}, {rname} rays: lanes {n}, hits {hits}, slot mismatches "
                  f"{slot_bad}, material mismatches {mat_bad}, worst float error {err:.3e}",
                  flush=True)
            if slot_bad or mat_bad or not err <= K3_ATOL:
                fail(f"K3 differs from its plain version ({gname}, {rname})")
            if rr is r_quads_off:  # a merged quad slot reports one triangle of the two
                k3 = ctr.trace_closest_clusters(oo, dd, rr.accel, 1e-4, tm, act)
                walk = traverse.trace_closest(oo, dd, bvh, 1e-4, tm, act)
                torch.cuda.synchronize()
                bad = int((k3.prim != walk.prim).sum())
                print(f"   K3 against the BVH walk, {rname} rays: prim differs on {bad} of {n} "
                      f"lanes", flush=True)
                if bad > FLIP_FRAC * n:
                    fail(f"K3 and the BVH walk differ on {bad} lanes ({rname})")
    ctr.trace_core.launches = saved  # comparison launches do not count
    return worst


def wavefront_path(main_opts, mega_img):
    """The wavefront engine on the main scene, held against the
    megakernel image of the same configuration."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    opt = dataclasses.replace(opt, engine="wavefront")
    r = Renderer(scene, opt)
    t0 = time.perf_counter()
    Renderer(scene, dataclasses.replace(opt, width=64, height=64, num_samples=1)).render()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ctr.trace_core.launches
    paths = opt.width * opt.height * opt.num_samples
    nonflip, flips = flip_gate(img, mega_img)
    budget = WAVEFRONT_FLIP_FRAC * opt.width * opt.height
    print(f"   showcase {opt.width}x{opt.height}@{opt.num_samples} parity, wavefront: warm-up "
          f"(64x64@1) {warm:.3f} s, timed {dt:.3f} s = {paths / dt / 1e6:.4f} Mpaths/s; K3 launches "
          f"{launches}; image mean {float(np.mean(img)):.6f}; against the megakernel image: "
          f"non-flip RMSE {nonflip:.3e} (limit 1e-3), flip pixels {flips} (budget {budget:.0f})",
          flush=True)
    if launches <= 0:
        fail("the wavefront path launched the closest-hit kernel no time")
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        fail("wavefront image is not finite or has the wrong shape")
    if not (nonflip <= 1e-3 and flips <= budget):
        fail("the wavefront image fails the gate against the megakernel image")
    return launches


def aov_phase(main_opts):
    """The three AOVs of showcase at full size through K3, against the
    same passes with K3's plain version on the card."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    real_launch = ctr._launch

    def plain_launch(o, d, grid, eff_tmax, t_min):
        out = ctr.trace_core_plain(o, d, grid, eff_tmax, t_min)
        return tuple(x.to(torch.int32) if i in (1, 7) else x for i, x in enumerate(out))

    for kind in ("depth", "normal", "topology"):
        r = Renderer(scene, dataclasses.replace(opt, aov=kind))
        reset_launch_counts()
        img = r.render()
        launches = ctr.trace_core.launches
        ctr._launch = plain_launch
        try:
            ref = r.render()
        finally:
            ctr._launch = real_launch
        equal = bool(np.array_equal(img, ref))
        print(f"   AOV {kind} {opt.width}x{opt.height}: K3 launches {launches}, equal to the plain "
              f"pass: {equal}, mean {float(np.mean(img)):.6f}", flush=True)
        if launches != 1:
            fail(f"AOV {kind} launched K3 {launches} times, expected once")
        if not equal or not np.isfinite(img).all():
            fail(f"AOV {kind} through K3 differs from its plain pass")


def k3_needed_work(g, o, d, t_hit):
    """(box tests, slot-test operations) that a closest trace of rays
    (o, d) with final hits ``t_hit`` needs: the boxes of every super, the
    boxes of the clusters of supers met, and the real slots of the
    clusters met before the final hit."""
    real, per_super = grid_counts(g)
    rays = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    need, sup, clus = boxes_met(g, rays, t_hit, t_hit)
    slabs = float(need.sum()) * g.num_supers + float((sup.double() @ per_super).sum())
    return slabs, (ORIGIN_OPS + RAY_OPS) * float((clus.double() @ real).sum())


def cuda_time(fn, reps):
    """Mean device ms of ``fn(i)`` for i in range(reps), by CUDA events
    around each call. Each call is queued behind a device sleep, so the
    host's work in the wrapper is done while the card sleeps and the
    events time the card's work alone (a wrapper that syncs, like the
    plain versions, adds its host time)."""
    import torch

    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(i)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in pairs) / reps


def time_k3(r):
    """K3 per launch at the wavefront's widest launch (65,536 fresh
    showcase lanes, closest trace), the plain version on the same input,
    and the bound from the work that input needs."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr

    g = r.accel
    o, d = primary_rays(r)
    n = o.shape[0]
    tmax = torch.full((n,), 1e4, device=o.device)
    before = ctr.trace_core.launches
    kern = lambda _i=0: ctr.trace_core(o, d, g, 1e-4, tmax)  # noqa: E731
    plain = lambda _i=0: ctr.trace_core_plain(o, d, g, tmax)  # noqa: E731
    t_hit = kern()[0]
    slabs, slot_ops = k3_needed_work(g, o, d, t_hit)
    ops = slabs * SLAB_OPS + slot_ops
    grid_bytes = sum(t.numel() * t.element_size() for t in (g.bounds, g.super_bounds, g.run_rows))
    nbytes = n * K3_RAY_BYTES + grid_bytes
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    cuda_time(kern, 5)  # warm-up
    ms = cuda_time(kern, 50)
    plain_ms = cuda_time(plain, 3)
    ctr.trace_core.launches = before
    print(f"   K3 at {n} fresh lanes, closest trace: {ms:.4f} ms per launch; plain {plain_ms:.3f} "
          f"ms; needed work: {slabs:.0f} box tests, {slot_ops:.6e} slot-test operations, "
          f"{ops:.6e} f32 operations in all = {t_ops:.5f} ms at {PEAK_F32_OPS:.3e} op/s; {nbytes} "
          f"bytes = {t_bytes:.5f} ms; bound {bound_ms:.5f} ms ({bound_by}), kernel at "
          f"{bound_ms / ms:.4f} of it", flush=True)
    return ms, plain_ms, bound_ms, bound_by


def profile_pass(r, engine):
    """Optional: torch.profiler over one 65,536-lane pass of 16 samples
    through the ``engine``'s beauty function."""
    import torch
    import torch.profiler as tp

    from complex_materials_renderer_tpu_torch.render.integrator import render_beauty
    from complex_materials_renderer_tpu_torch.render.megarender import render_beauty_mega

    opt = r.options
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
              rng_mode=opt.rng, full_resolution=(opt.width, opt.height))
    fn = render_beauty_mega if engine == "mega" else render_beauty
    spp = 16
    fn(r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, 128), 1, **kw)
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, 128), spp, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Only the kernel rows: an aten op's self device time repeats the time
    # of the kernels it launched, which have rows of their own.
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    busy = sum(dev_ms(e) for e in rows)
    print(f"   profile of one {engine} pass (65536 lanes x {spp} spp): wall {wall * 1e3:.2f} ms, "
          f"device busy {busy:.2f} ms", flush=True)
    for e in sorted(rows, key=lambda e: -dev_ms(e))[:12]:
        print(f"     {dev_ms(e):10.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="stop after the first kernel comparisons")
    ap.add_argument("--profile", action="store_true", help="add torch.profiler breakdowns")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: FAIL: {PACKAGE}/ is not beside this script", flush=True)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"   {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("build")
    from complex_materials_renderer_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.prebuild([1, 4, 8, 10], verbose=True)
    print(f"   built {len(build.build_log)} libraries in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    for lib, secs, log in build.build_log:
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"   {lib}: {secs:.1f} s; " + " | ".join(regs[-2:]), flush=True)

    from complex_materials_renderer_tpu_torch.renderer import Renderer

    phase("megakernel (K1) against plain (showcase, 65,536 lanes)")
    main_opts = showcase_options(512, 512, 16)
    r = Renderer(*main_opts)
    scene, opt = main_opts
    r_part = Renderer(scene, dataclasses.replace(opt, partition="media"))
    r_quads_off = Renderer(scene, dataclasses.replace(opt, quads="off"))
    if r_part.accel.num_opaque_supers <= 0:
        fail("the partitioned grid has no opaque supers")
    if not bool((r.accel.qa != 0.5).any()) or bool((r_quads_off.accel.qa != 0.5).any()):
        fail("the default grid should hold quad slots and the quads-off grid none")
    worst, media9, misc, base = kernel_vs_plain(r, r_part, args.quick)

    phase("closest-hit kernel (K3) against plain and the BVH walk (showcase, 65,536 lanes)")
    worst_k3 = k3_vs_plain(r, r_quads_off, r_part)
    if args.quick:
        print("chip_smoke: --quick stops here", flush=True)
        return 3

    phase("main path: showcase 512x512 @ 16 spp, megakernel")
    r, launches, mega_img = main_path(main_opts)
    golden_gate()

    phase("wavefront path: showcase 512x512 @ 16 spp, AOVs, bvh backend")
    k3_launches = wavefront_path(main_opts, mega_img)
    golden_gate(engine="wavefront")
    aov_phase(main_opts)
    golden_gate(name="isobox", golden="isobox", spp=2, engine="wavefront", backend="bvh")

    phase("kernel timing")
    ms, plain_ms, bound_ms, bound_by = time_kernel(r, media9, misc, base)
    ms_k3, plain_ms_k3, bound_ms_k3, bound_by_k3 = time_k3(r)
    if args.profile:
        phase("profile")
        profile_pass(r, "mega")
        profile_pass(r, "wavefront")

    print(json.dumps({"kernels": [{
        "name": "megakernel (K1, with the triangle tester K2 inlined)",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/megakernel.cu",
        "replaces": "complex_materials_renderer_tpu/kernels/megakernel.py:1475",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "closest-hit trace over the cluster grid (K3)",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/cluster_trace.cu",
        "replaces": "complex_materials_renderer_tpu/kernels/pallas_trace.py:170",
        "launches": k3_launches,
        "max_abs_err": worst_k3,
        "ms": ms_k3,
        "plain_ms": plain_ms_k3,
        "bound_ms": bound_ms_k3,
        "bound_by": bound_by_k3,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
