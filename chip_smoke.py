#!/usr/bin/env python3
"""Smoke test of complex_materials_renderer_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the CUDA kernels of
   ``csrc/`` with nvcc (one process per library, started together);
2. holds the path-tracing kernel (K1, with the triangle tester K2
   inlined) against its plain PyTorch version on the card, from one
   65,536-lane state of the showcase scene, in five cases: parity to
   termination, counter with one iteration on part of the blocks, ld from
   Sobol dimension 2, TIR kill with the analytic direct term, and an
   opaque/media partitioned grid. rng, depth and alive must be equal on
   all lanes but the flip lanes (those whose depth or alive differ), at
   most 1e-3 of the lanes; rad, thr, org and dir within atol 1e-4 and
   rtol 1e-4 on the other lanes;
3. drives the main path: a default render of scenes/showcase.obj at
   512x512 with 16 samples per pixel (parity RNG) through ``Renderer``,
   timed after one warm-up, with the kernel's launch count; then the
   64x64 at 32 spp render against tests/golden/showcase_gate.npz under the
   flip-budgeted gate (non-flip RMSE <= 1e-3, at most 24 pixels with
   |diff| > 1e-2);
4. times the kernel with CUDA events at the main path's widest launch
   (65,536 fresh lanes, one bounce), times the plain version on the same
   input, and computes the bound from that input: a plain pass over the
   same state finds, for each ray set the bounce needs, the clusters whose
   box the ray meets before its final hit (or its own bound), and counts
   their real slots and boxes at the f32 operations of the CUDA tests;
5. prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero before the last line. ``--quick`` stops
after the first kernel comparison; ``--profile`` adds a torch.profiler
breakdown of one main-path pass.
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

BAND_ROWS = 128  # rows of 512 pixels in one main-path pass: 65,536 lanes
FLIP_FRAC = 1e-3
ATOL = 1e-4
RTOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def showcase_options(width, height, spp, **kw):
    from complex_materials_renderer_tpu_torch.config import RenderOptions
    from complex_materials_renderer_tpu_torch.scene import load_scene

    obj = os.path.join(REPO, "scenes", "showcase.obj")
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
    """Phase 2: the kernel against its plain version on the card."""
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
        ("parity, max_iters=max_depth", r.grid, "parity", dict()),
        ("counter, max_iters=1, live_blocks=5/8 of the blocks", r.grid, "counter",
         dict(max_iters=1, live_blocks=BAND_ROWS * 512 // mk.BLOCK * 5 // 8)),
        ("ld, dim0=2", r.grid, "ld", dict(ld=True, dim0=2)),
        ("tir_kill + analytic_direct", r.grid, "parity", dict(tir_kill=True, analytic_direct=True)),
        ("partitioned grid", r_part.grid, "parity", dict()),
    ]
    if quick:
        cases = cases[:1]
    worst = 0.0
    for name, grid, rng_mode, kw in cases:
        st = band_state(r, rng_mode)
        a, b = clone_state(st), clone_state(st)
        launches = mk.trace_paths_mega.launches
        trace_paths_mega(grid, media9, misc, a, **base, **kw)
        torch.cuda.synchronize()
        mk.trace_paths_mega.launches = launches  # comparison launches do not count
        trace_paths_mega_plain(grid, media9, misc, b, **base, **kw)
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
    """Phase 3: the showcase render at 512x512, 16 spp, and the gate."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = r_opts
    t0 = time.perf_counter()
    r = Renderer(scene, opt)
    print(f"   accel build + upload {time.perf_counter() - t0:.3f} s; clusters "
          f"{r.grid.num_clusters}, supers {r.grid.num_supers}, width {r.grid.width}", flush=True)
    t0 = time.perf_counter()
    r.render()  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    mk.trace_paths_mega.launches = 0
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
    return r, launches, dt, paths


def golden_gate():
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    img = Renderer(*showcase_options(64, 64, 32, shard="none")).render()
    with np.load(os.path.join(REPO, "tests", "golden", "showcase_gate.npz")) as z:
        ref = np.asarray(z["img"], np.float64)
    diff = np.abs(img.astype(np.float64) - ref).max(-1)
    flip = diff > 1e-2
    err2 = (img.astype(np.float64) - ref) ** 2
    nonflip = float(np.sqrt(err2[~flip].mean()))
    flips = int(flip.sum())
    print(f"   showcase_gate 64x64@32 parity: non-flip RMSE {nonflip:.3e} (limit 1e-3), "
          f"flip pixels {flips} (budget 24)", flush=True)
    if not (nonflip <= 1e-3 and flips <= 24):
        fail("showcase_gate golden gate failed")


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

    g = r.grid
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

    real = (g.tri_index.reshape(g.num_clusters, -1) >= 0).sum(1).to(torch.float64)
    sf, S, C = g.super_factor, g.num_supers, g.num_clusters
    per_super = torch.tensor([min(sf, C - s * sf) for s in range(S)], dtype=torch.float64,
                             device=real.device)
    owner = torch.arange(C, device=real.device) // sf

    def met(rays, tmax, bound):
        """(needs the set, supers met, clusters met) within the final bound."""
        O = torch.stack(rays[:3], 1)
        INV = torch.stack([mk._safe_inv(d) for d in rays[3:]], 1)
        need = tmax > mk.T_MIN

        def hits(boxes):
            t0 = (boxes[None, :, 0:3] - O[:, None]) * INV[:, None]
            t1 = (boxes[None, :, 3:6] - O[:, None]) * INV[:, None]
            tn = torch.minimum(t0, t1).amax(-1).clamp(min=mk.T_MIN)
            tf = torch.minimum(torch.maximum(t0, t1).amin(-1), bound[:, None])
            return (tn <= tf) & need[:, None]

        sup = hits(g.super_bounds)
        return need, sup, hits(g.bounds) & sup[:, owner]

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
    """Phase 4: K1 per launch at the main path's widest shape, the plain
    version on the same input, and the bound from the work that input
    needs."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    st = band_state(r, "parity")
    kw = dict(base, max_iters=1)
    g = r.grid
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
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        total = 0.0
        for c in copies:
            e0.record()
            fn(c)
            e1.record()
            torch.cuda.synchronize()
            total += e0.elapsed_time(e1)
        return total / reps

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


def profile_pass(r):
    """Optional: torch.profiler over one 65,536-lane, 16-sample pass."""
    import torch
    import torch.profiler as tp

    from complex_materials_renderer_tpu_torch.render.megarender import render_beauty_mega

    opt = r.options
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
              rng_mode=opt.rng, full_resolution=(opt.width, opt.height))
    render_beauty_mega(r.camera, r.scene_arrays, r.grid, r.lights, (opt.width, 128), 16, **kw)
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_beauty_mega(r.camera, r.scene_arrays, r.grid, r.lights, (opt.width, 128), 16, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Only the kernel rows: an aten op's self device time repeats the time
    # of the kernels it launched, which have rows of their own.
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    busy = sum(dev_ms(e) for e in rows)
    print(f"   profile of one pass (65536 lanes x 16 spp): wall {wall * 1e3:.2f} ms, "
          f"device busy {busy:.2f} ms", flush=True)
    for e in sorted(rows, key=lambda e: -dev_ms(e))[:12]:
        print(f"     {dev_ms(e):10.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="stop after the first kernel comparison")
    ap.add_argument("--profile", action="store_true", help="add a torch.profiler breakdown")
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
    build.prebuild([1, 4, 8], verbose=True)
    print(f"   built {len(build.build_log)} libraries in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    for lib, secs, log in build.build_log:
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"   {lib}: {secs:.1f} s; " + " | ".join(regs[-2:]), flush=True)

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    phase("kernel against plain (showcase, 65,536 lanes)")
    main_opts = showcase_options(512, 512, 16)
    r = Renderer(*main_opts)
    scene, opt = main_opts
    r_part = Renderer(scene, dataclasses.replace(opt, partition="media"))
    if r_part.grid.num_opaque_supers <= 0:
        fail("the partitioned grid has no opaque supers")
    worst, media9, misc, base = kernel_vs_plain(r, r_part, args.quick)
    if args.quick:
        print("chip_smoke: --quick stops here", flush=True)
        return 3

    phase("main path: showcase 512x512 @ 16 spp")
    r, launches, dt, paths = main_path(main_opts)
    golden_gate()

    phase("kernel timing")
    ms, plain_ms, bound_ms, bound_by = time_kernel(r, media9, misc, base)
    if args.profile:
        phase("profile")
        profile_pass(r)

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
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
