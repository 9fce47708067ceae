#!/usr/bin/env python3
"""Smoke test of complex_materials_renderer_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the CUDA kernels of
   ``csrc/`` with nvcc (one process per library, started together): the
   megakernel for ``--nee-bound`` 1, 4, 8 and 10, the closest-hit kernel,
   and at ``--nee-bound`` 4 the listing, the round (each at list lengths
   4, 8 and 12) and the pair sweep, each with its ptxas lines (registers
   and spill stores of every kernel);
2. holds the path-tracing kernel (K1, with the triangle tester K2
   inlined) against its plain PyTorch version on the card, from one
   65,536-lane state of the showcase scene, in six cases: parity to
   termination, counter with one iteration on part of the blocks, ld from
   Sobol dimension 2, TIR kill with the analytic direct term, an
   opaque/media partitioned grid, and ``--nee-bound 10``. rng, depth and
   alive must be equal on all lanes but the flip lanes (those whose depth
   or alive differ), at most 1e-3 of the lanes; rad, thr, org and dir
   within atol 1e-4 and rtol 1e-4 on the other lanes. Then at every group
   size G (threads per lane: 1, 2, 4, 8, 16, 32) on the widest launch
   (65,536 fresh lanes, one bounce) and on the tail of one sample step
   (1,024 lanes of a mid-path state run to termination), bit-equal;
3. holds the closest-hit kernel (K3) against its plain version on the
   card: 65,536 showcase primary rays and 65,536 bounce-like rays (random
   directions from the primary hits, a third of the lanes parked, a
   per-lane t_max), on the default, the quads-off and the partitioned
   grid. Slot and material must be equal on every lane and the floats
   within atol 1e-6 (the worst error is printed; both round every
   operation once, in the same order). Against the BVH walk of the same
   rays on the quads-off grid (a merged quad slot reports one of its two
   triangles), prim must be equal on all but 1e-3 of the lanes (K3's
   additive far-edge epsilon admits hits up to 2e-6 past an edge). At
   every G, on the primary and bounce-like rays, every output equal;
3b. holds the binned and pair engines' kernels against their plain
   versions on the card, on 65,536-lane ray sets of showcase (primary
   rays; bounce-like rays; shadow rays from their hits): the listing K4
   at list lengths 4, 8 and 12 with fresh and relisting t_lo; the round
   K5 at every (G, S) it is built for (threads per lane, CTAs of a thread
   block cluster) on the first round after the regroup sort for 'full',
   'dist' and 'nee' and with ``cap_iters=2``, and on the narrowest round
   of a whole 'full' and 'nee' trace; the pair sweep K6 at every G over a
   first generation's pairs and over the pairs of 1,024 lanes for 'dist',
   'occl' and 'nee': keys, tlim, state and iterations equal on every
   lane. Then whole traces: the binned 'full' trace against K3 (slot
   equal on all but 1e-3 of the lanes: K2's scaled edge epsilon is not
   K3's additive one), the pair trace against the binned one ('dist'
   equal; 'nee' t_opq and the boundaries below it equal);
4. drives the main path: a default (megakernel) render of
   scenes/showcase.obj at 512x512 with 16 samples per pixel (parity RNG)
   through ``Renderer``, timed after one warm-up, with K1's launch count
   and the G of its launches by width;
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
5b. drives the binned and pair paths: showcase 512x512 at 4 spp through
   ``--engine binned`` and ``--engine pair``, each timed after a small
   warm-up with its K3-K6 launch counts (each count set to 0 just before
   the render), held against the megakernel image of the same render
   under the wavefront's gate, and showcase_gate through each engine;
6. times K1, K3, K4, K5 and K6 with CUDA events at their widest launches
   on their paths (65,536 lanes: K1 one bounce, K3 and K4 the closest
   trace of the primary rays, K5 its first round, K6 the pair engine's
   NEE sweep), times the plain versions on the same inputs, and computes
   each bound from its input: for K1 and K3 a plain pass finds, for each
   ray set, the clusters whose box the ray meets before its final hit (or
   its own bound), and counts their real slots and boxes at the f32
   operations of the CUDA tests; K4 counts the listing's box tests, K5
   the slot tests of the lanes holding each served cluster, K6 those of
   each valid pair's own cluster. Then K1 launch by launch over one
   parity sample step of the main path (width, cap, G, lanes alive,
   lane-bounces, ms, bound) and K3 at 65,536 primary rays and 16,384,
   4,096 and 1,024 live bounce-like rays, each at the wrappers' G; then at
   every G the widest K3 launch and the narrowest, and K1's first, second
   (both 65,536 lanes) and tail launches. Then K5 launch by launch over
   one binned closest trace (lanes, live blocks, servings, the rule's G
   and S, ms, the bound and the TPU algorithm's own work: every lane of a
   served block tests the cluster) with its widest and narrowest launch at
   every (G, S) and ``cudaOccupancyMaxActiveClusters`` of every K5
   instance, and K6 launch by launch over one pair NEE trace (pairs, valid
   pairs, distinct ids per block, G, ms, bound, TPU work) with its widest
   and narrowest launch at every G;
7. prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero before the last line. ``--quick`` stops
after the kernel comparisons (phases 2-3b) and exits 4; ``--tables``
builds, prints only the K1, K3, K5 and K6 launch tables of phase 6 and
the timed main-path render of phase 4, and exits 4;
``--profile`` adds a torch.profiler breakdown of one pass of each engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

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
BINNED_LISTS = (4, 8, 12)  # list lengths at which K4 is held against its plain version
PAIR_LIST = 4  # the pair engine's list length for its distance and NEE traces
ENGINE_SPP = 4  # samples per pixel of the binned and pair engines' showcase renders
TRACE_FLIP_FRAC = 1e-3
FLIP_FRAC = 1e-3
ATOL = 1e-4
RTOL = 1e-4
K3_ATOL = 1e-6
WAVEFRONT_FLIP_FRAC = 24 / 4096  # the golden gate's flip budget, per pixel
GROUPS = (1, 2, 4, 8, 16, 32)  # threads per ray that K1 and K3 are built for
# Device sleep queued ahead of each timed launch: about 10 ms at the H100's
# clock, far longer than a wrapper's host work.
SLEEP_CYCLES = 20_000_000


def ptxas_lines(log: str):
    """(kernel, registers, spill-store bytes) of each entry function in an
    ``nvcc -Xptxas -v`` log."""
    import re

    out, fn, spill = [], "?", 0
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            name = re.sub(r"^_ZN3cmr\d+", "", fn)[:56]
            out.append((name, int(m.group(1)), spill))
            spill = 0
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper to 0."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    mk.trace_paths_mega.launches = 0
    ctr.trace_core.launches = 0
    bt.listing.launches = 0
    bt.run_round.launches = 0
    ps.sweep.launches = 0


def launch_counts() -> dict:
    """The launch count of every kernel wrapper."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    return {"K1": mk.trace_paths_mega.launches, "K3": ctr.trace_core.launches,
            "K4": bt.listing.launches, "K5": bt.run_round.launches, "K6": ps.sweep.launches}


class uncounted:
    """Leaves every launch count as it was on entry: the launches made to
    compare or time a kernel are not the main path's."""

    def __enter__(self):
        self.saved = launch_counts()

    def __exit__(self, *exc):
        from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
        from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
        from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
        from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

        mk.trace_paths_mega.launches = self.saved["K1"]
        ctr.trace_core.launches = self.saved["K3"]
        bt.listing.launches = self.saved["K4"]
        bt.run_round.launches = self.saved["K5"]
        ps.sweep.launches = self.saved["K6"]
        return False


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


def mega_inputs(r):
    """(media9, misc, the main path's K1 arguments) of renderer ``r``."""
    from complex_materials_renderer_tpu_torch.kernels.megakernel import pack_media, pack_misc

    opt = r.options
    media9 = pack_media(r.scene_arrays.media, r.scene_arrays.scale, device=r.device)
    misc = pack_misc(r.lights, r.scene_arrays.world_lo, r.scene_arrays.world_hi, device=r.device)
    base = dict(background=opt.background, max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                nee_max_media=opt.nee_max_media)
    return media9, misc, base


def kernel_vs_plain(r, r_part, quick):
    """K1 against its plain version on the card."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.kernels.megakernel import (
        trace_paths_mega, trace_paths_mega_plain,
    )

    media9, misc, base = mega_inputs(r)
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


def k1_groups_vs_plain(r, media9, misc, base, tail):
    """K1 against its plain version at every group size, on the main path's
    widest launch (65,536 fresh lanes, one bounce) and on its tail (the
    last launch of one sample step: 1,024 lanes of a mid-path state run to
    termination). The two must agree to the bit: no flip lane, no rng
    mismatch, float error 0."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    tail_st, tail_kw = tail
    fresh = band_state(r, "parity")
    for label, st, kw in (
        (f"{fresh.org.shape[0]} fresh lanes, max_iters=1", fresh, dict(base, max_iters=1)),
        (f"tail, {tail_st.org.shape[0]} lanes ({int(tail_st.alive.sum())} alive), "
         f"max_iters={tail_kw['max_iters']}", tail_st, dict(base, **tail_kw)),
    ):
        want = clone_state(st)
        mk.trace_paths_mega_plain(r.accel, media9, misc, want, **kw)
        for g in GROUPS:
            got = clone_state(st)
            with uncounted(), forced_group(g):
                mk.trace_paths_mega(r.accel, media9, misc, got, **kw)
            torch.cuda.synchronize()
            n_flip, err = compare_states(f"G={g}, {label}", got, want)
            if n_flip or err != 0.0:
                fail(f"K1 at G={g} is not bit-equal to its plain version ({label})")


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
    with recorded_groups(mk) as groups:
        t0 = time.perf_counter()
        img = r.render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = mk.trace_paths_mega.launches
    paths = opt.width * opt.height * opt.num_samples
    mean = float(np.mean(img))
    print(f"   K1 launches by width and threads per lane: {groups.line()}", flush=True)
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
    """(slab tests, slot-test operations, lane-bounces) that the kernel call
    on ``state`` needs, from a plain pass over the same state: it runs the
    plain version once, records each ray set that the bounce traces (rays,
    own bound, final result) and counts, for each lane that needs the set,
    the boxes and the real (not padding) slots of the clusters whose box
    the ray meets before its final bound: the closest hit, or the set's own
    bound when nothing is hit. A walk that knew that bound in advance would
    test exactly these; the kernel tests at least these. Lane-bounces are
    the lanes of every bounce iteration the call runs."""
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
    lane_bounces = 0
    i = 0
    while i < len(records):
        payload, rays, tmax, bound = records[i]
        if payload == "full":
            lane_bounces += rays[0].numel()
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
    return slabs, slots_ops, lane_bounces


def k1_bound(r, media9, misc, st, kw):
    """(box tests, slot-test operations, lane-bounces, bytes, bytes ms,
    operations ms, bound ms, bound by) of the K1 call ``kw`` on state
    ``st`` (``needed_work`` on a copy)."""
    g = r.accel
    slabs, slots_ops, lane_bounces = needed_work(r, media9, misc, clone_state(st), kw)
    ops = slabs * SLAB_OPS + slots_ops
    lanes = st.org.shape[0]
    grid_bytes = sum(t.numel() * t.element_size() for t in (g.bounds, g.super_bounds, g.run_rows))
    nbytes = 2 * lanes * STATE_BYTES + grid_bytes + (media9.numel() + misc.numel()) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return slabs, slots_ops, lane_bounces, nbytes, t_bytes, t_ops, bound_ms, bound_by


def timed_states(fn, st, reps):
    """Mean device ms of ``fn`` on ``reps`` fresh copies of state ``st``."""
    copies = [clone_state(st) for _ in range(reps)]
    return cuda_time(lambda i: fn(copies[i]), reps)


def time_k1(r, media9, misc, st, kw, reps):
    """Device ms of one K1 call ``kw`` on state ``st``, after a warm-up."""
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    def kern(s):
        return mk.trace_paths_mega(r.accel, media9, misc, s, **kw)

    timed_states(kern, st, 2)
    return timed_states(kern, st, reps)


def time_kernel(r, media9, misc, base):
    """K1 per launch at the main path's widest shape, the plain
    version on the same input, and the bound from the work that input
    needs."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    st = band_state(r, "parity")
    kw = dict(base, max_iters=1)
    g = r.accel
    slabs, slots_ops, _, nbytes, t_bytes, t_ops, bound_ms, bound_by = k1_bound(
        r, media9, misc, st, kw)
    ops = slabs * SLAB_OPS + slots_ops
    lanes = st.org.shape[0]
    with uncounted():
        ms = time_k1(r, media9, misc, st, kw, 20)
        plain_ms = timed_states(
            lambda s: mk.trace_paths_mega_plain(g, media9, misc, s, **kw), st, 3)
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
    for rname, (oo, dd, tm, act) in (("primary", (o, d, 1e4, ones)),
                                      ("bounce-like", (ob, db, tb, ab))):
        eff = torch.where(act, torch.broadcast_to(torch.as_tensor(tm, device=o.device), (n,)),
                          torch.zeros((n,), device=o.device))
        want = ctr.trace_core_plain(oo, dd, r.accel, eff)
        bad = []
        for g in GROUPS:
            with forced_group(g):
                got = ctr.trace_core(oo, dd, r.accel, 1e-4, tm, act)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y.to(x.dtype)) for x, y in zip(got, want)):
                bad.append(g)
        print(f"   K3 default grid, {rname} rays, at G = {', '.join(map(str, GROUPS))}: every "
              f"output equal to the plain version except at G = {bad or 'none'}", flush=True)
        if bad:
            fail(f"K3 differs from its plain version at G = {bad} ({rname})")
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
    with recorded_groups(ctr) as groups:
        t0 = time.perf_counter()
        img = r.render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = ctr.trace_core.launches
    print(f"   K3 launches of the wavefront render by threads per ray: "
          f"{len(groups.seen)} widths; " + ", ".join(
              f"G={g} x{sum(n for (_, gg), n in groups.seen.items() if gg == g)}"
              for g in sorted({g for _, g in groups.seen})), flush=True)
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


# --------------------------------------------------------------------------
# K1 and K3 launch by launch, and at every group size
# --------------------------------------------------------------------------


def group_rule():
    """The wrappers' choice of threads per ray from the launch width, or
    None for kernels that serve one ray per thread (those before the group
    walk: the tables below also run on them, for comparison)."""
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    return getattr(mk, "group_size", None)


class forced_group:
    """K1 and K3 launch with ``g`` threads per ray, whatever their width."""

    def __init__(self, g):
        self.g = g

    def __enter__(self):
        from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
        from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

        self.saved = (mk.group_size, ctr.group_size)
        mk.group_size = ctr.group_size = lambda lanes: self.g

    def __exit__(self, *exc):
        from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
        from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

        mk.group_size, ctr.group_size = self.saved
        return False


class recorded_groups:
    """Records (lanes, group size) of every launch of ``module``'s kernel
    (kernels.megakernel: K1, kernels.cluster_trace: K3) made inside it."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        self.rule, self.seen = getattr(self.module, "group_size", None), {}
        if self.rule is None:  # one thread per ray
            return self

        def rule(lanes):
            g = self.rule(lanes)
            self.seen[(lanes, g)] = self.seen.get((lanes, g), 0) + 1
            return g

        self.module.group_size = rule
        return self

    def __exit__(self, *exc):
        if self.rule is not None:
            self.module.group_size = self.rule
        return False

    def line(self) -> str:
        return ", ".join(f"{lanes} lanes G={g} x{n}" for (lanes, g), n in
                         sorted(self.seen.items(), reverse=True)) or "one thread per lane"


def k1_step_calls(r, media9, misc, base):
    """(input state, call arguments) of every K1 launch of one parity
    sample step of the main path over the 65,536-lane band, recorded
    through the renderer's own phase schedule (render/megarender.py)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.render.megarender import (
        _make_advance, _phase_schedule, _resolve_dynamic,
    )

    opt = r.options
    st = band_state(r, "parity")
    n = st.org.shape[0]
    dynamic = _resolve_dynamic("auto", r.accel)
    if dynamic != "off":
        fail(f"the main path's schedule mode on showcase is {dynamic!r}, expected 'off'")
    calls = []

    def kern(state, **kw):
        calls.append((clone_state(state), kw))
        mk.trace_paths_mega(r.accel, media9, misc, state, **base, **kw)

    lane = torch.arange(n, device=st.org.device)
    with uncounted():
        _make_advance(kern, dynamic, _phase_schedule(n, opt.max_depth), r.scene_arrays, "dir",
                      opt.max_depth)(st, lane, n)
    torch.cuda.synchronize()
    return calls


def k1_step_table(r, media9, misc, base, reps=10):
    """K1 launch by launch over one sample step of the main path: width and
    cap, lanes alive at the start, lane-bounces, device ms and the bound of
    each launch; then the first, the second and the tail launch at every
    group size.
    Returns (step ms, step bound ms, the tail's input and arguments)."""
    rule = group_rule()
    calls = k1_step_calls(r, media9, misc, base)
    print("   K1 launches of one parity sample step (showcase 512x512, the 65,536-lane band):",
          flush=True)
    print("     #  width  cap  G   alive  lane-bounces        ms   bound ms  bound by   "
          "share of bound", flush=True)
    tot_ms = tot_bound = 0.0
    with uncounted():
        for i, (st, kw) in enumerate(calls):
            lanes = st.org.shape[0]
            call_kw = dict(base, **kw)
            _, _, lane_bounces, _, _, _, b_ms, b_by = k1_bound(r, media9, misc, st, call_kw)
            ms = time_k1(r, media9, misc, st, call_kw, reps)
            tot_ms += ms
            tot_bound += b_ms
            g = rule(lanes) if rule else 1
            print(f"    {i:2d} {lanes:6d} {kw['max_iters']:4d} {g:2d} {int(st.alive.sum()):7d} "
                  f"{lane_bounces:13d} {ms:9.4f} {b_ms:10.5f} {b_by:>10s} {b_ms / ms:9.4f}",
                  flush=True)
        print(f"   K1 over the step: {len(calls)} launches, {tot_ms:.4f} ms, bound {tot_bound:.5f} "
              f"ms; x16 samples x4 bands = {tot_ms * 64 / 1e3:.4f} s of K1 per 512x512@16 "
              f"render", flush=True)
        if rule:
            for label, (st, kw) in (("widest", calls[0]), ("second", calls[1]),
                                    ("tail", calls[-1])):
                call_kw = dict(base, **kw)
                times = []
                for g in GROUPS:
                    with forced_group(g):
                        times.append(time_k1(r, media9, misc, st, call_kw, reps))
                print(f"   K1 {label} launch ({st.org.shape[0]} lanes, cap {kw['max_iters']}) by "
                      f"threads per ray: " + ", ".join(
                          f"G={g} {t:.4f} ms" for g, t in zip(GROUPS, times))
                      + f"; the rule picks G={rule(st.org.shape[0])}", flush=True)
    return tot_ms, tot_bound, calls[-1]


def k3_width_table(r, reps=20):
    """K3 at the widest launch (65,536 primary rays) and at compacted
    widths (16,384, 4,096 and 1,024 live bounce-like rays): device ms and
    bound; then the widest and the narrowest at every group size."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr

    g = r.accel
    rule = group_rule()
    o, d = primary_rays(r)
    with uncounted():
        ob, db, tb, ab = bounce_rays(r, o, d)
    act = ab.nonzero().squeeze(1)
    sets = [("primary", o, d, torch.full((o.shape[0],), 1e4, device=o.device))]
    for n in (16384, 4096, 1024):
        sel = act[:n]
        sets.append(("bounce-like", ob[sel].contiguous(), db[sel].contiguous(),
                     tb[sel].contiguous()))
    grid_bytes = sum(t.numel() * t.element_size() for t in (g.bounds, g.super_bounds, g.run_rows))

    def timed(oo, dd, tm):
        cuda_time(lambda _i: ctr.trace_core(oo, dd, g, 1e-4, tm), 3)
        return cuda_time(lambda _i: ctr.trace_core(oo, dd, g, 1e-4, tm), reps)

    print("   K3 by width (showcase):", flush=True)
    print("     rays          width  G        ms   bound ms  bound by   share of bound",
          flush=True)
    with uncounted():
        for name, oo, dd, tm in sets:
            n = oo.shape[0]
            t_hit = ctr.trace_core(oo, dd, g, 1e-4, tm)[0]
            slabs, slot_ops = k3_needed_work(g, oo, dd, t_hit)
            t_ops = (slabs * SLAB_OPS + slot_ops) / PEAK_F32_OPS * 1e3
            t_bytes = (n * K3_RAY_BYTES + grid_bytes) / PEAK_BYTES * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ms = timed(oo, dd, tm)
            print(f"     {name:12s} {n:6d} {rule(n) if rule else 1:2d} {ms:9.4f} {b_ms:10.5f} "
                  f"{b_by:>10s} {b_ms / ms:9.4f}", flush=True)
        if rule:
            for name, oo, dd, tm in (sets[0], sets[-1]):
                times = []
                for gs in GROUPS:
                    with forced_group(gs):
                        times.append(timed(oo, dd, tm))
                print(f"   K3 {name} rays, {oo.shape[0]} lanes, by threads per ray: " + ", ".join(
                    f"G={gs} {t:.4f} ms" for gs, t in zip(GROUPS, times))
                    + f"; the rule picks G={rule(oo.shape[0])}", flush=True)


# --------------------------------------------------------------------------
# The binned and pair engines: K4 (listing), K5 (round), K6 (pair sweep)
# --------------------------------------------------------------------------


def ray_sets(r):
    """The ray sets on which K4, K5 and K6 are held against their plain
    versions, from the main path's first pass over showcase (65,536
    lanes), each as (origin, direction, the trace's bound; 0 = parked):
    'full' the primary rays bounded by the scene-box exit (the closest
    trace), 'dist' the bounce-like rays with their t_max, also clamped to
    the scene box, and 'nee' shadow rays toward the light from where the
    bounce-like rays hit (from the primary hits the light is in plain
    view), bounded by the light distance."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.render.integrator import light_setup

    sc = r.scene_arrays
    o, d = primary_rays(r)
    n = o.shape[0]
    with uncounted():
        ob, db, tb, ab = bounce_rays(r, o, d)
        hit = ctr.trace_shaded_clusters(ob, db, r.accel, 1e-4, 1e4)
    full_b = bt.scene_box_clamp(torch.full((n,), 1e4, device=o.device), o, d, sc.world_lo,
                                sc.world_hi)
    dist_b = bt.scene_box_clamp(torch.where(ab, tb, torch.zeros_like(tb)), ob, db, sc.world_lo,
                                sc.world_hi)
    _, ldir, _, eff = light_setup(hit.position, r.lights, hit.hit)
    return {"full": (o, d, full_b.contiguous()), "dist": (ob, db, dist_b.contiguous()),
            "nee": (hit.position.contiguous(), ldir.contiguous(), eff.contiguous())}


def rays6(o, d):
    import torch

    return torch.cat([o.t(), d.t()]).contiguous()


def fresh_tlo(eff):
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    return torch.where(eff > bt._T_MIN, -1, bt.EMPTY).to(torch.int32)


def first_round(r, payload, o, d, eff, L):
    """(K, rays, keys, state, lb) of a binned trace's first round, built as
    ``trace_binned`` builds it: the fresh state, the listing (plain) and the
    regroup sort; lb, the live blocks, a host int."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct

    K = ct.nee_list_len(r.options.nee_max_media)
    rays = rays6(o, d)
    state = bt.state_bits(ct.payload_state0(payload, eff, K))
    bnd = ct.payload_bound(payload, bt.state_fields(state, payload, K), K).contiguous()
    keys, _ = bt.listing_plain(r.accel, rays, bnd, fresh_tlo(eff), L)
    live, keys, rays, state = bt.regroup(keys, rays, state)
    return K, rays, keys, state, -(-int(live) // bt.BLOCK)


def float_err(a_bits, b_bits, payload, K):
    """Worst difference of the float fields of two payload states."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    worst = 0.0
    for x, y in zip(bt.state_fields(a_bits, payload, K), bt.state_fields(b_bits, payload, K)):
        if x.dtype.is_floating_point and x.numel():
            worst = max(worst, float((x - y).abs().max()))
    return worst


def k456_vs_plain(r, media9, sets):
    """K4, K5 and K6 against their plain versions on the card: keys, tlim,
    state and iterations equal on every lane. Returns the worst float
    error of each (0.0 when equal)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    g = r.accel
    errs = {"K4": 0.0, "K5": 0.0, "K6": 0.0}
    with uncounted():
        for name, (o, d, eff) in sets.items():
            rays = rays6(o, d)
            fresh = fresh_tlo(eff)
            relist = bt.listing_plain(g, rays, eff, fresh, 2)[0][1].contiguous()
            for L in BINNED_LISTS:
                for tname, tlo in (("fresh", fresh), ("relisting", relist)):
                    keys, tlim = bt.listing(g, rays, eff, tlo, L)
                    torch.cuda.synchronize()
                    wk, wt = bt.listing_plain(g, rays, eff, tlo, L)
                    bad = int(((keys != wk).any(0) | (tlim != wt)).sum())
                    print(f"   K4 L={L}, {name} rays, {tname} t_lo: lanes {rays.shape[1]}, "
                          f"listing {int((tlo != bt.EMPTY).sum())}, keys listed "
                          f"{int((keys != bt.EMPTY).sum())}, lanes differing {bad}", flush=True)
                    if bad:
                        fail(f"K4 differs from its plain version (L={L}, {name}, {tname})")
        cases = [(f"{payload}, L=8, cap_iters={cap}",
                  first_round(r, payload, *sets[payload], 8)[1:], payload, cap)
                 for payload, cap in (("full", 12), ("dist", 12), ("nee", 12), ("full", 2))]
        for payload in ("full", "nee"):  # narrow: the last round of a whole trace
            K, (lb, rays, keys, state, _, cap) = narrow_round(r, media9, sets, payload)
            cases.append((f"{payload}, the last round of its trace, cap_iters={cap}",
                          (rays, keys, state, lb), payload, cap))
        K = ct.nee_list_len(r.options.nee_max_media)
        for label, (rays, keys, state, lb), payload, cap in cases:
            want = bt.round_plain(g, media9, lb, rays, keys, state, payload, K, cap)
            for gs in bt.ROUND_GROUPS:
                with forced(bt, "round_split", lambda _lb, gs=gs: split_of(gs)):
                    got = bt.run_round(g, media9, lb, rays, keys.clone(), state.clone(), payload,
                                       K, cap)
                    torch.cuda.synchronize()
                bad = [f for f, x, y in zip(("keys", "state", "iters"), got, want)
                       if not torch.equal(x, y)]
                err = float_err(got[1], want[1], payload, K)
                errs["K5"] = max(errs["K5"], err)
                G, S = split_of(gs)
                print(f"   K5 {label}: live blocks {lb}, G={G} S={S}: servings "
                      f"{int(got[2].sum())}, fields differing {bad}, worst float error {err:.3e}",
                      flush=True)
                if bad:
                    fail(f"K5 differs from its plain version ({label}, G={G}, S={S}): {bad}")
        sweeps = []
        for payload in ("dist", "occl", "nee"):
            o, d, eff = sets["nee" if payload == "nee" else "dist"]
            rays = rays6(o, d)
            keys, _ = bt.listing_plain(g, rays, eff, fresh_tlo(eff), PAIR_LIST)
            sweeps.append((payload, "first generation", ps.expand_pairs(keys, rays, eff, 8)[:2]))
            # A small sweep: the pairs of the first 1,024 lanes.
            keys, _ = bt.listing_plain(g, rays[:, :1024].contiguous(), eff[:1024],
                                       fresh_tlo(eff[:1024]), PAIR_LIST)
            sweeps.append((payload, "1,024 lanes", ps.expand_pairs(
                keys, rays[:, :1024].contiguous(), eff[:1024], 8)[:2]))
        for payload, label, (pair_rays, cid) in sweeps:
            pairs = int((cid < bt.BIGC).sum())
            want = ps.sweep_plain(g, media9, pair_rays, cid, payload, K)
            for gs in GROUPS:
                with forced(ps, "group_size", lambda _p, gs=gs: gs):
                    got = ps.sweep(g, media9, pair_rays, cid, payload, K, pairs)
                    torch.cuda.synchronize()
                err = float_err(got, want, payload, K)
                errs["K6"] = max(errs["K6"], err)
                equal = torch.equal(got, want)
                print(f"   K6 {payload}, {label}: pairs {pairs} of {cid.shape[0]}, G={gs}: equal "
                      f"{equal}, worst float error {err:.3e}", flush=True)
                if not equal:
                    fail(f"K6 differs from its plain version ({payload}, {label}, G={gs})")
    return errs


def whole_traces(r, media9, sets):
    """The binned 'full' trace against K3 on the primary rays (slot equal
    on all but 1e-3 of the lanes: K2's scaled edge epsilon is not K3's
    additive one), and the pair trace against the binned one: 'dist'
    equal; 'nee' t_opq and the boundaries below it equal (what the march
    reads)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    g = r.accel
    sc = r.scene_arrays
    world = dict(world_lo=sc.world_lo, world_hi=sc.world_hi)
    with uncounted():
        o, d, eff = sets["full"]
        n = o.shape[0]
        got = bt.trace_binned(g, media9, o, d, torch.full((n,), 1e4, device=o.device), "full",
                              **world)
        k3 = ctr.trace_core(o, d, g, 1e-4, eff)
        torch.cuda.synchronize()
        bad = int((got[1].to(torch.int32) != k3[1]).sum())
        print(f"   trace_binned 'full' against K3, primary rays: slot differs on {bad} of {n} "
              f"lanes; hits {int((k3[1] >= 0).sum())}", flush=True)
        if bad > TRACE_FLIP_FRAC * n:
            fail(f"the binned closest trace and K3 differ on {bad} lanes")
        K = ct.nee_list_len(r.options.nee_max_media)
        for payload in ("dist", "nee"):
            o, d, eff = sets[payload]
            kw = world if payload == "dist" else {}
            a = bt.trace_binned(g, media9, o, d, eff, payload, list_len=PAIR_LIST, **kw)
            b = ps.trace_pairs(g, media9, o, d, eff, payload, list_len=PAIR_LIST, **kw)
            torch.cuda.synchronize()
            if payload == "dist":
                ok = all(torch.equal(x, y) for x, y in zip(a, b))
                print(f"   trace_pairs against trace_binned, 'dist': equal {ok}; hits "
                      f"{int((a[1] >= 0).sum())}", flush=True)
            else:
                opq = a[2 * K]
                below = torch.stack(a[:K]) < opq
                ok = (torch.equal(opq, b[2 * K])
                      and torch.equal(below, torch.stack(b[:K]) < b[2 * K])
                      and torch.equal(torch.where(below, torch.stack(a[:K]), 0),
                                      torch.where(below, torch.stack(b[:K]), 0))
                      and torch.equal(torch.where(below, torch.stack(a[K:2 * K]), 0),
                                      torch.where(below, torch.stack(b[K:2 * K]), 0)))
                beyond = int((torch.stack(a[:2 * K]) != torch.stack(b[:2 * K])).any(0).sum())
                print(f"   trace_pairs against trace_binned, 'nee': t_opq and the "
                      f"{int(below.sum())} boundaries below it equal {ok}; lanes whose keys "
                      f"beyond t_opq differ {beyond}", flush=True)
            if not ok:
                fail(f"trace_pairs and trace_binned differ ('{payload}')")


def engine_path(main_opts, engine, mega_img):
    """The showcase render through ``--engine binned`` or ``pair`` at
    512x512 and ENGINE_SPP samples, timed after a 64x64 one-sample
    warm-up, held against the megakernel image of the same render."""
    import torch

    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    opt = dataclasses.replace(opt, engine=engine, num_samples=ENGINE_SPP)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
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
    counts = launch_counts()
    paths = opt.width * opt.height * opt.num_samples
    nonflip, flips = flip_gate(img, mega_img)
    budget = WAVEFRONT_FLIP_FRAC * opt.width * opt.height
    rate = paths / dt / 1e6
    print(f"   showcase {opt.width}x{opt.height}@{opt.num_samples} parity, {engine}: warm-up "
          f"(64x64@1) {warm:.3f} s, timed {dt:.3f} s = {rate:.4f} Mpaths/s; launches K3 "
          f"{counts['K3']}, K4 {counts['K4']}, K5 {counts['K5']}, K6 {counts['K6']}; image mean "
          f"{float(np.mean(img)):.6f}; against the megakernel image: non-flip RMSE "
          f"{nonflip:.3e} (limit 1e-3), flip pixels {flips} (budget {budget:.0f})", flush=True)
    need = ("K4", "K5") if engine == "binned" else ("K3", "K4", "K6")
    for k in need:
        if counts[k] <= 0:
            fail(f"the {engine} path launched {k} no time")
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        fail(f"{engine} image is not finite or has the wrong shape")
    if not (nonflip <= 1e-3 and flips <= budget):
        fail(f"the {engine} image fails the gate against the megakernel image")
    return counts, rate


def real_slots(g):
    real, _ = grid_counts(g)
    return real


def time_k456(r, media9, sets):
    """K4, K5 and K6 per launch at their widest launches on the engines'
    paths (65,536 lanes), each plain version on the same input, and the
    bounds from the work that input needs: K4 the listing of the binned
    closest trace (L = 8, primary rays, fresh), K5 that trace's first round,
    K6 the pair engine's NEE sweep (L = 4, shadow rays). Returns
    {kernel: (ms, plain ms, bound ms, bound by)}."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    g = r.accel
    real = real_slots(g)
    run_bytes = g.run_rows.numel() * 4
    out = {}

    def bound(nbytes, ops):
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_F32_OPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    with uncounted():
        # K4
        o, d, eff = sets["full"]
        rays, tlo, L = rays6(o, d), fresh_tlo(eff), 8
        n = rays.shape[1]
        need, sup, _ = boxes_met(g, (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]), eff, eff)
        _, per_super = grid_counts(g)
        slabs = float(need.sum()) * g.num_supers + float((sup.double() @ per_super).sum())
        nbytes = n * (8 + L + 1) * 4 + (g.num_clusters + g.num_supers) * 32
        b_ms, b_by = bound(nbytes, slabs * SLAB_OPS)
        cuda_time(lambda i: bt.listing(g, rays, eff, tlo, L), 5)
        ms = cuda_time(lambda i: bt.listing(g, rays, eff, tlo, L), 50)
        plain_ms = cuda_time(lambda i: bt.listing_plain(g, rays, eff, tlo, L), 3)
        out["K4"] = (ms, plain_ms, b_ms, b_by)
        print(f"   K4 at {n} primary lanes, L={L}: {ms:.4f} ms per launch; plain {plain_ms:.3f} ms; "
              f"needed work {slabs:.0f} box tests; {nbytes} bytes; bound {b_ms:.5f} ms ({b_by}), "
              f"kernel at {b_ms / ms:.4f} of it", flush=True)
        # K5
        K, rays5, keys, state, lb = first_round(r, "full", o, d, eff, L)
        served = []
        bt.round_plain(g, media9, lb, rays5, keys, state, "full", K, 12, served=served)
        holders = 0.0
        for c, cnt in served:
            ok = c < bt.BIGC
            holders += float((cnt[ok].double() * real[c[ok].to(torch.int64)]).sum())
        ns = state.shape[0]
        nbytes = n * (6 + 2 * (L + ns)) * 4 + (n // bt.BLOCK) * 4 + run_bytes
        b_ms, b_by = bound(nbytes, holders * (ORIGIN_OPS + RAY_OPS))
        copies = [(keys.clone(), state.clone()) for _ in range(25)]
        launch = lambda i: bt.run_round(g, media9, lb, rays5, *copies[i], "full", K, 12)  # noqa: E731
        cuda_time(launch, 5)
        ms = cuda_time(lambda i: launch(5 + i), 20)
        plain_ms = cuda_time(lambda i: bt.round_plain(g, media9, lb, rays5, keys, state, "full", K,
                                                      12), 3)
        out["K5"] = (ms, plain_ms, b_ms, b_by)
        print(f"   K5 at {n} primary lanes ({lb} live blocks, G, S = {bt.round_split(lb)}), first "
              f"round of the closest "
              f"trace: {ms:.4f} ms per launch; plain {plain_ms:.3f} ms; needed work "
              f"{holders:.0f} slot tests of lanes holding the served cluster; {nbytes} bytes; "
              f"bound {b_ms:.5f} ms ({b_by}), kernel at {b_ms / ms:.4f} of it", flush=True)
        # K6
        o, d, eff = sets["nee"]
        rays = rays6(o, d)
        keys, _ = bt.listing_plain(g, rays, eff, fresh_tlo(eff), PAIR_LIST)
        pair_rays, cid, _ = ps.expand_pairs(keys, rays, eff, 8)
        valid = cid < bt.BIGC
        pairs_work = float(real[cid[valid].to(torch.int64)].sum())
        nbytes = cid.shape[0] * (8 + K + 1) * 4 + run_bytes
        b_ms, b_by = bound(nbytes, pairs_work * (ORIGIN_OPS + RAY_OPS))
        pairs = int(valid.sum())
        cuda_time(lambda i: ps.sweep(g, media9, pair_rays, cid, "nee", K, pairs), 5)
        ms = cuda_time(lambda i: ps.sweep(g, media9, pair_rays, cid, "nee", K, pairs), 50)
        plain_ms = cuda_time(lambda i: ps.sweep_plain(g, media9, pair_rays, cid, "nee", K), 3)
        out["K6"] = (ms, plain_ms, b_ms, b_by)
        print(f"   K6 at {pairs} pairs of {n} shadow lanes (L={PAIR_LIST}, G={ct.group_size(pairs)}), "
              f"'nee': "
              f"{ms:.4f} ms per launch; plain {plain_ms:.3f} ms; needed work {pairs_work:.0f} "
              f"slot tests; {nbytes} bytes; bound {b_ms:.5f} ms ({b_by}), kernel at "
              f"{b_ms / ms:.4f} of it", flush=True)
    return out


# --------------------------------------------------------------------------
# K5 and K6 launch by launch, and at every G / S
# --------------------------------------------------------------------------


class forced:
    """``module.name`` is ``value`` inside the block (a wrapper's rule or
    the wrapper itself)."""

    def __init__(self, module, name, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)
        return False


def split_of(g):
    """(G, S) of a K5 launch with G threads per lane."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    return g, bt.BLOCK * g // bt.ROUND_CTA


def recorded_rounds(r, media9, sets, payload, cap_iters=12):
    """The input of every K5 launch of one binned trace of ``sets[payload]``
    (list 8; 'full' bounded by the scene box, as the closest trace is):
    (lb, rays, keys, state, payload, cap_iters), recorded before each
    launch."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    o, d, eff = sets[payload]
    sc = r.scene_arrays
    kw = {}
    if payload == "full":
        eff = torch.full((o.shape[0],), 1e4, device=o.device)
        kw = dict(world_lo=sc.world_lo, world_hi=sc.world_hi)
    calls = []
    run = bt.run_round

    def rec(grid, media9, lb, rays, keys, state, payload, K, cap):
        calls.append((lb, rays.clone(), keys.clone(), state.clone(), payload, cap))
        return run(grid, media9, lb, rays, keys, state, payload, K, cap)

    rec.launches = 0  # the wrapper counts its launches under its module name

    with uncounted(), forced(bt, "run_round", rec):
        bt.trace_binned(r.accel, media9, o, d, eff, payload, cap_iters=cap_iters, **kw)
        torch.cuda.synchronize()
    return calls


def narrow_round(r, media9, sets, payload):
    """(K, the input of the narrowest K5 launch of one binned trace with
    two servings a round (``CMR_BINNED_CAP=2``): the last round with the
    fewest live blocks)."""
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct

    calls = recorded_rounds(r, media9, sets, payload, cap_iters=2)
    lb = min(c[0] for c in calls)
    return ct.nee_list_len(r.options.nee_max_media), [c for c in calls if c[0] == lb][-1]


def round_work(g, media9, call, K, real):
    """(servings, servings per live block, slot tests of the lanes holding
    the served cluster, slot tests of every lane of a served block) of one
    K5 launch, from its plain version. 'nee' serves only the holders, which
    is exact, so its two counts agree."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    lb, rays, keys, state, payload, cap = call
    served = []
    bt.round_plain(g, media9, lb, rays, keys, state, payload, K, cap, served=served)
    holders = every = 0.0
    per_block = torch.zeros((keys.shape[1] // bt.BLOCK,), dtype=torch.int64, device=keys.device)
    for c, cnt in served:
        ok = c < bt.BIGC
        slots = real[c[ok].to(torch.int64)]
        holders += float((cnt[ok].double() * slots).sum())
        every += float(bt.BLOCK * slots.sum())
        per_block += ok
    return int(per_block.sum()), per_block[:lb], holders, holders if payload == "nee" else every


def time_round(g, media9, call, K, reps):
    """Device ms of one K5 launch on a recorded input (updated in place:
    each launch gets its own copy)."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    lb, rays, keys, state, payload, cap = call
    copies = [(keys.clone(), state.clone()) for _ in range(reps + 3)]
    launch = lambda i: bt.run_round(g, media9, lb, rays, *copies[i], payload, K, cap)  # noqa: E731
    cuda_time(launch, 3)
    return cuda_time(lambda i: launch(3 + i), reps)


def bound_of(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_launch_table(r, media9, sets, reps=10):
    """K5 launch by launch over one binned closest trace (showcase primary
    rays, list 8), with the engine's 12 servings a round and with 2 (whose
    late rounds are narrow): lanes, live blocks, servings and servings per
    live block, the rule's G and S, device ms, the bound (the holders' slot
    tests, or bytes) and the TPU algorithm's own work (every lane of a
    served block tests the cluster); then the widest and the narrowest
    launch at every G / S, and the cluster occupancy of every instance.
    Returns (ms, bound ms) of the engine's trace."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import build
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct

    g = r.accel
    K = ct.nee_list_len(r.options.nee_max_media)
    real = real_slots(g)
    run_bytes = g.run_rows.numel() * 4
    tot_ms = tot_bound = 0.0
    traces = {}
    for cap in (12, 2):
        calls = traces[cap] = recorded_rounds(r, media9, sets, "full", cap_iters=cap)
        print(f"   K5 launches of one binned closest trace (showcase, {sets['full'][0].shape[0]} "
              f"primary lanes, list 8, 'full', cap_iters={cap}):", flush=True)
        print("     #  lanes  live blocks  payload  servings  ids per block (mean, max)  G  S"
              "        ms   bound ms  bound by   TPU-work ms  share of bound", flush=True)
        ms_sum = bound_sum = algo_sum = 0.0
        with uncounted():
            for i, call in enumerate(calls):
                lb, rays, keys, state, payload, cap = call
                servings, per_block, holders, every = round_work(g, media9, call, K, real)
                lanes = lb * bt.BLOCK
                nbytes = (lanes * (6 + 2 * (keys.shape[0] + state.shape[0])) * 4 + lb * 4
                          + run_bytes)
                b_ms, b_by = bound_of(nbytes, holders * (ORIGIN_OPS + RAY_OPS))
                algo_ms = every * (ORIGIN_OPS + RAY_OPS) / PEAK_F32_OPS * 1e3
                ms = time_round(g, media9, call, K, reps)
                G, S = bt.round_split(lb)
                ms_sum, bound_sum, algo_sum = ms_sum + ms, bound_sum + b_ms, algo_sum + algo_ms
                print(f"    {i:2d} {lanes:6d} {lb:12d} {payload:>8s} {servings:9d} "
                      f"{float(per_block.double().mean()):14.2f} {int(per_block.max()):4d} "
                      f"{G:12d} {S:2d} {ms:9.4f} {b_ms:10.5f} {b_by:>10s} {algo_ms:12.5f} "
                      f"{b_ms / ms:9.4f}", flush=True)
        print(f"   K5 over the trace: {len(calls)} launches, {ms_sum:.4f} ms, bound "
              f"{bound_sum:.5f} ms, TPU-work {algo_sum:.5f} ms", flush=True)
        if cap == 12:
            tot_ms, tot_bound = ms_sum, bound_sum
    tight = traces[2]
    lbs = [c[0] for c in tight]
    with uncounted():
        for label, call in (("widest", traces[12][0]),
                            ("narrowest (cap_iters=2)", tight[len(lbs) - 1 - lbs[::-1].index(min(lbs))])):
            times = []
            for gs in bt.ROUND_GROUPS:
                with forced(bt, "round_split", lambda _lb, gs=gs: split_of(gs)):
                    times.append(time_round(g, media9, call, K, reps))
            print(f"   K5 {label} launch ({call[0]} live blocks) by G, S: " + ", ".join(
                f"G={gs} S={split_of(gs)[1]} {t:.4f} ms" for gs, t in zip(bt.ROUND_GROUPS, times))
                + f"; the rule picks {bt.round_split(call[0])}", flush=True)
    nee = r.options.nee_max_media
    for L in BINNED_LISTS:
        occ = [(payload, gs, build.round_max_clusters(L, nee, bt.PAYLOAD_IDS[payload], gs))
               for payload in bt.PAYLOAD_IDS for gs in bt.ROUND_GROUPS]
        print(f"   K5 cudaOccupancyMaxActiveClusters (L={L}, --nee-bound {nee}): " + ", ".join(
            f"{payload} G={gs} S={split_of(gs)[1]}: {m}" for payload, gs, m in occ), flush=True)
        if any(m < 1 for _, _, m in occ):
            fail(f"a K5 instance's thread block cluster does not fit on the card (L={L})")
    return tot_ms, tot_bound


def recorded_sweeps(r, media9, sets, payload, list_len):
    """The input of every K6 launch of one pair trace of ``sets[payload]``:
    (pair rays, cluster ids, payload, valid pairs)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    o, d, eff = sets[payload]
    calls = []
    sweep = ps.sweep

    def rec(grid, media9, rays, cid, payload, K, pairs=None):
        calls.append((rays, cid, payload, pairs))
        return sweep(grid, media9, rays, cid, payload, K, pairs)

    rec.launches = 0  # the wrapper counts its launches under its module name

    with uncounted(), forced(ps, "sweep", rec):
        ps.trace_pairs(r.accel, media9, o, d, eff, payload, list_len=list_len)
        torch.cuda.synchronize()
    return calls


def sweep_work(g, cid, payload, real):
    """(pair servings of the kernel, slot tests of each valid pair's own
    cluster, slot tests of the TPU algorithm: every pair of a block against
    each of the block's distinct clusters; distinct ids of each block
    holding a valid pair). 'nee' serves only the pair's own cluster, which
    is exact, so its two slot counts agree."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    C = g.num_clusters
    valid = cid < C
    own = float(real[cid[valid].to(torch.int64)].sum())
    blocks = torch.where(valid, cid, C).view(-1, bt.BLOCK).to(torch.int64)
    present = torch.zeros((blocks.shape[0], C + 1), dtype=torch.bool, device=cid.device)
    present.scatter_(1, blocks, True)
    present = present[:, :C]
    every = float(bt.BLOCK * (present.double() @ real).sum())
    distinct = present.sum(1)
    servings = int(valid.sum()) if payload == "nee" else int(bt.BLOCK * distinct.sum())
    return servings, own, own if payload == "nee" else every, distinct[distinct > 0]


def k6_launch_table(r, media9, sets, reps=20):
    """K6 launch by launch over one pair NEE trace (showcase shadow rays,
    list 4): pairs, valid pairs, distinct ids per block, the rule's G,
    device ms, the bound (each valid pair's own cluster, or bytes) and the
    TPU algorithm's own work; then the widest and the narrowest launch at
    every G."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    g = r.accel
    K = ct.nee_list_len(r.options.nee_max_media)
    real = real_slots(g)
    run_bytes = g.run_rows.numel() * 4
    calls = recorded_sweeps(r, media9, sets, "nee", PAIR_LIST)

    def timed(call):
        rays, cid, payload, pairs = call
        launch = lambda i: ps.sweep(g, media9, rays, cid, payload, K, pairs)  # noqa: E731
        cuda_time(launch, 3)
        return cuda_time(launch, reps)

    print(f"   K6 launches of one pair NEE trace (showcase, {sets['nee'][0].shape[0]} shadow "
          f"lanes, list {PAIR_LIST}):", flush=True)
    print("     #   pairs    valid  payload  servings  ids per block (mean, max)   G        ms   "
          "bound ms  bound by   TPU-work ms  share of bound", flush=True)
    tot_ms = tot_bound = 0.0
    with uncounted():
        for i, call in enumerate(calls):
            rays, cid, payload, pairs = call
            servings, own, every, distinct = sweep_work(g, cid, payload, real)
            b_ms, b_by = bound_of(cid.shape[0] * (8 + K + 1) * 4 + run_bytes,
                                  own * (ORIGIN_OPS + RAY_OPS))
            algo_ms = every * (ORIGIN_OPS + RAY_OPS) / PEAK_F32_OPS * 1e3
            ms = timed(call)
            tot_ms, tot_bound = tot_ms + ms, tot_bound + b_ms
            print(f"    {i:2d} {cid.shape[0]:7d} {pairs:8d} {payload:>8s} {servings:9d} "
                  f"{float(distinct.double().mean()):14.2f} {int(distinct.max()):4d} "
                  f"{ct.group_size(pairs):12d} {ms:9.4f} {b_ms:10.5f} {b_by:>10s} "
                  f"{algo_ms:12.5f} {b_ms / ms:9.4f}", flush=True)
        print(f"   K6 over the trace: {len(calls)} launches, {tot_ms:.4f} ms, bound "
              f"{tot_bound:.5f} ms", flush=True)
        valid = [c[3] for c in calls]
        for label, call in (("widest", calls[valid.index(max(valid))]),
                            ("narrowest", calls[valid.index(min(valid))])):
            times = []
            for gs in GROUPS:
                with forced(ps, "group_size", lambda _p, gs=gs: gs):
                    times.append(timed(call))
            print(f"   K6 {label} launch ({call[3]} pairs) by threads per pair: " + ", ".join(
                f"G={gs} {t:.4f} ms" for gs, t in zip(GROUPS, times))
                + f"; the rule picks G={ct.group_size(call[3])}", flush=True)
    return tot_ms, tot_bound


def profile_pass(r, engine):
    """Optional: torch.profiler over one 65,536-lane pass through the
    ``engine``'s beauty function, of 16 samples (ENGINE_SPP for the binned
    and pair engines)."""
    import torch
    import torch.profiler as tp

    from complex_materials_renderer_tpu_torch.render.integrator import render_beauty
    from complex_materials_renderer_tpu_torch.render.megarender import render_beauty_mega

    opt = r.options
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
              rng_mode=opt.rng, full_resolution=(opt.width, opt.height))
    fn = render_beauty if engine == "wavefront" else render_beauty_mega
    spp = 16
    if engine in ("binned", "pair"):
        kw["trace_engine"] = engine
        spp = ENGINE_SPP
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
    # Each kernel of the port summed over its instances (G, S, payload).
    names = (("K1", "cmr::megakernel"), ("K3", "cmr::cluster_trace"), ("K4", "cmr::binned_listing"),
             ("K5", "cmr::binned_round"), ("K6", "cmr::pair_sweep"))
    sums = {k: [0.0, 0] for k, _ in names}
    for e in rows:
        for k, prefix in names:
            if prefix in e.key:
                sums[k][0] += dev_ms(e)
                sums[k][1] += e.count
    print("   the port's kernels in that pass: " + ", ".join(
        f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in sums.items() if n), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="stop after the first kernel comparisons")
    ap.add_argument("--profile", action="store_true", help="add torch.profiler breakdowns")
    ap.add_argument("--tables", action="store_true",
                    help="only build, print the K1, K3, K5 and K6 launch tables and time the "
                    "main path")
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
    build.prebuild([1, 4, 8, 10], verbose=True, list_lens=BINNED_LISTS,
                   rounds=[(L, 4) for L in BINNED_LISTS], sweeps=[4])
    print(f"   built {len(build.build_log)} libraries in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    worst_spill = 0
    for lib, secs, log in build.build_log:
        lines = ptxas_lines(log)
        worst_spill = max([worst_spill] + [sp for _, _, sp in lines])
        print(f"   {lib}: {secs:.1f} s; " + " | ".join(
            f"{fn}: {regs} registers, {sp} bytes spill stores" for fn, regs, sp in lines),
            flush=True)
    print(f"   worst spill of any kernel: {worst_spill} bytes of stores", flush=True)

    from complex_materials_renderer_tpu_torch.renderer import Renderer

    main_opts = showcase_options(512, 512, 16)
    if args.tables:
        phase("K1, K3, K5 and K6 launch tables")
        r = Renderer(*main_opts)
        inputs = mega_inputs(r)
        media9 = inputs[0]
        k1_step_table(r, *inputs)
        k3_width_table(r)
        sets = ray_sets(r)
        k5_launch_table(r, media9, sets)
        k6_launch_table(r, media9, sets)
        main_path(main_opts)
        print("chip_smoke: --tables stops here", flush=True)
        return 4  # nonzero: no result line is printed

    phase("megakernel (K1) against plain (showcase, 65,536 lanes)")
    r = Renderer(*main_opts)
    scene, opt = main_opts
    r_part = Renderer(scene, dataclasses.replace(opt, partition="media"))
    r_quads_off = Renderer(scene, dataclasses.replace(opt, quads="off"))
    if r_part.accel.num_opaque_supers <= 0:
        fail("the partitioned grid has no opaque supers")
    if not bool((r.accel.qa != 0.5).any()) or bool((r_quads_off.accel.qa != 0.5).any()):
        fail("the default grid should hold quad slots and the quads-off grid none")
    worst, media9, misc, base = kernel_vs_plain(r, r_part, args.quick)
    k1_groups_vs_plain(r, media9, misc, base, k1_step_calls(r, media9, misc, base)[-1])

    phase("closest-hit kernel (K3) against plain and the BVH walk (showcase, 65,536 lanes)")
    worst_k3 = k3_vs_plain(r, r_quads_off, r_part)

    phase("listing (K4), round (K5) and pair sweep (K6) against plain (showcase, 65,536 lanes)")
    sets = ray_sets(r)
    errs = k456_vs_plain(r, media9, sets)
    whole_traces(r, media9, sets)
    if args.quick:
        print("chip_smoke: --quick stops here", flush=True)
        return 4  # nonzero: no result line is printed

    phase("main path: showcase 512x512 @ 16 spp, megakernel")
    r, launches, mega_img = main_path(main_opts)
    golden_gate()

    phase("wavefront path: showcase 512x512 @ 16 spp, AOVs, bvh backend")
    k3_launches = wavefront_path(main_opts, mega_img)
    golden_gate(engine="wavefront")
    aov_phase(main_opts)
    golden_gate(name="isobox", golden="isobox", spp=2, engine="wavefront", backend="bvh")

    phase(f"binned and pair engines: showcase 512x512 @ {ENGINE_SPP} spp")
    with uncounted():
        mega4 = Renderer(scene, dataclasses.replace(opt, num_samples=ENGINE_SPP)).render()
    engines = {}
    for engine in ("binned", "pair"):
        engines[engine] = engine_path(main_opts, engine, mega4)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            golden_gate(engine=engine)

    phase("kernel timing")
    ms, plain_ms, bound_ms, bound_by = time_kernel(r, media9, misc, base)
    ms_k3, plain_ms_k3, bound_ms_k3, bound_by_k3 = time_k3(r)
    k1_step_table(r, media9, misc, base)
    k3_width_table(r)
    k456 = time_k456(r, media9, sets)
    k5_launch_table(r, media9, sets)
    k6_launch_table(r, media9, sets)
    if args.profile:
        phase("profile")
        for engine in ("mega", "wavefront", "binned", "pair"):
            profile_pass(r, engine)

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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/{src}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": errs[kid],
        "ms": k456[kid][0],
        "plain_ms": k456[kid][1],
        "bound_ms": k456[kid][2],
        "bound_by": k456[kid][3],
        "library_ms": None,
    } for kid, name, src, replaces, launches in (
        ("K4", "per-lane candidate-cluster listing (K4)", "binned_listing.cu",
         "complex_materials_renderer_tpu/kernels/binned_trace.py:88",
         engines["binned"][0]["K4"] + engines["pair"][0]["K4"]),
        ("K5", "binned round (K5, with the triangle tester K2 inlined)", "binned_round.cu",
         "complex_materials_renderer_tpu/kernels/binned_trace.py:199",
         engines["binned"][0]["K5"]),
        ("K6", "cluster-major pair sweep (K6, with the triangle tester K2 inlined)",
         "pair_sweep.cu", "complex_materials_renderer_tpu/kernels/pairsweep.py:111",
         engines["pair"][0]["K6"]),
    )]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
