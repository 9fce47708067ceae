#!/usr/bin/env python3
"""Smoke test of complex_materials_renderer_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit and builds the CUDA kernels of
   ``csrc/`` with nvcc (one process per library, started together): the
   megakernel for ``--nee-bound`` 1, 4, 8 and 10, the closest-hit kernel,
   and at ``--nee-bound`` 4 the listing, the round (each at list lengths
   4, 8 and 12), the pair sweep and the megakernel's ablation instance of
   each ``megakernel.ABLATION_SETS`` token set (CMR_MEGA_DEBUG; carrywalk
   is the nofuse instance at one thread a lane), each with its ptxas
   lines (registers and spill stores of every kernel) and the build time,
   and beside them the port's host library (``native.py``: the OBJ parser,
   BVH builder and .hdr writer, C++ built with the host's compiler), with
   its build time and the host CPU's model;
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
2b. holds each ablation instance of K1 (nofuse, ordered, carrywalk,
   cullonly, notrace, notrace with cullonly, nophys, nodist, nonee, nonee
   with nodist) bit for bit against its plain version on the same two
   launches (the tail has lanes dead at entry: nophys's 1024-lane
   lockstep), each launched from its own library;
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
   at list lengths 4, 8 and 12 with fresh and relisting t_lo, at every
   instance (the one-thread walk, the tile walk at every G, the rule's
   launch); the round
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
3c. builds the many-cluster scene through ``Renderer``: showcase's
   triangles, materials and media tiled 16 x 16 on the ground plane
   (352,768 triangles; auto width and super fan-out: about 2,750 clusters
   in about 170 supers, both printed), seen by a low camera across the
   tiles; holds K4 on its 65,536-lane ray sets as on showcase's, adding a
   sparse relist (about 1.5% of the lanes) on the primary rays, runs
   the whole-trace checks of 3b on it, holds K1's default, nofuse,
   ordered and carrywalk instances bit for bit against their plain
   versions on its first 65,536-lane launch and on a tail of 4,096
   lanes alive after two bounces, run to termination (the walks between
   many supers, and ordered's stop rule across them), and drives its
   binned closest and
   NEE traces with every launch count set to 0 just before and read just
   after (each K4 launch there must be the tile walk's);
4. drives the main path: a default (megakernel) render of
   scenes/showcase.obj at 512x512 with 16 samples per pixel (parity RNG)
   through ``Renderer``, timed after one warm-up (which captures the
   pass's CUDA graphs), with K1's launch count (the K1 launches that the
   graph replays ran, counted on the card by the control kernel), the
   partition's launches (captured by its wrapper in the warm-up; run in
   the timed render: its sort sites' visits on the card, four launches a
   sort; none fails) and the G of the captured K1 launches by width;
   then the 64x64 at 32 spp render against tests/golden/showcase_gate.npz
   under the flip-budgeted gate (non-flip RMSE <= 1e-3, at most 24 pixels
   with |diff| > 1e-2);
4a. holds the mega pass as one device program (render/megarender.py
   ``PassPlan`` captured as a CUDA graph, its loops conditional nodes)
   bit-equal to the eager executor (the same steps driven from the host)
   on the 512x512@16 render in parity, counter and ld, each also under
   the forced schedule ``1:1,8:1,32:2`` (it spills in every phase), and on
   the many-cluster scene at 256x256@4 in the dynamic modes all and
   hybrid, each with the graph's K1 launches (counted on the card) equal
   to the eager executor's; runs the main path's call once under
   ``torch.cuda.set_sync_debug_mode("error")`` (the copy to the host
   after it); holds K1 with the pass control block (32 live blocks, an ld
   base past the Sobol table; then a run flag of 0) bit-equal to its
   plain version with the same block, untouched beyond its live blocks,
   and times its first launch with the block beside the host-int launch,
   and 8 live blocks of the 65,536-lane launch beside the 8,192-lane
   launch (the G the dynamic modes now take); holds the control kernel
   equal to its plain version and times it beside an empty launch and
   ``torch.count_nonzero``; holds the partition (the pass plan's
   compaction sort, ``csrc/partition.cu``) bit-equal to its plain route at
   65,536 and 16,384 lanes and times it eagerly, in a graph and as a sort
   segment beside the plain route (``torch.argsort`` and the gathers);
   times the default command's pass (1920x34@16)
   on both executors in turns, with its capture time; and with
   ``--profile`` profiles that pass on both (the card's busy share);
4b. renders the main path under CMR_MEGA_DEBUG nofuse, ordered and
   carrywalk (exact walks), each timed after a warm-up, each of its K1
   launches from the token's library: the image within atol 1e-6 of the
   default render's; then K1's decomposition by token set: ptxas
   registers and spill, the ms of the first 65,536-lane launch and of one
   whole parity sample step (its launches recorded under the token), each
   in turns with the default (default, token, token, default), the step's
   lane-bounces and ms per million of them; cullonly must take longer
   than notrace with cullonly on the first launch (its closest-hit culls
   were not compiled away);
5. drives the wavefront path: the same showcase render with ``--engine
   wavefront`` as one CUDA graph a call shape, timed after a render that
   captures it, with K3's launch count (counted on the card), held
   against the megakernel image (non-flip RMSE <= 1e-3, flip pixels at most
   0.6% of the image: the golden budget of 24 of 4,096, scaled); the
   showcase_gate golden through the wavefront engine; the depth, normal
   and topology AOVs of showcase at 512x512 through K3 against the same
   passes through its plain version on the card (equal); and
   scenes/isobox.obj at 64x64 with 2 spp through ``--backend bvh --engine
   wavefront`` on the card against tests/golden/isobox.npz (the gate);
5b. drives the binned and pair paths: showcase 512x512 at 4 spp through
   ``--engine binned`` and ``--engine pair`` as CUDA graphs, each timed
   after a render that captures it, with its K3-K6 launch counts (each
   count set to 0 just before the render; a replay's counted on the card),
   held against the megakernel image of the same render under the
   wavefront's gate, and showcase_gate through each engine;
5b'. the wavefront-style engines as device programs: for the wavefront
   engine on the clusters and on the BVH and the binned and pair engines
   (showcase 128x128@4 through the Renderer; binned and pair also at
   128x128@2 through ``render_beauty_mega`` in the static phase schedule)
   and the binned engine on the many-cluster scene (64x64@2), the graph's
   image and RNG words bit-equal to the eager executor's with equal K1,
   K3, K4, K5 and K6 launches (the graph's counted on the card), and one
   call of each under ``torch.cuda.set_sync_debug_mode("error")``; K5 and
   K6 taking their counts from the control block held bit-equal to their
   plain versions at every rung of their launch-shape ladders and timed
   beside their host-int launches, 0 live blocks and 0 pairs launching
   nothing; with ``--profile`` one 65,536-lane pass of each engine profiled
   on the graph and on the eager executor (the busy share);
5c. drives adaptive sampling: ``render_samples_mega`` at exactly the
   uniform (pixel, sample) pairs of showcase 120x120 at 2 spp (28,800
   lanes), averaged per pixel, must equal ``render_beauty_mega`` of the
   same render bit for bit on the mega, binned and pair engines in
   counter and ld, in one wave and in waves of 10,240 lanes (three, the
   last padded), as the adaptive path runs 16 waves a call (each call's
   launches counted from 0: K1; K4 and K5; K3, K4 and K6); then
   ``--spp-mode adaptive --rng counter`` on showcase 512x512 at 16 spp,
   timed after a small warm-up, with K1's launches, the rounds and the
   per-pixel counts: the budget must be exact, the image finite and its
   mean within 2% of the uniform counter render's;
5d. drives sharding: ``render_beauty_sharded`` over a mesh of four
   logical shards on cuda:0, the megakernel per shard, on showcase
   512x512 at 4 spp: four tiles in parity bit-equal to the single render
   of the frame, 2 x 2 in counter within atol 1e-6, each warmed up at its
   shape through the same tables, then timed beside the single render
   with K1's launches, capturing no graph on any card and under
   ``torch.cuda.set_sync_debug_mode("error")``; then ``render_multihost`` in a
   one-process NCCL world (a file store) equal to ``render_beauty_sharded``
   on the same mesh (NCCL across several cards needs more than the one
   card here);
5e. drives the CLI: ``cli.main`` on scenes/showcase.obj at 512x512 with
   16 spp, the default engine, in this process (K1's launches counted
   from 0: as many as the main path's; the rendered image must be the
   main path's, bit for bit), then ``python -m`` of the package in a fresh
   interpreter with the host library and with ``CMR_NO_NATIVE=1`` (the
   Python parser and writer), in turns (native, Python, Python, native);
   prints the phase tables (scene_load, accel_build, upload, render,
   write, wall) side by side; the five .hdr files must be byte-equal, and
   decode to the main path's image encoded. ``parse_obj`` of a generated
   131,072-triangle heightfield and ``write_hdr`` at 1920x1080, each
   through the library and through the Python path, timed in turns.
   Then the host BVH builder: ``build_bvh`` timed on the many-cluster scene
   and, beside ``_build_bvh_python``, on its 4 x 4 tiling (22,048
   triangles); each tree's invariants (tri_order a permutation, leaves of
   at most leaf_size triangles, miss[0] == -1, bmin <= bmax) and its
   sha256 against that of the JAX package's native tree (a constant, taken
   with the JAX package's committed library: the tree must not depend on
   the host or its compiler); the host library's digest and load times in
   a fresh interpreter; and the BVH
   walk over the C++ and the numpy tree of the 4 x 4 tiling on 65,536
   camera rays, equal in prim and t;
5f. drives the default command at its full size: ``python -m`` of the
   package with ``-o`` alone in a fresh interpreter (showcase 1920x1080,
   256 spp, parity, depth 32, the default engine), its phases, wall time
   and the card memory it took (``nvidia-smi`` sampled beside it), the
   .hdr 1920x1080 and finite; then in this process the first, a middle
   and the last (26-row) row block rendered again as the single-device
   loop renders them (RGBE equal to the .hdr's rows byte for byte, the
   peak allocation printed); 256 pixels spread over the frame (every
   block's first and last row, the last block, partial-tile rows)
   through ``render_pixels_mega`` on the card, every sample each, RGBE
   byte-equal to the .hdr's pixels, and 64
   of them through the plain K1 on the host CPU (eight processes) against
   the card's under the golden gate's rule; the same render at 16 spp
   with every launch count set to 0 just before: its passes must be the
   schedule's 32, printed beside the sample steps and K1's launches; and
   that render at 8 samples a pass with ``--checkpoint``, stopped by its
   save hook after 15 saves (in the middle of a row block) and resumed by
   a new Renderer: bit-equal to it uninterrupted, the file removed;
5g. renders isobox, gembox and vessel (BASELINE configs 2-4) through the
   default engine against their goldens at 64x64 with 2 spp under the
   gate, then each and showcase at 256x256 with 8 spp, counter RNG, one
   warm and one timed render (bench.py's), with K1's launches per sample
   step;
6. times K1, K3, K4, K5 and K6 with CUDA events at their widest launches
   on their paths (65,536 lanes: K1 one bounce, K3 and K4 the closest
   trace of the primary rays, K5 its first round, K6 the pair engine's
   NEE sweep), times the plain versions on the same inputs, and computes
   each bound from its input: for K1 and K3 a plain pass finds, for each
   ray set, the clusters whose box the ray meets before its final hit (or
   its own bound), and counts their real slots and boxes at the f32
   operations of the CUDA tests; K4's bound is a floor for any exact
   listing (per listing lane, the boxes of the clusters it meets whose key
   ends at or below its final tlim, and one super box for each super
   holding them; or the bytes), printed beside the one-thread walk's work
   (every super, every cluster of a super met) and an empty kernel's time
   on the same grid (the launch floor), and K4 is timed before and after
   the redesign (the one-thread walk and the tile walk in turns: old, new,
   new, old); K5 counts the slot tests of the lanes holding each served
   cluster, K6 those of each valid pair's own cluster. K4, K5 and K6 are
   timed so on the many-cluster scene too, and K4 on its sparse relist;
   then K4 (both walks in turns) on showcase tiled 2 x 1, 2 x 2, 3 x 3
   and 4 x 4, grids of a few supers where the rule's cut between the
   walks lies. Then K4 launch by launch over
   one binned closest trace and one binned NEE trace of each scene
   (generation, listing lanes, keys listed, lists full, the tile walk's
   and the one-thread walk's ms, the empty launch, the bound, the rule's G
   over its CTAs). Then K1 launch by launch over one
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
7. prints its command time, a ``{"host_runtime": {...}}`` line (the
   CLI's phase tables, the BVH build times, the card and the host CPU), a
   ``{"default_workload": {...}}`` line (5f's and 5g's numbers), a
   ``{"pass_graph": {...}}`` line (4a's numbers), a
   ``{"kernels": [...]}`` line (one K1 row, one row of the control kernel,
   one partition row a width with the main path's sort launches,
   that names its ablation instances; K4 in two rows: showcase's
   renders with the walk the rule launches there, and the tile walk on
   the many-cluster scene with the launches of its traces), the
   ``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
   {...}}``.

Any failed phase exits nonzero before the last line. ``--quick`` stops
after the kernel comparisons (phases 2-3c) and exits 4; ``--tables``
builds, prints only the K1 launch table and K1's decomposition (4b), the
K3, K4 (both scenes, and the few-super tilings), K5 and K6 launch tables
of phase 6 and the timed main-path render of phase 4, times the main path at 2^16, 2^17 and 2^18 lanes a
pass (``LANES_PER_PASS``, which ``CMR_LANES_PER_PASS`` sets), and exits 4;
``--profile`` adds a torch.profiler breakdown of one pass of each engine.
``--workload`` builds, runs only 5f and 5g, and exits 4. ``--default-ab``
builds, runs 5f's command without and with its memory sampler in turns
(twice each), then the same render in the process with every pass timed
and the card's SM clock, power and temperature read every 64 passes, and
exits 4. ``--engines`` builds, times showcase 512x512 through each
engine's Renderer (a warm-up render, then three timed; mega and
wavefront at 16 spp, binned and pair at 4) and exits 4; it calls only
what the port has had since every engine ran as a CUDA graph, so a copy
of this script in an unpacked older tree (``git archive`` under
``build/``) times that tree in the same call: parent, change, change,
parent.
``--cards`` (a host with an even number of cards, at least 2) builds and
drives only what needs several cards: the Renderer's sharded band loop
(``--shard auto``, one tile a card, every card's call of a band queued
before the band's one host read) against ``--shard none`` on showcase
512x512 at 16 spp in parity and counter and at 1920x1080 with 16 spp in
counter, each Renderer warmed up by a render at the timed shapes and
then timed with K1's launches, the sharded render capturing nothing and
bit-equal (at 1920x1080 each card's calls in each band timed with CUDA
events: busy ms, and the wait for the band's slowest card); one band
over every card replayed under ``torch.cuda.set_sync_debug_mode
("error")``; the default command's bands (1920x1080@256 parity) in the
process, timed so; the default command in fresh processes on one
card (``CUDA_VISIBLE_DEVICES=0``), on two (where there are more) and on
every card (``--shard auto``, its default), their rates, one row block
of each card's tiles computed again on cuda:0 RGBE byte-equal to the
sharded .hdr, the images within one RGBE step of the one-card image (the
band loop sums a band's samples in one call, the one-card loop in
chunks); BASELINE config 5 (``-s 1024``, tiles over the cards) in a
fresh process, two row blocks of each card's tiles checked so; then a
two-process NCCL ``render_multihost`` (a file store; each process holds
half the cards; 2 x (cards / 2) in counter, the
'sample' axis across the processes; warmed up at its shape, no capture
in the timed call) whose image, on both processes, must equal
``render_beauty_sharded`` over the same cards bit for bit. It prints a
``{"cards": {...}}`` line, fails after all of them if any check failed,
and else exits 4.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

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
GROUPS = (1, 2, 4, 8, 16, 32)  # threads per ray that K1, K3 and K4's tile walk are built for
ONE_THREAD = (0, 128, 0)  # K4's one-thread walk (variant 0) as ``listing_split`` gives it
# The many-cluster scene (``tiled_options``): 16 x 16 copies of showcase,
# 352,768 triangles, a low camera across them.
TILES = 16
FEW_TILES = ((2, 1), (2, 2), (3, 3), (4, 4))  # tilings of a few supers, where K4's rule is cut
TILE_PITCH = (12.5, 9.5)
TILE_SEED = 6
TILED_CAMERA = ((-8.0, 4.0, 8.0), (100.0, -20.0, -100.0))
# Device sleep queued ahead of each timed launch: about 10 ms at the H100's
# clock, far longer than a wrapper's host work.
SLEEP_CYCLES = 20_000_000
# K1's CMR_MEGA_DEBUG token sets are kernels/megakernel.py's ABLATION_SETS
# (EXACT_ABLATIONS: the walks that render the default image).
TILED_ABLATIONS = ("", "nofuse", "ordered", "carrywalk")  # held on the many-cluster scene
TILED_TAIL = 4096  # lanes of the many-cluster scene's tail check
ABLATION_ATOL = 1e-6  # an exact ablation's image against the default's (the JAX tests' limit)
T_START = time.perf_counter()


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
    print(f"== {name} [at {time.perf_counter() - T_START:.1f} s]", flush=True)


def device_counts() -> list:
    """[K1 launches that ran, control launches] counted on the cards by
    the graph replays (kernels/pass_control.py), summed over the cards."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    tot = [0, 0]
    for d in pc.counted_devices():
        a, b = pc.device_counts(d)[:2].tolist()
        tot = [tot[0] + a, tot[1] + b]
    return tot


def sample_steps() -> int:
    """The pass-loop advances (sample steps) that ran, counted on the
    cards: the visits of the pass plan's "pass head" site, summed over the
    cards (every executor counts its sites)."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    return sum(pc.site_counts(pc.device_counts(d)).get("pass head", [0])[pc.SITE_VISITS]
               for d in pc.counted_devices())


def sort_visits() -> int:
    """The pass plans' sorts that ran, counted on the cards: the visits of
    the sites of kind 'sort' ("sort before phase i", "sort of a dynamic
    bounce"), whose control launch follows each sort in every executor,
    summed over the cards."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    kinds = {s.label: s.kind for s in pc.sites()}
    return sum(v[pc.SITE_VISITS] for d in pc.counted_devices()
               for label, v in pc.site_counts(pc.device_counts(d)).items()
               if kinds.get(label) == "sort")


def card_kernel_counts() -> dict:
    """The K3, K4, K5 and K6 launches that graph replays ran, counted on
    the cards (``pass_control.kernel_counts``), summed over the cards."""
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    tot = dict.fromkeys(pc.COUNTED_KERNELS, 0)
    for d in pc.counted_devices():
        for k, n in zip(pc.COUNTED_KERNELS, pc.kernel_counts(d).tolist()):
            tot[k] += n
    return tot


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper, and the counts on the
    cards, to 0."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
    from complex_materials_renderer_tpu_torch.kernels import partition as pt
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    mk.trace_paths_mega.launches = 0
    ctr.trace_core.launches = 0
    bt.listing.launches = 0
    bt.run_round.launches = 0
    ps.sweep.launches = 0
    pc.pass_control.launches = 0
    pt.partition.launches = 0
    for d in pc.counted_devices():
        pc.device_counts(d).zero_()
        pc.kernel_counts(d).zero_()


def launch_counts() -> dict:
    """The launch count of every kernel: those launched by its wrapper plus
    those that graph replays ran (counted on the card: K1's and the control
    kernel's by the control kernel, K3-K6's by an add beside each captured
    launch); the partition's, which takes the kernel or raises on the card,
    are its launches a sort times the sorts the cards ran (``sort_visits``:
    eager or replayed)."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
    from complex_materials_renderer_tpu_torch.kernels import partition as pt
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    on_card = device_counts()
    kc = card_kernel_counts()
    return {"K1": mk.trace_paths_mega.launches + on_card[0],
            "K3": ctr.trace_core.launches + kc["K3"], "K4": bt.listing.launches + kc["K4"],
            "K5": bt.run_round.launches + kc["K5"], "K6": ps.sweep.launches + kc["K6"],
            "PC": pc.pass_control.launches + on_card[1],
            "partition": pt.LAUNCHES_PER_SORT * sort_visits()}


class uncounted:
    """Leaves every launch count as it was on entry: the launches made to
    compare or time a kernel are not the main path's."""

    def __enter__(self):
        from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
        from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
        from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
        from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
        from complex_materials_renderer_tpu_torch.kernels import partition as pt
        from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

        self.host = (mk.trace_paths_mega.launches, pc.pass_control.launches,
                     ctr.trace_core.launches, bt.listing.launches, bt.run_round.launches,
                     ps.sweep.launches, pt.partition.launches)
        self.cards = {d: (pc.device_counts(d).clone(), pc.kernel_counts(d).clone())
                      for d in pc.counted_devices()}

    def __exit__(self, *exc):
        from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
        from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
        from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
        from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
        from complex_materials_renderer_tpu_torch.kernels import partition as pt
        from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

        (mk.trace_paths_mega.launches, pc.pass_control.launches, ctr.trace_core.launches,
         bt.listing.launches, bt.run_round.launches, ps.sweep.launches,
         pt.partition.launches) = self.host
        for d in pc.counted_devices():
            if d in self.cards:
                pc.device_counts(d).copy_(self.cards[d][0])
                pc.kernel_counts(d).copy_(self.cards[d][1])
            else:
                pc.device_counts(d).zero_()
                pc.kernel_counts(d).zero_()
        return False


def nvidia_smi_line(every: bool = False):
    """The first card's ``name, power.limit`` (with ``every``, a list of
    every card's)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    lines = out.stdout.strip().splitlines()
    return lines if every else lines[0]


def showcase_options(width, height, spp, obj="showcase", **kw):
    from complex_materials_renderer_tpu_torch.config import RenderOptions
    from complex_materials_renderer_tpu_torch.scene import load_scene

    obj = os.path.join(REPO, "scenes", f"{obj}.obj")
    base = dict(width=width, height=height, num_samples=spp, rng="parity", device="cuda")
    base.update(kw)
    scene = load_scene(obj, RenderOptions(obj_path=obj, **base))
    return scene, dataclasses.replace(scene.options, **base)


def tiled_options(width, height, spp, tiles=(TILES, TILES), **kw):
    """(scene, options) of the many-cluster scene: showcase's triangles,
    materials and media tiled ``tiles`` (TILES x TILES) on the ground plane at
    TILE_PITCH (showcase's floor is 12 x 9), each tile shifted by a jitter
    in [0, 0.5) along x and z drawn from TILE_SEED; showcase's light; a low
    camera looking across the tiles' diagonal (TILED_CAMERA). Built through
    ``Renderer`` like showcase: auto width, partition and super fan-out."""
    scene, opt = showcase_options(width, height, spp, **kw)
    rs = np.random.default_rng(TILE_SEED)
    offs = np.asarray([(TILE_PITCH[0] * i + rs.uniform(0.0, 0.5), 0.0,
                        -TILE_PITCH[1] * j - rs.uniform(0.0, 0.5))
                       for i in range(tiles[0]) for j in range(tiles[1])], np.float32)
    tris = (scene.triangles[None] + offs[:, None, None, :]).reshape(-1, 3, 3)
    scene = scene._replace(triangles=np.ascontiguousarray(tris, np.float32),
                           mat_ids=np.tile(scene.mat_ids, len(offs)))
    return scene, dataclasses.replace(opt, camera_pos=TILED_CAMERA[0],
                                      camera_look_at=TILED_CAMERA[1])


def tiled_scene(tiles=(TILES, TILES)):
    """(renderer, ray sets) of the many-cluster scene (or another tiling)
    at the main path's 512x512, 16 spp, with its cluster and super counts
    printed."""
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    t0 = time.perf_counter()
    scene, opt = tiled_options(512, 512, 16, tiles)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = Renderer(scene, opt)
    g = r.accel
    print(f"   showcase tiled {tiles[0]} x {tiles[1]}, {scene.triangles.shape[0]} triangles: "
          f"{g.num_clusters} clusters of width "
          f"{g.width}, {g.num_supers} supers of {g.super_factor} ({g.num_opaque_supers} opaque); "
          f"built and uploaded in {time.perf_counter() - t0:.1f} s", flush=True)
    return r, ray_sets(r)


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
    from complex_materials_renderer_tpu_torch.kernels import partition as pt
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = r_opts
    t0 = time.perf_counter()
    r = Renderer(scene, opt)
    print(f"   accel build + upload {time.perf_counter() - t0:.3f} s; clusters "
          f"{r.accel.num_clusters}, supers {r.accel.num_supers}, width {r.accel.width}", flush=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_groups(mk) as groups:  # the warm-up captures the graphs
        r.render()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    captured_sorts = pt.partition.launches  # the sorts' launches recorded into the graphs
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    launches, sort_launches = counts["K1"], counts["partition"]
    print(f"   partition: {captured_sorts} launches captured by its wrapper in the warm-up's "
          f"graphs; the timed render ran {sort_launches} ({sort_launches // pt.LAUNCHES_PER_SORT} "
          f"sorts counted on the card, {pt.LAUNCHES_PER_SORT} launches a sort)", flush=True)
    if captured_sorts <= 0 or sort_launches <= 0:
        fail("the main path sorted on the partition kernel no time")
    paths = opt.width * opt.height * opt.num_samples
    mean = float(np.mean(img))
    print(f"   K1 nodes captured by width and threads per lane: {groups.line()}", flush=True)
    digest = hashlib.sha256(np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()[:16]
    print(f"   showcase {opt.width}x{opt.height}@{opt.num_samples} parity: warm-up {warm:.3f} s, "
          f"timed {dt:.3f} s = {paths / dt / 1e6:.4f} Mpaths/s; K1 launches {launches}; "
          f"image mean {mean:.6f}, sha256 {digest}", flush=True)
    if launches <= 0:
        fail("the main path launched the megakernel no time")
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        fail("main-path image is not finite or has the wrong shape")
    return r, launches, img, counts["PC"], sort_launches


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


# --------------------------------------------------------------------------
# K1's ablation instances (CMR_MEGA_DEBUG)
# --------------------------------------------------------------------------


class requested_masks:
    """Records the ablation mask of every K1 library the wrapper asks for
    inside it: which instance each launch ran."""

    def __enter__(self):
        from complex_materials_renderer_tpu_torch.kernels import build

        self.build, self.orig, self.masks = build, build.megakernel, set()

        def megakernel(nee_max_media, ablate=0):
            self.masks.add(ablate)
            return self.orig(nee_max_media, ablate)

        build.megakernel = megakernel
        return self.masks

    def __exit__(self, *exc):
        self.build.megakernel = self.orig
        return False


def ablation_vs_plain(r, media9, misc, base, calls):
    """Each ablation instance against its plain version on the card, on the
    main path's first launch (65,536 fresh lanes, one bounce) and on the
    tail of one sample step (1,024 lanes of a mid-path state run to
    termination, some dead at entry: nophys's block lockstep): bit-equal,
    and launched from the token's own library."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    for debug in mk.ABLATION_SETS:
        for label, (st, kw) in (("first launch", calls[0]), ("tail", calls[-1])):
            instance_vs_plain(r, media9, misc, st, dict(base, **kw), debug, label)


def instance_vs_plain(r, media9, misc, st, kw, debug, label):
    """K1's instance of ``debug`` against its plain version on a copy of
    ``st``: bit-equal, launched from the token's own library (carrywalk:
    the nofuse library)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    lib_mask = mk.cuda_instance(mk.ablation_mask(debug))[0]
    kwd = dict(kw, debug=debug)
    want = clone_state(st)
    mk.trace_paths_mega_plain(r.accel, media9, misc, want, **kwd)
    got = clone_state(st)
    with uncounted(), requested_masks() as masks:
        mk.trace_paths_mega(r.accel, media9, misc, got, **kwd)
    torch.cuda.synchronize()
    if masks != {lib_mask}:
        fail(f"{debug}: the wrapper asked for the K1 libraries of masks {masks}, not {lib_mask}")
    n_flip, err = compare_states(f"{debug or 'default'} (library mask {lib_mask}), {label}",
                                 got, want)
    if n_flip or err != 0.0:
        fail(f"the {debug or 'default'} instance of K1 is not bit-equal to its plain version "
             f"({label})")


def tiled_ablations_vs_plain(rt):
    """K1's default and exact-walk instances against their plain versions
    on the many-cluster scene: its first 65,536-lane launch (one bounce)
    and the first TILED_TAIL lanes alive two bounces later run to
    termination, bit-equal. Showcase is one super; here the walks cross
    many, and ordered's nearest-first order and its stop rule with them."""
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    media9, misc, base = mega_inputs(rt)
    first = band_state(rt, "parity")
    mid = clone_state(first)
    with uncounted():
        mk.trace_paths_mega(rt.accel, media9, misc, mid, **base, max_iters=2)
    live = mid.alive.nonzero().flatten()[:TILED_TAIL]
    if live.numel() == 0:
        fail("no lane of the many-cluster scene lives after two bounces")
    tail = mk.MegaState(*(x[live].clone() for x in mid))
    print(f"   tail: the first {live.numel()} of {int(mid.alive.sum())} lanes alive after two "
          "bounces", flush=True)
    for debug in TILED_ABLATIONS:
        instance_vs_plain(rt, media9, misc, first, dict(base, max_iters=1), f"{debug}",
                          "tiled first launch")
        instance_vs_plain(rt, media9, misc, tail, dict(base, dim0=2 * mk.DRAWS_PER_BOUNCE),
                          debug, "tiled tail")


def ablation_renders(main_opts, mega_img):
    """The main path under each exact ablation (CMR_MEGA_DEBUG as the
    Renderer reads it), each render's K1 launches from the token's library
    alone, its image within ABLATION_ATOL of the default render's."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    r = Renderer(scene, opt)
    paths = opt.width * opt.height * opt.num_samples
    for debug in mk.EXACT_ABLATIONS:
        os.environ["CMR_MEGA_DEBUG"] = debug
        try:
            # The warm-up captures the graphs: the K1 library they launch is
            # asked for then.
            with uncounted(), requested_masks() as masks:
                r.render()
            reset_launch_counts()
            torch.cuda.synchronize()
            img, dt = timed_render(r.render)
        finally:
            del os.environ["CMR_MEGA_DEBUG"]
        launches = launch_counts()["K1"]
        diff = float(np.abs(np.asarray(img, np.float64) - np.asarray(mega_img, np.float64)).max())
        print(f"   {debug}: showcase {opt.width}x{opt.height}@{opt.num_samples} parity {dt:.3f} s "
              f"= {paths / dt / 1e6:.4f} Mpaths/s; K1 launches {launches}, all of mask "
              f"{sorted(masks)}; max |diff| against the default image {diff:.3e} "
              f"(limit {ABLATION_ATOL})", flush=True)
        if launches <= 0 or masks != {mk.cuda_instance(mk.ablation_mask(debug))[0]}:
            fail(f"the main path under {debug} did not run the {debug} instance of K1")
        if not diff <= ABLATION_ATOL:
            fail(f"the main path under {debug} is not the default image (max |diff| {diff:.3e})")


GRAPH_SPILL = "1:1,8:1,32:2"  # a forced schedule that spills in every phase
GRAPH_TILED = (256, 256, 4)  # the tiled scene's dynamic-mode comparison
CONTROL_REPS = 200


class executor_as:
    """Makes the Renderer's calls of ``render_beauty_mega`` and of the
    wavefront ``render_beauty`` take ``executor`` ('eager': the host loop
    the graph is compared with)."""

    def __init__(self, executor):
        self.executor = executor

    def __enter__(self):
        from functools import partial

        from complex_materials_renderer_tpu_torch.render import integrator as it
        from complex_materials_renderer_tpu_torch.render import megarender as mr

        self.saved = [(mr, "render_beauty_mega", mr.render_beauty_mega),
                      (it, "render_beauty", it.render_beauty)]
        for mod, name, fn in self.saved:
            setattr(mod, name, partial(fn, executor=self.executor))

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def counted_k1(fn):
    """(result, seconds, K1 launches: the wrappers' and those counted on
    the card) of ``fn()``, the counts left as they were."""
    with uncounted():
        reset_launch_counts()
        out, dt = timed_render(fn)
        return out, dt, launch_counts()["K1"]


def graph_against_eager(label, fn_eager, fn_graph):
    """The graph executor's result bit-equal to the eager executor's, with
    the same K1 launches (eager: the wrapper's count; graph: the count on
    the card, of a replay after the capturing call); returns their times."""
    import torch

    from complex_materials_renderer_tpu_torch.render import megarender as mr

    eager, t_eager, n_eager = counted_k1(fn_eager)
    n_cap = len(mr.captures)
    _, t_first, _ = counted_k1(fn_graph)
    captured = sum(c.seconds for c in mr.captures[n_cap:])
    graph, t_graph, n_graph = counted_k1(fn_graph)
    eager = eager if isinstance(eager, tuple) else (eager,)
    graph = graph if isinstance(graph, tuple) else (graph,)
    equal = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                for a, b in zip(eager, graph))
    print(f"   {label}: graph bit-equal to eager {equal}; K1 launches eager {n_eager}, graph "
          f"(on the card) {n_graph}; eager {t_eager:.4f} s, graph {t_graph:.4f} s (first call "
          f"{t_first:.4f} s, {len(mr.captures) - n_cap} captures {captured:.4f} s)", flush=True)
    if not equal:
        fail(f"{label}: the graph executor differs from the eager executor")
    if n_graph != n_eager or n_graph <= 0:
        fail(f"{label}: the graph ran {n_graph} K1 launches, the eager executor {n_eager}")
    return t_eager, t_graph


def k1_control_vs_plain(r, media9, misc, base):
    """K1 with the control block against its plain version with the same
    block on the card (65,536 fresh ld lanes, one bounce: 32 live blocks
    and dim0 past the Sobol table's edge, then a run flag of 0), and K1's
    first launch timed with the block beside the host-int launch; then a
    launch over 8 live blocks at the full width's G against the 8,192-lane
    launch's G (the dynamic modes' launches: the graph takes G from the
    static width)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
    from complex_materials_renderer_tpu_torch.kernels.cluster_test import group_size

    st = band_state(r, "ld")
    n = st.org.shape[0]
    kw = dict(base, max_iters=1, ld=True)
    worst = 0.0
    with uncounted():
        for live, dim0, run in ((32, 5000, 1), (64, 2, 0)):
            ctrl = pc.new_ctrl(st.org.device)
            ctrl[:3] = torch.tensor([live, dim0, run], dtype=torch.int32)
            got = mk.trace_paths_mega(r.accel, media9, misc, clone_state(st), ctrl=ctrl, **kw)
            want = mk.trace_paths_mega_plain(r.accel, media9, misc, clone_state(st), ctrl=ctrl,
                                             **kw)
            torch.cuda.synchronize()
            n_flip, err = compare_states(f"K1 with the control block (live_blocks {live}, dim0 "
                                         f"{dim0}, run {run})", got, want)
            kept = all(torch.equal(a[live * 1024 * run:], b[live * 1024 * run:])
                       for a, b in zip(got, st))
            if n_flip or err != 0.0 or not kept:
                fail("K1 with the control block is not bit-equal to its plain version, or "
                     "touched a lane beyond its live blocks")
            worst = max(worst, err)
        pkw = dict(base, max_iters=1)
        pst = band_state(r, "parity")
        ctrl = pc.new_ctrl(pst.org.device)
        ctrl[:3] = torch.tensor([n // 1024, 0, 1], dtype=torch.int32)
        host = time_k1(r, media9, misc, pst, pkw, 20)
        with_ctrl = time_k1(r, media9, misc, pst, dict(pkw, ctrl=ctrl), 20)
        host2 = time_k1(r, media9, misc, pst, pkw, 20)
        ctrl[0] = 8
        wide = time_k1(r, media9, misc, pst, dict(pkw, ctrl=ctrl), 20)
        narrow = time_k1(r, media9, misc, state_head(pst, 8 * 1024), pkw, 20)
    print(f"   K1's first launch ({n} lanes, G={group_size(n)}): with the control block "
          f"{with_ctrl:.5f} ms, host ints {host:.5f}, {host2:.5f} ms; 8 live blocks of the "
          f"{n}-lane launch (G={group_size(n)}) {wide:.5f} ms against the 8,192-lane launch "
          f"(G={group_size(8192)}) {narrow:.5f} ms", flush=True)
    return worst, with_ctrl


def state_head(st, k):
    """A copy of the first ``k`` lanes of state ``st``."""
    from complex_materials_renderer_tpu_torch.kernels.megakernel import MegaState

    return MegaState(*(x[:k].clone() for x in st))


def time_control(n=65536):
    """The control kernel against its plain version on the card at the
    main path's width (the spill loop's flags), each launch counting at a
    site (SITE_COUNT, as every launch of the main path does) in a whole
    counter block, compared in every field but the card's clock (the last
    stamp and the sites' ns), then timed so: CUDA events over CONTROL_REPS
    launches each, beside as many empty launches of its grid and
    ``torch.count_nonzero`` of the lanes (the library call nearest it).
    Returns (ms, plain ms, bound ms, library ms, max error)."""
    import ctypes

    import torch

    from complex_materials_renderer_tpu_torch.kernels import build
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    g = torch.Generator(device="cuda").manual_seed(7)
    alive = torch.rand(n, device="cuda", generator=g) < 0.3
    site = pc.MAX_SITES - 1
    flags = pc.AFTER_K1 | pc.COND | pc.DEVICE_COUNT | pc.SITE_COUNT
    clock = torch.zeros(pc.CNT_LEN, dtype=torch.bool, device="cuda")
    clock[pc.CNT_LAST] = True
    clock[pc.CNT_SITES + pc.SITE_NS::pc.SITE_FIELDS] = True
    err = 0
    with uncounted():
        for f, kw in ((pc.INIT | pc.COND | pc.DEVICE_COUNT, dict(dim0=2, threshold=1024)),
                      (flags | pc.SET_LIVE, dict(advance=8, threshold=16384)),
                      (pc.AFTER_K1 | pc.NOT_K1 | pc.DEVICE_COUNT, dict(advance=8)),
                      (pc.SET_FULL, {})):
            ctrl_k = torch.tensor([3, 10, 1, 777, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
            cnt_k = torch.zeros(pc.CNT_LEN, dtype=torch.int64, device="cuda")
            ctrl_p, cnt_p = ctrl_k.clone(), cnt_k.clone()
            for _ in range(2):  # the second launch after a stamp of the first
                pc.pass_control(alive, ctrl_k, cnt_k, f | pc.SITE_COUNT, site=site, **kw)
                pc.pass_control_plain(alive, ctrl_p, cnt_p, f | pc.SITE_COUNT, site=site, **kw)
            torch.cuda.synchronize()
            diff = (cnt_k - cnt_p).masked_fill(clock, 0)
            err = max(err, int((ctrl_k - ctrl_p).abs().max()), int(diff.abs().max()))
        if err:
            fail(f"the control kernel differs from its plain version by {err}")
        ctrl = pc.new_ctrl("cuda")
        cnt = torch.zeros(pc.CNT_LEN, dtype=torch.int64, device="cuda")
        lib = build.pass_control()
        stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731

        def many(fn):
            return cuda_time(lambda i: [fn() for _ in range(CONTROL_REPS)], 5) / CONTROL_REPS

        def launch():
            pc.pass_control(alive, ctrl, cnt, flags, advance=8, threshold=1024, site=site)

        ms = many(launch)
        empty = many(lambda: lib.cmr_pass_control_empty(stream()))
        ms2 = many(launch)
        plain = cuda_time(lambda i: pc.pass_control_plain(alive, ctrl, cnt, flags, advance=8,
                                                          threshold=1024, site=site), 20)
        library = many(lambda: torch.count_nonzero(alive))
    nbytes = n + 4 * pc.CTRL_LEN * 2 + 16 * 2 + 8 * 2 * (pc.SITE_FIELDS + 1)
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"   control kernel ({n} lanes, flags AFTER_K1 | COND | SITE_COUNT): {ms:.5f}, "
          f"{ms2:.5f} ms a launch in a run of {CONTROL_REPS}; an empty launch of its grid "
          f"{empty:.5f} ms; plain {plain:.4f} ms; torch.count_nonzero {library:.5f} ms; bound "
          f"{nbytes} bytes = {bound:.6f} ms (bytes; its time is its launch latency); against "
          f"its plain version (SITE_COUNT, all but the clock): max difference {err}", flush=True)
    return min(ms, ms2), plain, bound, library, float(err)


PARTITION_REPS = 200  # sorts of one timed run
PARTITION_WIDTHS = (65536, 16384)  # the frames cells' pass width and the preview's
SORT_BYTES = 77  # a lane's state: org, dir, thr, rad, rng, aux, lane, depth, alive


def partition_lanes(n, seed, alive_share=0.4):
    """A wavefront of ``n`` lanes on the card (state, lane ids, world box):
    origins around and outside a box, normal directions, ``alive_share``
    of the lanes alive, lane ids a permutation."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels.megakernel import MegaState

    rs = np.random.default_rng(seed)
    lo, hi = np.array([-2, -1, -3], np.float32), np.array([3, 4, 1], np.float32)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    state = MegaState(
        org=t(rs.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)),
        dir=t(rs.normal(size=(n, 3)).astype(np.float32)),
        thr=t(rs.random((n, 3)).astype(np.float32)), rad=t(rs.random((n, 3)).astype(np.float32)),
        rng=t(rs.integers(0, 2**32, n, dtype=np.int64)),
        depth=t(rs.integers(0, 33, n).astype(np.int32)), alive=t(rs.random(n) < alive_share),
        aux=t(rs.integers(0, 2**32, n, dtype=np.int64)))
    return state, t(rs.permutation(n).astype(np.int64)), t(lo), t(hi)


def time_partition(n):
    """The partition (kernels/partition.py) against its plain route on the
    card at ``n`` lanes (40% alive): the permutation, every field, the lane
    ids and the bank rows of a phase shrink equal; then CUDA events over
    PARTITION_REPS sorts: eagerly, in one CUDA graph, and as a sort segment
    of the pass plan's graph (the sort and its control launch), beside the
    plain route (``torch.argsort`` and the gathers: the library yardstick)
    eagerly and in a graph. Returns a dict of ms a sort."""
    from functools import partial

    import torch

    from complex_materials_renderer_tpu_torch.kernels import partition as pt
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc
    from complex_materials_renderer_tpu_torch.kernels.megakernel import MegaState

    state, lane, lo, hi = partition_lanes(n, n)
    scratch = pt.Scratch("cuda", n)
    outs = []
    for fn in (partial(pt.partition, scratch=scratch), pt.partition_plain):
        s, l_ = MegaState(*(x.clone() for x in state)), lane.clone()
        banks = (torch.zeros((n + 1, 3), device="cuda"),
                 torch.zeros((n + 1,), dtype=torch.int64, device="cuda"), n // 2)
        perm = fn(s, l_, lo, hi, "dir", banks).to(torch.int64)
        outs.append([perm, *s, l_, banks[0], banks[1]])
    torch.cuda.synchronize()
    err = sum(int(not torch.equal(a, b)) for a, b in zip(*outs))
    if err:
        fail(f"the partition differs from its plain route in {err} outputs at {n} lanes")
    ctrl = pc.new_ctrl("cuda")
    cnt = torch.zeros(pc.CNT_LEN, dtype=torch.int64, device="cuda")

    def kernel():
        pt.partition(state, lane, lo, hi, "dir", scratch=scratch)

    def plain():
        pt.partition_plain(state, lane, lo, hi, "dir")

    def segment(sort):
        def fn():
            sort()
            pc.pass_control(state.alive, ctrl, cnt, pc.SET_LIVE)
        return fn

    def eager(fn, reps=PARTITION_REPS):
        return cuda_time(lambda i: [fn() for _ in range(reps)], 3) / reps

    def in_graph(fn, reps=PARTITION_REPS):
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        ms = cuda_time(lambda i: graph.replay(), 5) / reps
        del graph
        return ms

    out = {"lanes": n, "max_abs_err": float(err)}
    with uncounted():
        out["eager_ms"] = eager(kernel)
        out["graph_ms"] = in_graph(kernel)
        out["segment_ms"] = in_graph(segment(kernel))
        out["plain_ms"] = eager(plain, 20)
        out["plain_graph_ms"] = in_graph(plain, 20)
        out["plain_segment_ms"] = in_graph(segment(plain), 20)
        out["graph_ms_again"] = in_graph(kernel)
    nbytes = 2 * SORT_BYTES * n
    out["bound_ms"] = nbytes / PEAK_BYTES * 1e3
    print(f"   partition ({n} lanes, 40% alive; {pt.LAUNCHES_PER_SORT} launches a sort): "
          f"{out['eager_ms']:.5f} ms a sort eagerly, {out['graph_ms']:.5f} and "
          f"{out['graph_ms_again']:.5f} in a graph of {PARTITION_REPS}, a sort segment with its "
          f"control launch {out['segment_ms']:.5f}; plain route (torch.argsort and gathers) "
          f"{out['plain_ms']:.5f} eagerly, {out['plain_graph_ms']:.5f} in a graph, a segment "
          f"{out['plain_segment_ms']:.5f}; bound {nbytes} bytes = {out['bound_ms']:.6f} ms "
          f"(bytes); against the plain route: {err} outputs differ", flush=True)
    return out


def graph_phase(main_opts, rt, media9, misc, base, profile):
    """The mega pass as one device program: the graph executor (the
    default on the card) against the eager executor (the host loop) on
    showcase 512x512@16 in parity, counter and ld, under GRAPH_SPILL in
    each, and on the tiled scene in the dynamic modes all and hybrid; one
    call under torch.cuda.set_sync_debug_mode('error'); K1 with the control
    block and the control kernel against their plain versions; the default
    command's pass timed on both executors (and profiled with --profile)."""
    import torch

    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    out = {"frames": {}}
    for rng in ("parity", "counter", "ld"):
        for sched in ("", GRAPH_SPILL):
            r = Renderer(scene, dataclasses.replace(opt, rng=rng))
            label = f"showcase {opt.width}x{opt.height}@{opt.num_samples} {rng}" + (
                f" CMR_MEGA_SCHED={sched}" if sched else "")
            if sched:
                os.environ["CMR_MEGA_SCHED"] = sched
            try:
                def eager():
                    with executor_as("eager"):
                        return torch.from_numpy(r.render())
                t_e, t_g = graph_against_eager(label, eager, lambda: torch.from_numpy(r.render()))
            finally:
                os.environ.pop("CMR_MEGA_SCHED", None)
            out["frames"][label] = {"eager_s": t_e, "graph_s": t_g}
    w, h, spp = GRAPH_TILED
    for mode in ("all", "hybrid"):
        args = (rt.camera, rt.scene_arrays, rt.accel, rt.lights, (w, h), spp)
        kw = dict(rng_mode="parity", schedule_mode=mode, full_resolution=(w, h),
                  max_depth=rt.options.max_depth, rr_depth=rt.options.rr_depth,
                  nee_max_media=rt.options.nee_max_media, return_rng=True)
        t_e, t_g = graph_against_eager(
            f"tiled {w}x{h}@{spp} parity, schedule mode {mode}",
            lambda: mr.render_beauty_mega(*args, executor="eager", **kw),
            lambda: mr.render_beauty_mega(*args, **kw))
        out["frames"][f"tiled {mode}"] = {"eager_s": t_e, "graph_s": t_g}

    # One call with a synchronising operation raising: the band call of the
    # main path, replayed (its graph is captured above); the copy to the
    # host after it.
    r = Renderer(scene, opt)
    args = (r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, BAND_ROWS),
            opt.num_samples)
    kw = dict(rng_mode="parity", full_resolution=(opt.width, opt.height), row_offset=BAND_ROWS,
              return_rng=True)
    mr.render_beauty_mega(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, words = mr.render_beauty_mega(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"   torch.cuda.set_sync_debug_mode('error') around one render_beauty_mega call "
          f"({opt.width}x{BAND_ROWS}@{opt.num_samples}, the main path's call): no synchronising "
          f"operation; image mean {float(img.mean().cpu()):.6f}", flush=True)

    out["k1_ctrl_err"], out["k1_ctrl_ms"] = k1_control_vs_plain(r, media9, misc, base)
    out["control"] = time_control()
    out["partition"] = [time_partition(n) for n in PARTITION_WIDTHS]

    # The default command's pass: one 16-sample call over its first row
    # block, on both executors in turns (the graph captured first).
    from complex_materials_renderer_tpu_torch.renderer import _auto_row_chunk, _auto_sample_chunk

    w, h, spp = DEFAULT_SIZE
    rows, chunk = _auto_row_chunk(w), _auto_sample_chunk(w, h)
    dscene, dopt = showcase_options(w, h, spp)
    rd = Renderer(dscene, dopt)
    args = (rd.camera, rd.scene_arrays, rd.accel, rd.lights, (w, rows), chunk)
    kw = dict(rng_mode="parity", full_resolution=(w, h), return_rng=True)
    n_cap = len(mr.captures)
    mr.render_beauty_mega(*args, **kw)
    cap_s = sum(c.seconds for c in mr.captures[n_cap:])
    times = {"graph": [], "eager": []}
    with uncounted():
        for ex in ("graph", "eager", "eager", "graph", "graph", "eager"):
            _, dt = timed_render(lambda: mr.render_beauty_mega(
                *args, executor="auto" if ex == "graph" else "eager", **kw))
            times[ex].append(dt * 1e3)
    paths = w * rows * chunk
    print(f"   the default command's pass ({w}x{rows}@{chunk}, {paths} paths), in turns: graph "
          f"{', '.join(f'{t:.2f}' for t in times['graph'])} ms, eager "
          f"{', '.join(f'{t:.2f}' for t in times['eager'])} ms; its capture {cap_s:.3f} s",
          flush=True)
    out["pass_ms"] = times
    out["pass_capture_s"] = cap_s
    if profile:
        out["profile"] = {ex: profile_call(lambda ex=ex: mr.render_beauty_mega(
            *args, executor=ex, **kw), f"the default command's pass, {ex} executor")
            for ex in ("auto", "eager")}
    return out


def profile_call(fn, label):
    """torch.profiler over one call of ``fn`` after a warm one: wall ms,
    the kernels' device ms and their share of the wall (the card's busy
    share), the largest kernels."""
    import torch
    import torch.profiler as tp

    fn()
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    busy = sum(dev_ms(e) for e in rows)
    print(f"   profile of {label}: wall {wall:.2f} ms, kernels {busy:.2f} ms on the card "
          f"(busy share {busy / wall:.3f}), {sum(e.count for e in rows)} kernel launches",
          flush=True)
    for e in sorted(rows, key=lambda e: -dev_ms(e))[:8]:
        print(f"     {dev_ms(e):10.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall}


def lane_bounces(r, media9, misc, st, kw):
    """Lanes alive at the start of each bounce iteration of the K1 call
    ``kw`` on ``st``: a replay on a copy, one iteration a launch."""
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    s, n = clone_state(st), 0
    with uncounted():
        for k in range(kw["max_iters"]):
            alive = int(s.alive.sum())
            if alive == 0:
                break
            n += alive
            mk.trace_paths_mega(r.accel, media9, misc, s, **dict(
                kw, max_iters=1, dim0=kw.get("dim0", 0) + mk.DRAWS_PER_BOUNCE * k))
    return n


def instance_ptxas(mask, group):
    """(registers, spill-store bytes) of K1's instance of ``mask`` at
    ``group`` threads a lane, and the range of registers over its
    instances, from the build log (--nee-bound 4: K = 10)."""
    from complex_materials_renderer_tpu_torch.kernels import build

    for lib, _, log in build.build_log:
        if lib.startswith(f"libmegakernel_CMR_MEGA_ABLATE{mask}_CMR_NEE_MAX_MEDIA4_"):
            lines = [x for x in ptxas_lines(log) if x[0].startswith("megakernelILi10E")]
            regs = [x[1] for x in lines]
            for name, n, spill in lines:
                if name.startswith(f"megakernelILi10ELi{group}E"):
                    return n, spill, f"{min(regs)}-{max(regs)}"
    return None, None, "not built here"


def k1_decomposition(r, media9, misc, base, reps=5):
    """K1's time split by its ablation instances on the main path: per
    token set (the default first), ptxas registers and spill of the
    instance the 65,536-lane launch runs, the ms of that first launch and
    of one whole parity sample step (its launches recorded through the
    renderer's phase schedule under the token), each timed in turns with
    the default (default, token, token, default), the step's lane-bounces
    (lanes alive at each iteration) and ms per million lane-bounces."""
    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    def step_ms(calls, debug):
        return sum(time_k1(r, media9, misc, s, dict(base, **kw, debug=debug), reps)
                   for s, kw in calls)

    default_calls = k1_step_calls(r, media9, misc, base)
    first, kw0 = default_calls[0]
    print("   K1 decomposition by CMR_MEGA_DEBUG (showcase 512x512@16 parity, the 65,536-lane "
          "band; each token's times beside the default's, timed in turns):", flush=True)
    print("     token            G  regs (all G)  spill  first ms  default   step ms   default  "
          "launches  lane-bounces  ms/M l-b  first l-b", flush=True)
    rows = {}
    with uncounted():
        for debug in ("",) + mk.ABLATION_SETS:
            lib_mask, one_thread = mk.cuda_instance(mk.ablation_mask(debug))
            calls = k1_step_calls(r, media9, misc, dict(base, debug=debug)) if debug else \
                default_calls
            kw_tok = dict(base, **kw0, debug=debug)
            kw_def = dict(base, **kw0)
            d1 = time_k1(r, media9, misc, first, kw_def, 20)
            t1 = time_k1(r, media9, misc, first, kw_tok, 20)
            t2 = time_k1(r, media9, misc, first, kw_tok, 20)
            d2 = time_k1(r, media9, misc, first, kw_def, 20)
            sd1 = step_ms(default_calls, "")
            st1 = step_ms(calls, debug)
            st2 = step_ms(calls, debug)
            sd2 = step_ms(default_calls, "")
            lb = sum(lane_bounces(r, media9, misc, s, dict(base, **kw, debug=debug))
                     for s, kw in calls)
            lb0 = lane_bounces(r, media9, misc, first, kw_tok)
            g = 1 if one_thread else mk.group_size(first.org.shape[0])
            regs, spill, span = instance_ptxas(lib_mask, g)
            tok_first, tok_step = (t1 + t2) / 2, (st1 + st2) / 2
            rows[debug or "default"] = (tok_first, tok_step, lb)
            print(f"     {debug or 'default':16s} {g:2d} {regs!s:>4s} ({span:>7s}) {spill!s:>5s} "
                  f"{tok_first:9.4f} {(d1 + d2) / 2:8.4f} {tok_step:9.4f} {(sd1 + sd2) / 2:9.4f} "
                  f"{len(calls):9d} {lb:13d} {tok_step / (lb / 1e6):9.4f} {lb0:10d}", flush=True)
    # cullonly's closest-hit walk must survive the compiler: cullonly is
    # notrace,cullonly plus that walk's culls. (notrace keeps the fused
    # walk's triangle tests, which cullonly drops, so it is no yardstick.)
    culls = rows["cullonly"][0] - rows["notrace,cullonly"][0]
    print(f"   cullonly's closest-hit culls on the first launch: {culls:.4f} ms (cullonly "
          f"{rows['cullonly'][0]:.4f}, notrace,cullonly {rows['notrace,cullonly'][0]:.4f}, "
          f"notrace {rows['notrace'][0]:.4f})", flush=True)
    if not culls > 0.05 * rows["notrace,cullonly"][0]:
        fail("cullonly's walk took no measurable time: the compiler removed it")
    return rows


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


def graph_warm(r):
    """Render once with ``r`` (which captures its call shapes' graphs) and
    return (seconds, captures, their seconds)."""
    import torch

    from complex_materials_renderer_tpu_torch.render import megarender as mr

    n_cap = len(mr.captures)
    t0 = time.perf_counter()
    r.render()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, len(mr.captures) - n_cap,
            sum(c.seconds for c in mr.captures[n_cap:]))


def wavefront_path(main_opts, mega_img):
    """The wavefront engine on the main scene, as one CUDA graph a call
    shape (timed after a render that captures it), held against the
    megakernel image of the same configuration."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import cluster_trace as ctr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    opt = dataclasses.replace(opt, engine="wavefront")
    r = Renderer(scene, opt)
    with recorded_groups(ctr) as groups:  # the warm-up captures the graphs
        warm, n_cap, cap_s = graph_warm(r)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()["K3"]
    print(f"   K3 launches recorded at capture by threads per ray: "
          f"{len(groups.seen)} widths; " + ", ".join(
              f"G={g} x{sum(n for (_, gg), n in groups.seen.items() if gg == g)}"
              for g in sorted({g for _, g in groups.seen})), flush=True)
    paths = opt.width * opt.height * opt.num_samples
    nonflip, flips = flip_gate(img, mega_img)
    budget = WAVEFRONT_FLIP_FRAC * opt.width * opt.height
    print(f"   showcase {opt.width}x{opt.height}@{opt.num_samples} parity, wavefront (graph): "
          f"warm-up render {warm:.3f} s ({n_cap} captures, {cap_s:.3f} s), timed {dt:.3f} s = "
          f"{paths / dt / 1e6:.4f} Mpaths/s; K3 launches {launches} (on the card); image mean "
          f"{float(np.mean(img)):.6f}; against the megakernel image: "
          f"non-flip RMSE {nonflip:.3e} (limit 1e-3), flip pixels {flips} (budget {budget:.0f})",
          flush=True)
    if launches <= 0:
        fail("the wavefront path launched the closest-hit kernel no time")
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        fail("wavefront image is not finite or has the wrong shape")
    if not (nonflip <= 1e-3 and flips <= budget):
        fail("the wavefront image fails the gate against the megakernel image")
    return launches, paths / dt / 1e6


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

    kern.prepare = lambda device, lanes: None  # the library is built
    plan = _make_advance(kern, dynamic, _phase_schedule(n, opt.max_depth), r.scene_arrays, "dir",
                         opt.max_depth)
    plan.prepare(st.org.device, n)
    lane = torch.arange(n, device=st.org.device)
    with uncounted():
        plan(st, lane, n)
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
            k4_vs_plain(g, f"showcase {name}", rays6(o, d), eff, sparse=name == "full")
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


def k4_configs(n, supers):
    """(label, ``listing_split`` value; None: the rule's) of every K4
    instance for a launch over ``n`` lanes of a grid of ``supers`` supers:
    the one-thread walk (variant 0), the tile walk with G chosen per CTA
    (its span from ``listing_span``) and at each fixed G (span LIST_CTA /
    G), and the rule's launch."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct

    return ([("one-thread", ONE_THREAD), ("tile", (1, bt.listing_span(n, supers), 0))]
            + [(f"G={gs}", (1, ct.LIST_CTA // gs, gs)) for gs in GROUPS] + [("rule", None)])


def tile_split(g, n):
    """The tile walk's launch over ``n`` lanes of grid ``g``, G per CTA."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    return 1, bt.listing_span(n, g.num_supers), 0


def k4_forced(cfg):
    """K4 launches as ``cfg`` (a ``listing_split`` value; None: the rule)."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    return forced(bt, "listing_split",
                  bt.listing_split if cfg is None else (lambda _n, _s, cfg=cfg: cfg))


def relist_tlo(g, rays, eff):
    """The second generation's t_lo of a fresh listing: each lane's second
    key (EMPTY where the lane listed fewer)."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    return bt.listing_plain(g, rays, eff, fresh_tlo(eff), 2)[0][1].contiguous()


def sparse_tlo(tlo, frac=0.015, seed=11):
    """``tlo`` on about ``frac`` of the lanes (drawn from ``seed``), EMPTY
    elsewhere: a sparse relist, its few live lanes scattered over all."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    gen = torch.Generator(device=tlo.device).manual_seed(seed)
    pick = torch.rand(tlo.shape, generator=gen, device=tlo.device) < frac
    return torch.where(pick, tlo, bt.EMPTY).to(torch.int32).contiguous()


def k4_vs_plain(g, label, rays, eff, sparse=False):
    """K4 against ``listing_plain`` on the card at every list length of
    BINNED_LISTS, with fresh and relisting t_lo (and, with ``sparse``, a
    relist on about 1.5% of the lanes), at every instance of
    ``k4_configs``: keys and tlim equal on every lane. Returns the largest
    |key difference| seen (0)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    worst = 0.0
    fresh = fresh_tlo(eff)
    relist = relist_tlo(g, rays, eff)
    tlos = [("fresh", fresh), ("relisting", relist)]
    if sparse:
        tlos.append(("sparse relisting", sparse_tlo(relist)))
    for L in BINNED_LISTS:
        for tname, tlo in tlos:
            wk, wt = bt.listing_plain(g, rays, eff, tlo, L)
            torch.cuda.synchronize()
            bad = {}
            for cname, cfg in k4_configs(rays.shape[1], g.num_supers):
                with k4_forced(cfg):
                    keys, tlim = bt.listing(g, rays, eff, tlo, L)
                    torch.cuda.synchronize()
                bad[cname] = int(((keys != wk).any(0) | (tlim != wt)).sum())
                worst = max(worst, float((keys.long() - wk.long()).abs().max()))
            print(f"   K4 L={L}, {label} rays, {tname} t_lo: lanes {rays.shape[1]}, listing "
                  f"{int((tlo != bt.EMPTY).sum())}, keys listed {int((wk != bt.EMPTY).sum())}, "
                  f"lists full {int((wt != bt.EMPTY).sum())}; lanes differing: " + ", ".join(
                      f"{c} {b}" for c, b in bad.items()), flush=True)
            if any(bad.values()):
                fail(f"K4 differs from its plain version (L={L}, {label}, {tname}): {bad}")
    return worst


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
    512x512 and ENGINE_SPP samples, as one CUDA graph a call shape (timed
    after a render that captures it), held against the megakernel image of
    the same render."""
    import torch

    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    opt = dataclasses.replace(opt, engine=engine, num_samples=ENGINE_SPP)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = Renderer(scene, opt)
        warm, n_cap, cap_s = graph_warm(r)
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
    print(f"   showcase {opt.width}x{opt.height}@{opt.num_samples} parity, {engine} (graph): "
          f"warm-up render {warm:.3f} s ({n_cap} captures, {cap_s:.3f} s), timed {dt:.3f} s = "
          f"{rate:.4f} Mpaths/s; launches K3 {counts['K3']}, K4 {counts['K4']}, K5 "
          f"{counts['K5']}, K6 {counts['K6']} (on the card); image mean "
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


def k56_control_vs_plain(r, media9, sets):
    """K5 and K6 with their counts from the control block (as the graphs
    launch them: one instance a rung of their ladders) against their plain
    versions and their host-int launches on the card. K5 on the first round
    of the binned closest trace (65,536 primary lanes, L = 8): at each rung
    of its (G, S) ladder with the live blocks in the block set to the
    rung's most (at most the round's own, so the round is whole), bit-equal
    to the plain round at those live blocks and timed beside the host-int
    launch at the same G; then 0 live blocks, which serve nothing. K6 on
    the pair engine's NEE sweep (L = 4): the count of its valid pairs in
    the block at its rung, timed beside the host-int launch, then at every
    other rung with the count set to that rung's most (the output does not
    depend on how the pairs are split between the tiles and the strided
    pass), each bit-equal to the plain sweep; then 0 pairs. Returns
    {kernel: [row, ...]}."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps
    from complex_materials_renderer_tpu_torch.kernels import pass_control as pc

    g = r.accel
    out = {"K5": [], "K6": []}
    with uncounted():
        o, d, eff = sets["full"]
        K, rays5, keys, state, lb = first_round(r, "full", o, d, eff, 8)
        n_blocks = keys.shape[1] // bt.BLOCK
        for a, b, G in bt.round_ladder(n_blocks):
            live = min(b, lb)
            if live < a:
                continue
            want = bt.round_plain(g, media9, live, rays5, keys, state, "full", K, 12)
            ctrl = pc.new_ctrl("cuda")
            ctrl[pc.CTRL_LIVE] = live
            got = bt.run_round(g, media9, None, rays5, keys.clone(), state.clone(), "full", K,
                               12, ctrl=ctrl, group=G)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                fail(f"K5 with the control block differs from its plain version (rung G={G}, "
                     f"{live} live blocks)")
            copies = [(keys.clone(), state.clone()) for _ in range(50)]
            cuda_time(lambda i: bt.run_round(g, media9, None, rays5, *copies[i], "full", K, 12,
                                             ctrl=ctrl, group=G), 3)
            ms_ctrl = cuda_time(lambda i: bt.run_round(
                g, media9, None, rays5, *copies[3 + i], "full", K, 12, ctrl=ctrl, group=G), 20)
            ms_host = cuda_time(lambda i: bt.run_round(
                g, media9, live, rays5, *copies[25 + i], "full", K, 12), 20)
            row = {"rung": [a, b], "G": G, "S": split_of(G)[1], "live_blocks": live,
                   "grid_blocks": min(b, n_blocks), "ctrl_ms": ms_ctrl, "host_ms": ms_host}
            out["K5"].append(row)
            print(f"   K5 with the control block, rung G={G} S={row['S']} (live blocks {a}-{b}, "
                  f"grid {row['grid_blocks']} blocks), {live} live blocks: bit-equal to plain; "
                  f"{ms_ctrl:.5f} ms a launch beside the host-int launch's {ms_host:.5f} ms",
                  flush=True)
        ctrl = pc.new_ctrl("cuda")
        k0, s0 = keys.clone(), state.clone()
        got = bt.run_round(g, media9, None, rays5, k0, s0, "full", K, 12, ctrl=ctrl,
                           group=bt.round_ladder(n_blocks)[0][2])
        torch.cuda.synchronize()
        if not (torch.equal(k0, keys) and torch.equal(s0, state) and int(got[2].sum()) == 0):
            fail("K5 with 0 live blocks in the control block changed a lane")
        # K6
        o, d, eff = sets["nee"]
        rays = rays6(o, d)
        lkeys, _ = bt.listing_plain(g, rays, eff, fresh_tlo(eff), PAIR_LIST)
        pair_rays, cid, _ = ps.expand_pairs(lkeys, rays, eff, 8)
        P = cid.shape[0]
        pairs = int((cid < bt.BIGC).sum())
        want = ps.sweep_plain(g, media9, pair_rays, cid, "nee", K)
        for a, b, G in ps.sweep_ladder(P):
            count = pairs if a <= pairs <= b else min(b, P)
            ctrl = pc.new_ctrl("cuda")
            ctrl[pc.CTRL_NALIVE] = count
            got = ps.sweep(g, media9, pair_rays, cid, "nee", K, ctrl=ctrl, group=G)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K6 with the control block differs from its plain version (rung G={G}, "
                     f"count {count})")
            ms_ctrl = cuda_time(lambda i: ps.sweep(g, media9, pair_rays, cid, "nee", K,
                                                   ctrl=ctrl, group=G), 20)
            row = {"rung": [a, b], "G": G, "count": count, "real": count == pairs,
                   "grid_pairs": max(bt.BLOCK, -(-min(b, P) // bt.BLOCK) * bt.BLOCK),
                   "ctrl_ms": ms_ctrl, "host_ms": None}
            if count == pairs:
                row["host_ms"] = cuda_time(lambda i: ps.sweep(g, media9, pair_rays, cid, "nee",
                                                              K, pairs), 20)
            out["K6"].append(row)
            print(f"   K6 with the control block, rung G={G} (pairs {a}-{b}, grid {row['grid_pairs']}"
                  f" pairs), count {count}" + (" (the sweep's own)" if row["real"] else "")
                  + f": bit-equal to plain; {ms_ctrl:.5f} ms a launch" + (
                      f" beside the host-int launch's {row['host_ms']:.5f} ms"
                      if row["host_ms"] is not None else ""), flush=True)
        seeds = ps.seed_state_bits(pair_rays, "nee", K)
        hs = ps.sweep(g, media9, pair_rays, cid, "nee", K, 0)
        torch.cuda.synchronize()
        if not torch.equal(hs, seeds):
            fail("K6 with 0 pairs did not keep every pair's seed state")
    return out


ENGINE_GRAPH_SIZE = (128, 128, 4)  # the engines' graph-against-eager renders
ENGINE_GRAPH_TILED = (64, 64, 2)  # binned on the many-cluster scene
ENGINE_GRAPH_BVH = (64, 64, 2)  # wavefront on the BVH (the plain walk)


def counted_all(fn):
    """(result, seconds, launch counts: the wrappers' and those counted on
    the card) of ``fn()``, the counts left as they were."""
    with uncounted():
        reset_launch_counts()
        out, dt = timed_render(fn)
        return out, dt, launch_counts()


def engine_graph_against_eager(label, fn_eager, fn_graph, used=()):
    """The graph executor's result bit-equal to the eager executor's, with
    the same K1, K3, K4, K5 and K6 launches (eager: the wrappers' counts;
    graph: those counted on the card by a replay after the capturing
    call), each kernel of ``used`` launched; returns (eager s, graph s,
    captures, capture s, counts)."""
    import torch

    from complex_materials_renderer_tpu_torch.render import megarender as mr

    eager, t_eager, n_eager = counted_all(fn_eager)
    n_cap = len(mr.captures)
    _, t_first, _ = counted_all(fn_graph)
    caps = len(mr.captures) - n_cap
    cap_s = sum(c.seconds for c in mr.captures[n_cap:])
    graph, t_graph, n_graph = counted_all(fn_graph)
    eager = eager if isinstance(eager, tuple) else (eager,)
    graph = graph if isinstance(graph, tuple) else (graph,)
    equal = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                for a, b in zip(eager, graph))
    kinds = ("K1", "K3", "K4", "K5", "K6")
    print(f"   {label}: graph bit-equal to eager {equal}; launches eager "
          f"{[n_eager[k] for k in kinds]}, graph (on the card) {[n_graph[k] for k in kinds]} "
          f"(K1, K3, K4, K5, K6); eager {t_eager:.4f} s, graph {t_graph:.4f} s (first call "
          f"{t_first:.4f} s, {caps} captures {cap_s:.4f} s)", flush=True)
    if not equal:
        fail(f"{label}: the graph executor differs from the eager executor")
    if any(n_graph[k] != n_eager[k] for k in kinds) or any(n_graph[k] <= 0 for k in used):
        fail(f"{label}: the graph's launches differ from the eager executor's, or a kernel of "
             f"{used} was launched no time")
    return {"eager_s": t_eager, "graph_s": t_graph, "captures": caps, "capture_s": cap_s,
            "counts": {k: n_graph[k] for k in kinds}}


def engine_cases():
    """(label, options, kernels it launches) of the wavefront-style
    engines' graph comparison: wavefront on the clusters, binned and pair
    on showcase at ENGINE_GRAPH_SIZE, wavefront on the BVH (the plain
    PyTorch walk: no kernel of the port, and slow, so at
    ENGINE_GRAPH_BVH), and binned on the many-cluster scene."""
    w, h, spp = ENGINE_GRAPH_SIZE
    bw, bh, bspp = ENGINE_GRAPH_BVH
    tw, th, tspp = ENGINE_GRAPH_TILED
    return [
        (f"wavefront showcase {w}x{h}@{spp}",
         showcase_options(w, h, spp, engine="wavefront", backend="cluster"), ("K3",)),
        (f"wavefront bvh showcase {bw}x{bh}@{bspp}",
         showcase_options(bw, bh, bspp, engine="wavefront", backend="bvh"), ()),
        (f"binned showcase {w}x{h}@{spp}", showcase_options(w, h, spp, engine="binned"),
         ("K4", "K5")),
        (f"pair showcase {w}x{h}@{spp}", showcase_options(w, h, spp, engine="pair"),
         ("K3", "K4", "K6")),
        (f"binned tiled {TILES}x{TILES} {tw}x{th}@{tspp}",
         tiled_options(tw, th, tspp, engine="binned"), ("K4", "K5")),
    ]


def engine_graph_phase(profile):
    """The wavefront, binned and pair engines as device programs: for each
    case of ``engine_cases`` the Renderer's image on the graph executor
    (the default on the card) bit-equal to the eager executor's with equal
    launch counts; for binned and pair also a direct call in the static
    phase schedule; one call of each case under
    torch.cuda.set_sync_debug_mode('error'); with ``profile`` the busy
    share of one 65,536-lane pass of each engine on both executors."""
    import torch

    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    out = {}
    for label, (scene, opt), used in engine_cases():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = Renderer(scene, opt)

        def eager(r=r):
            with executor_as("eager"):
                return torch.from_numpy(r.render())

        out[label] = engine_graph_against_eager(label, eager,
                                                lambda r=r: torch.from_numpy(r.render()), used)
        if opt.engine in ("binned", "pair") and "tiled" not in label:
            args = (r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, opt.height), 2)
            kw = dict(trace_engine=opt.engine, schedule_mode="off", return_rng=True,
                      max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                      nee_max_media=opt.nee_max_media)
            out[label + " off"] = engine_graph_against_eager(
                f"{opt.engine} {opt.width}x{opt.height}@2, render_beauty_mega, static phases",
                lambda: mr.render_beauty_mega(*args, executor="eager", **kw),
                lambda: mr.render_beauty_mega(*args, **kw), used)
        # One call under sync-debug 'error': the Renderer's band call, its
        # graph captured above.
        fn = r._beauty_fn()
        call = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                    nee_max_media=opt.nee_max_media, rng_mode=opt.rng,
                    full_resolution=(opt.width, opt.height), return_rng=True)
        args = (r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, opt.height),
                opt.num_samples)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want, _ = fn(*args, **call)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img, _ = fn(*args, **call)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        same = torch.equal(img, want)
        print(f"   {label}: torch.cuda.set_sync_debug_mode('error') around one call of the "
              f"Renderer's tile function: no synchronising operation; the image its replay's "
              f"{same}", flush=True)
        if not same:
            fail(f"{label}: a replay differs from the call before it")
    if profile:
        rp = Renderer(*showcase_options(512, 512, 16))
        out["profile"] = {engine: busy_share(rp, engine) for engine in ("wavefront", "binned",
                                                                         "pair")}
    return out


def busy_share(r, engine, reps=3):
    """The card's busy share of one 65,536-lane pass of ``engine`` (512 x
    128 lanes, ENGINE_SPP samples) on both executors: the eager pass under
    torch.profiler (its kernels' device ms over its wall), and the graph
    pass's host-clock wall (the median of ``reps`` replays after the call
    that captures it) beside the same kernels' device ms. The profiler's
    trace of a graph misses kernels in nested conditional bodies (its count
    is printed beside the eager one), so the graph's share is the eager
    pass's kernel time over the graph pass's wall: both executors launch
    the same kernels on the same data (equal counts, bit-equal images)."""
    from functools import partial

    import torch

    from complex_materials_renderer_tpu_torch.render.integrator import render_beauty
    from complex_materials_renderer_tpu_torch.render.megarender import render_beauty_mega

    eager = profile_pass(r, engine, "eager", spp=ENGINE_SPP)
    opt = r.options
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
              rng_mode=opt.rng, full_resolution=(opt.width, opt.height))
    fn = render_beauty
    if engine != "wavefront":
        fn, kw["trace_engine"] = render_beauty_mega, engine
    call = partial(fn, r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, 128),
                   ENGINE_SPP, **kw)
    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[len(walls) // 2]
    share = eager["busy_ms"] / wall
    print(f"   {engine} pass (65536 lanes x {ENGINE_SPP} spp) on the graph: wall "
          f"{', '.join(f'{w:.2f}' for w in walls)} ms (median {wall:.2f}); the eager pass's "
          f"kernels {eager['busy_ms']:.2f} ms over it: busy share {share:.3f} (eager "
          f"{eager['busy_share']:.3f})", flush=True)
    return {"eager": eager, "graph_wall_ms": walls, "graph_busy_share": share}


ADAPTIVE_CHECK = 120  # side of the frame at which render_samples_mega is held bit-equal
ADAPTIVE_WAVE = 10240  # its wave in the several-wave case: 28,800 lanes in three waves
ADAPTIVE_MEAN_TOL = 0.02  # the adaptive image mean against the uniform one's, relative
SHARDS = 4  # logical shards of the sharding phase's mesh on cuda:0
PASS_WIDTHS = (1 << 16, 1 << 17, 1 << 18)  # lanes a pass timed by --tables


def adaptive_lanes_check(main_opts):
    """render_samples_mega at exactly the uniform (pixel, sample) pairs of
    showcase ADAPTIVE_CHECK^2 at 2 spp, averaged per pixel, against
    render_beauty_mega of the same render: bit-equal, on each engine of
    the mega family, in counter and ld, in one wave and in waves of
    ADAPTIVE_WAVE lanes (the last one padded). Each call's launches are
    counted from 0; the engine's kernels must have run."""
    import torch

    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    n = ADAPTIVE_CHECK
    r = Renderer(scene, dataclasses.replace(opt, width=n, height=n))
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pix = torch.from_numpy(np.repeat(np.stack([xs.reshape(-1), ys.reshape(-1)], -1), 2, axis=0))
    sidx = torch.from_numpy(np.tile(np.arange(2), n * n))
    val = torch.ones(2 * n * n, dtype=torch.bool)
    need = {"mega": ("K1",), "binned": ("K4", "K5"), "pair": ("K3", "K4", "K6")}
    for engine, kernels in need.items():
        for rng in ("counter", "ld"):
            kw = dict(rng_mode=rng, trace_engine=engine, max_depth=opt.max_depth,
                      rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media)
            with uncounted():
                img = mr.render_beauty_mega(*objs, (n, n), 2, **kw).cpu().numpy()
            for wave in (1 << 16, ADAPTIVE_WAVE):
                with uncounted():
                    reset_launch_counts()
                    rad = mr.render_samples_mega(*objs, pix, sidx, val, (n, n),
                                                 chunk_lanes=wave, **kw)
                    torch.cuda.synchronize()
                    counts = launch_counts()
                per_px = rad.cpu().numpy().reshape(n * n, 2, 3).mean(1).reshape(n, n, 3)
                equal = bool(np.array_equal(per_px, img))
                waves = -(-2 * n * n // min(wave, 2 * n * n))
                print(f"   render_samples_mega {engine}, {rng}, showcase {n}x{n}@2 at the "
                      f"uniform pairs, {waves} wave(s): per-pixel mean bit-equal to "
                      f"render_beauty_mega {equal}; launches "
                      + ", ".join(f"{k} {counts[k]}" for k in kernels), flush=True)
                if not equal:
                    fail(f"render_samples_mega ({engine}, {rng}, {waves} waves) differs from "
                         "the uniform render")
                for k in kernels:
                    if counts[k] <= 0:
                        fail(f"render_samples_mega ({engine}) launched {k} no time")


def adaptive_path(main_opts):
    """The adaptive render of showcase at the main path's size and budget,
    counter RNG, the default engine: timed after a small warm-up, with
    K1's launches counted from 0, the rounds and the per-pixel counts;
    the budget must be exact, the image finite and its mean within
    ADAPTIVE_MEAN_TOL of the uniform counter render's."""
    import torch

    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = main_opts
    opt = dataclasses.replace(opt, spp_mode="adaptive", rng="counter")
    r = Renderer(scene, opt)
    t0 = time.perf_counter()
    with uncounted():
        Renderer(scene, dataclasses.replace(opt, width=64, height=64, num_samples=2)).render()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rounds = []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render_adaptive(snapshot_cb=lambda avg, f: rounds.append(avg))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()["K1"]
    counts = r.sample_counts
    paths = opt.width * opt.height * opt.num_samples
    with uncounted():
        uniform = Renderer(scene, dataclasses.replace(opt, spp_mode="uniform")).render()
    mean, umean = float(np.mean(img)), float(np.mean(uniform))
    print(f"   showcase {opt.width}x{opt.height}@{opt.num_samples} adaptive, counter: warm-up "
          f"(64x64@2) {warm:.3f} s, timed {dt:.3f} s = {paths / dt / 1e6:.4f} Mpaths/s; K1 "
          f"launches {launches}; rounds {len(rounds)} (average spp after each: "
          f"{', '.join(f'{a:.3f}' for a in rounds)}); samples {int(counts.sum())} of {paths}, "
          f"per pixel min {int(counts.min())}, max {int(counts.max())}; image mean {mean:.6f} "
          f"against the uniform counter render's {umean:.6f} (limit "
          f"{ADAPTIVE_MEAN_TOL:.0%})", flush=True)
    if launches <= 0:
        fail("the adaptive path launched the megakernel no time")
    if int(counts.sum()) != paths or int(counts.min()) < 1:
        fail("the adaptive render did not spend exactly its budget over every pixel")
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        fail("adaptive image is not finite or has the wrong shape")
    if abs(mean - umean) > ADAPTIVE_MEAN_TOL * abs(umean):
        fail("the adaptive image mean differs from the uniform one by more than "
             f"{ADAPTIVE_MEAN_TOL:.0%}")
    return paths / dt / 1e6


def timed_render(fn):
    """(result, seconds) of ``fn()`` between two device synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sync_all() -> None:
    """Wait for the work queued on every card."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def no_sync_call(fn):
    """(result, seconds) of ``fn()`` under ``torch.cuda.set_sync_debug_mode
    ("error")``, where every synchronising operation raises; every card is
    synchronised before and after, outside it."""
    import torch

    sync_all()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_all()
    return out, time.perf_counter() - t0


def captures_by_card(since: int) -> dict:
    """{card: graphs captured} since ``megarender.captures[since]``."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    out: dict = {}
    for c in mr.captures[since:]:
        out[str(c.device)] = out.get(str(c.device), 0) + 1
    return out


def sharding_path(r):
    """render_beauty_sharded over SHARDS logical shards on cuda:0, the
    megakernel per shard: SHARDS tiles in parity bit-equal to the single
    render of the frame, 2 x (SHARDS / 2) in counter within atol 1e-6, each
    warmed up at the timed shape through the same tables and then timed
    with no capture and under sync-debug 'error', beside its single render,
    with K1's launches counted from 0; then render_multihost in a
    one-process NCCL world (a file store) equal to render_beauty_sharded on
    the same mesh."""
    import tempfile

    import torch
    import torch.distributed as dist

    from complex_materials_renderer_tpu_torch.parallel import multihost
    from complex_materials_renderer_tpu_torch.parallel.sharding import (
        make_render_mesh,
        render_beauty_sharded,
    )
    from complex_materials_renderer_tpu_torch.render import megarender as mr

    opt = r.options
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media)
    res, spp = (opt.width, opt.height), 4
    dev = torch.device("cuda", 0)
    cases = (("parity", 1), ("counter", 2))
    for rng, sp in cases:
        mesh = make_render_mesh([dev] * SHARDS, sample_parallel=sp)

        def sharded():
            return render_beauty_sharded(*objs, res, spp, rng_mode=rng, mesh=mesh, engine="mega",
                                         **kw)

        with uncounted():
            sharded()  # warm-up: the timed call's shapes, through the same tables
            ref, t_single = timed_render(lambda: mr.render_beauty_mega(
                *objs, res, spp, rng_mode=rng, **kw))
        reset_launch_counts()
        n_cap = len(mr.captures)
        img, t_sharded = no_sync_call(sharded)
        caps = captures_by_card(n_cap)
        launches = launch_counts()["K1"]
        a, b = img.cpu().numpy(), ref.cpu().numpy()
        err = float(np.abs(a - b).max())
        ok = err == 0.0 if rng == "parity" else err <= 1e-6
        print(f"   sharded mega, showcase {res[0]}x{res[1]}@{spp} {rng}, mesh {mesh.shape} on "
              f"cuda:0: {t_sharded:.3f} s (single render {t_single:.3f} s) after a warm-up at "
              f"its shape, under sync-debug 'error' (no synchronising operation); captures "
              f"{caps or 0}; K1 launches {launches}; worst difference from the single render "
              f"{err:.3e} (limit {'0, bit-equal' if rng == 'parity' else '1e-6'})", flush=True)
        if launches <= 0:
            fail("the sharded path launched the megakernel no time")
        if caps:
            fail(f"the sharded call after its warm-up captured graphs: {caps}")
        if a.shape != (res[1], res[0], 3) or not np.isfinite(a).all() or not ok:
            fail(f"the sharded render ({rng}) differs from the single render")

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one process: loopback only
    mesh_devices = [dev] * SHARDS
    with tempfile.TemporaryDirectory() as tmp:
        multihost.init_distributed("file://" + os.path.join(tmp, "store"), 1, 0)
        try:
            backend = multihost.group_backend("cuda")
            reset_launch_counts()
            img, dt = timed_render(lambda: multihost.render_multihost(
                *objs, res, spp, sample_parallel=2, devices=mesh_devices, rng_mode="counter",
                engine="mega", **kw))
            launches = launch_counts()["K1"]
        finally:
            dist.destroy_process_group()
    with uncounted():
        ref = render_beauty_sharded(*objs, res, spp, rng_mode="counter", engine="mega",
                                    mesh=make_render_mesh(mesh_devices, 2), **kw).cpu().numpy()
    equal = bool(np.array_equal(img, ref))
    print(f"   render_multihost, one-process world (file store; cuda tensors over {backend}), "
          f"{SHARDS} shards on "
          f"cuda:0, 2 x {SHARDS // 2}, counter: {dt:.3f} s; K1 launches {launches}; equal to "
          f"render_beauty_sharded {equal}. NCCL across several cards is checked by --cards "
          "on a host with several: this run has one card", flush=True)
    if backend != "nccl" or launches <= 0 or not equal:
        fail("render_multihost in a one-process NCCL world differs from render_beauty_sharded")
    return t_sharded


CARDS_SPP = 16  # samples of --cards' Renderer renders
CARDS_MULTIHOST_SPP = 4  # samples of its two-process render
CONFIG5_SPP = 1024  # BASELINE config 5: showcase 1920x1080 at 1024 spp, tiles over the cards


CLI_SIZE = ("512", "512", "16")  # the main path's width, height and samples per pixel
# sha256 (first 16 hex digits) of the six arrays (bmin, bmax, left, count,
# miss, tri_order) of the JAX package's native build_bvh over the tiled
# scenes (leaf_size 4), built with its committed native/cmr_native.so: the
# port's C++ builder must give this tree on any host and compiler.
JAX_NATIVE_TREES = {(TILES, TILES): "7bfa35dbc9acc5dc", (4, 4): "086c846bb94ec6e9"}


def cpu_model() -> str:
    """The host CPU's model from /proc/cpuinfo: its model name, or, where
    the kernel reports that as unknown, vendor, family and model number."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            if not ln.strip():
                break  # the first processor's block
            key, _, value = ln.partition(":")
            fields[key.strip()] = value.strip()
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} (model name unknown), {fields.get('cpu MHz', '?')} MHz")


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cli_phases(stdout: str) -> dict:
    """{phase: ms} of the ``PhaseTimer`` reports that ``cli.main`` prints."""
    import re

    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\w+) time: ([\d.]+) ms$", stdout, re.M)}


def cli_path(mega_img, mega_launches):
    """Phase 5e: ``cli.main`` on showcase 512x512 @ 16 spp, the default
    engine, in this process (K1's launches counted from 0, the rendered
    image recorded) and then as ``python -m`` in a fresh process with the
    host library and with ``CMR_NO_NATIVE=1``, in turns; the phase tables
    side by side, the .hdr files byte-equal, and the image the main path's."""
    import contextlib
    import io
    import tempfile

    from complex_materials_renderer_tpu_torch import cli
    from complex_materials_renderer_tpu_torch.io import read_hdr
    from complex_materials_renderer_tpu_torch.io.hdr import float_to_rgbe, rgbe_to_float
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()[:16]

    obj = os.path.join(REPO, "scenes", "showcase.obj")
    w, h, spp = CLI_SIZE
    argv = [obj, "--width", w, "--height", h, "-s", spp]
    runs, files = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        images = []
        render = Renderer.render

        def recorded(self, *a, **kw):
            images.append(render(self, *a, **kw))
            return images[-1]

        Renderer.render = recorded
        out = io.StringIO()
        reset_launch_counts()
        try:
            with contextlib.redirect_stdout(out):
                (rc, wall) = timed_render(lambda: cli.main(argv + ["-o", os.path.join(tmp, "in")]))
        finally:
            Renderer.render = render
        launches = launch_counts()["K1"]
        if rc != 0:
            fail(f"cli.main returned {rc}")
        runs["in process"] = {**cli_phases(out.getvalue()), "wall": wall * 1e3}
        files["in process"] = os.path.join(tmp, "in.hdr")
        env = {k: v for k, v in os.environ.items() if k != "CMR_NO_NATIVE"}
        # In turns (native, Python, Python, native): one run each is noise.
        for label, extra in (("native", {}), ("CMR_NO_NATIVE=1", {"CMR_NO_NATIVE": "1"}),
                             ("CMR_NO_NATIVE=1 (2)", {"CMR_NO_NATIVE": "1"}),
                             ("native (2)", {})):
            path = os.path.join(tmp, f"run{len(files)}")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", PACKAGE, *argv, "-o", path], cwd=REPO,
                                  env={**env, **extra}, capture_output=True, text=True,
                                  timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"python -m {PACKAGE} ({label}) exited {proc.returncode}:\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            runs[label] = {**cli_phases(proc.stdout), "wall": wall * 1e3}
            files[label] = path + ".hdr"
        data = {k: file_bytes(p) for k, p in files.items()}
        decoded = {k: read_hdr(p) for k, p in files.items()}
    # The host library's share of a fresh process's scene_load: the
    # compiler's --version for the library's digest, then its load.
    proc = subprocess.run([sys.executable, "-c", LIBRARY_LOAD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"loading the host library in a fresh process failed:\n{proc.stderr[-4000:]}")
    load_ms = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"   the host library in a fresh process: digest (the compiler's --version) "
          f"{load_ms['digest']:.1f} ms, load {load_ms['load']:.1f} ms", flush=True)
    names = ["scene_load", "accel_build", "upload", "render", "write", "wall"]
    print("   phase (ms)      " + "".join(f"{k:>21}" for k in runs), flush=True)
    for n in names:
        print(f"   {n:<15} " + "".join(f"{runs[k].get(n, float('nan')):>21.1f}" for k in runs),
              flush=True)
    print("   (wall: cli.main in this process, warm; the others a fresh interpreter's whole "
          "command, interpreter start and CUDA context included)", flush=True)
    if len(images) != 1:
        fail(f"cli.main rendered {len(images)} images, expected 1")
    img = images[0]
    ref_rgbe = rgbe_to_float(float_to_rgbe(mega_img))
    print(f"   K1 launches {launches}; image sha256 {sha(img)} (main path {sha(mega_img)}); "
          f".hdr sizes {[len(v) for v in data.values()]}; decoded sha256 "
          f"{[sha(v) for v in decoded.values()]} (main path's image encoded {sha(ref_rgbe)})",
          flush=True)
    if launches != mega_launches:
        fail(f"cli.main launched K1 {launches} times, the main path {mega_launches}")
    if sha(img) != sha(mega_img):
        fail("cli.main rendered another image than the main path")
    if len(set(data.values())) != 1:
        fail("the .hdr files of the CLI runs differ")
    if any(sha(v) != sha(ref_rgbe) for v in decoded.values()):
        fail("the decoded .hdr is not the main path's image encoded")
    return {**runs, "library in a fresh process": load_ms}, launches


LIBRARY_LOAD = """
import json, time
from complex_materials_renderer_tpu_torch import native
t0 = time.perf_counter()
native._lib_path(native.compiler())
t1 = time.perf_counter()
native.load()
t2 = time.perf_counter()
print(json.dumps({"digest": (t1 - t0) * 1e3, "load": (t2 - t1) * 1e3}))
"""


def host_io_times():
    """ms of ``parse_obj`` on a generated 256 x 256 heightfield (131,072
    triangles) and of ``write_hdr`` at 1920x1080, each through the host
    library and through its Python path (``CMR_NO_NATIVE``), in turns
    (native, Python, Python, native); the outputs must be equal."""
    import tempfile

    from complex_materials_renderer_tpu_torch.io import write_hdr
    from complex_materials_renderer_tpu_torch.scene.obj import parse_obj

    n = 256
    x, z = np.meshgrid(np.linspace(-4.0, 4.0, n + 1), np.linspace(-4.0, 4.0, n + 1))
    verts = np.stack([x, 0.3 * np.sin(3.0 * x) * np.cos(2.0 * z), z], -1).reshape(-1, 3)
    i = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None]).ravel() + 1
    faces = np.stack([i, i + 1, i + n + 2, i, i + n + 2, i + n + 1], -1).reshape(-1, 3)
    image = np.random.default_rng(3).lognormal(0.0, 2.0, (1080, 1920, 3)).astype(np.float32)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "heightfield.obj")
        with open(obj, "w") as f:
            f.write("".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in verts))
            f.write("".join(f"f {a} {b} {c}\n" for a, b, c in faces))
        for step in ("parse_obj, 131,072 triangles", "write_hdr, 1920x1080"):
            times = {"native": [], "python": []}
            results = []
            for k, side in enumerate(("native", "python", "python", "native")):
                if side == "python":
                    os.environ["CMR_NO_NATIVE"] = "1"
                try:
                    t0 = time.perf_counter()
                    if step.startswith("parse"):
                        results.append(parse_obj(obj))
                    else:
                        write_hdr(os.path.join(tmp, f"{k}.hdr"), image)
                    times[side].append((time.perf_counter() - t0) * 1e3)
                finally:
                    os.environ.pop("CMR_NO_NATIVE", None)
            if results:
                same = all(all(np.array_equal(a, b) for a, b in zip(results[0][:3], r[:3]))
                           and results[0][3] == r[3] for r in results[1:])
            else:
                same = len({file_bytes(os.path.join(tmp, f"{k}.hdr"))
                            for k in range(4)}) == 1
            print(f"   {step}: native {', '.join(f'{t:.1f}' for t in times['native'])} ms; "
                  f"Python {', '.join(f'{t:.1f}' for t in times['python'])} ms (in turns: "
                  f"native, Python, Python, native); outputs equal {same}", flush=True)
            if not same:
                fail(f"{step}: the host library and the Python path differ")
            out[step] = times
    return out


def check_tree(flat, num_tris: int, leaf_size: int, label: str) -> None:
    """A threaded BVH's invariants: ``tri_order`` a permutation, leaves of
    at most ``leaf_size`` triangles covering each triangle once, the root's
    miss link -1, every box with bmin <= bmax."""
    order = np.sort(flat.tri_order)
    leaves = flat.count > 0
    if not np.array_equal(order, np.arange(num_tris)):
        fail(f"{label}: tri_order is not a permutation")
    if flat.count.max() > leaf_size or int(flat.count[leaves].sum()) != num_tris:
        fail(f"{label}: a leaf holds more than {leaf_size} triangles, or the leaves miss some")
    if flat.miss[0] != -1:
        fail(f"{label}: the root's miss link is {flat.miss[0]}, not -1")
    if not (flat.bmin <= flat.bmax).all():
        fail(f"{label}: a node's bmin exceeds its bmax")


def bvh_host_path():
    """Phase 5e, the BVH: the host library's builder on the many-cluster
    scene and on its 4 x 4 tiling beside the numpy builder, the trees'
    invariants, and the BVH walk over both trees of the 4 x 4 tiling on
    65,536 camera rays (pixel centres, 256 x 256) equal in prim and t."""
    import torch

    from complex_materials_renderer_tpu_torch.accel.bvh import _build_bvh_python, build_bvh
    from complex_materials_renderer_tpu_torch.kernels import traverse
    from complex_materials_renderer_tpu_torch.ops.camera import generate_rays, make_camera

    def best(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, min(times)

    out = {}
    for tiles in ((TILES, TILES), (4, 4)):
        scene, opt = tiled_options(256, 256, 1, tiles)
        tris, leaf = scene.triangles, opt.leaf_size
        label = f"showcase tiled {tiles[0]} x {tiles[1]}"
        flat, native_s = best(lambda: build_bvh(tris, leaf), 3)
        check_tree(flat, tris.shape[0], leaf, label)
        digest = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                         for a in flat)).hexdigest()[:16]
        print(f"   {label}: the C++ tree's sha256 {digest} (the JAX package's native tree "
              f"{JAX_NATIVE_TREES[tiles]})", flush=True)
        if leaf != 4 or digest != JAX_NATIVE_TREES[tiles]:
            fail(f"{label}: the C++ tree is not the JAX package's native tree")
        row = {"triangles": int(tris.shape[0]), "nodes": int(flat.num_nodes),
               "native_ms": native_s * 1e3}
        if tiles == (4, 4):
            py, py_s = best(lambda: _build_bvh_python(tris, leaf), 1)
            check_tree(py, tris.shape[0], leaf, f"{label}, numpy")
            row["python_ms"] = py_s * 1e3
            cam = make_camera(opt.camera_pos, opt.camera_look_at, opt.camera_fov, device="cuda")
            ys, xs = torch.meshgrid(torch.arange(256, device="cuda"),
                                    torch.arange(256, device="cuda"), indexing="ij")
            pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
            o, d = generate_rays(cam, pix, torch.full((pix.shape[0], 2), 0.5, device="cuda"),
                                 (256, 256))
            o, d = o.contiguous(), d.contiguous()
            hits = [traverse.trace_closest(o, d, traverse.device_bvh(f, tris, leaf, "cuda"),
                                           1e-4, 1e4) for f in (flat, py)]
            n_hit = int((hits[0].prim >= 0).sum())
            bad = int(((hits[0].prim != hits[1].prim) | (hits[0].t != hits[1].t)).sum())
            print(f"   {label}: the BVH walk over both trees, {o.shape[0]} camera rays, "
                  f"{n_hit} hits: {bad} lanes differ in prim or t", flush=True)
            if n_hit == 0 or bad:
                fail(f"{label}: the walks over the C++ and the numpy trees differ on {bad} "
                     f"lanes ({n_hit} hits)")
        print(f"   {label}, {row['triangles']} triangles, {row['nodes']} nodes: build_bvh "
              f"(C++) {row['native_ms']:.1f} ms"
              + (f", _build_bvh_python (numpy) {row['python_ms']:.1f} ms"
                 if "python_ms" in row else ""), flush=True)
        out[f"tiled_{tiles[0]}x{tiles[1]}"] = row
    return out


# The default workload (phase 5f): the reference's default command at its
# full size, and the hermetic acceptance scenes at their sizes (5g).
DEFAULT_SIZE = (1920, 1080, 256)  # config.py's width, height and samples per pixel
DEFAULT_COUNTED_SPP = 16  # samples of the in-process renders that count launches
DEFAULT_PIXELS = 256  # pixels recomputed on the card, every sample each
PLAIN_PIXELS = 64  # of them recomputed on the host CPU through the plain K1
PLAIN_WORKERS = 8  # processes of that recomputation (its cost follows the live lanes)
PIXEL_SEED = 10
RGBE_REL = 2.0 ** -8  # RGBE's quantisation, relative to a pixel's largest channel
CARD_STATE_EVERY = 64  # passes between the --default-ab run's card-state reads
CHECKPOINT_CHUNK = 8  # samples a pass of the checkpointed render: two passes a row block
CHECKPOINT_STOP = 15  # saves (passes) before it is stopped: in the middle of a row block
ACCEPTANCE = ("isobox", "gembox", "vessel")  # BASELINE configs 2-4
BENCH_SIZE = (256, 256, 8)  # bench.py's size of them: counter RNG, a warm and a timed render


class counted_calls:
    """Counts the calls of ``module.name`` (each with its keyword
    arguments) while the block runs: the passes of the single-device
    loop (``render_beauty_mega``). The sample steps are counted on the
    cards (``sample_steps``)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.calls.append(kw)
            return orig(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def memory_used_mib() -> int:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    return int(out.stdout.split()[0])


def default_command(tmp, sample_memory=True, name="default", args=(), env=None):
    """``python -m <package> -o <tmp>/<name>`` in a fresh process, the
    user's command with no other argument (or with ``args``; ``env``: more
    environment), with ``nvidia-smi`` sampling the first card's memory
    beside it unless ``sample_memory`` is false. Returns (its phases in ms
    with its wall time, the card's memory in use in MiB just before it and
    at its peak, the decoded image)."""
    from complex_materials_renderer_tpu_torch.io import read_hdr

    out = os.path.join(tmp, name)
    base = memory_used_mib()
    sampler = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
                                "--format=csv,noheader,nounits", "-lms", "250"],
                               stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                               text=True) if sample_memory else None
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", PACKAGE, *args, "-o", out], cwd=REPO,
                              capture_output=True, text=True, timeout=1000,
                              env={**os.environ, **(env or {})})
        wall = time.perf_counter() - t0
    finally:
        samples = ""
        if sampler is not None:
            sampler.terminate()
            samples = sampler.communicate(timeout=60)[0]
    if proc.returncode != 0:
        fail(f"python -m {PACKAGE} {' '.join(args)} -o {out} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    used = [int(x) for x in samples.split() if x.isdigit()]
    phases = {**cli_phases(proc.stdout), "wall": wall * 1e3}
    img = read_hdr(out + ".hdr")
    print("   " + "\n   ".join(proc.stdout.strip().splitlines()), flush=True)
    w, h, _ = DEFAULT_SIZE
    if img.shape != (h, w, 3) or not np.isfinite(img).all():
        fail(f"the default command wrote a {img.shape} image, or one not finite")
    return phases, (base, max(used + [base])), img


def row_blocks_check(r, rgbe):
    """The first, a middle and the last row block of the frame rendered
    again in this process as the single-device loop renders them (its
    tile renderer, the chunks in sample order with the parity state
    carried, the float32 weights); their RGBE encoding must equal the
    same rows of the command's .hdr byte for byte. Returns the peak of
    what they allocate on the device, in MiB."""
    import torch

    from complex_materials_renderer_tpu_torch.io.hdr import float_to_rgbe
    from complex_materials_renderer_tpu_torch.renderer import (
        _auto_row_chunk,
        _auto_sample_chunk,
    )

    opt = r.options
    rows, chunk = _auto_row_chunk(opt.width), _auto_sample_chunk(opt.width, opt.height)
    starts = list(range(0, opt.height, rows))
    beauty_fn = r._beauty_fn()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # this process's earlier tensors
    for row0 in (starts[0], starts[len(starts) // 2], starts[-1]):
        tile_h = min(rows, opt.height - row0)
        acc = np.zeros((tile_h, opt.width, 3), np.float32)
        rng_state, done = None, 0
        t0 = time.perf_counter()
        while done < opt.num_samples:
            n = min(chunk, opt.num_samples - done)
            img, rng_state = beauty_fn(
                r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, tile_h), n,
                max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                nee_max_media=opt.nee_max_media, rng_mode=opt.rng, row_offset=row0,
                full_resolution=(opt.width, opt.height), sample_offset=done,
                rng_state=rng_state, return_rng=True,
            )
            acc += img.cpu().numpy() * np.float32(n / opt.num_samples)
            done += n
        dt = time.perf_counter() - t0
        same = bool(np.array_equal(float_to_rgbe(acc), rgbe[row0:row0 + tile_h]))
        print(f"   row block {row0 // rows} (rows {row0}-{row0 + tile_h - 1}): {done // chunk} "
              f"passes of {chunk} samples in {dt:.3f} s; RGBE equal to the .hdr's rows "
              f"{same}", flush=True)
        if not same:
            fail(f"row block at row {row0} rendered in process differs from the .hdr")
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def check_pixel_list(width, height, rows):
    """DEFAULT_PIXELS (x, y) pixels spread over the frame: every row
    block's first and last row, every row of the last block, the partial
    tile rows (32 and 33) of every fourth 34-row block, then rows drawn
    from PIXEL_SEED; the columns drawn from it, the first two 0 and
    width - 1."""
    rs = np.random.default_rng(PIXEL_SEED)
    starts = list(range(0, height, rows))
    ys = [y for s in starts for y in (s, min(s + rows, height) - 1)]
    ys += list(range(starts[-1], height))
    ys += [s + k for s in starts[:-1:4] for k in (32, 33) if s + k < min(s + rows, height)]
    ys += rs.integers(0, height, DEFAULT_PIXELS - len(ys)).tolist()
    xs = rs.integers(0, width, DEFAULT_PIXELS)
    xs[:2] = (0, width - 1)
    return np.stack([xs, np.asarray(ys[:DEFAULT_PIXELS])], -1).astype(np.int64)


def pixel_values(r, pix):
    """Every sample of each pixel of ``pix`` through ``render_pixels_mega``
    on ``r``'s device, in the loop's chunks (the parity state carried,
    each chunk weighted as the loop weights it): (N, 3) float32."""
    import torch

    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import _auto_sample_chunk, _engine_knobs

    opt = r.options
    chunk = _auto_sample_chunk(opt.width, opt.height)
    acc = np.zeros((len(pix), 3), np.float32)
    rng_state, done = None, 0
    while done < opt.num_samples:
        n = min(chunk, opt.num_samples - done)
        img, rng_state = mr.render_pixels_mega(
            r.camera, r.scene_arrays, r.accel, r.lights, torch.from_numpy(pix), n,
            (opt.width, opt.height), max_depth=opt.max_depth, rr_depth=opt.rr_depth,
            nee_max_media=opt.nee_max_media, rng_state=rng_state, return_rng=True, tir=opt.tir,
            direct=opt.direct, **_engine_knobs("mega"))
        acc += img.cpu().numpy() * np.float32(n / opt.num_samples)
        done += n
    return acc


def plain_pixels_worker(pix, size):
    """One process of the host CPU's recomputation: ``pix`` through the
    plain K1 on a CPU renderer of showcase at ``size`` (width, height,
    samples), the default engine's path, one thread."""
    import torch

    from complex_materials_renderer_tpu_torch.renderer import Renderer

    torch.set_num_threads(1)
    r = Renderer(*showcase_options(*size, device="cpu", backend="cluster", engine="mega"))
    return pixel_values(r, pix)


def pixels_check(r, img, rgbe):
    """DEFAULT_PIXELS pixels recomputed on the card, every sample each,
    against the command's decoded .hdr (within RGBE's quantisation), and
    PLAIN_PIXELS of them through the plain K1 on the host CPU against the
    card's (the golden gate's rule)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from complex_materials_renderer_tpu_torch.io.hdr import float_to_rgbe
    from complex_materials_renderer_tpu_torch.renderer import _auto_row_chunk

    opt = r.options
    pix = check_pixel_list(opt.width, opt.height, _auto_row_chunk(opt.width))
    with uncounted():
        card, t_card = timed_render(lambda: pixel_values(r, pix))
    hdr = img[pix[:, 1], pix[:, 0]]
    scale = card.max(-1)
    rel = float((np.abs(hdr - card).max(-1) / np.maximum(scale, 1e-30)).max())
    same = int((float_to_rgbe(card) == rgbe[pix[:, 1], pix[:, 0]]).all(-1).sum())
    print(f"   {len(pix)} pixels ({len(set(pix[:, 1].tolist()))} rows) through "
          f"render_pixels_mega on the card, {opt.num_samples} samples each, in {t_card:.3f} s: "
          f"RGBE bytes equal to the .hdr's on {same} of {len(pix)} (the gate); largest "
          f"error against the decoded .hdr {rel:.3e} of the pixel's largest channel (RGBE's "
          f"quantisation 2^-8 = {RGBE_REL:.3e})", flush=True)
    if not np.isfinite(card).all() or same != len(pix):
        fail("pixels recomputed on the card are not the .hdr's RGBE bytes")

    sub = pix[::len(pix) // PLAIN_PIXELS][:PLAIN_PIXELS]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as ex:
        size = (opt.width, opt.height, opt.num_samples)
        plain = np.concatenate(list(ex.map(plain_pixels_worker,
                                           np.array_split(sub, PLAIN_WORKERS),
                                           [size] * PLAIN_WORKERS)))
    t_plain = time.perf_counter() - t0
    ref = card[::len(pix) // PLAIN_PIXELS][:PLAIN_PIXELS]
    nonflip, flips = flip_gate(plain[:, None], ref[:, None])
    budget = max(1, int(WAVEFRONT_FLIP_FRAC * PLAIN_PIXELS))
    print(f"   {PLAIN_PIXELS} of them through the plain K1 on the host CPU ({PLAIN_WORKERS} "
          f"processes, {cpu_model()}), {opt.num_samples} samples each, in {t_plain:.1f} s: "
          f"against the card's non-flip RMSE {nonflip:.3e} (limit 1e-3), flip pixels {flips} "
          f"(budget {budget}), largest difference {float(np.abs(plain - ref).max()):.3e}",
          flush=True)
    if not (nonflip <= 1e-3 and flips <= budget):
        fail("the plain K1's pixels differ from the card's beyond the golden gate's rule")
    return {"card_s": t_card, "plain_s": t_plain, "rgbe_rel": rel, "rgbe_equal": same,
            "plain_nonflip_rmse": nonflip, "plain_flips": flips}


def counted_render(scene, opt):
    """The default workload at DEFAULT_COUNTED_SPP samples in this process
    with every launch count set to 0 just before: (image, seconds, the
    loop's calls, K1 launches, sample steps)."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    r = Renderer(scene, dataclasses.replace(opt, num_samples=DEFAULT_COUNTED_SPP))
    reset_launch_counts()
    steps = sample_steps()
    with counted_calls(mr, "render_beauty_mega") as passes:
        img, dt = timed_render(r.render)
    return img, dt, passes.calls, launch_counts()["K1"], sample_steps() - steps


def checkpoint_check(scene, opt, blocks, tmp):
    """The DEFAULT_COUNTED_SPP render at CHECKPOINT_CHUNK samples a pass
    with a checkpoint, stopped by its save hook after CHECKPOINT_STOP saves
    (in the middle of a row block, so the resume starts from the saved RNG
    state), then resumed by a new Renderer through the passes left:
    bit-equal to the uninterrupted render at the same options, the file
    gone."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    class Stopped(Exception):
        pass

    opt = dataclasses.replace(opt, num_samples=DEFAULT_COUNTED_SPP,
                              sample_chunk=CHECKPOINT_CHUNK)
    resumed_passes = blocks * (DEFAULT_COUNTED_SPP // CHECKPOINT_CHUNK) - CHECKPOINT_STOP
    with uncounted():
        want = Renderer(scene, opt).render()
    path = os.path.join(tmp, "default.ckpt.npz")
    first = Renderer(scene, opt)
    saves = []
    save = first._save_checkpoint

    def stopping_save(*a):
        save(*a)
        saves.append(dict(a[4]))  # done_rows
        if len(saves) == CHECKPOINT_STOP:
            raise Stopped

    first._save_checkpoint = stopping_save
    try:
        with uncounted():
            first.render(checkpoint_path=path)
    except Stopped:
        pass
    else:
        fail("the checkpointed render was not stopped by its save hook")
    if not os.path.exists(path):
        fail("no checkpoint file after the stop")
    with uncounted(), counted_calls(mr, "render_beauty_mega") as passes:
        img, dt = timed_render(lambda: Renderer(scene, opt).render(checkpoint_path=path))
    equal = bool(np.array_equal(img, want))
    gone = not os.path.exists(path)
    done = saves[-1]
    full_blocks = sum(d == opt.num_samples for d in done.values())
    partial = {row: d for row, d in done.items() if d < opt.num_samples}
    print(f"   --checkpoint at {opt.width}x{opt.height}@{opt.num_samples}, {opt.sample_chunk} "
          f"samples a pass: stopped after {len(saves)} saves ({full_blocks} row blocks done, "
          f"samples done in the next {partial}), resumed by a new Renderer "
          f"in {dt:.3f} s through {len(passes.calls)} passes (the rest: {resumed_passes}); "
          f"bit-equal to the uninterrupted render {equal}; checkpoint removed {gone}",
          flush=True)
    if len(passes.calls) != resumed_passes:
        fail(f"the resumed render made {len(passes.calls)} passes, not the {resumed_passes} "
             "left after the stop")
    if not partial:
        fail("the checkpointed render was not stopped in the middle of a row block")
    if not (equal and gone):
        fail("the resumed render differs from the uninterrupted one, or left its checkpoint")


def card_state():
    """The first card's SM clock, power draw and temperature (one
    ``nvidia-smi`` query)."""
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def default_ab(smi):
    """``--default-ab``: the default command without and with the memory
    sampler in turns (twice each), then the same render in this process
    (no sampler) with every pass timed and the card's clock, power and
    temperature read every CARD_STATE_EVERY passes: where the command's
    render phase loses to the 16-spp in-process render."""
    import tempfile

    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer, _auto_sample_chunk

    w, h, spp = DEFAULT_SIZE
    paths = w * h * spp
    with tempfile.TemporaryDirectory() as tmp:
        for sampled in (False, True, False, True):
            phases, (base, peak), _ = default_command(tmp, sample_memory=sampled)
            print(f"   python -m {PACKAGE}, sampler {'on' if sampled else 'off'}: render "
                  f"{phases['render'] / 1e3:.3f} s = {paths / phases['render'] * 1e3 / 1e6:.4f} "
                  f"Mpaths/s; wall {phases['wall'] / 1e3:.3f} s"
                  + (f"; card memory {base} -> {peak} MiB" if sampled else ""), flush=True)
    scene, opt = showcase_options(w, h, spp)
    r = Renderer(scene, opt)
    stamps, states = [], []
    with counted_calls(mr, "render_beauty_mega") as passes:
        orig = mr.render_beauty_mega

        def stamped(*a, **kw):
            if len(stamps) % CARD_STATE_EVERY == 0:
                states.append(card_state())
            stamps.append(time.perf_counter())
            return orig(*a, **kw)
        mr.render_beauty_mega = stamped
        img, dt = timed_render(r.render)
    stamps.append(time.perf_counter())
    ms = np.diff(stamps) * 1e3
    per = spp // _auto_sample_chunk(w, h)
    blocks = ms.reshape(-1, per).sum(1) if ms.size % per == 0 else ms
    print(f"   in process, sampler off: {dt:.3f} s = {paths / dt / 1e6:.4f} Mpaths/s over "
          f"{len(passes.calls)} passes; a pass {np.median(ms):.2f} ms median, first block "
          f"{blocks[0]:.1f} ms, blocks 1-{len(blocks) - 1} {blocks[1:].min():.1f}-"
          f"{blocks[1:].max():.1f} ms, "
          f"first half {ms[:ms.size // 2].sum() / 1e3:.3f} s, second half "
          f"{ms[ms.size // 2:].sum() / 1e3:.3f} s; image mean {float(img.mean()):.6f} ({smi}; "
          f"host CPU {cpu_model()})", flush=True)
    print(f"   card state (SM clock, power draw, temperature) every {CARD_STATE_EVERY} passes: "
          + " | ".join(states), flush=True)


def default_workload(smi):
    """Phase 5f: the default command at its full size, its pixels checked
    three ways, its launches against the schedule, and --checkpoint."""
    import tempfile

    import torch

    from complex_materials_renderer_tpu_torch.io.hdr import float_to_rgbe
    from complex_materials_renderer_tpu_torch.renderer import (
        Renderer,
        _auto_row_chunk,
        _auto_sample_chunk,
    )

    w, h, spp = DEFAULT_SIZE
    rows, chunk = _auto_row_chunk(w), _auto_sample_chunk(w, h)
    blocks = -(-h // rows)
    paths = w * h * spp
    scene, opt = showcase_options(w, h, spp)
    print(f"   the schedule: {blocks} row blocks of {rows} rows (the last "
          f"{h - (blocks - 1) * rows}), {chunk} samples a pass: {blocks * (-(-spp // chunk))} "
          f"passes, {paths} paths", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        phases, (mem_base, mem_peak), img = default_command(tmp)
        mem_mib = mem_peak - mem_base
        render_s = phases["render"] / 1e3
        print(f"   python -m {PACKAGE} (showcase {w}x{h}@{spp}, parity, depth {opt.max_depth}, "
              f"defaults): render {render_s:.3f} s = {paths / render_s / 1e6:.4f} Mpaths/s; "
              f"wall {phases['wall'] / 1e3:.3f} s; card memory in use (nvidia-smi, sampled "
              f"every 250 ms) {mem_base} MiB before it, {mem_peak} MiB at its peak: "
              f"{mem_mib} MiB taken; image mean {float(img.mean()):.6f} ({smi}; host CPU "
              f"{cpu_model()})", flush=True)
        rgbe = float_to_rgbe(img)
        r = Renderer(scene, opt)
        peak_mib = row_blocks_check(r, rgbe)
        print(f"   peak device allocation of those row blocks "
              f"(torch.cuda.max_memory_allocated above what this process held before) "
              f"{peak_mib:.1f} MiB", flush=True)
        pixels = pixels_check(r, img, rgbe)

        small, dt, calls, launches, steps = counted_render(scene, opt)
        want_passes = blocks * (-(-DEFAULT_COUNTED_SPP // chunk))
        print(f"   in process at {DEFAULT_COUNTED_SPP} spp (launch counts set to 0 just "
              f"before): {dt:.3f} s = {w * h * DEFAULT_COUNTED_SPP / dt / 1e6:.4f} Mpaths/s; "
              f"passes {len(calls)} (the schedule's {want_passes}), rows "
              f"{sorted({c.get('row_offset') for c in calls})[:3]}...; sample steps {steps}; "
              f"K1 launches {launches} ({launches / max(steps, 1):.2f} a sample step); at "
              f"{spp} spp the schedule runs {spp // DEFAULT_COUNTED_SPP} times the passes",
              flush=True)
        if len(calls) != want_passes or launches <= 0:
            fail(f"the {DEFAULT_COUNTED_SPP}-spp render made {len(calls)} passes and "
                 f"{launches} K1 launches; the schedule has {want_passes} passes")
        if small.shape != (h, w, 3) or not np.isfinite(small).all():
            fail("the in-process render is not finite or has the wrong shape")
        checkpoint_check(scene, opt, blocks, tmp)
    return {"card": smi, "cpu": cpu_model(), "render_s": render_s,
            "mpaths_s": paths / render_s / 1e6, "cli_ms": phases, "card_memory_mib": mem_mib,
            "card_memory_before_mib": mem_base,
            "peak_allocated_mib": peak_mib, "passes": blocks * (-(-spp // chunk)),
            "counted_spp": DEFAULT_COUNTED_SPP, "counted_passes": len(calls),
            "counted_steps": steps, "k1_launches": launches, "counted_s": dt, **pixels}


def acceptance_scenes(smi):
    """Phase 5g: BASELINE configs 2-4 through the default engine: their
    goldens at 64x64@2 under the flip gate, then each (and showcase) at
    bench.py's size, counter RNG, one warm and one timed render with K1's
    launches and sample steps counted from 0."""
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    for name in ACCEPTANCE:
        golden_gate(name=name, golden=name, size=64, spp=2)
    w, h, spp = BENCH_SIZE
    out = {}
    for name in ("showcase",) + ACCEPTANCE:
        scene, opt = showcase_options(w, h, spp, obj=name, rng="counter", shard="none")
        r = Renderer(scene, opt)
        with uncounted():
            r.render()  # warm-up
        reset_launch_counts()
        steps = sample_steps()
        img, dt = timed_render(r.render)
        launches = launch_counts()["K1"]
        n = sample_steps() - steps
        print(f"   {name} {w}x{h}@{spp} counter ({r.accel.num_clusters} clusters): {dt:.4f} s = "
              f"{w * h * spp / dt / 1e6:.4f} Mpaths/s; K1 launches {launches} over {n} sample "
              f"steps ({launches / max(n, 1):.2f} a step); image mean {float(np.mean(img)):.6f} "
              f"({smi})", flush=True)
        if launches <= 0 or not np.isfinite(img).all():
            fail(f"{name} at {w}x{h}@{spp} launched K1 no time or is not finite")
        out[name] = {"s": dt, "mpaths_s": w * h * spp / dt / 1e6, "k1_launches": launches,
                     "steps": n}
    return out


class card_timeline:
    """Times, on the cards, every shard call that ``sharding.dispatch_cells``
    queues while the block runs: a CUDA event before and after each call
    on its card's current stream, grouped by band (a ``dispatch_cells``
    call), and the host time each band takes to queue."""

    def __enter__(self):
        import torch

        from complex_materials_renderer_tpu_torch.parallel import sharding

        self.sharding, self.bands, self.queue_s = sharding, [], []
        self.real_fn, self.real_dispatch = sharding._beauty_fn, sharding.dispatch_cells

        def beauty_fn(engine):
            beauty = self.real_fn(engine)

            def timed(*a, **k):
                card = torch.cuda.current_device()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = beauty(*a, **k)
                end.record()
                self.bands[-1].append((card, start, end))
                return out

            return timed

        def dispatch(*a, **k):
            self.bands.append([])
            t0 = time.perf_counter()
            out = self.real_dispatch(*a, **k)
            self.queue_s.append(time.perf_counter() - t0)
            return out

        sharding._beauty_fn, sharding.dispatch_cells = beauty_fn, dispatch
        return self

    def __exit__(self, *exc):
        self.sharding._beauty_fn, self.sharding.dispatch_cells = self.real_fn, self.real_dispatch
        return False

    def report(self, label: str) -> dict:
        """Print and return, per card, its busy ms in each band and in all,
        and its wait for the band's slowest card (the band's busiest card's
        ms less its own), with the host's queueing ms a band."""
        sync_all()
        busy = []
        for band in self.bands:
            per: dict = {}
            for card, start, end in band:
                per[card] = per.get(card, 0.0) + start.elapsed_time(end)
            busy.append(per)
        cards = sorted({c for per in busy for c in per})
        total = {c: sum(per.get(c, 0.0) for per in busy) for c in cards}
        wait = {c: sum(max(per.values()) - per.get(c, 0.0) for per in busy) for c in cards}
        slowest = sum(max(per.values()) for per in busy)
        print(f"   {label}: {len(busy)} bands; per card, busy ms in all "
              + ", ".join(f"cuda:{c} {total[c]:.1f}" for c in cards)
              + "; waiting for the band's slowest card "
              + ", ".join(f"cuda:{c} {wait[c]:.1f}" for c in cards)
              + f"; the slowest cards' ms summed over the bands {slowest:.1f} against a mean "
              f"card's {np.mean(list(total.values())):.1f} (busy share "
              f"{np.mean(list(total.values())) / slowest:.4f}); host ms to queue a band "
              f"{1e3 * min(self.queue_s):.2f}-{1e3 * max(self.queue_s):.2f}", flush=True)
        for i, per in enumerate(busy):
            print(f"     band {i}: " + ", ".join(f"cuda:{c} {per[c]:.1f} ms" for c in sorted(per)),
                  flush=True)
        return {"bands": [{str(c): per[c] for c in sorted(per)} for per in busy],
                "busy_ms": {str(c): total[c] for c in cards},
                "wait_ms": {str(c): wait[c] for c in cards}, "slowest_ms": slowest,
                "queue_ms": [1e3 * q for q in self.queue_s]}


def cards_renders(scene, opt, n, problems, timeline=False):
    """``--shard auto`` over the ``n`` cards against ``--shard none`` on
    cuda:0, the same options: each Renderer warmed up by a render at the
    timed shapes, then timed; the sharded render must capture nothing and
    equal the single one bit for bit (with ``timeline``, its shard calls
    timed on the cards)."""
    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    single_r = Renderer(scene, dataclasses.replace(opt, shard="none"))
    sharded_r = Renderer(scene, dataclasses.replace(opt, shard="auto"))
    if len(sharded_r._shard_devices()) != n:
        fail(f"--shard auto spreads over {len(sharded_r._shard_devices())} devices, not the "
             f"{n} cards")
    label = f"showcase {opt.width}x{opt.height}@{opt.num_samples} {opt.rng}"
    paths = opt.width * opt.height * opt.num_samples
    n_cap = len(mr.captures)
    with uncounted():
        (_, t_warm_single), (_, t_warm) = (timed_render(single_r.render),
                                           timed_render(sharded_r.render))  # warm-ups
        warm_caps = captures_by_card(n_cap)
        single, t_single = timed_render(single_r.render)
    reset_launch_counts()
    n_cap = len(mr.captures)
    with card_timeline() as tl:
        sharded, t_sharded = timed_render(sharded_r.render)
    caps = captures_by_card(n_cap)
    launches = launch_counts()["K1"]
    err = float(np.abs(sharded - single).max())
    print(f"   Renderer {label}: --shard auto over {n} cards {t_sharded:.4f} s = "
          f"{paths / t_sharded / 1e6:.4f} Mpaths/s; --shard none on cuda:0 {t_single:.4f} s = "
          f"{paths / t_single / 1e6:.4f} Mpaths/s ({t_single / t_sharded:.4f}x); warm-ups "
          f"{t_warm:.3f} s and {t_warm_single:.3f} s (captures {warm_caps}); captures in the "
          f"timed sharded render {caps or 0}; K1 launches (sharded) {launches}; worst "
          f"difference {err:.3e} (limit 0, bit-equal)", flush=True)
    out = {"sharded_s": t_sharded, "single_s": t_single,
           "sharded_mpaths_s": paths / t_sharded / 1e6, "single_mpaths_s": paths / t_single / 1e6,
           "captures": caps, "k1_launches": launches, "max_abs_err": err}
    if timeline:
        out["timeline"] = tl.report(f"{label}, the timed sharded render")
    if launches <= 0:
        problems.append(f"the sharded Renderer ({label}) launched the megakernel no time")
    if caps:
        problems.append(f"the sharded Renderer ({label}) captured graphs after its warm-up: "
                        f"{caps}")
    if sharded.shape != single.shape or not np.isfinite(sharded).all() or err:
        problems.append(f"--shard auto over {n} cards ({label}) differs from --shard none")
    return out


def cards_band_no_sync(scene, opt, n, problems):
    """One band over every card (the sharded Renderer's call at showcase
    512x512, one band: ``render_beauty_sharded``, its dispatch and combine)
    replayed under sync-debug 'error' after a warm-up: no capture, no
    synchronising operation, the image the warm-up's."""
    import torch

    from complex_materials_renderer_tpu_torch.parallel.sharding import (
        make_render_mesh,
        render_beauty_sharded,
    )
    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    r = Renderer(scene, opt)
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    mesh = make_render_mesh()

    def band():
        return render_beauty_sharded(*objs, (opt.width, opt.height), opt.num_samples,
                                     max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                                     nee_max_media=opt.nee_max_media, rng_mode=opt.rng,
                                     mesh=mesh, full_resolution=(opt.width, opt.height),
                                     engine="mega", direct=opt.direct)

    with uncounted():
        want = band().cpu()
        n_cap = len(mr.captures)
        try:
            img, dt = no_sync_call(band)
        except RuntimeError as e:
            problems.append(f"the band over every card synchronised: {e}")
            return
    caps = captures_by_card(n_cap)
    same = bool(torch.equal(img.cpu(), want))
    print(f"   one band over the {n} cards (showcase {opt.width}x{opt.height}@"
          f"{opt.num_samples} {opt.rng}, render_beauty_sharded, mesh {mesh.shape}) under "
          f"torch.cuda.set_sync_debug_mode('error'): no synchronising operation from the first "
          f"card's first launch to the combined image ({dt:.4f} s); captures {caps or 0}; the "
          f"image the warm-up's {same}", flush=True)
    if caps or not same:
        problems.append("the band over every card captured graphs or differs from its warm-up")


def sharded_blocks_check(opt, rgbe, blocks, n):
    """Row blocks of a sharded render (band start, tile) computed again on
    cuda:0 as the shard computes them (``render_beauty_mega``, every sample
    in one call, the band loop's weight): RGBE byte-equal to the .hdr's
    rows. Returns the list of blocks that differ."""
    from complex_materials_renderer_tpu_torch.io.hdr import float_to_rgbe
    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    r = Renderer(*showcase_options(opt.width, opt.height, opt.num_samples))
    rows = -(-band_rows(opt.width, opt.height, n) // n)
    bad = []
    for row0, t in blocks:
        first = row0 + t * rows
        t0 = time.perf_counter()
        img = mr.render_beauty_mega(
            r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, rows), opt.num_samples,
            max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
            rng_mode="parity", row_offset=first, full_resolution=(opt.width, opt.height),
            direct=opt.direct)
        acc = img.cpu().numpy() * (opt.num_samples / opt.num_samples)
        same = bool(np.array_equal(float_to_rgbe(acc), rgbe[first:first + rows]))
        print(f"   rows {first}-{first + rows - 1} (band at row {row0}, card {t}'s tile) "
              f"computed again on cuda:0 at {opt.num_samples} spp in {time.perf_counter() - t0:.3f}"
              f" s: RGBE equal to the sharded .hdr's rows {same}", flush=True)
        if not same:
            bad.append((row0, t))
    return bad


def band_rows(width, height, n):
    """The sharded band loop's band height over ``n`` cards (renderer.py's
    ``_render_sharded``)."""
    from complex_materials_renderer_tpu_torch import renderer

    return min(max(1, (renderer.LANES_PER_PASS * n) // width), height)


def cards_commands(n, problems):
    """The default command in fresh processes: on one card
    (``CUDA_VISIBLE_DEVICES=0``), on two (where there are more) and on the
    ``n`` cards (``--shard auto``, its default), their render rates; one
    row block of each card's tiles of the sharded .hdr computed again on
    cuda:0, RGBE byte-equal; each image within one RGBE step of the
    one-card image (their sums differ in order: the one-card loop chunks
    the samples, the band loop takes them in one call). Then
    BASELINE config 5 (showcase 1920x1080 at CONFIG5_SPP, parity, tiles
    over the cards: ``-s 1024``) on the ``n`` cards, two row blocks of each
    card's tiles checked so."""
    import tempfile

    from complex_materials_renderer_tpu_torch.io.hdr import float_to_rgbe

    w, h, spp = DEFAULT_SIZE
    scene, opt = showcase_options(w, h, spp)
    band = band_rows(w, h, n)
    bands = list(range(0, h, band))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        half = [("2 cards", {"CUDA_VISIBLE_DEVICES": "0,1"})] if n > 2 else []
        for name, env in [("one card", {"CUDA_VISIBLE_DEVICES": "0"})] + half + [
                (f"{n} cards", {})]:
            phases, (base, peak), img = default_command(tmp, name=name.replace(" ", "_"),
                                                        env=env)
            render_s = phases["render"] / 1e3
            runs[name] = (render_s, img)
            print(f"   python -m {PACKAGE} -o <name> on {name} (showcase {w}x{h}@{spp}, parity, "
                  f"depth {opt.max_depth}): render {render_s:.3f} s = "
                  f"{w * h * spp / render_s / 1e6:.4f} Mpaths/s; wall "
                  f"{phases['wall'] / 1e3:.3f} s; cuda:0 memory {base} -> {peak} MiB", flush=True)
            out[name] = {"render_s": render_s, "mpaths_s": w * h * spp / render_s / 1e6,
                         "cli_ms": phases}
        t1, one = runs["one card"]
        # One step of an RGBE pixel is 1/m of its largest channel, m its
        # mantissa (128-255): at most 2^-7.
        one_step = 2 * RGBE_REL
        for name, (t, img) in runs.items():
            if name == "one card":
                continue
            step = np.abs(one - img).max(axis=-1) / np.maximum(
                np.maximum(one.max(axis=-1), img.max(axis=-1)), 1e-30)
            same = float(np.mean(float_to_rgbe(one) == float_to_rgbe(img)))
            print(f"   {name} {t1 / t:.4f}x one card's rate; against the one-card image: "
                  f"largest difference {float(np.abs(one - img).max()):.3e}, at most "
                  f"{float(step.max()):.3e} of a pixel's largest channel (one RGBE step: at "
                  f"most {one_step:.3e}); RGBE bytes equal on {same:.6f} of them", flush=True)
            out[name]["speedup"] = t1 / t
            if float(step.max()) > one_step:
                problems.append(f"the default command on {name} differs from one card's by "
                                "more than one RGBE step")
        rgbe = float_to_rgbe(runs[f"{n} cards"][1])
        if sharded_blocks_check(opt, rgbe, [(bands[3], t) for t in range(n)], n):
            problems.append("a row block of the sharded default command differs from its "
                            "recomputation on cuda:0")

        spp5 = CONFIG5_SPP
        phases, (base, peak), img = default_command(tmp, name="config5", args=("-s", str(spp5)))
        render_s = phases["render"] / 1e3
        paths = w * h * spp5
        print(f"   BASELINE config 5, python -m {PACKAGE} -s {spp5} -o <name> on {n} cards "
              f"(showcase {w}x{h}@{spp5}, parity, tiles over the cards, {paths} paths): render "
              f"{render_s:.3f} s = {paths / render_s / 1e6:.4f} Mpaths/s "
              f"({paths / render_s / 1e6 / out['one card']['mpaths_s']:.4f}x the one-card "
              f"default command's rate); wall {phases['wall'] / 1e3:.3f} s; cuda:0 memory "
              f"{base} -> {peak} MiB; image mean {float(img.mean()):.6f}", flush=True)
        out["config5"] = {"render_s": render_s, "mpaths_s": paths / render_s / 1e6,
                          "cli_ms": phases}
        blocks = [(bands[b], t) for b in (0, len(bands) // 2) for t in range(n)]
        opt5 = dataclasses.replace(opt, num_samples=spp5)
        if sharded_blocks_check(opt5, float_to_rgbe(img), blocks, n):
            problems.append("a row block of BASELINE config 5 differs from its recomputation "
                            "on cuda:0")
    return out


def cards_path():
    """--cards: the sharded Renderer over every card against one card, a
    band under sync-debug 'error', the default command and BASELINE config
    5 in fresh processes, and a two-process NCCL render_multihost (see the
    module's docstring). Every check runs; the failures are reported at
    the end."""
    import tempfile

    import torch

    from complex_materials_renderer_tpu_torch.parallel.sharding import (
        make_render_mesh,
        render_beauty_sharded,
    )
    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        fail(f"--cards needs an even number of cards, at least 2; {n} visible")
    print(f"   host CPU {cpu_model()}, {os.cpu_count()} cores", flush=True)
    problems: list = []
    summary = {"cards": nvidia_smi_line(every=True), "cpu": cpu_model()}
    scene, opt = showcase_options(512, 512, CARDS_SPP)
    for rng in ("parity", "counter"):
        summary[f"512 {rng}"] = cards_renders(scene, dataclasses.replace(opt, rng=rng), n,
                                              problems)
    cards_band_no_sync(scene, opt, n, problems)

    w, h, spp = DEFAULT_SIZE
    scene_d, opt_d = showcase_options(w, h, CARDS_SPP, rng="counter")
    summary["1080 counter"] = cards_renders(scene_d, opt_d, n, problems, timeline=True)
    # The default command's bands in this process, each card's calls timed.
    scene_p, opt_p = showcase_options(w, h, spp)
    r = Renderer(scene_p, dataclasses.replace(opt_p, shard="auto"))
    n_cap = len(mr.captures)
    with uncounted(), card_timeline() as tl:
        _, dt = timed_render(r.render)
    caps = captures_by_card(n_cap)
    print(f"   Renderer showcase {w}x{h}@{spp} parity (the default command's bands) in this "
          f"process over {n} cards: {dt:.3f} s = {w * h * spp / dt / 1e6:.4f} Mpaths/s, its "
          f"first render (captures {caps})", flush=True)
    summary["default bands"] = tl.report(f"showcase {w}x{h}@{spp} parity")
    summary["default bands"]["render_s"] = dt
    summary.update(cards_commands(n, problems))

    r = Renderer(scene, dataclasses.replace(opt, num_samples=CARDS_MULTIHOST_SPP, rng="counter"))
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
              rng_mode="counter", engine="mega")
    res = (opt.width, opt.height)
    mesh = make_render_mesh([torch.device("cuda", i) for i in range(n)], 2)
    with uncounted():
        render_beauty_sharded(*objs, res, CARDS_MULTIHOST_SPP, mesh=mesh, **kw)  # warm-up
        ref, t_ref = timed_render(lambda: render_beauty_sharded(
            *objs, res, CARDS_MULTIHOST_SPP, mesh=mesh, **kw))
    ref = ref.cpu().numpy()
    print(f"   render_beauty_sharded over the {n} cards, mesh {mesh.shape}, counter "
          f"{res[0]}x{res[1]}@{CARDS_MULTIHOST_SPP}: {t_ref:.4f} s", flush=True)
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the processes share one host
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{i}.npy") for i in range(2)]
        store = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cards-worker",
                                   str(i), store, outs[i]], env=env, cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for i in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for i, (p, log) in enumerate(zip(procs, logs)):
            for line in log.strip().splitlines()[-12:]:
                print(f"   [rank {i}] {line}", flush=True)
            if p.returncode != 0:
                problems.append(f"the render_multihost process of rank {i} exited "
                                f"{p.returncode}")
        imgs = [np.load(o) for o in outs if os.path.exists(o)]
    equal = [bool(np.array_equal(img, ref)) for img in imgs]
    print(f"   two-process NCCL render_multihost, {n // 2} cards a process, 2 x {n // 2}: "
          f"each rank's image equal to render_beauty_sharded over the same cards {equal}",
          flush=True)
    if len(equal) != 2 or not all(equal):
        problems.append("the two-process render_multihost differs from render_beauty_sharded")
    print(json.dumps({"cards": summary}), flush=True)
    if problems:
        fail("; ".join(problems))


def cards_worker(rank: int, store: str, out: str) -> int:
    """One process of --cards' two-process render: half the cards, the
    group joined through ``store``, the image saved to ``out``."""
    import torch
    import torch.distributed as dist

    from complex_materials_renderer_tpu_torch.parallel import multihost
    from complex_materials_renderer_tpu_torch.render import megarender as mr
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    half = torch.cuda.device_count() // 2
    devices = [torch.device("cuda", rank * half + i) for i in range(half)]
    scene, opt = showcase_options(512, 512, CARDS_MULTIHOST_SPP, rng="counter",
                                  device=str(devices[0]))
    r = Renderer(scene, opt)
    objs = (r.camera, r.scene_arrays, r.accel, r.lights)
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
              sample_parallel=2, devices=devices, rng_mode="counter", engine="mega")
    multihost.init_distributed(store, 2, rank)
    try:
        backend = multihost.group_backend("cuda")
        res = (opt.width, opt.height)
        multihost.render_multihost(*objs, res, CARDS_MULTIHOST_SPP, **kw)  # warm-up, same shape
        reset_launch_counts()
        n_cap = len(mr.captures)
        img, dt = timed_render(lambda: multihost.render_multihost(
            *objs, res, CARDS_MULTIHOST_SPP, **kw))
        caps = captures_by_card(n_cap)
        launches = launch_counts()["K1"]
    finally:
        dist.destroy_process_group()
    np.save(out, img)
    print(f"devices {[str(d) for d in devices]}, backend for cuda tensors {backend}: "
          f"{dt:.4f} s after a warm-up at its shape; captures {caps or 0}; K1 launches "
          f"{launches}", flush=True)
    return 0 if backend == "nccl" and launches > 0 and not caps else 1


def engines_times(reps=3):
    """--engines: showcase 512x512 through the default engine and the
    wavefront engine at 16 spp and the binned and pair engines at
    ENGINE_SPP, each through one Renderer: a warm-up render (which
    captures its graphs), then ``reps`` timed renders. It uses only what
    the port has had since every engine ran as a CUDA graph, so that two
    trees compare in one call (see the module's docstring)."""
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    scene, opt = showcase_options(512, 512, 16)
    for engine, spp in (("mega", 16), ("wavefront", 16), ("binned", ENGINE_SPP),
                        ("pair", ENGINE_SPP)):
        r = Renderer(scene, dataclasses.replace(opt, engine=engine, num_samples=spp))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, warm = timed_render(r.render)
            times = [timed_render(r.render)[1] for _ in range(reps)]
        paths = opt.width * opt.height * spp
        print(f"   {engine} showcase {opt.width}x{opt.height}@{spp} parity: warm-up {warm:.3f} s; "
              f"timed " + ", ".join(f"{t:.4f}" for t in times) + f" s = "
              + ", ".join(f"{paths / t / 1e6:.4f}" for t in times) + " Mpaths/s", flush=True)


def pass_width_table(main_opts, smi):
    """The main path timed at PASS_WIDTHS lanes a pass: the renderer's
    LANES_PER_PASS, which CMR_LANES_PER_PASS sets at import (a measurement,
    not a change of default)."""
    import torch

    from complex_materials_renderer_tpu_torch import renderer as rmod

    scene, opt = main_opts
    saved = rmod.LANES_PER_PASS
    paths = opt.width * opt.height * opt.num_samples
    try:
        for lanes in PASS_WIDTHS:
            rmod.LANES_PER_PASS = lanes
            r = rmod.Renderer(scene, opt)
            r.render()  # warm-up
            img, dt = timed_render(r.render)
            print(f"   main path at {lanes} lanes a pass ({rmod._auto_row_chunk(opt.width)} rows, "
                  f"{rmod._auto_sample_chunk(opt.width, opt.height)} samples a call): "
                  f"{dt:.3f} s = {paths / dt / 1e6:.4f} Mpaths/s; image mean "
                  f"{float(np.mean(img)):.6f} ({smi})", flush=True)
    finally:
        rmod.LANES_PER_PASS = saved


def real_slots(g):
    real, _ = grid_counts(g)
    return real


def k4_work(g, rays, bound, tlo, tlim, chunk=4096):
    """(box tests a floor, box tests of the one-thread walk, box tests of
    the tile walk with its culls left out) of a listing. Per listing lane,
    the floor tests the boxes of the clusters the lane meets whose key is at
    or below its final ``tlim`` (every exact listing must test them) and
    one super box for each super holding them; the one-thread walk (variant
    0) tests every super and every cluster of a super the lane meets; the
    tile walk tests every group box, every super of a group the lane meets
    and every cluster of a super it meets (its culls only remove tests)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct

    C, S, SF, GS = g.num_clusters, g.num_supers, g.super_factor, ct.LIST_SUPER_GROUP
    ids = torch.arange(C, dtype=torch.int32, device=rays.device)
    owner = (ids // SF).to(torch.int64)
    _, per_super = grid_counts(g)
    sb = g.super_bounds
    groups = torch.stack([torch.cat([sb[k:k + GS, 0:3].amin(0), sb[k:k + GS, 3:6].amax(0),
                                     sb[k, 6:8]]) for k in range(0, S, GS)])
    per_group = torch.tensor([min(GS, S - k) for k in range(0, S, GS)], dtype=torch.float64,
                             device=rays.device)
    live = (tlo != bt.EMPTY).nonzero().squeeze(1)
    floor = walk = tile = 0.0
    for lo in range(0, live.numel(), chunk):
        idx = live[lo:lo + chunk]
        O = tuple(rays[a, idx] for a in range(3))
        INV = tuple(bt._safe_inv(rays[3 + a, idx]) for a in range(3))
        _, hit_g = bt._entries(groups, O, INV, bound[idx])
        _, hit_s = bt._entries(sb, O, INV, bound[idx])
        tn, hit = bt._entries(g.bounds, O, INV, bound[idx])
        hit = hit & hit_s[:, owner]
        key = (tn.view(torch.int32) & ~bt.ID_MASK) | ids
        need = hit & (key <= tlim[idx, None])
        holders = torch.zeros((idx.numel(), S), dtype=torch.int32, device=rays.device)
        holders.index_add_(1, owner, need.to(torch.int32))
        floor += float(need.sum()) + float((holders > 0).sum())
        met = float((hit_s.double() @ per_super).sum())
        walk += idx.numel() * S + met
        tile += idx.numel() * groups.shape[0] + float((hit_g.double() @ per_group).sum()) + met
    return floor, walk, tile


def k4_bound(g, rays, bound, tlo, tlim, L):
    """(bound ms, bound by, (floor, one-thread walk, tile walk) box tests,
    bytes) of a listing: the larger of its bytes (each lane reads 8 words
    and writes L + 1; every box once) and the floor's box tests
    (``k4_work``) at SLAB_OPS each."""
    n = rays.shape[1]
    work = k4_work(g, rays, bound, tlo, tlim)
    nbytes = n * (8 + L + 1) * 4 + (g.num_clusters + g.num_supers) * 32
    b_ms, b_by = bound_of(nbytes, work[0] * SLAB_OPS)
    return b_ms, b_by, work, nbytes


def work_ms(tests):
    """Device ms of ``tests`` box tests at SLAB_OPS each at the card's f32
    rate."""
    return tests * SLAB_OPS / PEAK_F32_OPS * 1e3


def empty_ms(n, supers, L, reps=30):
    """Device ms of an empty kernel on the grid of the tile walk's launch
    over ``n`` lanes, launched and timed as the kernel is: the launch
    floor."""
    import ctypes

    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import build

    fn = build.listing_empty(L)
    span = bt.listing_span(n, supers)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731

    def launch(_i):
        err = fn(n, span, stream())
        if err:
            fail(f"the empty kernel did not launch: {build.error_string(err)}")

    cuda_time(launch, 3)
    return cuda_time(launch, reps)


def time_k4(g, label, rays, eff, tlo, L, reps=50):
    """K4 per launch on one input: the one-thread walk (variant 0, the
    kernel before the redesign) and the tile walk (G per CTA) in turns
    (old, new, new, old), the plain version, the empty launch, and the
    bound (``k4_bound``) beside both walks' work. Returns (ms, plain ms,
    bound ms, bound by) of the walk the rule launches (``listing_split``)."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    n = rays.shape[1]
    _, tlim = bt.listing_plain(g, rays, eff, tlo, L)
    b_ms, b_by, (floor, walk, tile), nbytes = k4_bound(g, rays, eff, tlo, tlim, L)
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        with k4_forced(ONE_THREAD if which == "old" else tile_split(g, n)):
            cuda_time(lambda i: bt.listing(g, rays, eff, tlo, L), 5)
            times[which].append(cuda_time(lambda i: bt.listing(g, rays, eff, tlo, L), reps))
    old, new = (sum(times[k]) / 2 for k in ("old", "new"))
    plain_ms = cuda_time(lambda i: bt.listing_plain(g, rays, eff, tlo, L), 3)
    floor_ms = empty_ms(n, g.num_supers, L)
    print(f"   K4 at {n} lanes ({label}, {int((tlo != bt.EMPTY).sum())} listing, L={L}; the "
          f"rule launches {bt.listing_split(n, g.num_supers)}): tile walk {tile_split(g, n)} "
          f"{times['new'][0]:.5f}, "
          f"{times['new'][1]:.5f} ms; one-thread walk {times['old'][0]:.5f}, "
          f"{times['old'][1]:.5f} ms (in turns: old, new, new, old); plain {plain_ms:.3f} ms; "
          f"empty launch {floor_ms:.5f} ms; floor {floor:.0f} box tests, one-thread walk's work "
          f"{walk:.0f} = {work_ms(walk):.5f} ms, tile walk's without its culls {tile:.0f} = "
          f"{work_ms(tile):.5f} ms; {nbytes} bytes; bound {b_ms:.5f} ms "
          f"({b_by}), tile walk at {b_ms / new:.4f} of it, one-thread walk at {b_ms / old:.4f}",
          flush=True)
    rule = new if bt.listing_split(n, g.num_supers)[0] == 1 else old
    return rule, plain_ms, b_ms, b_by


def time_k456(r, media9, sets, label="showcase"):
    """K4, K5 and K6 per launch at their widest launches on the engines'
    paths (65,536 lanes), each plain version on the same input, and the
    bounds from the work that input needs: K4 the listing of the binned
    closest trace (L = 8, primary rays, fresh; ``time_k4``), K5 that
    trace's first round, K6 the pair engine's NEE sweep (L = 4, shadow
    rays). Returns {kernel: (ms, plain ms, bound ms, bound by)}, K4's of
    the walk the rule launches."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct
    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    g = r.accel
    real = real_slots(g)
    run_bytes = g.run_rows.numel() * 4
    out = {}
    with uncounted():
        # K4
        o, d, eff = sets["full"]
        rays, tlo, L = rays6(o, d), fresh_tlo(eff), 8
        n = rays.shape[1]
        out["K4"] = time_k4(g, label, rays, eff, tlo, L)
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
        b_ms, b_by = bound_of(nbytes, holders * (ORIGIN_OPS + RAY_OPS))
        copies = [(keys.clone(), state.clone()) for _ in range(25)]
        launch = lambda i: bt.run_round(g, media9, lb, rays5, *copies[i], "full", K, 12)  # noqa: E731
        cuda_time(launch, 5)
        ms = cuda_time(lambda i: launch(5 + i), 20)
        plain_ms = cuda_time(lambda i: bt.round_plain(g, media9, lb, rays5, keys, state, "full", K,
                                                      12), 3)
        out["K5"] = (ms, plain_ms, b_ms, b_by)
        print(f"   K5 at {n} primary lanes ({label}, {lb} live blocks, G, S = "
              f"{bt.round_split(lb)}), first round of the closest trace: {ms:.4f} ms per launch; plain {plain_ms:.3f} ms; needed work "
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
        b_ms, b_by = bound_of(nbytes, pairs_work * (ORIGIN_OPS + RAY_OPS))
        pairs = int(valid.sum())
        cuda_time(lambda i: ps.sweep(g, media9, pair_rays, cid, "nee", K, pairs), 5)
        ms = cuda_time(lambda i: ps.sweep(g, media9, pair_rays, cid, "nee", K, pairs), 50)
        plain_ms = cuda_time(lambda i: ps.sweep_plain(g, media9, pair_rays, cid, "nee", K), 3)
        out["K6"] = (ms, plain_ms, b_ms, b_by)
        print(f"   K6 at {pairs} pairs of {n} shadow lanes ({label}, L={PAIR_LIST}, "
              f"G={ct.group_size(pairs)}), 'nee': "
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

    def rec(grid, media9, lb, rays, keys, state, payload, K, cap, **kw):
        calls.append((lb, rays.clone(), keys.clone(), state.clone(), payload, cap))
        return run(grid, media9, lb, rays, keys, state, payload, K, cap, **kw)

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


def recorded_listings(r, media9, sets, payload, list_len=8):
    """The input of every K4 launch of one binned trace of ``sets[payload]``
    ('full' bounded by the scene box, as the closest trace is): (rays,
    bound, t_lo), recorded before each launch."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    o, d, eff = sets[payload]
    sc = r.scene_arrays
    kw = {}
    if payload == "full":
        eff = torch.full((o.shape[0],), 1e4, device=o.device)
        kw = dict(world_lo=sc.world_lo, world_hi=sc.world_hi)
    calls = []
    run = bt.listing

    def rec(grid, rays, bound, tlo, L):
        calls.append((rays.clone(), bound.clone(), tlo.clone()))
        return run(grid, rays, bound, tlo, L)

    rec.launches = 0  # the wrapper counts its launches under its module name

    with uncounted(), forced(bt, "listing", rec):
        bt.trace_binned(r.accel, media9, o, d, eff, payload, list_len=list_len, **kw)
        torch.cuda.synchronize()
    return calls


def rule_groups(g, n, tlo):
    """What the rule launches: the one-thread walk, or the tile walk's G
    over its CTAs that hold a listing lane, as "G=4 x1020, G=32 x4"."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt
    from complex_materials_renderer_tpu_torch.kernels import cluster_test as ct

    if bt.listing_split(n, g.num_supers)[0] == 0:
        return "one-thread walk"
    span = bt.listing_span(n, g.num_supers)
    live = (tlo != bt.EMPTY).to(torch.int32)
    live = torch.cat([live, live.new_zeros((-n) % span)]).view(-1, span).sum(1)
    mix = {}
    for c in live[live > 0].tolist():
        gs = ct.listing_group(c, g.num_supers)
        mix[gs] = mix.get(gs, 0) + 1
    return ", ".join(f"G={gs} x{k}" for gs, k in sorted(mix.items()))


def k4_launch_table(r, media9, sets, label, reps=20):
    """K4 launch by launch over one binned closest trace ('full', primary
    rays) and one binned NEE trace ('nee', shadow rays), list 8: the
    generation (0 fresh, later ones relists), listing lanes, keys listed,
    lists full, what the rule launches (the one-thread walk, or the tile
    walk's G over its CTAs), device ms of the tile walk (G per CTA) and
    of the one-thread walk, the empty launch, the bound (the floor of
    ``k4_work``, or bytes) and the work of the one-thread walk and of the
    tile walk without its culls at SLAB_OPS a box; then the widest and the
    narrowest launch of each trace at every instance of ``k4_configs``.
    Returns (tile walk ms, one-thread walk ms, bound ms) over the closest
    trace."""
    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    g = r.accel
    L = 8
    total = None
    for payload in ("full", "nee"):
        calls = recorded_listings(r, media9, sets, payload, L)
        print(f"   K4 launches of one binned {payload} trace ({label}: {g.num_clusters} clusters, "
              f"{g.num_supers} supers; {sets[payload][0].shape[0]} lanes, list {L}):", flush=True)
        print("     gen  listing  keys listed  lists full  tile walk ms  one-thread ms  empty ms"
              "   bound ms  bound by  work ms: one-thread  tile (no culls)  share of bound  the "
              "rule launches", flush=True)
        sums = [0.0, 0.0, 0.0]
        with uncounted():
            for i, (rays, bnd, tlo) in enumerate(calls):
                n = rays.shape[1]
                keys, tlim = bt.listing_plain(g, rays, bnd, tlo, L)
                b_ms, b_by, (_, walk, tile), _ = k4_bound(g, rays, bnd, tlo, tlim, L)
                ms = {}
                for which, cfg in (("new", tile_split(g, n)), ("old", ONE_THREAD)):
                    with k4_forced(cfg):
                        launch = lambda _i: bt.listing(g, rays, bnd, tlo, L)  # noqa: E731
                        cuda_time(launch, 3)
                        ms[which] = cuda_time(launch, reps)
                e_ms = empty_ms(n, g.num_supers, L)
                sums = [sums[0] + ms["new"], sums[1] + ms["old"], sums[2] + b_ms]
                print(f"     {i:3d} {int((tlo != bt.EMPTY).sum()):8d} "
                      f"{int((keys != bt.EMPTY).sum()):12d} {int((tlim != bt.EMPTY).sum()):11d} "
                      f"{ms['new']:13.5f} {ms['old']:14.5f} {e_ms:9.5f} {b_ms:10.5f} {b_by:>9s} "
                      f"{work_ms(walk):19.5f} {work_ms(tile):16.5f} {b_ms / ms['new']:15.4f}  "
                      f"{rule_groups(g, n, tlo)}", flush=True)
        print(f"   K4 over the {payload} trace ({label}): {len(calls)} launches "
              f"({len(calls) - 1} relists), tile walk {sums[0]:.5f} ms, one-thread walk "
              f"{sums[1]:.5f} ms, bound {sums[2]:.5f} ms", flush=True)
        listing = [int((c[2] != bt.EMPTY).sum()) for c in calls]
        with uncounted():
            ends = {listing.index(min(listing)): "narrowest", listing.index(max(listing)): "widest"}
            for i, which in ends.items():
                rays, bnd, tlo = calls[i]
                times = []
                configs = k4_configs(rays.shape[1], g.num_supers)
                for _, cfg in configs:
                    with k4_forced(cfg):
                        launch = lambda _i: bt.listing(g, rays, bnd, tlo, L)  # noqa: E731
                        cuda_time(launch, 3)
                        times.append(cuda_time(launch, reps))
                print(f"   K4 {payload} trace ({label}), {which} launch ({listing[i]} listing "
                      f"lanes) by instance: " + ", ".join(
                          f"{c} {t:.5f} ms" for (c, _), t in zip(configs, times)), flush=True)
        total = total or tuple(sums)
    return total


def k4_few_supers(reps=50):
    """K4 on tilings of showcase of a few supers (FEW_TILES), where the
    rule's cut between the one-thread walk and the tile walk lies: on each,
    the two walks in turns (``time_k4``) on the fresh listing of the
    closest trace's 65,536 primary lanes and of the NEE trace's shadow
    rays, list 8, with what the rule launches."""
    with uncounted():
        for tiles in FEW_TILES:
            r, sets = tiled_scene(tiles)
            for payload in ("full", "nee"):
                o, d, eff = sets[payload]
                time_k4(r.accel, f"tiled {tiles[0]} x {tiles[1]}, {payload}", rays6(o, d), eff,
                        fresh_tlo(eff), 8, reps)


def tiled_path(r, media9, sets, list_len=8):
    """The many-cluster scene's binned traces as the binned engine makes
    them: a closest trace ('full', bounded by the scene box) of the primary
    rays and a NEE trace of the shadow rays, every launch count set to 0
    just before and read just after. Returns K4's launches; fails unless
    there were some and the rule launched the tile walk at each."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import binned_trace as bt

    variants = []
    rule = bt.listing_split

    def recorded(n, supers):
        split = rule(n, supers)
        variants.append(split[0])
        return split

    sc = r.scene_arrays
    reset_launch_counts()
    with forced(bt, "listing_split", recorded):
        for payload in ("full", "nee"):
            o, d, eff = sets[payload]
            kw = {}
            if payload == "full":
                eff = torch.full((o.shape[0],), 1e4, device=o.device)
                kw = dict(world_lo=sc.world_lo, world_hi=sc.world_hi)
            bt.trace_binned(r.accel, media9, o, d, eff, payload, list_len=list_len, **kw)
        torch.cuda.synchronize()
    counts = launch_counts()
    print(f"   many-cluster path (a binned closest and a binned NEE trace, list {list_len}): "
          f"launches {counts}; K4's walks by variant {sorted(set(variants))}", flush=True)
    if counts["K4"] < 1 or counts["K4"] != len(variants) or set(variants) != {1}:
        fail(f"the many-cluster traces should launch K4's tile walk: {counts}, {variants}")
    return counts["K4"]


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
    """The input of every K6 launch of one pair trace of ``sets[payload]``
    on the eager executor (host ints): (pair rays, cluster ids, payload,
    valid pairs)."""
    import torch

    from complex_materials_renderer_tpu_torch.kernels import pairsweep as ps

    o, d, eff = sets[payload]
    calls = []
    sweep = ps.sweep

    def rec(grid, media9, rays, cid, payload, K, pairs=None, **kw):
        if pairs:  # a sweep of no valid pair launches nothing
            calls.append((rays, cid, payload, pairs))
        return sweep(grid, media9, rays, cid, payload, K, pairs, **kw)

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


def profile_pass(r, engine, executor="auto", spp=None):
    """Optional: torch.profiler over one 65,536-lane pass through the
    ``engine``'s beauty function, of ``spp`` samples (default 16, and
    ENGINE_SPP for the binned and pair engines), on ``executor`` (after a
    call of the same shape, which captures its graph). Returns its wall
    and busy ms and the busy share."""
    import torch
    import torch.profiler as tp

    from complex_materials_renderer_tpu_torch.render.integrator import render_beauty
    from complex_materials_renderer_tpu_torch.render.megarender import render_beauty_mega

    opt = r.options
    kw = dict(max_depth=opt.max_depth, rr_depth=opt.rr_depth, nee_max_media=opt.nee_max_media,
              rng_mode=opt.rng, full_resolution=(opt.width, opt.height), executor=executor)
    fn = render_beauty if engine == "wavefront" else render_beauty_mega
    if engine in ("binned", "pair"):
        kw["trace_engine"] = engine
    spp = spp or (ENGINE_SPP if engine in ("binned", "pair") else 16)
    fn(r.camera, r.scene_arrays, r.accel, r.lights, (opt.width, 128), spp, **kw)
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
    name = "graph" if executor == "auto" else executor
    print(f"   profile of one {engine} pass (65536 lanes x {spp} spp, {name} executor): wall "
          f"{wall * 1e3:.2f} ms, device busy {busy:.2f} ms (busy share "
          f"{busy / (wall * 1e3):.3f}), {sum(e.count for e in rows)} kernel launches", flush=True)
    for e in sorted(rows, key=lambda e: -dev_ms(e))[:12]:
        print(f"     {dev_ms(e):10.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)
    # Each kernel of the port summed over its instances (G, S, payload).
    names = (("K1", "cmr::megakernel"), ("K3", "cmr::cluster_trace"), ("K4", "cmr::binned_listing"),
             ("K5", "cmr::binned_round"), ("K6", "cmr::pair_sweep"),
             ("PC", "cmr::pass_control"))
    sums = {k: [0.0, 0] for k, _ in names}
    for e in rows:
        for k, prefix in names:
            if prefix in e.key:
                sums[k][0] += dev_ms(e)
                sums[k][1] += e.count
    print("   the port's kernels in that pass: " + ", ".join(
        f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in sums.items() if n), flush=True)
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "busy_share": busy / (wall * 1e3),
            "kernels": {k: v for k, v in sums.items() if v[1]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="stop after the first kernel comparisons")
    ap.add_argument("--profile", action="store_true", help="add torch.profiler breakdowns")
    ap.add_argument("--tables", action="store_true",
                    help="only build, print the K1, K3, K4, K5 and K6 launch tables and time "
                    "the main path")
    ap.add_argument("--cards", action="store_true",
                    help="only build and drive the paths that need several cards")
    ap.add_argument("--workload", action="store_true",
                    help="only build and drive the default command at its full size and the "
                    "acceptance scenes")
    ap.add_argument("--default-ab", action="store_true",
                    help="only build, run the default command without and with the memory "
                    "sampler in turns, then in this process with every pass timed")
    ap.add_argument("--engines", action="store_true",
                    help="only build and time every engine's showcase render")
    ap.add_argument("--cards-worker", nargs=3, metavar=("RANK", "STORE", "OUT"),
                    help=argparse.SUPPRESS)
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
    if args.cards_worker:
        rank, store, out = args.cards_worker
        return cards_worker(int(rank), store, out)

    phase("device")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"   {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("build")
    from complex_materials_renderer_tpu_torch.kernels import build

    from complex_materials_renderer_tpu_torch.kernels import megakernel as mk

    from complex_materials_renderer_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_lib = pool.submit(native.load)  # beside the nvcc processes
        if args.cards:  # the default engine at the default --nee-bound: what --cards renders
            build.prebuild([4], verbose=True)
        elif args.engines:
            build.prebuild([4], verbose=True, list_lens=BINNED_LISTS,
                           rounds=[(L, 4) for L in BINNED_LISTS], sweeps=[4])
        else:
            build.prebuild([1, 4, 8, 10], verbose=True, list_lens=BINNED_LISTS,
                           rounds=[(L, 4) for L in BINNED_LISTS], sweeps=[4],
                           ablations=[(4, mk.cuda_instance(mk.ablation_mask(d))[0])
                                      for d in mk.ABLATION_SETS])
        host_lib.result()
    print(f"   built {len(build.build_log)} libraries in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    host_build_s = sum(secs for _, secs, _ in native.build_log)
    cxx_version = subprocess.run([*native.compiler(), "--version"], capture_output=True,
                                 text=True).stdout.partition("\n")[0]
    print(f"   host library {os.path.relpath(native.load()._name, REPO)}: "
          f"{host_build_s:.1f} s ({' '.join(native.compiler() + native.CXX_FLAGS)}; "
          f"{cxx_version}); host CPU {cpu_model()}, {os.cpu_count()} cores", flush=True)
    worst_spill = 0
    for lib, secs, log in build.build_log:
        lines = ptxas_lines(log)
        worst_spill = max([worst_spill] + [sp for _, _, sp in lines])
        print(f"   {lib}: {secs:.1f} s; " + " | ".join(
            f"{fn}: {regs} registers, {sp} bytes spill stores" for fn, regs, sp in lines),
            flush=True)
    print(f"   worst spill of any kernel: {worst_spill} bytes of stores", flush=True)

    from complex_materials_renderer_tpu_torch.renderer import Renderer

    if args.cards:
        phase("several cards: the sharded Renderer, a two-process NCCL render_multihost")
        print("   " + "\n   ".join(nvidia_smi_line(every=True)), flush=True)
        cards_path()
        print(f"chip_smoke: command time {time.perf_counter() - T_START:.1f} s", flush=True)
        print("chip_smoke: --cards stops here", flush=True)
        return 4  # nonzero: no result line is printed

    if args.engines:
        phase("every engine's showcase render")
        engines_times()
        print(f"chip_smoke: command time {time.perf_counter() - T_START:.1f} s", flush=True)
        print("chip_smoke: --engines stops here", flush=True)
        return 4  # nonzero: no result line is printed

    if args.default_ab:
        phase("the default command with and without the memory sampler, then in process")
        default_ab(smi)
        print(f"chip_smoke: command time {time.perf_counter() - T_START:.1f} s", flush=True)
        print("chip_smoke: --default-ab stops here", flush=True)
        return 4  # nonzero: no result line is printed

    if args.workload:
        phase("default workload: python -m complex_materials_renderer_tpu_torch, showcase "
              "1920x1080 @ 256 spp")
        default_workload(smi)
        phase("acceptance scenes: isobox, gembox, vessel")
        acceptance_scenes(smi)
        print(f"chip_smoke: command time {time.perf_counter() - T_START:.1f} s", flush=True)
        print("chip_smoke: --workload stops here", flush=True)
        return 4  # nonzero: no result line is printed

    main_opts = showcase_options(512, 512, 16)
    if args.tables:
        phase("K1, K3, K4, K5 and K6 launch tables")
        r = Renderer(*main_opts)
        inputs = mega_inputs(r)
        media9 = inputs[0]
        k1_step_table(r, *inputs)
        k1_decomposition(r, *inputs)
        k3_width_table(r)
        sets = ray_sets(r)
        k4_launch_table(r, media9, sets, "showcase")
        rt, sets_t = tiled_scene()
        k4_launch_table(rt, media9, sets_t, "tiled")
        k4_few_supers()
        k5_launch_table(r, media9, sets)
        k6_launch_table(r, media9, sets)
        main_path(main_opts)
        pass_width_table(main_opts, smi)
        print(f"chip_smoke: command time {time.perf_counter() - T_START:.1f} s", flush=True)
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
    calls = k1_step_calls(r, media9, misc, base)
    k1_groups_vs_plain(r, media9, misc, base, calls[-1])

    phase("K1's ablation instances (CMR_MEGA_DEBUG) against plain: "
          f"{', '.join(mk.ABLATION_SETS)}")
    ablation_vs_plain(r, media9, misc, base, calls)

    phase("closest-hit kernel (K3) against plain and the BVH walk (showcase, 65,536 lanes)")
    worst_k3 = k3_vs_plain(r, r_quads_off, r_part)

    phase("listing (K4), round (K5) and pair sweep (K6) against plain (showcase, 65,536 lanes)")
    sets = ray_sets(r)
    errs = k456_vs_plain(r, media9, sets)
    whole_traces(r, media9, sets)

    phase(f"many-cluster scene: showcase tiled {TILES} x {TILES}, K4 against plain")
    rt, sets_t = tiled_scene()
    err_t = max(k4_vs_plain(rt.accel, f"tiled {payload}", rays6(o, d), eff,
                            sparse=payload == "full") for payload, (o, d, eff) in sets_t.items())
    whole_traces(rt, media9, sets_t)
    tiled_ablations_vs_plain(rt)
    tiled_k4 = tiled_path(rt, media9, sets_t)
    if args.quick:
        print(f"chip_smoke: command time {time.perf_counter() - T_START:.1f} s", flush=True)
        print("chip_smoke: --quick stops here", flush=True)
        return 4  # nonzero: no result line is printed

    phase("main path: showcase 512x512 @ 16 spp, megakernel")
    r, launches, mega_img, pc_launches, sort_launches = main_path(main_opts)
    golden_gate()

    phase("the mega pass as one device program: the graph executor against the eager one, "
          "a call under sync-debug 'error', K1's control block, the control kernel")
    graph = graph_phase(main_opts, rt, media9, misc, base, args.profile)

    phase(f"K1 ablations on the main path: {', '.join(mk.EXACT_ABLATIONS)} against the default "
          "image; K1's decomposition")
    ablation_renders(main_opts, mega_img)
    k1_decomposition(r, media9, misc, base)

    phase("wavefront path: showcase 512x512 @ 16 spp, AOVs, bvh backend")
    k3_launches, wave_rate = wavefront_path(main_opts, mega_img)
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

    phase("the wavefront-style engines as device programs: wavefront (clusters, BVH), binned, "
          "pair and binned on the many-cluster scene, graph against eager, a call under "
          "sync-debug 'error'; K5 and K6 with the control block")
    engine_graph = engine_graph_phase(args.profile)
    engine_graph["k56_ctrl"] = k56_control_vs_plain(r, media9, sets)
    engine_graph["rates"] = {"wavefront": wave_rate, "binned": engines["binned"][1],
                             "pair": engines["pair"][1]}

    phase(f"adaptive sampling: render_samples_mega at the uniform pairs, showcase 512x512 @ "
          f"16 spp --spp-mode adaptive")
    adaptive_lanes_check(main_opts)
    adaptive_path(main_opts)

    phase(f"sharding: {SHARDS} logical shards on cuda:0, render_multihost over NCCL")
    sharding_path(r)

    phase("cli: python -m complex_materials_renderer_tpu_torch showcase 512x512 @ 16 spp, "
          "with the host library and with CMR_NO_NATIVE=1; the host BVH builder")
    print(f"   {smi}; host CPU {cpu_model()}", flush=True)
    cli_runs, cli_launches = cli_path(mega_img, launches)
    io_rows = host_io_times()
    bvh_rows = bvh_host_path()

    phase("default workload: python -m complex_materials_renderer_tpu_torch, showcase "
          "1920x1080 @ 256 spp")
    workload = default_workload(smi)
    phase("acceptance scenes: isobox, gembox, vessel")
    workload["scenes"] = acceptance_scenes(smi)

    phase("kernel timing")
    ms, plain_ms, bound_ms, bound_by = time_kernel(r, media9, misc, base)
    ms_k3, plain_ms_k3, bound_ms_k3, bound_by_k3 = time_k3(r)
    k1_step_table(r, media9, misc, base)
    k3_width_table(r)
    k456 = time_k456(r, media9, sets)
    k456_t = time_k456(rt, media9, sets_t, "tiled")
    with uncounted():
        o, d, eff = sets_t["full"]
        rays = rays6(o, d)
        time_k4(rt.accel, "tiled, sparse relist", rays, eff,
                sparse_tlo(relist_tlo(rt.accel, rays, eff)), 8)
    k4_launch_table(r, media9, sets, "showcase")
    k4_launch_table(rt, media9, sets_t, "tiled")
    k4_few_supers()
    k5_launch_table(r, media9, sets)
    k6_launch_table(r, media9, sets)
    if args.profile:
        phase("profile")
        profile_pass(r, "mega")  # the engines' passes: the engines' graph phase

    from complex_materials_renderer_tpu_torch.render import megarender as mr

    graph["captures"] = len(mr.captures)
    graph["capture_s"] = sum(c.seconds for c in mr.captures)
    print(f"   graphs captured in this process: {graph['captures']} in {graph['capture_s']:.3f} s",
          flush=True)
    print(f"chip_smoke: command time {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"host_runtime": {
        "card": smi, "cpu": cpu_model(), "compiler": cxx_version, "library_build_s": host_build_s,
        "cli_ms": cli_runs, "cli_k1_launches": cli_launches, "host_io_ms": io_rows,
        "build_bvh": bvh_rows}}),
          flush=True)
    print(json.dumps({"default_workload": workload}), flush=True)
    print(json.dumps({"pass_graph": graph}), flush=True)
    print(json.dumps({"engine_graph": engine_graph}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "megakernel (K1, with the triangle tester K2 inlined; its ablation instances "
                f"launched beside the default: {', '.join(mk.ABLATION_SETS)})",
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
        "name": "pass control (the mega pass's alive count, live_blocks, ld base, K1 count and "
                "the CUDA graph's loop conditions; glue with no Pallas kernel of its own: the "
                "jit's scalar work between the JAX pass loop's kernel calls)",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/pass_control.cu",
        "replaces": "complex_materials_renderer_tpu/render/megarender.py:213",
        "launches": pc_launches,
        "max_abs_err": graph["control"][4],
        "ms": graph["control"][0],
        "plain_ms": graph["control"][1],
        "bound_ms": graph["control"][2],
        "bound_by": "bytes",
        "library_ms": graph["control"][3],
    }] + [{
        "name": f"partition (the pass plan's compaction sort, timed at {t['lanes']} lanes: the "
                "coherence key, a stable 19-bit radix sort and one state move; no Pallas "
                "kernel of its own: the JAX pass loop's jnp.argsort; launches: the main path's "
                "sorts at every width)",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/partition.cu",
        "replaces": "complex_materials_renderer_tpu/render/megarender.py:114",
        "launches": sort_launches,
        "max_abs_err": t["max_abs_err"],
        "ms": t["graph_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["plain_graph_ms"],
    } for t in graph["partition"]] + [{
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
        "max_abs_err": err,
        "ms": timed[kid][0],
        "plain_ms": timed[kid][1],
        "bound_ms": timed[kid][2],
        "bound_by": timed[kid][3],
        "library_ms": None,
    } for kid, name, src, replaces, launches, err, timed in (
        ("K4", "per-lane candidate-cluster listing (K4; on showcase's grid of one super the "
         "rule launches its one-thread walk, timed at 65,536 lanes; launches: the binned and "
         "pair renders)", "binned_listing.cu",
         "complex_materials_renderer_tpu/kernels/binned_trace.py:88",
         engines["binned"][0]["K4"] + engines["pair"][0]["K4"], errs["K4"], k456),
        ("K4", "K4 tiled: per-lane candidate-cluster listing, its tile walk on the "
         "many-cluster scene (timed at 65,536 lanes; launches: a binned closest and a binned "
         "NEE trace of that scene)", "binned_listing.cu",
         "complex_materials_renderer_tpu/kernels/binned_trace.py:88", tiled_k4, err_t, k456_t),
        ("K5", "binned round (K5, with the triangle tester K2 inlined)", "binned_round.cu",
         "complex_materials_renderer_tpu/kernels/binned_trace.py:199",
         engines["binned"][0]["K5"], errs["K5"], k456),
        ("K6", "cluster-major pair sweep (K6, with the triangle tester K2 inlined)",
         "pair_sweep.cu", "complex_materials_renderer_tpu/kernels/pairsweep.py:111",
         engines["pair"][0]["K6"], errs["K6"], k456),
    )]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
