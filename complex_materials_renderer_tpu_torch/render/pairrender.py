"""Pair-sweep engine: the wavefront bounce with the distance and NEE
traces through the cluster-major pair sweep (kernels/pairsweep.py: K4 and
K6).

Counterpart of complex_materials_renderer_tpu/render/pairrender.py
(``make_pair_tracer`` :44, ``make_pair_kern`` :196). The physics is the
wavefront's ``_bounce`` behind a swapped ``Tracer``; the NEE K-list is
marched by the binned engine's ``_march_klist``. The closest-hit trace is
the hybrid's block-shared walk, here the standalone closest-hit kernel K3
(``trace_shaded_clusters``) bounded by the scene-box exit; with
``closest_mode='pair'`` it goes through the pair sweep as well.

``render_beauty_mega(trace_engine="pair")`` swaps its per-pass kernel for
``make_pair_kern``'s bounce loop. The bounce loop (the JAX
``lax.while_loop``, :273-292), its head-width ``lax.cond``s (:286, here
one IF a width: a ladder on the extent of the alive lanes) and the
tracers' guards run on the pass plan's executor (kernels/pass_control.py):
on the card conditional nodes of the pass's CUDA graph.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..kernels import pass_control as pc
from ..kernels.binned_trace import scene_box_clamp
from ..kernels.cluster_test import nee_list_len
from ..kernels.cluster_trace import trace_shaded_clusters
from ..kernels.pairsweep import trace_pairs
from ..ops.medium import media_tensors
from .binnedrender import (
    _march_klist,
    bounce_kern,
    distance_bound,
    engine_prepare,
    guarded,
    shaded_hit,
)
from .hitinfo import T_MAX, T_MIN, Lights, SceneArrays
from .integrator import Tracer, _bounce, _State, light_setup

# Candidate-bounded interior segments and shadow lines list 1-3 clusters;
# the distance and NEE traces list 4 a generation (pairrender.py:146-148,
# :172-175).
_SHORT_LIST = 4


def make_pair_tracer(grid, scene: SceneArrays, lights: Lights, media9, nee_max_media: int,
                     list_len: int = 12, chunk_blocks: int = 8, closest_mode: str = "shared",
                     direct_mode: str = "scatter", ex=None) -> Tracer:
    if closest_mode not in ("shared", "pair"):
        raise ValueError(f"closest_mode must be shared|pair, got {closest_mode!r}")
    wlo, whi = scene.world_lo, scene.world_hi
    K = nee_list_len(nee_max_media)

    def closest(org, direction, alive):
        if closest_mode == "pair":
            bound = torch.where(alive, torch.full_like(org[:, 0], T_MAX),
                                torch.zeros_like(org[:, 0]))
            out = trace_pairs(grid, media9, org, direction, bound, "full", world_lo=wlo,
                              world_hi=whi, list_len=list_len, chunk_blocks=chunk_blocks, ex=ex)
            return shaded_hit(*out)
        clamp = scene_box_clamp(torch.full_like(org[:, 0], T_MAX), org, direction, wlo, whi)
        return trace_shaded_clusters(org, direction, grid, T_MIN,
                                     torch.where(alive, clamp, torch.zeros_like(clamp)))

    def distance(position, dir_after, transmitted, rngs, med):
        def trace():
            bound = distance_bound(rngs, transmitted, med, direct_mode)
            dt, dslot = trace_pairs(grid, media9, position, dir_after, bound, "dist",
                                    world_lo=wlo, world_hi=whi, list_len=_SHORT_LIST,
                                    chunk_blocks=chunk_blocks, ex=ex)
            return torch.where(dslot >= 0.0, dt, torch.full_like(dt, T_MAX))

        seg = torch.full(position.shape[:1], T_MAX, dtype=torch.float32, device=position.device)
        return guarded(ex, transmitted, seg, trace)

    def direct(position, active):
        light_value, ldir, ldist, eff = light_setup(position, lights, active)

        def trace():
            out = trace_pairs(grid, media9, position, ldir, eff, "nee",
                              nee_max_media=nee_max_media, list_len=_SHORT_LIST,
                              chunk_blocks=chunk_blocks, ex=ex)
            tr = _march_klist(out[:K], out[K:2 * K], out[2 * K], ldist, eff, active, scene.media,
                              scene.scale)
            return light_value * tr

        return guarded(ex, active, light_value.clone(), trace)

    return Tracer(closest=closest, distance=distance, direct=direct)


def head_widths(n: int):
    """The pair kern's bounce widths over ``n`` lanes (pairrender.py:250-290):
    the head slices n/64 and n/8 of at least 1024 lanes, then all."""
    return [w for w in (n // 64, n // 8) if w >= 1024] + [n]


def make_pair_kern(grid, scene: SceneArrays, lights: Lights, media9, max_depth: int,
                   rr_depth: int, nee_max_media: int, tir: str, list_len: int = 12,
                   chunk_blocks: int = 8, direct: str = "scatter", ld: bool = False):
    """A drop-in for megarender's per-pass kernel (``bounce_kern``) with the
    distance and NEE traces through the pair sweep, bouncing a head slice
    when no lane beyond it is alive."""
    scene = dataclasses.replace(scene, media=media_tensors(scene.media, grid.device))

    def make_tracer(ex):
        return make_pair_tracer(grid, scene, lights, media9, nee_max_media, list_len,
                                chunk_blocks, direct_mode=direct, ex=ex)

    def bounce_at(s: _State, tracer) -> _State:
        return _bounce(s, scene, None, lights, max_depth, rr_depth, nee_max_media, tir,
                       tracer=tracer, direct=direct)

    def bounce(ex, st: _State, tracer) -> _State:
        # Two widths (pairrender.py:250-290): the pair glue is sized by
        # lanes x list length, so when no lane beyond n/64 (or n/8) is
        # alive, as after the pass loop's compaction, only that head bounces
        # and the dead tail is kept as it is: the narrowest width that holds
        # every alive lane (one IF a width, on the alive lanes' extent).
        n = st.alive.shape[0]
        widths = head_widths(n)
        out = _State(*(x.clone() for x in st))
        ctrl = pc.new_ctrl(st.alive.device)
        handles = ex.conds(len(widths))
        edges = [0] + [w + 1 for w in widths]
        ex.control(st.alive, ctrl, pc.EXTENT | pc.RUNGS, edges=edges, handles=handles)

        def at_width(w, _h):
            head = bounce_at(_State(*(x[:w] for x in st)), tracer)
            for x, h in zip(out, head):
                x[:w].copy_(h)

        ex.rungs(handles, ctrl, [partial(at_width, w) for w in widths])
        return out

    prepare = engine_prepare(("cluster_trace",), ("binned_listing", list_len),
                             ("binned_listing", _SHORT_LIST), ("pair_sweep", nee_max_media), ld=ld)
    return bounce_kern(make_tracer, bounce, ld, prepare)
