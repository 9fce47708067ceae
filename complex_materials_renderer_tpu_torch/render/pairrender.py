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
``make_pair_kern``'s bounce loop. The JAX ``lax.cond`` guards are host
``if``s.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.binned_trace import scene_box_clamp
from ..kernels.cluster_test import nee_list_len
from ..kernels.cluster_trace import trace_shaded_clusters
from ..kernels.megakernel import MegaState
from ..kernels.pairsweep import trace_pairs
from ..ops.medium import media_tensors
from .binnedrender import _march_klist, distance_bound, kern_state, shaded_hit, write_back
from .hitinfo import T_MAX, T_MIN, Lights, SceneArrays
from .integrator import Tracer, _bounce, _State, light_setup

# Candidate-bounded interior segments and shadow lines list 1-3 clusters;
# the distance and NEE traces list 4 a generation (pairrender.py:146-148,
# :172-175).
_SHORT_LIST = 4


def make_pair_tracer(grid, scene: SceneArrays, lights: Lights, media9, nee_max_media: int,
                     list_len: int = 12, chunk_blocks: int = 8, closest_mode: str = "shared",
                     direct_mode: str = "scatter") -> Tracer:
    if closest_mode not in ("shared", "pair"):
        raise ValueError(f"closest_mode must be shared|pair, got {closest_mode!r}")
    wlo, whi = scene.world_lo, scene.world_hi
    K = nee_list_len(nee_max_media)

    def closest(org, direction, alive):
        if closest_mode == "pair":
            bound = torch.where(alive, torch.full_like(org[:, 0], T_MAX),
                                torch.zeros_like(org[:, 0]))
            out = trace_pairs(grid, media9, org, direction, bound, "full", world_lo=wlo,
                              world_hi=whi, list_len=list_len, chunk_blocks=chunk_blocks)
            return shaded_hit(*out)
        clamp = scene_box_clamp(torch.full_like(org[:, 0], T_MAX), org, direction, wlo, whi)
        return trace_shaded_clusters(org, direction, grid, T_MIN,
                                     torch.where(alive, clamp, torch.zeros_like(clamp)))

    def distance(position, dir_after, transmitted, rngs, med):
        if not bool(transmitted.any()):
            return torch.full(position.shape[:1], T_MAX, dtype=torch.float32,
                              device=position.device)
        bound = distance_bound(rngs, transmitted, med, direct_mode)
        dt, dslot = trace_pairs(grid, media9, position, dir_after, bound, "dist", world_lo=wlo,
                                world_hi=whi, list_len=_SHORT_LIST, chunk_blocks=chunk_blocks)
        return torch.where(dslot >= 0.0, dt, torch.full_like(dt, T_MAX))

    def direct(position, active):
        light_value, ldir, ldist, eff = light_setup(position, lights, active)
        if not bool(active.any()):
            return light_value
        out = trace_pairs(grid, media9, position, ldir, eff, "nee", nee_max_media=nee_max_media,
                          list_len=_SHORT_LIST, chunk_blocks=chunk_blocks)
        tr = _march_klist(out[:K], out[K:2 * K], out[2 * K], ldist, eff, active, scene.media,
                          scene.scale)
        return light_value * tr

    return Tracer(closest=closest, distance=distance, direct=direct)


def make_pair_kern(grid, scene: SceneArrays, lights: Lights, media9, max_depth: int,
                   rr_depth: int, nee_max_media: int, tir: str, list_len: int = 12,
                   chunk_blocks: int = 8, direct: str = "scatter", ld: bool = False):
    """A drop-in for megarender's per-pass kernel: advance every live lane
    up to ``max_iters`` bounces, updating the state in place
    (``live_blocks`` is accepted and unused)."""
    scene = dataclasses.replace(scene, media=media_tensors(scene.media, grid.device))
    tracer = make_pair_tracer(grid, scene, lights, media9, nee_max_media, list_len,
                              chunk_blocks, direct_mode=direct)

    def bounce_at(s: _State) -> _State:
        return _bounce(s, scene, None, lights, max_depth, rr_depth, nee_max_media, tir,
                       tracer=tracer, direct=direct)

    def kern(state: MegaState, max_iters: int = 1, live_blocks=None, dim0=0):
        del live_blocks
        st = kern_state(state, ld, dim0)
        n = state.org.shape[0]
        # Two widths (pairrender.py:250-290): the pair glue is sized by
        # lanes x list length, so when no lane beyond n/64 (or n/8) is
        # alive, as after the pass loop's compaction, only that head bounces
        # and the dead tail is kept as it is.
        widths = [w for w in (n // 64, n // 8) if w >= 1024]
        for _ in range(max_iters):
            if not bool(st.alive.any()):
                break
            for w in widths:
                if not bool(st.alive[w:].any()):
                    head = bounce_at(_State(*(x[:w] for x in st)))
                    st = _State(*(torch.cat([h, x[w:]]) for h, x in zip(head, st)))
                    break
            else:
                st = bounce_at(st)
        write_back(state, st, ld)
        return state

    return kern
