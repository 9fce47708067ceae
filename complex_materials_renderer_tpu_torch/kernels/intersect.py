"""Ray-triangle and ray-AABB intersection primitives, and the brute-force
closest-hit oracle.

Counterpart of complex_materials_renderer_tpu/kernels/intersect.py
(:30-150). A hit commits when t is in (t_min, t_max) (VK ray-query
semantics); (u, v) weight v1 and v2, so P = (1-u-v) v0 + u v1 + v v2
(reference volpath:161-170). The barycentric test admits 1e-6 of slack so
rays that land exactly on a shared edge do not fall through.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.vec import cross, dot

_DET_EPS = 1e-12
_BARY_EPS = 1e-6


class Hit(NamedTuple):
    t: torch.Tensor  # (R,) hit distance; t_max where missed
    prim: torch.Tensor  # (R,) int32 triangle index; -1 where missed
    u: torch.Tensor  # (R,) barycentric toward v1
    v: torch.Tensor  # (R,) barycentric toward v2


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test: does the ray meet the box within [t_min, t_max]?
    ``inv_d`` comes from ``safe_inv_dir``, so no component is infinite."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    t_near = torch.maximum(near.amax(dim=-1), torch.as_tensor(t_min, dtype=torch.float32,
                                                              device=o.device))
    t_far = torch.minimum(far.amin(dim=-1), torch.as_tensor(t_max, dtype=torch.float32,
                                                            device=o.device))
    return t_near <= t_far


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal direction with components below 1e-12 nudged off zero."""
    tiny = 1e-12
    safe = torch.where(d.abs() < tiny,
                       torch.where(d < 0, torch.full_like(d, -tiny), torch.full_like(d, tiny)), d)
    return 1.0 / safe


def ray_triangle(o, d, v0, v1, v2, t_min, t_max):
    """Moller-Trumbore with culling disabled (reference main.cpp:198). All
    arguments broadcast; returns (hit mask, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(d, e2)
    det = dot(e1, p)
    valid = det.abs() > _DET_EPS
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    tv = o - v0
    u = dot(tv, p) * inv_det
    q = cross(tv, e1)
    v = dot(d, q) * inv_det
    t = dot(e2, q) * inv_det
    hit = (valid & (u >= -_BARY_EPS) & (v >= -_BARY_EPS) & (u + v <= 1.0 + _BARY_EPS)
           & (t > t_min) & (t < t_max))
    return hit, t, u, v


def trace_naive(o, d, triangles, t_min, t_max, chunk: int = 512) -> Hit:
    """Closest hit against every triangle of ``triangles`` (T, 3, 3), in
    triangle chunks: the oracle of the BVH and cluster backends. Among
    equal t the lowest triangle index wins."""
    tris = torch.as_tensor(triangles, dtype=torch.float32, device=o.device)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    r = o.shape[0]
    t_max_arr = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                                   (r,))
    best_t = t_max_arr.clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros((r,), dtype=torch.float32, device=o.device)
    best_v = torch.zeros((r,), dtype=torch.float32, device=o.device)
    rows = torch.arange(r, device=o.device)
    for base in range(0, tris.shape[0], chunk):
        c0, c1, c2 = (x[base:base + chunk][None] for x in (v0, v1, v2))
        hit, t, u, v = ray_triangle(o[:, None, :], d[:, None, :], c0, c1, c2, t_min,
                                    best_t[:, None])
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        j = torch.argmin(t, dim=1)
        tj = t[rows, j]
        improved = tj < best_t
        best_t = torch.where(improved, tj, best_t)
        best_prim = torch.where(improved, (base + j).to(torch.int32), best_prim)
        best_u = torch.where(improved, u[rows, j], best_u)
        best_v = torch.where(improved, v[rows, j], best_v)
    best_t = torch.where(best_prim >= 0, best_t, t_max_arr)
    return Hit(t=best_t, prim=best_prim, u=best_u, v=best_v)
