"""Threaded-BVH closest-hit walk, and the trace dispatch of the wavefront
engine and the AOV passes.

Counterpart of complex_materials_renderer_tpu/kernels/traverse.py
(:37-188). The BVH walk is plain PyTorch, as it is XLA in the JAX
package (no Pallas kernel): every lane carries one node cursor into the
threaded BVH of ``accel/bvh.py``; a box hit on an interior node moves it
to the first child, a miss or a tested leaf to the node's miss link. All
lanes step together in a loop that ends when no cursor is left (the JAX
``lax.while_loop`` :184): a conditional WHILE node of the caller's graph on
the card (``ex``, kernels/pass_control.py), a host read of ``any(cur >= 0)``
a step on the CPU and on the eager executor. It is the portable backend,
slow on a card; the Renderer warns when it is asked for there.

``trace_closest`` and ``trace_shaded`` dispatch on the accel type: a
``DeviceBVH`` takes the walk, a ``DeviceClusterGrid`` the closest-hit
kernel K3 (``kernels/cluster_trace.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.vec import cross, safe_normalize
from .cluster_grid import DeviceClusterGrid
from . import pass_control as pc
from .cluster_trace import ShadedHit, lane_values, trace_closest_clusters, trace_shaded_clusters
from .intersect import Hit, ray_aabb, ray_triangle, safe_inv_dir

_TENSOR_FIELDS = ("bmin", "bmax", "left", "count", "miss", "v0", "v1", "v2", "tri_index")


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    """FlatBVH plus the triangle vertices in leaf order, on a device."""

    bmin: torch.Tensor  # (N, 3)
    bmax: torch.Tensor  # (N, 3)
    left: torch.Tensor  # (N,) int64: first child (interior) or first triangle (leaf)
    count: torch.Tensor  # (N,) int64: 0 for interior nodes
    miss: torch.Tensor  # (N,) int64: skip link; -1 ends the walk
    v0: torch.Tensor  # (T, 3) in BVH leaf order
    v1: torch.Tensor
    v2: torch.Tensor
    tri_index: torch.Tensor  # (T,) int32 original triangle id per leaf-order slot
    leaf_size: int  # max triangles per leaf

    @property
    def device(self) -> torch.device:
        return self.bmin.device


def device_bvh(flat, triangles, leaf_size: int, device=None) -> DeviceBVH:
    """A host FlatBVH and triangle soup (T, 3, 3) as a DeviceBVH on
    ``device`` (default ``cuda``)."""
    from ..utils.device import resolve_device

    tris = np.asarray(triangles, np.float32)[np.asarray(flat.tri_order)]
    host = dict(bmin=flat.bmin, bmax=flat.bmax, left=flat.left, count=flat.count,
                miss=flat.miss, v0=tris[:, 0], v1=tris[:, 1], v2=tris[:, 2],
                tri_index=flat.tri_order)
    return device_bvh_from_jax(host, leaf_size=leaf_size, device=resolve_device(device))


def device_bvh_from_jax(arrays, leaf_size: int | None = None, device="cpu") -> DeviceBVH:
    """A DeviceBVH from numpy arrays: ``arrays`` maps the field names to
    arrays (a dict, or the JAX package's ``DeviceBVH``, whose fields are
    converted with ``np.asarray``); ``leaf_size`` defaults to its own."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    t = {k: torch.from_numpy(np.array(np.asarray(get(k)), copy=True, order="C")).to(device)
         for k in _TENSOR_FIELDS}
    for k in ("left", "count", "miss"):
        t[k] = t[k].to(torch.int64)
    t["tri_index"] = t["tri_index"].to(torch.int32)
    return DeviceBVH(**t, leaf_size=int(leaf_size if leaf_size is not None
                                        else arrays.leaf_size))


def trace_closest(o, d, accel, t_min, t_max, active=None, ex=None) -> Hit:
    """Closest hit: the BVH walk for a DeviceBVH (its loop run by the
    executor ``ex``), K3 for a cluster grid."""
    if isinstance(accel, DeviceClusterGrid):
        return trace_closest_clusters(o, d, accel, t_min, t_max, active=active)
    return _trace_closest_bvh(o, d, accel, t_min, t_max, active=active, ex=ex)


def trace_shaded(o, d, accel, scene_v0, scene_v1, scene_v2, scene_mat_ids,
                 t_min, t_max, active=None, ex=None) -> ShadedHit:
    """Closest hit with the shading payload. K3 returns it directly; on
    the BVH it comes from the hit triangle's vertices (reference
    getObjectHitInfo, volpath:158-196)."""
    if isinstance(accel, DeviceClusterGrid):
        return trace_shaded_clusters(o, d, accel, t_min, t_max, active=active)
    hit = _trace_closest_bvh(o, d, accel, t_min, t_max, active=active, ex=ex)
    p = torch.clamp(hit.prim, min=0).to(torch.int64)
    a, b, c = scene_v0[p], scene_v1[p], scene_v2[p]
    n = safe_normalize(cross(b - a, c - a))
    got = hit.prim >= 0
    mat = torch.where(got, scene_mat_ids[p].to(torch.int32), torch.full_like(hit.prim, -1))
    position = a + hit.u[:, None] * (b - a) + hit.v[:, None] * (c - a)
    return ShadedHit(t=hit.t, hit=got, u=hit.u, v=hit.v, normal=n, mat_id=mat, position=position)


def _trace_closest_bvh(o, d, bvh: DeviceBVH, t_min, t_max, active=None, ex=None) -> Hit:
    """Closest hit of every ray by the threaded-BVH walk. Inactive lanes
    start parked (cursor -1) and miss; ``prim`` indexes the original
    triangle order; ``t`` is ``t_max`` on a miss. The walk's loop is run by
    the executor ``ex`` (``pass_control.executor``), its state updated in
    place."""
    r = o.shape[0]
    dev = o.device
    ex = pc.executor(dev, ex)
    inv_d = safe_inv_dir(d)
    t_max_arr = lane_values(t_max, r, dev)
    t_min_arr = lane_values(t_min, r, dev)
    cur = torch.zeros((r,), dtype=torch.int64, device=dev)
    if active is not None:
        cur = torch.where(active, cur, torch.full_like(cur, -1))
    best_t = t_max_arr.clone()
    best_slot = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    last = bvh.v0.shape[0] - 1
    ctrl = pc.new_ctrl(dev)

    def walk_step(h):
        c = torch.clamp(cur, min=0)
        left, count, miss = bvh.left[c], bvh.count[c], bvh.miss[c]
        live = cur >= 0
        box_hit = ray_aabb(o, inv_d, bvh.bmin[c], bvh.bmax[c], t_min_arr, best_t) & live
        is_leaf = count > 0
        test_leaf = box_hit & is_leaf
        for j in range(bvh.leaf_size):
            valid = test_leaf & (j < count)
            slot = torch.clamp(left + j, 0, last)
            hit, t, u, v = ray_triangle(o, d, bvh.v0[slot], bvh.v1[slot], bvh.v2[slot],
                                        t_min_arr, best_t)
            upd = valid & hit
            best_t.copy_(torch.where(upd, t, best_t))
            best_slot.copy_(torch.where(upd, slot, best_slot))
            best_u.copy_(torch.where(upd, u, best_u))
            best_v.copy_(torch.where(upd, v, best_v))
        nxt = torch.where(box_hit & ~is_leaf, left, miss)
        cur.copy_(torch.where(live, nxt, torch.full_like(nxt, -1)))
        ex.control(cur >= 0, ctrl, pc.COND, handle=h)

    h = ex.cond()
    ex.control(cur >= 0, ctrl, pc.COND, handle=h)
    ex.loop(h, ctrl, walk_step)
    got = best_slot >= 0
    prim = torch.where(got, bvh.tri_index[torch.clamp(best_slot, min=0)],
                       torch.full_like(best_slot, -1, dtype=torch.int32))
    return Hit(t=torch.where(got, best_t, t_max_arr), prim=prim, u=best_u, v=best_v)
