"""Standalone closest-hit trace over the cluster grid (K3).

Counterpart of complex_materials_renderer_tpu/kernels/pallas_trace.py
(``_trace_kernel`` :170 through ``_trace_core`` :399, ``ShadedHit`` :356,
``trace_shaded_clusters`` :368, ``trace_closest_clusters`` :385): for R
rays and a per-lane bound (inactive lanes are parked at ``t_max = 0``),
the closest hit over every slot of the grid with the shading payload
(t, slot, u, v, the unnormalised normal e1 x e2, material id, the
barycentric position). The far-edge acceptance is K3's own, with an
additive epsilon (``cluster_test._mt``).

On CUDA tensors ``trace_core`` launches the hand-written kernel of
``csrc/cluster_trace.cu`` with ``group_size`` threads per ray (or raises);
on CPU tensors it runs ``trace_core_plain``, a brute force over all slots,
chunked over lanes, which keeps the lowest slot of least t as the
kernel's strict ``t < t_best`` walk does. The plain version is what the wavefront engine
and the AOVs run on the CPU, and what the kernel is held against.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops.vec import safe_normalize
from ..render.hitinfo import T_MIN
from .cluster_grid import DeviceClusterGrid
from .cluster_test import group_size, payload_state0, slot_table, trace_slots
from .intersect import Hit
from .megakernel import _require


class ShadedHit(NamedTuple):
    """Closest hit plus the shading payload."""

    t: torch.Tensor  # (R,) hit distance; t_max on a miss
    hit: torch.Tensor  # (R,) bool
    u: torch.Tensor
    v: torch.Tensor
    normal: torch.Tensor  # (R, 3) normalized geometric normal
    mat_id: torch.Tensor  # (R,) int32; -1 on a miss
    position: torch.Tensor  # (R, 3) barycentric hit position (volpath:170)


def trace_core_plain(o: torch.Tensor, d: torch.Tensor, grid: DeviceClusterGrid,
                     eff_tmax: torch.Tensor, t_min: float = T_MIN):
    """The plain version of the kernel: (t, slot, u, v, nx, ny, nz, mat,
    px, py, pz) with slot and mat as float32, and the miss defaults t =
    ``eff_tmax``, slot -1, normal (0, 0, 1), mat -1, position 0. Only the
    lanes whose bound exceeds ``t_min`` are tested: no other lane can
    accept a hit."""
    state0 = payload_state0("full", eff_tmax.to(torch.float32).contiguous())
    act = (state0[0] > t_min).nonzero().squeeze(1)
    if act.numel() == 0:
        return state0
    rays = (o[act, 0], o[act, 1], o[act, 2], d[act, 0], d[act, 1], d[act, 2])
    sub = trace_slots(slot_table(grid), rays, "full", tuple(x[act] for x in state0), t_min,
                      additive_eps=True)
    out = []
    for x, y in zip(state0, sub):
        x = x.clone()
        x[act] = y
        out.append(x)
    return tuple(out)


def trace_core(o, d, grid: DeviceClusterGrid, t_min, t_max, active=None):
    """The kernel's outputs (t, slot, u, v, nx, ny, nz, mat, px, py, pz)
    with slot and mat as int32, plus the broadcast ``t_max``
    (pallas_trace.py ``_trace_core``). CUDA launches are counted in
    ``trace_core.launches``."""
    r = o.shape[0]
    t_max_arr = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (r,))
    eff_tmax = t_max_arr
    if active is not None:
        eff_tmax = torch.where(active, t_max_arr, torch.zeros_like(t_max_arr))
    if o.device.type == "cpu":
        out = trace_core_plain(o, d, grid, eff_tmax, float(t_min))
        t, slot, u, v, nx, ny, nz, mat, px, py, pz = out
        slot, mat = slot.to(torch.int32), mat.to(torch.int32)
    else:
        t, slot, u, v, nx, ny, nz, mat, px, py, pz = _launch(o, d, grid, eff_tmax, t_min)
    return t, slot, u, v, nx, ny, nz, mat, px, py, pz, t_max_arr


trace_core.launches = 0  # CUDA launches made by trace_core


def trace_shaded_clusters(o, d, grid: DeviceClusterGrid, t_min, t_max, active=None) -> ShadedHit:
    """Closest hit with the shading payload: the normal normalised with
    ``max(norm, 1e-20)``, t mapped back to the caller's ``t_max`` on a
    miss (pallas_trace.py:368-382)."""
    t_raw, slot, u, v, nx, ny, nz, mat, px, py, pz, t_max_arr = trace_core(
        o, d, grid, t_min, t_max, active)
    hit = slot >= 0
    return ShadedHit(
        t=torch.where(hit, t_raw, t_max_arr), hit=hit, u=u, v=v,
        normal=safe_normalize(torch.stack([nx, ny, nz], dim=-1)),
        mat_id=torch.where(hit, mat, torch.full_like(mat, -1)),
        position=torch.stack([px, py, pz], dim=-1),
    )


def trace_closest_clusters(o, d, grid: DeviceClusterGrid, t_min, t_max, active=None) -> Hit:
    """Closest hit with ``prim`` in the original triangle order and t ==
    t_max on a miss (pallas_trace.py:385-396)."""
    t_raw, slot, u, v, *_rest, t_max_arr = trace_core(o, d, grid, t_min, t_max, active)
    hit = slot >= 0
    prim = torch.where(hit, grid.tri_index[torch.clamp(slot, min=0).to(torch.int64)].to(torch.int32),
                       torch.full_like(slot, -1))
    return Hit(t=torch.where(hit, t_raw, t_max_arr), prim=prim, u=u, v=v)


def _launch(o, d, grid: DeviceClusterGrid, eff_tmax, t_min):
    """Check every tensor and launch the CUDA kernel on the current
    stream. Returns the 11 outputs (slot and mat int32)."""
    from . import build

    if np.float32(t_min) != np.float32(T_MIN):
        raise ValueError(f"the CUDA closest-hit kernel traces from t_min {T_MIN}, got {t_min}")
    dev = o.device
    r = o.shape[0]
    C, S = grid.num_clusters, grid.num_supers
    row_w = grid.run_rows.shape[1]
    o = o.contiguous()
    d = d.contiguous()
    eff_tmax = eff_tmax.contiguous()
    _require(o, "o", torch.float32, (r, 3), dev)
    _require(d, "d", torch.float32, (r, 3), dev)
    _require(eff_tmax, "t_max", torch.float32, (r,), dev)
    _require(grid.bounds, "bounds", torch.float32, (C, 8), dev)
    _require(grid.super_bounds, "super_bounds", torch.float32, (S, 8), dev)
    _require(grid.run_rows, "run_rows", torch.float32, (C * grid.runs_per_cluster, row_w), dev)
    fout = torch.empty((9, r), dtype=torch.float32, device=dev)
    iout = torch.empty((2, r), dtype=torch.int32, device=dev)
    if r > 0:
        fn = build.cluster_trace()
        p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(p(grid.bounds), p(grid.super_bounds), p(grid.run_rows),
                     p(o), p(d), p(eff_tmax), p(fout), p(iout),
                     r, C, S, grid.runs_per_cluster, grid.run_size, row_w, grid.super_factor,
                     group_size(r), ctypes.c_void_p(stream))
        trace_core.launches += 1
        if err != 0:
            raise RuntimeError(f"closest-hit kernel launch failed: {build.error_string(err)}")
    t, u, v, nx, ny, nz, px, py, pz = fout
    slot, mat = iout
    return t, slot, u, v, nx, ny, nz, mat, px, py, pz
