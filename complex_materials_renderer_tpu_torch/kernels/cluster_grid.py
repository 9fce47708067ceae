"""The cluster grid laid out for the path-tracing kernel.

Counterpart of ``DeviceClusterGrid`` and ``device_cluster_grid`` in
complex_materials_renderer_tpu/kernels/pallas_trace.py:57-167, with the
same layout: per-component (C, width) rows, run-major ``run_rows`` of
shape (C*subs, row_w) with 12 components strided by ``run``, (C, 8)
``bounds``, (S, 8) ``super_bounds``, ``qa``/``qb``, ``num_opaque_supers``
and ``super_factor``; and, the port's own, ``group_bounds``: a level of
boxes over consecutive supers that K1's walk tests above the supers on a
grid of many supers (``super_groups``; kernels/megakernel.py has the rule).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.clusters import SUB_SIZE

_SENTINEL = np.float32(1e30)  # an empty box: a far-away point (accel/clusters.py)

_TENSOR_FIELDS = (
    "v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
    "bounds", "super_bounds", "tri_index", "mat", "qa", "qb", "run_rows",
)
_META_FIELDS = (
    "num_clusters", "num_supers", "num_opaque_supers",
    "runs_per_cluster", "run_size", "super_factor",
)


@dataclasses.dataclass(frozen=True)
class DeviceClusterGrid:
    v0x: torch.Tensor  # (C, width)
    v0y: torch.Tensor
    v0z: torch.Tensor
    e1x: torch.Tensor  # v1 - v0
    e1y: torch.Tensor
    e1z: torch.Tensor
    e2x: torch.Tensor  # v2 - v0
    e2y: torch.Tensor
    e2z: torch.Tensor
    bounds: torch.Tensor  # (C, 8) cluster AABBs
    super_bounds: torch.Tensor  # (S, 8) super-cluster AABBs
    # (n_groups, 8) group boxes over consecutive supers (``super_groups``):
    # lo xyz, hi xyz, the end of the group's supers (a float), 0
    group_bounds: torch.Tensor
    tri_index: torch.Tensor  # (C*width,) slot -> original triangle id
    mat: torch.Tensor  # (C, width) per-slot material id as float32
    qa: torch.Tensor  # (C, width) quad far-corner coefficients
    qb: torch.Tensor
    run_rows: torch.Tensor  # (C * runs_per_cluster, row_w) run-major rows
    num_clusters: int
    num_supers: int
    num_opaque_supers: int  # supers [0, this) hold only opaque triangles
    runs_per_cluster: int
    run_size: int
    super_factor: int

    @property
    def device(self) -> torch.device:
        return self.run_rows.device

    @property
    def width(self) -> int:
        return int(self.v0x.shape[1])


def device_cluster_grid(grid, device=None) -> DeviceClusterGrid:
    """Lay out a host ``ClusterGrid`` on ``device`` (default ``cuda``)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    # Slot ids and material ids ride through the kernel as float32; above
    # 2^24 slots (~16.7M triangles) slot identity would silently lose
    # integer precision and corrupt prim/material lookups.
    num_slots = int(grid.bounds.shape[0]) * int(grid.v0x.shape[1])
    if num_slots >= 1 << 24:
        raise ValueError(
            f"cluster grid has {num_slots} triangle slots; the kernel's "
            "float32 slot ids are exact only below 2^24 (16.7M triangles)"
        )

    c = int(grid.bounds.shape[0])
    width = int(grid.v0x.shape[1])
    subs = max(1, width // SUB_SIZE)
    if width % subs:
        raise ValueError(f"cluster width {width} not divisible into runs")
    run = width // subs
    row_w = -(-(12 * run) // 128) * 128
    qa = grid.qa if grid.qa is not None else np.full_like(
        np.asarray(grid.v0x, np.float32), 0.5
    )
    qb = grid.qb if grid.qb is not None else np.full_like(
        np.asarray(grid.v0x, np.float32), 0.5
    )
    comps = [
        grid.v0x, grid.v0y, grid.v0z,
        grid.e1x, grid.e1y, grid.e1z,
        grid.e2x, grid.e2y, grid.e2z,
        np.asarray(grid.mat_id, np.float32),
        qa, qb,
    ]
    run_rows = np.zeros((c * subs, row_w), np.float32)
    for k, arr in enumerate(comps):
        run_rows[:, k * run : (k + 1) * run] = np.asarray(
            arr, np.float32
        ).reshape(c * subs, run)

    host = dict(
        v0x=grid.v0x, v0y=grid.v0y, v0z=grid.v0z,
        e1x=grid.e1x, e1y=grid.e1y, e1z=grid.e1z,
        e2x=grid.e2x, e2y=grid.e2y, e2z=grid.e2z,
        bounds=grid.bounds, super_bounds=grid.super_bounds,
        tri_index=grid.tri_index,
        mat=np.asarray(grid.mat_id, np.float32),
        qa=np.asarray(qa, np.float32), qb=np.asarray(qb, np.float32),
        run_rows=run_rows,
    )
    return from_jax_arrays(
        host,
        num_clusters=c,
        num_supers=int(grid.super_bounds.shape[0]),
        num_opaque_supers=int(getattr(grid, "num_opaque_supers", 0)),
        runs_per_cluster=subs,
        run_size=run,
        super_factor=int(getattr(grid, "super_factor", 16)),
        device=dev,
    )


def group_fanout(num_supers: int) -> int:
    """The supers of a group box: the power of two nearest the square
    root of the supers (16 at 172, 32 at the 1,024-super cap), so that a
    walk tests about as many group boxes as supers in a group."""
    root = float(num_supers) ** 0.5
    f = 1
    while abs(2 * f - root) < abs(f - root):
        f *= 2
    return f


def super_groups(super_bounds, num_opaque_supers: int, fanout: int) -> np.ndarray:
    """The (n_groups, 8) float32 group boxes of ``fanout`` consecutive
    supers of the (S, 8) ``super_bounds``: the min and max of the group's
    live super boxes (an empty super's far-point sentinel left out, as
    accel/clusters.py leaves out empty clusters), the sentinel where all
    are empty; column 6 the end of the group's supers. The opaque supers
    [0, num_opaque_supers) are grouped apart from the media supers after
    them, so that no group straddles the cut. A group box holds each of
    its supers' boxes and the slab test is monotone in the box, so a walk
    that misses a group would have missed each of its supers."""
    sb = np.asarray(super_bounds, np.float32)
    s = sb.shape[0]
    cut = min(max(int(num_opaque_supers), 0), s)
    ends = [*range(fanout, cut, fanout), cut] if cut else []
    ends += [*range(cut + fanout, s, fanout), s] if s > cut else []
    out = np.zeros((len(ends), 8), np.float32)
    out[:, 0:6] = _SENTINEL
    lo = 0
    for g, hi in enumerate(ends):
        box = sb[lo:hi]
        live = ~np.all(box[:, 0:6] == _SENTINEL, axis=1)
        if live.any():
            out[g, 0:3] = box[live, 0:3].min(axis=0)
            out[g, 3:6] = box[live, 3:6].max(axis=0)
        out[g, 6] = hi
        lo = hi
    return out


def from_jax_arrays(arrays, device="cpu", **meta) -> DeviceClusterGrid:
    """Build the port's grid from numpy arrays: ``arrays`` maps the tensor
    field names to arrays (a dict, or the JAX package's
    ``DeviceClusterGrid`` whose fields are converted with ``np.asarray``);
    the integer metadata comes from ``meta`` or, when absent, from the
    same-named attributes of ``arrays``. The group boxes are built here
    from the super boxes, at the fan-out ``group_fanout`` gives."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (
        lambda k: getattr(arrays, k)
    )
    tensors = {
        k: torch.from_numpy(np.array(get(k), copy=True, order="C")).to(device)
        for k in _TENSOR_FIELDS
    }
    meta = {k: int(meta[k]) if k in meta else int(get(k)) for k in _META_FIELDS}
    groups = super_groups(np.asarray(get("super_bounds")), meta["num_opaque_supers"],
                          group_fanout(meta["num_supers"]))
    return DeviceClusterGrid(**tensors, group_bounds=torch.from_numpy(groups).to(device), **meta)
