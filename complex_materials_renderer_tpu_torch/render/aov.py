"""Debug AOV passes: depth, face normal, barycentric topology.

Counterpart of complex_materials_renderer_tpu/render/aov.py (:31-73; the
reference's depth.comp.glsl:94-99, normal.comp.glsl:129-141 and
topology.comp.glsl:95-111). One closest-hit trace of every pixel's
centre ray (no jitter, no RNG) through the production traversal: K3 on
the cluster backend, the BVH walk on the other.

- depth:    greyscale t/10; misses show t_max/10;
- normal:   0.5 + 0.5 * normalize(cross(v1-v0, v2-v0)); sky (0, 0, 0.5);
- topology: (1-u-v, u, v); sky (0, 0, 0.5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.traverse import trace_closest
from ..ops.camera import Camera, generate_rays
from ..ops.vec import cross, safe_normalize
from .hitinfo import T_MAX, T_MIN

_SKY = (0.0, 0.0, 0.5)


def _aov_pass(camera: Camera, accel, v0, v1, v2, resolution, kind: str) -> torch.Tensor:
    width, height = resolution
    dev = v0.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int64, device=dev),
                            torch.arange(width, dtype=torch.int64, device=dev), indexing="ij")
    pixel_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    jitter = torch.full((pixel_xy.shape[0], 2), 0.5, dtype=torch.float32, device=dev)
    o, d = generate_rays(camera, pixel_xy, jitter, resolution)
    hit = trace_closest(o.contiguous(), d, accel, T_MIN, T_MAX)
    miss = hit.prim < 0
    sky = torch.tensor(_SKY, dtype=torch.float32, device=dev)
    if kind == "depth":
        t = torch.where(miss, torch.full_like(hit.t, T_MAX), hit.t)
        img = (t / 10.0)[:, None].repeat(1, 3)
    elif kind == "normal":
        p = torch.clamp(hit.prim, min=0).to(torch.int64)
        n = safe_normalize(cross(v1[p] - v0[p], v2[p] - v0[p]))
        img = torch.where(miss[:, None], sky, 0.5 + 0.5 * n)
    elif kind == "topology":
        bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
        img = torch.where(miss[:, None], sky, bary)
    else:
        raise ValueError(f"unknown AOV kind: {kind}")
    return img.reshape(height, width, 3)


def render_aov(scene_tris, camera: Camera, accel, resolution, kind: str) -> torch.Tensor:
    """One AOV image (height, width, 3) on the device of ``accel``.
    ``scene_tris`` (T, 3, 3) is in the original triangle order, which the
    normal is reported against (the reference's primitive indexing,
    volpath:127)."""
    tris = torch.as_tensor(np.asarray(scene_tris, np.float32), device=accel.device)
    return _aov_pass(camera, accel, tris[:, 0], tris[:, 1], tris[:, 2], tuple(resolution), kind)
