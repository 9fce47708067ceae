"""Lambertian BSDF with the reference's concentric-disk cosine sampling.

Counterpart of complex_materials_renderer_tpu/ops/diffuse.py (reference
volpath.comp.glsl:255-310), quirks kept: the sampled direction is in the
local z-up frame and the integrator uses it as a world direction
(volpath:766-777); the eval mixes a world-space visibility test with the
local cosine (volpath:257-262); the albedo is a constant 0.8 grey.
"""

from __future__ import annotations

import torch

from .vec import dot

PI = 3.14159265359  # volpath:99
INV_PI = 0.31830988618  # volpath:100
REFLECTANCE = 0.8  # volpath:109


def concentric_disk(r1: torch.Tensor, r2: torch.Tensor):
    """Concentric square-to-disk map of two uniforms (volpath:272-297)."""
    u = 2.0 * r1 - 1.0
    v = 2.0 * r2 - 1.0
    zero = (u == 0.0) & (v == 0.0)
    use_u = u * u > v * v
    one = torch.ones_like(u)
    r = torch.where(use_u, u, v)
    phi = torch.where(
        use_u,
        (PI / 4.0) * (v / torch.where(use_u, u, one)),
        (PI / 2.0) - (u / torch.where(use_u, one, torch.where(v == 0.0, one, v))) * (PI / 4.0),
    )
    r = torch.where(zero, torch.zeros_like(r), r)
    phi = torch.where(zero, torch.zeros_like(phi), phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def diffuse_sample(wi: torch.Tensor, normal: torch.Tensor, r1, r2):
    """A cosine-weighted direction in the local frame (volpath:265-310).
    Returns (wo_local, bsdf value (R, 3): 0.8 where wi . n > 0, else 0)."""
    dx, dy = concentric_disk(r1, r2)
    temp = 1.0 - dx * dx - dy * dy
    z = torch.where(temp <= 0.0, torch.full_like(temp, 1e-10),
                    torch.sqrt(torch.clamp(temp, min=0.0)))
    wo = torch.stack([dx, dy, z], dim=-1)
    valid = dot(wi, normal) > 0.0
    value = torch.where(valid[..., None], REFLECTANCE, 0.0) * torch.ones_like(wi)
    return wo, value


def diffuse_eval(wi: torch.Tensor, wo_local: torch.Tensor, normal: torch.Tensor):
    """Lambert eval with the reference's frame-mixing quirk
    (volpath:255-263)."""
    visible = (dot(wi, normal) > 0.0) & (dot(wo_local, normal) > 0.0)
    val = REFLECTANCE * INV_PI * wo_local[..., 2]
    return torch.where(visible[..., None], val[..., None], 0.0) * torch.ones_like(wi)
