"""Henyey-Greenstein phase function on (R, 3) lanes.

Counterpart of complex_materials_renderer_tpu/ops/phase.py (reference
volpath.comp.glsl:428-479): the per-RGB anisotropy collapses to its mean
(volpath:438), and exactly isotropic media (|g| < 1e-4) sample the
uniform sphere, where the reference would divide by 2g.
"""

from __future__ import annotations

import torch

from .vec import cross, dot

INV_FOURPI = 0.07957747154594767  # volpath:98
TWOPI = 6.28318530718  # volpath:101
_ISO_EPS = 1e-4


def g_mean(anisotropy: torch.Tensor) -> torch.Tensor:
    """Mean of the RGB anisotropy channels (volpath:438)."""
    return (anisotropy[..., 0] + anisotropy[..., 1] + anisotropy[..., 2]) / 3.0


def hg_eval(in_dir: torch.Tensor, out_dir: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """HG phase value for the (in, out) direction pair (volpath:435-442)."""
    cos_theta = dot(in_dir, out_dir)
    tmp = 1.0 + g * g + 2.0 * g * cos_theta
    tmp = torch.clamp(tmp, min=1e-12)
    return INV_FOURPI * (1.0 - g * g) / (tmp * torch.sqrt(tmp))


def hg_eval_zero(g: torch.Tensor) -> torch.Tensor:
    """HG eval at cos_theta = 0: the reference evaluates the NEE phase
    before sampling an out direction, which is still vec3(0)
    (volpath:698-699)."""
    tmp = 1.0 + g * g
    return INV_FOURPI * (1.0 - g * g) / (tmp * torch.sqrt(tmp))


def _ortho_frame(normal: torch.Tensor):
    """Tangent frame of the reference sampler (volpath:461-472)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_x = nx.abs() > ny.abs()
    zero = torch.zeros_like(nx)
    inv_a = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=1e-20))
    t_a = torch.stack([nz * inv_a, zero, -nx * inv_a], dim=-1)
    inv_b = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=1e-20))
    t_b = torch.stack([zero, nz * inv_b, -ny * inv_b], dim=-1)
    t = torch.where(use_x[..., None], t_a, t_b)
    s = cross(t, normal)
    return s, t


def hg_sample(in_dir: torch.Tensor, g: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor):
    """Sample an outgoing direction from HG (volpath:444-479) in the frame
    around ``-in_dir``. Returns (out_dir, weight = 1)."""
    iso = g.abs() < _ISO_EPS
    safe_g = torch.where(iso, torch.ones_like(g), g)
    tmp = (1.0 - g * g) / (1.0 - g + 2.0 * g * r1)
    cos_aniso = (1.0 + g * g - tmp * tmp) / (2.0 * safe_g)
    cos_iso = 1.0 - 2.0 * r1
    cos_theta = torch.where(iso, cos_iso, cos_aniso)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWOPI * r2
    lx = sin_theta * torch.cos(phi)
    ly = sin_theta * torch.sin(phi)
    normal = -in_dir
    s, t = _ortho_frame(normal)
    out = s * lx[..., None] + t * ly[..., None] + normal * cos_theta[..., None]
    return out, torch.ones_like(g)
