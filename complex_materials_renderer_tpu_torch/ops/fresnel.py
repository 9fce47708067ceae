"""Fresnel reflectance and reflection/refraction directions on (R, 3)
lanes.

Counterpart of complex_materials_renderer_tpu/ops/fresnel.py (reference
volpath.comp.glsl:312-335, :545-548, :550-562), with its divergence from
the reference kept: under total internal reflection the reflectance is
0, so the refract branch resolves to a physical reflection (the
integrator's ``tir='kill'`` mode reproduces the reference's termination).
"""

from __future__ import annotations

import torch

from .vec import dot, norm


def reflect(direction: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (volpath:545-548)."""
    return direction - (2.0 * dot(direction, normal))[..., None] * normal


def refract(direction: torch.Tensor, normal: torch.Tensor, n1, n2):
    """Snell refraction (volpath:550-562). Returns (direction, tir): the
    direction is zero where ``tir`` is True, the reference's sentinel."""
    eta = torch.as_tensor(n1, dtype=torch.float32, device=direction.device) / torch.as_tensor(
        n2, dtype=torch.float32, device=direction.device)
    eta = torch.broadcast_to(eta, direction.shape[:-1])[..., None]
    cos_i = -dot(direction, normal)[..., None]
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    out = eta * direction + (eta * cos_i - cos_t) * normal
    out = torch.where(tir, torch.zeros_like(out), out)
    return out, tir[..., 0]


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / norm(v)[..., None]


def fresnel_r(n1, n2, in_dir: torch.Tensor, normal: torch.Tensor, fast: bool = False):
    """Unpolarized Fresnel reflectance (volpath:312-335); 0 under TIR.
    ``fast`` is the Schlick branch (volpath:314-318)."""
    dev = in_dir.device
    n1 = torch.as_tensor(n1, dtype=torch.float32, device=dev)
    n2 = torch.as_tensor(n2, dtype=torch.float32, device=dev)
    if n1.dim() == in_dir.dim() - 1:
        n1 = n1[..., None]
    if n2.dim() == in_dir.dim() - 1:
        n2 = n2[..., None]
    d = _normalize(in_dir)
    n = _normalize(normal)
    if fast:
        ratio = n1 / n2
        f = ((1.0 - ratio) ** 2) / ((1.0 + ratio) ** 2)
        cosine = dot(d, n).abs()[..., None]
        r = f + (1.0 - f) * (1.0 - cosine) ** 5
        return r[..., 0]
    cos1 = torch.clamp(dot(d, n).abs()[..., None], 0.0, 1.0)
    theta1 = torch.acos(cos1)
    sin_t2 = n1 / n2 * torch.sin(theta1)
    tir = sin_t2 >= 1.0
    theta2 = torch.asin(torch.clamp(sin_t2, -1.0, 1.0))
    c1 = torch.cos(theta1)
    c2 = torch.cos(theta2)
    rs = (n1 * c1 - n2 * c2) / (n1 * c1 + n2 * c2)
    rp = (n1 * c2 - n2 * c1) / (n1 * c2 + n2 * c1)
    r = (rs * rs + rp * rp) * 0.5
    r = torch.where(tir, torch.zeros_like(r), r)
    return r[..., 0]
