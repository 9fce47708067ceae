"""Participating-medium ops on lanes: table lookup, transmittance,
free-flight sampling and the analytic direct-light factor.

Counterpart of complex_materials_renderer_tpu/ops/medium.py (reference
volpath.comp.glsl:137-145, :248-253, :482-543): min-extinction density,
max-single-channel albedo weight clamped to >= 0.5, the 500000
no-interaction sentinel and the < 1e-4 transmittance zero clamp.
``MediaTable`` is the one of ``scene/medium.py``; its arrays may be numpy
or tensors (``media_tensors`` moves them to a device once per render).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.medium import MediaTable

NO_INTERACTION = 500000.0  # volpath:513
LN_CLAMP = 9.210340371976184  # ln(1e4): the <1e-4 transmittance clamp depth


class MediumLanes(NamedTuple):
    """Per-lane medium properties after lookup (scaled like volpath:141)."""

    has_medium: torch.Tensor  # (R,) bool
    sigma_s: torch.Tensor  # (R, 3) scaled
    sigma_a: torch.Tensor  # (R, 3) scaled
    g: torch.Tensor  # (R, 3)
    ior: torch.Tensor  # (R,)


def media_tensors(table: MediaTable, device) -> MediaTable:
    """The table's arrays as tensors on ``device``."""
    return MediaTable(*(torch.as_tensor(a, device=device) for a in table))


def _select(has: torch.Tensor, idx: torch.Tensor, table: MediaTable, scale) -> MediumLanes:
    t = media_tensors(table, idx.device)
    zero3 = torch.zeros((idx.shape[0], 3), dtype=torch.float32, device=idx.device)
    h3 = has[:, None]
    return MediumLanes(
        has_medium=has,
        sigma_s=torch.where(h3, t.sigma_s.to(torch.float32)[idx] * scale, zero3),
        sigma_a=torch.where(h3, t.sigma_a.to(torch.float32)[idx] * scale, zero3),
        g=torch.where(h3, t.g.to(torch.float32)[idx], zero3),
        ior=torch.where(has, t.ior.to(torch.float32)[idx], torch.ones_like(zero3[:, 0])),
    )


def lookup(mat_id: torch.Tensor, table: MediaTable, scale) -> MediumLanes:
    """First-match medium lookup by material id (volpath:137-145): the
    first table row whose id equals the lane's, as the reference's linear
    scan breaks; lanes with no match get no medium (zeros, ior 1)."""
    ids = torch.as_tensor(table.mat_id, device=mat_id.device).to(mat_id.dtype)
    idx = torch.zeros_like(mat_id, dtype=torch.int64)
    has = torch.zeros_like(mat_id, dtype=torch.bool)
    # Rows in reverse, so the lowest matching row is written last.
    for i in reversed(range(ids.shape[0])):
        m = mat_id == ids[i]
        idx = torch.where(m, torch.full_like(idx, i), idx)
        has = has | m
    return _select(has, idx, table, scale)


def lookup_index(row_idx: torch.Tensor, table: MediaTable, scale) -> MediumLanes:
    """Medium lookup by media-table row index (-1 = no medium)."""
    has = row_idx >= 0
    return _select(has, torch.clamp(row_idx, min=0).to(torch.int64), table, scale)


def eval_transmittance(dist, sigma_s: torch.Tensor, sigma_a: torch.Tensor) -> torch.Tensor:
    """Homogeneous Beer-Lambert transmittance (volpath:248-253)."""
    extinction = sigma_a + sigma_s
    d = torch.as_tensor(dist, dtype=torch.float32, device=extinction.device)
    if d.dim() == extinction.dim() - 1:
        d = d[..., None]
    return torch.exp(-extinction * d)


def _weight(sigma_s: torch.Tensor, extinction: torch.Tensor) -> torch.Tensor:
    """Max single-channel albedo, clamped to >= 0.5 when positive; -1 when
    no channel has extinction (volpath:492-504)."""
    albedo = torch.where(extinction > 0.0, sigma_s / torch.clamp(extinction, min=1e-30),
                         torch.full_like(extinction, -1.0))
    weight = albedo.amax(dim=-1)
    weight = torch.clamp(weight, min=-1.0)
    return torch.where(weight > 0.0, torch.clamp(weight, min=0.5), weight)


def _candidate(rand, density, weight):
    draw = rand < weight
    r_scaled = torch.where(draw, rand / torch.where(draw, weight, torch.ones_like(weight)),
                           torch.zeros_like(rand))
    exp_sample = -torch.log(torch.clamp(1.0 - r_scaled, min=1e-37)) / torch.clamp(density, min=1e-30)
    return torch.where(draw & (density > 0.0), exp_sample, torch.full_like(exp_sample, NO_INTERACTION))


def free_flight_candidate(rand, sigma_s, sigma_a):
    """The exponential candidate collision distance of ``sample_distance``
    (NO_INTERACTION when the single-scatter draw declines)."""
    extinction = sigma_s + sigma_a
    return _candidate(rand, extinction.amin(dim=-1), _weight(sigma_s, extinction))


def analytic_direct_scale(sigma_s, sigma_a, dist):
    """Closed-form expectation of the scatter branch's direct-light factor
    ``E[sigma_s T(t) / p_success(t)]`` per channel, with the reference's
    transmittance clamp (t_cap = min(dist, ln(1e4)/density)); see the JAX
    module. Returns (gate = density > 0, scale3)."""
    extinction = sigma_s + sigma_a
    density = extinction.amin(dim=-1)
    gate = density > 0.0
    t_cap = torch.minimum(torch.as_tensor(dist, dtype=torch.float32, device=density.device),
                          LN_CLAMP / torch.clamp(density, min=1e-30))
    a = (sigma_s * (1.0 - torch.exp(-extinction * t_cap[..., None]))
         / torch.clamp(extinction, min=1e-30))
    return gate, torch.where(gate[..., None], a, torch.zeros_like(a))


class DistanceSample(NamedTuple):
    success: torch.Tensor  # (R,) bool: scatter event inside the segment
    t: torch.Tensor  # (R,) sampled depth (== dist on failure)
    prob_fail: torch.Tensor  # (R,)
    prob_success: torch.Tensor  # (R,)
    transmittance: torch.Tensor  # (R, 3)


def sample_distance(rand, sigma_s, sigma_a, dist) -> DistanceSample:
    """Free-flight distance sampling (volpath:482-543): the failure
    probability folds the no-interaction branch, ``w e^{-sigma d} + 1 - w``
    (volpath:535)."""
    extinction = sigma_s + sigma_a
    density = extinction.amin(dim=-1)
    weight = _weight(sigma_s, extinction)
    sampled = _candidate(rand, density, weight)
    success = sampled < dist
    t = torch.where(success, sampled, dist)
    prob_fail = torch.exp(-density * t)
    prob_success = density * prob_fail * weight
    prob_fail = weight * prob_fail + (1.0 - weight)
    transmittance = torch.exp(-extinction * t[..., None])
    transmittance = torch.where((transmittance.amax(dim=-1) < 1e-4)[..., None],
                                torch.zeros_like(transmittance), transmittance)
    return DistanceSample(success=success, t=t, prob_fail=prob_fail,
                          prob_success=prob_success, transmittance=transmittance)
