"""Scene tables on the device, and the light.

Counterpart of complex_materials_renderer_tpu/render/hitinfo.py
(``SceneArrays``, ``make_scene_arrays``) plus ``Lights``, ``T_MIN`` and
``T_MAX`` of complex_materials_renderer_tpu/render/integrator.py:52-58.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..scene.medium import MediaTable

T_MIN = 1e-4  # volpath:617
T_MAX = 1e4  # volpath:619


class Lights(NamedTuple):
    position: torch.Tensor  # (3,)
    intensity: torch.Tensor  # (3,) = color * intensity (volpath:115)


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Scene tables used by hit shading. ``media`` stays a numpy table
    (it is packed into the kernel's media rows); ``world_lo``/``world_hi``
    bound the scene for the coherence sort."""

    v0: torch.Tensor  # (T, 3) triangle vertices in ORIGINAL order
    v1: torch.Tensor
    v2: torch.Tensor
    mat_ids: torch.Tensor  # (T,) int32
    media: MediaTable
    scale: float  # float32 value
    world_lo: torch.Tensor  # (3,)
    world_hi: torch.Tensor  # (3,)
    background: int  # 0 none, 1 checkerboard, 2 cornell


def make_scene_arrays(triangles, mat_ids, media: MediaTable, scale, background: int,
                      device="cpu") -> SceneArrays:
    """Assemble scene tables on ``device`` from host arrays."""
    host = np.asarray(triangles, np.float32)
    t = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    return SceneArrays(
        v0=t[:, 0],
        v1=t[:, 1],
        v2=t[:, 2],
        mat_ids=torch.as_tensor(np.asarray(mat_ids, np.int32), device=device),
        media=MediaTable(*(np.asarray(a) for a in media)),
        scale=float(np.float32(scale)),
        world_lo=torch.from_numpy(host.min(axis=(0, 1))).to(device),
        world_hi=torch.from_numpy(host.max(axis=(0, 1))).to(device),
        background=int(background),
    )


def shade_color(position: torch.Tensor, normal: torch.Tensor, background: int) -> torch.Tensor:
    """Procedural base color (hitinfo.py:72-90 of the JAX package,
    volpath:198-226): 0.8 grey; background 1 a checkerboard on the parity
    of floor(x) and floor(y), with ``jnp.mod``'s sign of the divisor
    (``torch.remainder``, not ``fmod``, which differs on negative
    floors); background 2 Cornell red/green by the normal's x."""
    r = position.shape[0]
    ones = torch.ones((r, 3), dtype=torch.float32, device=position.device)
    if background == 1:
        even = ((torch.remainder(torch.floor(position[:, 0]), 2.0) == 0.0)
                == (torch.remainder(torch.floor(position[:, 1]), 2.0) == 0.0))
        return torch.where(even[:, None], 0.8, 0.3) * ones
    base = 0.8 * ones
    if background == 2:
        dot_x = normal[:, 0]
        # Made on the device: a capture copies nothing from the host.
        zero = torch.zeros_like(dot_x)
        red = torch.stack([0.8 * ones[:, 0], zero, zero], dim=-1)
        green = torch.stack([zero, 0.8 * ones[:, 0], zero], dim=-1)
        return torch.where((dot_x > 0.99)[:, None], red,
                           torch.where((dot_x < -0.99)[:, None], green, base))
    return base


def make_lights(position, color, intensity, device="cpu") -> Lights:
    """``Lights`` from the options' light fields (renderer.py:203-207)."""
    color = np.asarray(color, np.float32)
    return Lights(
        position=torch.as_tensor(np.asarray(position, np.float32), device=device),
        intensity=torch.as_tensor(color * np.float32(intensity), device=device),
    )
