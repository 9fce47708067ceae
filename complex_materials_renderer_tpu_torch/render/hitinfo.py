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


def make_lights(position, color, intensity, device="cpu") -> Lights:
    """``Lights`` from the options' light fields (renderer.py:203-207)."""
    color = np.asarray(color, np.float32)
    return Lights(
        position=torch.as_tensor(np.asarray(position, np.float32), device=device),
        intensity=torch.as_tensor(color * np.float32(intensity), device=device),
    )
