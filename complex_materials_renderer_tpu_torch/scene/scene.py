"""Scene assembly: geometry + media + resolved options -> device-ready SoA.

The counterpart of complex_materials_renderer_tpu/scene/scene.py (the
reference Model class, model.cpp:16-118): numpy arrays the renderer
uploads once (triangles in BVH order, per-triangle material ids, the media
table) plus the options after JSON scene-block overrides.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional

import numpy as np

from ..config import RenderOptions
from .medium import MediaTable
from .media import load_media_json
from .obj import ObjMesh, parse_obj


class Scene(NamedTuple):
    triangles: np.ndarray  # (T, 3, 3) float32
    mat_ids: np.ndarray  # (T,) int32
    media: MediaTable  # numpy SoA
    options: RenderOptions  # after scene-JSON overrides
    material_names: List[str]


def _empty_media() -> MediaTable:
    return MediaTable(
        mat_id=np.full((1,), -2, np.int32),  # matches nothing (mat ids >= -1)
        sigma_s=np.zeros((1, 3), np.float32),
        sigma_a=np.zeros((1, 3), np.float32),
        g=np.zeros((1, 3), np.float32),
        ior=np.ones((1,), np.float32),
    )


def load_scene(obj_path: str, options: Optional[RenderOptions] = None) -> Scene:
    """Load ``scene.obj`` (+ ``scene.json`` if present).

    The reference hard-asserts on a missing .json (model.cpp:46); we degrade
    to a medium-less scene so AOV renders work on bare geometry, and keep
    the assert-like strictness for the beauty integrator at call sites that
    need media.
    """
    options = dataclasses.replace(options) if options else RenderOptions()
    mesh: ObjMesh = parse_obj(obj_path)

    json_path = os.path.splitext(obj_path)[0] + ".json"
    if os.path.exists(json_path):
        media, options = load_media_json(json_path, options)
    else:
        media = _empty_media()

    tris = mesh.vertices[mesh.indices]  # (T, 3, 3)
    return Scene(
        triangles=np.ascontiguousarray(tris, np.float32),
        mat_ids=mesh.material_ids.astype(np.int32),
        media=media,
        options=options,
        material_names=mesh.material_names,
    )
