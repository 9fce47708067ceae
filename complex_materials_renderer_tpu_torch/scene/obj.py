"""Wavefront .obj / .mtl parsing.

Replaces tinyobjloader (reference main.cpp:141-148) with semantics matched
to how the reference consumes it (model.cpp:23-42):

- all shapes are flattened into one vertex/index/material-id stream;
- only vertex positions are used (index.vertex_index, model.cpp:34);
- polygons are fan-triangulated (tinyobjloader's default triangulation);
- per-face material ids index the materials in .mtl definition order
  (tinyobjloader's materials vector), -1 for faces before any usemtl.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple

import numpy as np

from .. import native


class ObjMesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (F, 3) int32 — triangulated
    material_ids: np.ndarray  # (F,) int32 — per triangle, -1 = none
    material_names: List[str]  # .mtl definition order


def parse_mtl(path: str) -> List[str]:
    """Material names in definition order (mirrors tinyobjloader's vector)."""
    names: List[str] = []
    if not os.path.exists(path):
        return names
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if line.startswith("newmtl"):
                parts = line.split(None, 1)
                names.append(parts[1].strip() if len(parts) > 1 else "")
    return names


def parse_obj(path: str) -> ObjMesh:
    """Parse an .obj scene with the host library's C++ parser (native.py,
    as the JAX package does with its own); under ``CMR_NO_NATIVE`` with
    the pure-Python ``_parse_obj_python``. A missing file raises
    ``FileNotFoundError`` either way."""
    if native.disabled():
        return _parse_obj_python(path)
    vertices, indices, mat_ids, names = native.parse_obj(path)
    return ObjMesh(vertices=vertices, indices=indices, material_ids=mat_ids,
                   material_names=names)


def _parse_obj_python(path: str) -> ObjMesh:
    vertices: List[List[float]] = []
    indices: List[int] = []
    face_mats: List[int] = []
    material_names: List[str] = []
    name_to_id: Dict[str, int] = {}
    current_mat = -1
    base_dir = os.path.dirname(path)

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line[0] == "#":
                continue
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                parts = line.split()[1:]
                face: List[int] = []
                for tok in parts:
                    s = tok.split("/")[0]
                    idx = int(s)
                    # Negative indices are relative to the running vertex count.
                    face.append(idx - 1 if idx > 0 else len(vertices) + idx)
                # Fan triangulation, tinyobjloader-style.
                for k in range(1, len(face) - 1):
                    indices.extend((face[0], face[k], face[k + 1]))
                    face_mats.append(current_mat)
            elif line.startswith("usemtl"):
                parts = line.split(None, 1)
                name = parts[1].strip() if len(parts) > 1 else ""
                # Materials undeclared in any mtllib map to -1 (tinyobjloader
                # reports -1 for unresolved usemtl as consumed at
                # model.cpp:37-41).
                current_mat = name_to_id.get(name, -1)
            elif line.startswith("mtllib"):
                parts = line.split(None, 1)
                if len(parts) > 1:
                    mtl_path = os.path.join(base_dir, parts[1].strip())
                    for name in parse_mtl(mtl_path):
                        if name not in name_to_id:
                            name_to_id[name] = len(material_names)
                            material_names.append(name)

    verts = np.asarray(vertices, np.float32).reshape(-1, 3)
    idx = np.asarray(indices, np.int32).reshape(-1, 3)
    mats = np.asarray(face_mats, np.int32)
    return ObjMesh(
        vertices=verts,
        indices=idx,
        material_ids=mats,
        material_names=material_names,
    )
