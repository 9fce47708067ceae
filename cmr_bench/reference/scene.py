"""The benchmark's own reading of a scene: the .obj triangles with their
material ids, and the companion .json's camera, light, scale and media.

Written for the reference alone; it shares no code with the program's
parsers. Semantics (those of the reference renderer's tinyobjloader and
nlohmann::json load): every shape flattened into one triangle soup,
polygons fan-triangulated, vertex positions only, a face's material id
the index of its ``usemtl`` name in the .mtl's ``newmtl`` order (-1 before
any ``usemtl`` or for a name no .mtl declares); the .json's ``"scene"``
block sets camera, look-at, fov, light and scale, and every other key is a
material id with its medium (sigma_s, sigma_a, g per channel, ior), kept in
file order because the shader takes the first row that matches.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple

import numpy as np


class Medium(NamedTuple):
    mat_id: int
    sigma_s: tuple
    sigma_a: tuple
    g: tuple
    ior: float


class SceneData(NamedTuple):
    triangles: np.ndarray  # (T, 3, 3) float64, in file order
    mat_ids: np.ndarray  # (T,) int64
    media: List[Medium]  # in file order
    camera_pos: tuple
    look_at: tuple
    fov: float
    light_pos: tuple
    light_color: tuple
    light_intensity: float
    scale: float


def _mtl_names(path: str) -> List[str]:
    names: List[str] = []
    if not os.path.exists(path):
        return names
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split(None, 1)
            if parts and parts[0] == "newmtl":
                names.append(parts[1].strip() if len(parts) > 1 else "")
    return names


def read_obj(path: str):
    """(triangles (T, 3, 3) float64, material ids (T,) int64)."""
    verts: List[List[float]] = []
    tris: List[List[int]] = []
    mats: List[int] = []
    ids: dict = {}
    current = -1
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                face = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    face.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(face) - 1):
                    tris.append([face[0], face[k], face[k + 1]])
                    mats.append(current)
            elif tag == "usemtl":
                current = ids.get(line.split(None, 1)[1].strip() if len(parts) > 1 else "", -1)
            elif tag == "mtllib":
                for name in _mtl_names(os.path.join(base, line.split(None, 1)[1].strip())):
                    ids.setdefault(name, len(ids))
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    return v[np.asarray(tris, np.int64).reshape(-1, 3)], np.asarray(mats, np.int64)


def read_scene(obj_path: str) -> SceneData:
    """The scene of ``obj_path`` and its ``.json`` beside it."""
    triangles, mat_ids = read_obj(obj_path)
    with open(os.path.splitext(obj_path)[0] + ".json") as f:
        data = json.load(f)
    block = data["scene"]
    media = [
        Medium(int(float(key)), tuple(map(float, m["sigma_s"])), tuple(map(float, m["sigma_a"])),
               tuple(map(float, m["g"])), float(m["ior"]))
        for key, m in data.items() if key != "scene"
    ]
    return SceneData(
        triangles=triangles, mat_ids=mat_ids, media=media,
        camera_pos=tuple(map(float, block["camera"])),
        look_at=tuple(map(float, block["cameraLookAt"])),
        fov=float(block["fov"]),
        light_pos=tuple(map(float, block["lightPos"])),
        light_color=tuple(map(float, block["lightColor"])),
        light_intensity=float(block["lightIntensity"]),
        scale=float(block["scale"]),
    )
