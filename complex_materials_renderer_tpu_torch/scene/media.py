"""Companion .json scene/media parsing (counterpart of
complex_materials_renderer_tpu/scene/media.py ``load_media_json`` and
``pack_media_buffer``).

Replaces the reference's nlohmann::json scene load (model.cpp:44-105):
a ``"scene"`` key overrides camera/look-at/fov/light/intensity/scale in the
options (JSON wins over CLI-era defaults, model.cpp:54-79); every other
key is a material-id -> medium record. ``pack_media_buffer`` gives the
packed float stream the reference uploads (model.cpp:49: ``count,
(matID, sigma_s.rgb, sigma_a.rgb, g.rgb, ior)*count``).
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

from ..config import RenderOptions
from .medium import MediaTable


def load_media_json(path: str, options: RenderOptions) -> Tuple[MediaTable, RenderOptions]:
    """Parse ``<scene>.json``; mutates ``options`` with the scene block."""
    with open(path, "r") as f:
        data = json.load(f)

    ids: List[float] = []
    sigma_s: List[List[float]] = []
    sigma_a: List[List[float]] = []
    g: List[List[float]] = []
    ior: List[float] = []

    for key, value in data.items():
        if key == "scene":
            options.camera_pos = tuple(float(x) for x in value["camera"])
            options.camera_look_at = tuple(float(x) for x in value["cameraLookAt"])
            options.light_pos = tuple(float(x) for x in value["lightPos"])
            options.light_color = tuple(float(x) for x in value["lightColor"])
            options.camera_fov = float(value["fov"])
            options.light_intensity = float(value["lightIntensity"])
            options.scale = float(value["scale"])
            continue
        # The reference stores matID as float (std::stof of the key,
        # model.cpp:82) and compares uint(matID) in the shader
        # (volpath:139); we keep int ids.
        ids.append(int(float(key)))
        sigma_s.append([float(x) for x in value["sigma_s"]])
        sigma_a.append([float(x) for x in value["sigma_a"]])
        g.append([float(x) for x in value["g"]])
        ior.append(float(value["ior"]))

    count = len(ids)
    table = MediaTable(
        mat_id=np.asarray(ids, np.int32).reshape(count),
        sigma_s=np.asarray(sigma_s, np.float32).reshape(count, 3),
        sigma_a=np.asarray(sigma_a, np.float32).reshape(count, 3),
        g=np.asarray(g, np.float32).reshape(count, 3),
        ior=np.asarray(ior, np.float32).reshape(count),
    )
    return table, options



def pack_media_buffer(path: str) -> np.ndarray:
    """Reference-format packed media stream (model.cpp:49-103), float32.

    The reference's count includes the ``"scene"`` entry (it pushes
    ``data.size()`` before filtering, model.cpp:50); the buffer keeps that
    count, as the JAX package's does.
    """
    with open(path, "r") as f:
        data = json.load(f)
    out: List[float] = [float(len(data))]
    for key, value in data.items():
        if key == "scene":
            continue
        out.append(float(key))
        out.extend(float(x) for x in value["sigma_s"])
        out.extend(float(x) for x in value["sigma_a"])
        out.extend(float(x) for x in value["g"])
        out.append(float(value["ior"]))
    return np.asarray(out, np.float32)
