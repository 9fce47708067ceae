"""Media table (numpy only).

Counterpart of ``MediaTable`` in complex_materials_renderer_tpu/ops/medium.py
:27, kept here because that module imports ``jax.numpy``. The layout
mirrors the reference's packed media buffer (model.cpp:49) as SoA arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MediaTable(NamedTuple):
    """SoA media definitions. ``mat_id`` uses -1 padding for empty slots."""

    mat_id: np.ndarray  # (M,) int32
    sigma_s: np.ndarray  # (M, 3) float32, unscaled
    sigma_a: np.ndarray  # (M, 3) float32, unscaled
    g: np.ndarray  # (M, 3) float32
    ior: np.ndarray  # (M,) float32
