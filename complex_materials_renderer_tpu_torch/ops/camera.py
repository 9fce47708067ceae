"""Pinhole camera ray generation (counterpart of
complex_materials_renderer_tpu/ops/camera.py, reference
volpath.comp.glsl:575-601): look-at basis from a world-up cross product,
aspect-preserving screen UV with flipped y, and the reference's
``fovRad = 2*pi - radians(fov)`` forward-vector scale, kept as-is for
image parity.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

TWOPI = 6.28318530718


class Camera(NamedTuple):
    origin: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    fov_scale: torch.Tensor  # scalar: 2*pi - radians(fov)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, summed in x, y, z order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def make_camera(position, look_at, fov_degrees, device="cpu") -> Camera:
    origin = torch.as_tensor(np.asarray(position, np.float32), device=device)
    look = torch.as_tensor(np.asarray(look_at, np.float32), device=device)
    forward = look - origin
    forward = forward / _norm3(forward)
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)
    right = torch.linalg.cross(forward, world_up)
    right = right / _norm3(right)
    up = torch.linalg.cross(right, forward)
    up = up / _norm3(up)
    # deg2rad as a float32 product with the rounded pi/180, as jnp does.
    rad = np.float32(fov_degrees) * np.float32(np.pi / 180)
    fov_scale = torch.tensor(np.float32(TWOPI) - rad, device=device)
    return Camera(origin, forward, right, up, fov_scale)


def generate_rays(
    camera: Camera,
    pixel_xy: torch.Tensor,  # (R, 2) integer pixel coordinates (x, y)
    jitter: torch.Tensor,  # (R, 2) uniforms in [0, 1]
    resolution: Tuple[int, int],  # (width, height)
):
    """Primary ray origins/directions for jittered pixel samples
    (volpath:593-601)."""
    width, height = resolution
    px = pixel_xy[..., 0].to(torch.float32) + jitter[..., 0]
    py = pixel_xy[..., 1].to(torch.float32) + jitter[..., 1]
    u = (2.0 * px - width) / height
    v = -(2.0 * py - height) / height
    direction = (
        u[..., None] * camera.right
        + v[..., None] * camera.up
        + camera.fov_scale * camera.forward
    )
    direction = direction / _norm3(direction)[..., None]
    origin = camera.origin.expand(direction.shape)
    return origin, direction
