"""Vector helpers over a last axis of size 3, summed in x, y, z order as
the JAX package's reductions over that axis are (``jnp.sum``,
``jnp.linalg.norm``, ``jnp.cross``)."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """``v / max(|v|, 1e-20)``."""
    return v / torch.clamp(norm(v), min=1e-20)[..., None]
