"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.
With no card and no such request they raise: nothing falls back to the
CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return dev
