"""Per-phase wall timing.

The reference prints exactly two numbers, "CPU setup time" and "GPU render
time" (main.cpp:408-410, with command recording miscounted as GPU time —
SURVEY §5). This replaces them with named phases (load/bvh_build/upload/
render/write) and derived counters; `torch.profiler` traces remain
available for kernel-level work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


class PhaseTimer:
    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self._elapsed[name] = self._elapsed.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def items(self):
        return self._elapsed.items()

    def report(self) -> str:
        return "\n".join(
            f"{name} time: {seconds * 1e3:.1f} ms" for name, seconds in self._elapsed.items()
        )
