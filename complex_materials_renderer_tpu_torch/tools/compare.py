"""Image comparison tool: RMSE between two renders.

The parity oracle for this rebuild is RMSE <= 1e-3 against a reference
render at equal spp (BASELINE.json; bit equality is impossible across
traversal orders/hardware). This tool computes it for .hdr files.

The port's counterpart of complex_materials_renderer_tpu/tools/compare.py,
reading the files with the port's ``io.read_hdr``.

Usage: python -m complex_materials_renderer_tpu_torch.tools.compare a.hdr b.hdr
Exit code 0 if RMSE <= threshold (default 1e-3), 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..io import read_hdr


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def compare(path_a: str, path_b: str) -> dict:
    a = read_hdr(path_a)
    b = read_hdr(path_b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    diff = np.abs(a.astype(np.float64) - b)
    return {
        "rmse": rmse(a, b),
        "max_abs": float(diff.max()),
        "mean_a": float(a.mean()),
        "mean_b": float(b.mean()),
        "shape": list(a.shape),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--threshold", type=float, default=1e-3)
    args = parser.parse_args(argv)
    stats = compare(args.a, args.b)
    stats["threshold"] = args.threshold
    stats["pass"] = stats["rmse"] <= args.threshold
    print(json.dumps(stats))
    return 0 if stats["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
