"""Golden-image corpus: configs, generator and the gate constants.

Counterpart of complex_materials_renderer_tpu/tools/goldens.py. The
committed corpus ``tests/golden/*.npz`` was rendered by the JAX package
(parity RNG, its CPU backend, threaded-BVH traversal) and is the oracle
the port is held to: ``load_golden`` reads it, and the port's renders pass
the flip-budgeted gate against it (tests/test_torch_cli.py,
tests/test_torch_tools.py). ``render_golden`` renders a golden
configuration with the port's Renderer (64x64, parity, ``--backend bvh``),
on ``cuda`` unless the caller asks for the CPU.

``generate`` writes the port's own renders of the corpus to the directory
the caller names (``build/goldens`` by default, git-ignored), never to
``tests/golden/``:

    python -m complex_materials_renderer_tpu_torch.tools.goldens [names...] [--out DIR]

The JAX tool's three configs of scenes outside the repository
(gem_corner, stanford_dragon and cup) are not here: their goldens are
committed, their scenes are not (ROADMAP R3).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
_SCENES = os.path.join(_REPO, "scenes")

# name -> (obj path, spp). 64x64, parity RNG, bvh backend.
GOLDEN_CONFIGS = {
    "showcase": (os.path.join(_SCENES, "showcase.obj"), 4),
    # The gate of the bench at 32 spp: a decision flip perturbs one sample
    # of a pixel's mean, so more samples shrink its share of the RMSE.
    "showcase_gate": (os.path.join(_SCENES, "showcase.obj"), 32),
    "isobox": (os.path.join(_SCENES, "isobox.obj"), 2),
    "gembox": (os.path.join(_SCENES, "gembox.obj"), 2),
    "vessel": (os.path.join(_SCENES, "vessel.obj"), 2),
}

GOLDEN_DIR = os.path.join(_REPO, "tests", "golden")  # the JAX package's corpus: read only
OUT_DIR = os.path.join(_REPO, "build", "goldens")  # generate's default
GOLDEN_RES = 64
GOLDEN_ATOL = 1e-5  # same-backend float-noise allowance
GOLDEN_RMSE = 1e-3  # BASELINE.json cross-backend oracle


def render_golden(obj_path: str, spp: int, device=None) -> np.ndarray:
    """Render a golden-config frame (64x64, parity RNG, the BVH backend;
    the scene JSON still sets camera and lights) on ``device`` (default
    ``cuda``)."""
    from ..config import RenderOptions
    from ..renderer import Renderer
    from ..scene import load_scene

    kw = dict(width=GOLDEN_RES, height=GOLDEN_RES, num_samples=spp, shard="none",
              backend="bvh", rng="parity")
    opt = RenderOptions(obj_path=obj_path, **kw)
    scene = load_scene(obj_path, opt)
    opts = dataclasses.replace(scene.options, **kw)
    return np.asarray(Renderer(scene, opts, device=device).render())


def golden_path(name: str) -> str:
    """The committed golden of ``name`` (tests/golden)."""
    return os.path.join(GOLDEN_DIR, f"{name}.npz")


def load_golden(name: str) -> np.ndarray | None:
    path = golden_path(name)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return np.asarray(z["img"], np.float32)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def generate(names=None, out_dir: str = OUT_DIR, device=None) -> list:
    """Render the configs ``names`` (all by default) into ``out_dir`` as
    ``<name>.npz``; returns the paths written. ``tests/golden/`` is
    refused: it holds the JAX package's oracle."""
    out_dir = os.path.abspath(out_dir)
    if os.path.realpath(out_dir) == os.path.realpath(GOLDEN_DIR):
        raise ValueError(f"{out_dir} holds the JAX package's goldens; name another directory")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, (path, spp) in GOLDEN_CONFIGS.items():
        if names and name not in names:
            continue
        img = render_golden(path, spp, device=device)
        out = os.path.join(out_dir, f"{name}.npz")
        np.savez_compressed(out, img=img.astype(np.float32), spp=spp, res=GOLDEN_RES)
        written.append(out)
        print(f"{name}: mean={img.mean():.5f} std={img.std():.5f} -> {out}")
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("names", nargs="*", help="configs to render (default: all)")
    parser.add_argument("--out", default=OUT_DIR, help=f"output directory (default {OUT_DIR})")
    args = parser.parse_args(argv)
    # Goldens are deterministic CPU renders, as the JAX tool's __main__
    # forces its CPU platform.
    generate(set(args.names) or None, args.out, device="cpu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
