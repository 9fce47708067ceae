"""Generate the auxiliary benchmark/fixture scenes.

Two procedurally generated scenes complement the showcase
(tools/make_showcase.py), covering the BASELINE.json acceptance regimes
that the showcase exercises only lightly, and standing in for the
reference's cup/gem_corner assets so the test suite never has to skip on
a bare checkout (reference scenes stay optional extras):

- vessel.{obj,mtl,json}: a lathed cup (glass walls) filled with a presso
  coffee body — the dense, high-extinction, deep-bounce regime that
  dominated the reference's cup.obj workload (reference cup.json media).
  ~9k triangles.
- gembox.{obj,mtl,json}: a Cornell-style box with ruby/emerald/sapphire
  icospheres (ior 1.52-1.77) — the TIR-heavy anisotropic multi-media
  regime (reference gem_corner.json media).

And the many-cluster scene, which only the port's copy writes:

- showcase_tiled_<a>x<b>.{obj,mtl,json} (``build_tiled``): showcase's
  triangles, materials and media tiled a x b (16 x 16: 352,768 triangles)
  on the ground plane, each tile jittered, seen from above tile 0's corner
  across the tiles toward the middle of the 16 x 16 grid, lit by one
  point light above and behind the camera. The port's benchmark renders
  the 16 x 16 tiling, and its card checks the 16 x 16 and smaller tilings.

The port's own copy of complex_materials_renderer_tpu/tools/make_scenes.py
(numpy only): it writes the same bytes.

Run:  python -m complex_materials_renderer_tpu_torch.tools.make_scenes [outdir]
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

from . import make_showcase
from .make_showcase import build as build_showcase
from .make_showcase import icosphere, rot_y

# The many-cluster scene (``build_tiled``): showcase tiled TILES on the
# ground plane at TILE_PITCH (showcase's floor is 12 x 9), each tile shifted
# by a jitter in [0, 0.5) along x and z drawn from TILE_SEED, seen from
# TILED_EYE (above tile 0's corner) toward the middle of the grid
# (``tiled_look_at``) and lit by TILED_LIGHT (position, intensity; the
# colour is showcase's). Both stand above showcase's walls (6 high): from a
# camera among them, a turn of the view by a degree or two hides the tiles
# behind a wall, and showcase's own light, below the walls' tops, reaches
# little beyond its own tile.
TILES = (16, 16)
TILE_PITCH = (12.5, 9.5)
TILE_SEED = 6
TILED_EYE = (-20.0, 40.0, 30.0)
TILED_LIGHT = ((-40.0, 80.0, 50.0), 200000.0)


def tiled_look_at(tiles=TILES) -> tuple:
    """The middle of the tiles' grid on the ground plane."""
    return (TILE_PITCH[0] * (tiles[0] - 1) / 2, 0.0, -TILE_PITCH[1] * (tiles[1] - 1) / 2)

# Coefficients from the public material dictionary (mat_parser.py):
PRESSO = {
    "sigma_s": [7.78262, 8.1305, 8.53875],
    "sigma_a": [4.79838, 6.57512, 8.84925],
    "g": [0.907, 0.896, 0.88],
    "ior": 1.33,
}
GLASS = {
    "sigma_s": [0.00011, 0.00014, 0.00014],
    "sigma_a": [0.00189, 0.00183, 0.002],
    "g": [0.943, 0.953, 0.952],
    "ior": 1.5,
}
RUBY = {
    "sigma_s": [0.18, 0.07, 0.03],
    "sigma_a": [0.061, 0.97, 1.45],
    "g": [0.943, 0.953, 0.952],
    "ior": 1.77,
}
EMERALD = {
    "sigma_s": [0.18, 0.07, 0.03],
    "sigma_a": [0.97, 0.061, 1.45],
    "g": [0.943, 0.953, 0.952],
    "ior": 1.52,
}
SAPPHIRE = {
    "sigma_s": [0.18, 0.07, 0.03],
    "sigma_a": [0.97, 1.45, 0.061],
    "g": [0.943, 0.953, 0.952],
    "ior": 1.77,
}


def lathe(profile, segments: int = 64, cap_start=True, cap_end=True):
    """Revolve an (r, y) profile polyline around the y axis.

    Returns (verts, faces). Degenerate rings (r == 0) collapse to a
    single apex vertex; caps close the first/last rings when r > 0.
    """
    profile = np.asarray(profile, np.float64)
    rings = []
    verts = []
    for r, y in profile:
        if r <= 1e-9:
            verts.append((0.0, y, 0.0))
            rings.append((len(verts) - 1, None))
        else:
            start = len(verts)
            for s in range(segments):
                a = 2.0 * math.pi * s / segments
                verts.append((r * math.cos(a), y, r * math.sin(a)))
            rings.append((start, segments))
    faces = []
    for (s0, n0), (s1, n1) in zip(rings[:-1], rings[1:]):
        if n0 is None and n1 is None:
            continue
        if n0 is None:  # apex -> ring fan
            for s in range(n1):
                faces.append((s0, s1 + (s + 1) % n1, s1 + s))
        elif n1 is None:  # ring -> apex fan
            for s in range(n0):
                faces.append((s0 + s, s0 + (s + 1) % n0, s1))
        else:
            for s in range(n0):
                a = s0 + s
                b = s0 + (s + 1) % n0
                c = s1 + (s + 1) % n1
                d = s1 + s
                faces.append((a, b, c))
                faces.append((a, c, d))

    def cap(ring, flip):
        start, n = ring
        if n is None:
            return
        center = len(verts)
        ys = [verts[start + s][1] for s in range(n)]
        verts.append((0.0, float(np.mean(ys)), 0.0))
        for s in range(n):
            a = start + s
            b = start + (s + 1) % n
            faces.append((a, center, b) if flip else (a, b, center))

    if cap_start:
        cap(rings[0], flip=True)
    if cap_end:
        cap(rings[-1], flip=False)
    return np.asarray(verts), np.asarray(faces, np.int64)


def _write_obj(outdir, name, groups, scene_json):
    obj_path = os.path.join(outdir, f"{name}.obj")
    with open(obj_path, "w") as f:
        f.write(f"# generated scene: {name}\n")
        f.write(f"mtllib {name}.mtl\n")
        base = 1
        for gname, verts, faces in groups:
            f.write(f"o {gname}\n")
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            f.write(f"usemtl {gname}\n")
            for a, b, c in faces:
                f.write(f"f {base + a} {base + b} {base + c}\n")
            base += len(verts)
    with open(os.path.join(outdir, f"{name}.mtl"), "w") as f:
        for gname, _, _ in groups:
            f.write(f"newmtl {gname}\nKd 0.8 0.8 0.8\n\n")
    with open(os.path.join(outdir, f"{name}.json"), "w") as f:
        json.dump(scene_json, f, indent=4)
    n_tris = sum(len(fc) for _, _, fc in groups)
    print(f"wrote {obj_path}: {n_tris} triangles")
    return obj_path


def build_vessel(outdir: str):
    """Cup of coffee: glass lathed vessel + presso liquid body + floor."""
    os.makedirs(outdir, exist_ok=True)
    groups = []

    floor = (
        np.array([[-5, 0, 5], [5, 0, 5], [5, 0, -5], [-5, 0, -5]], np.float64),
        np.array([(0, 1, 2), (0, 2, 3)], np.int64),
    )
    groups.append(("floor", *floor))

    # Cup: outer wall up, rim, inner wall down, inner bottom.
    outer = [(0.0, 0.04), (0.55, 0.04), (0.72, 0.25), (0.80, 1.05),
             (0.82, 1.45), (0.83, 1.50)]
    inner = [(0.76, 1.50), (0.75, 1.10), (0.68, 0.35), (0.0, 0.28)]
    profile = outer + inner
    cv, cf = lathe(profile, segments=96, cap_start=False, cap_end=False)
    groups.append(("cup_glass", cv, cf))

    # Coffee body fills the cup interior up to just below the rim.
    coffee_profile = [(0.0, 0.30), (0.665, 0.37), (0.73, 1.08), (0.0, 1.30)]
    bv, bf = lathe(coffee_profile, segments=96, cap_start=False, cap_end=False)
    groups.append(("coffee", bv, bf))

    scene_json = {
        "scene": {
            "camera": [0.1, 2.1, 4.6],
            "cameraLookAt": [0.0, 0.85, 0.0],
            "fov": 36.0,
            "lightPos": [-1.4, 3.6, 2.8],
            "lightColor": [0.8, 0.8, 0.6],
            "lightIntensity": 60.0,
            "scale": 10.0,
        },
        # mat ids by .mtl order: 0 floor, 1 cup_glass, 2 coffee
        "1": GLASS,
        "2": PRESSO,
    }
    return _write_obj(outdir, "vessel", groups, scene_json)


def build_gembox(outdir: str):
    """Cornell-style box with three gem icospheres (TIR-heavy media)."""
    os.makedirs(outdir, exist_ok=True)
    groups = []

    def q(p0, p1, p2, p3):
        return (
            np.asarray([p0, p1, p2, p3], np.float64),
            np.array([(0, 1, 2), (0, 2, 3)], np.int64),
        )

    walls_v = []
    walls_f = []
    for verts, faces in [
        q([-2, 0, 2], [2, 0, 2], [2, 0, -2], [-2, 0, -2]),  # floor
        q([-2, 0, -2], [2, 0, -2], [2, 4, -2], [-2, 4, -2]),  # back
        q([-2, 0, 2], [-2, 0, -2], [-2, 4, -2], [-2, 4, 2]),  # left (+x normal)
        q([2, 0, -2], [2, 0, 2], [2, 4, 2], [2, 4, -2]),  # right (-x normal)
        q([-2, 4, -2], [2, 4, -2], [2, 4, 2], [-2, 4, 2]),  # ceiling
    ]:
        base = len(walls_v)
        walls_v.extend(verts)
        walls_f.extend(faces + base)
    groups.append(("box_walls", np.asarray(walls_v), np.asarray(walls_f)))

    gv, gf = icosphere(2)
    groups.append(("ruby", gv * 0.5 @ rot_y(15).T + np.array([-0.9, 0.51, 0.3]), gf))
    groups.append(("emerald", gv * 0.42 @ rot_y(40).T + np.array([0.75, 0.43, -0.4]), gf))
    groups.append(("sapphire", gv * 0.58 @ rot_y(70).T + np.array([0.1, 0.59, 0.9]), gf))

    scene_json = {
        "scene": {
            "camera": [0.0, 1.6, 5.6],
            "cameraLookAt": [0.0, 0.9, 0.0],
            "fov": 36.0,
            "lightPos": [0.0, 3.6, 1.2],
            "lightColor": [0.8, 0.8, 0.6],
            "lightIntensity": 80.0,
            "scale": 10.0,
        },
        # mat ids by .mtl order: 0 walls, 1 ruby, 2 emerald, 3 sapphire
        "1": RUBY,
        "2": EMERALD,
        "3": SAPPHIRE,
    }
    return _write_obj(outdir, "gembox", groups, scene_json)


def build_isobox(outdir: str):
    """Homogeneous isotropic medium cube over a floor (BASELINE config 2:
    g = 0, moderate extinction, high albedo)."""
    os.makedirs(outdir, exist_ok=True)
    groups = []
    floor = (
        np.array([[-5, 0, 5], [5, 0, 5], [5, 0, -5], [-5, 0, -5]], np.float64),
        np.array([(0, 1, 2), (0, 2, 3)], np.int64),
    )
    groups.append(("floor", *floor))

    v = np.array(
        [
            [-1, 0.2, -1], [1, 0.2, -1], [1, 2.2, -1], [-1, 2.2, -1],
            [-1, 0.2, 1], [1, 0.2, 1], [1, 2.2, 1], [-1, 2.2, 1],
        ],
        np.float64,
    )
    quads = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6), (0, 4, 7, 3),
             (7, 6, 2, 3), (0, 1, 5, 4)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    groups.append(("iso_medium", v, np.asarray(faces, np.int64)))

    scene_json = {
        "scene": {
            "camera": [0.2, 2.3, 5.4],
            "cameraLookAt": [0.0, 1.1, 0.0],
            "fov": 36.0,
            "lightPos": [-1.8, 4.2, 3.2],
            "lightColor": [0.8, 0.8, 0.6],
            "lightIntensity": 90.0,
            "scale": 10.0,
        },
        # isotropic, high-albedo, moderate extinction
        "1": {
            "sigma_s": [0.9, 0.95, 1.0],
            "sigma_a": [0.02, 0.02, 0.02],
            "g": [0.0, 0.0, 0.0],
            "ior": 1.33,
        },
    }
    return _write_obj(outdir, "isobox", groups, scene_json)


def tile_offsets(tiles=TILES) -> np.ndarray:
    """(tiles[0] * tiles[1], 3) float32 offsets of the tiles, tile (i, j)
    at row i * tiles[1] + j."""
    rs = np.random.default_rng(TILE_SEED)
    return np.asarray([(TILE_PITCH[0] * i + rs.uniform(0.0, 0.5), 0.0,
                        -TILE_PITCH[1] * j - rs.uniform(0.0, 0.5))
                       for i in range(tiles[0]) for j in range(tiles[1])], np.float32)


def build_tiled(outdir: str, tiles=TILES) -> str:
    """Write showcase_tiled_<a>x<b>.{obj,mtl,json} to ``outdir``: showcase's
    groups once a tile, tile by tile (``tile_offsets``), each vertex the
    float32 sum of showcase's vertex as its .obj reads (6 decimals) and the
    tile's offset, written with 9 significant digits so that it reads back
    bit-equal; faces by indices relative to the group's vertices. The .mtl
    is showcase's; the .json is showcase's with the camera at TILED_EYE
    looking at ``tiled_look_at(tiles)``, and TILED_LIGHT as the light's
    position and intensity. Returns the .obj's path."""
    os.makedirs(outdir, exist_ok=True)
    name = f"showcase_tiled_{tiles[0]}x{tiles[1]}"
    groups = [(g, np.asarray([[float(f"{x:.6f}") for x in v] for v in verts], np.float32),
               faces) for g, verts, faces in make_showcase.groups()]
    obj_path = os.path.join(outdir, f"{name}.obj")
    lines = [f"# generated scene: {name}: showcase tiled {tiles[0]} x {tiles[1]}\n",
             f"mtllib {name}.mtl\n"]
    offsets = tile_offsets(tiles)
    for t, off in enumerate(offsets):
        for gname, verts, faces in groups:
            lines.append(f"o {gname}_{t}\n")
            lines += [f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in (verts + off).tolist()]
            lines.append(f"usemtl {gname}\n")
            rel = faces - len(verts)
            lines += [f"f {a} {b} {c}\n" for a, b, c in rel.tolist()]
    with open(obj_path, "w") as f:
        f.writelines(lines)
    with open(os.path.join(outdir, f"{name}.mtl"), "w") as f:
        for gname, _, _ in groups:
            f.write(f"newmtl {gname}\nKd 0.8 0.8 0.8\n\n")
    scene_json = make_showcase.scene_json()
    scene_json["scene"]["camera"] = list(TILED_EYE)
    scene_json["scene"]["cameraLookAt"] = list(tiled_look_at(tiles))
    scene_json["scene"]["lightPos"] = list(TILED_LIGHT[0])
    scene_json["scene"]["lightIntensity"] = TILED_LIGHT[1]
    with open(os.path.join(outdir, f"{name}.json"), "w") as f:
        json.dump(scene_json, f, indent=4)
    n_tris = len(offsets) * sum(len(fc) for _, _, fc in groups)
    print(f"wrote {obj_path}: {n_tris} triangles")
    return obj_path


def build_all(outdir: str):
    build_showcase(outdir)
    build_vessel(outdir)
    build_gembox(outdir)
    build_isobox(outdir)


if __name__ == "__main__":
    build_all(sys.argv[1] if len(sys.argv) > 1 else "scenes")
