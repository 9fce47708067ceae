"""Generate the showcase scene (scenes/showcase.{obj,mtl,json}).

The reference's default scene (studio_corner.obj, utils.hpp:26) is
git-ignored upstream and absent from its repo, so the no-arg default run
fails there (SURVEY C10). The rebuild ships this procedurally generated
studio corner instead: floor + two walls (the checkerboard/Cornell
backgrounds read well on them), a milk sphere, a ruby gem and a glass cube
— covering isotropic-ish dense scattering, high-IOR TIR, and clear
refractive media in one frame (BASELINE.json acceptance configs 2-4).

The port's own copy of complex_materials_renderer_tpu/tools/make_showcase.py
(numpy only): it writes the same bytes.

Run:  python -m complex_materials_renderer_tpu_torch.tools.make_showcase [outdir]
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np


def icosphere(subdiv: int = 2):
    """Unit icosphere (verts, faces)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.asarray(v, np.float64) for v in verts]
    verts = [v / np.linalg.norm(v) for v in verts]

    for _ in range(subdiv):
        cache = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    return np.asarray(verts), np.asarray(faces, np.int64)


def cube():
    v = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    )
    quads = [
        (4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6),
        (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4),
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return v, np.asarray(faces, np.int64)


def rot_y(deg):
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def groups() -> list:
    """The scene's (material name, verts, faces) groups, in file order."""
    groups = []  # (material_name, verts, faces)

    # Studio corner: floor and two walls.
    floor = (
        np.array([[-6, 0, 6], [6, 0, 6], [6, 0, -3], [-6, 0, -3]], np.float64),
        np.array([(0, 1, 2), (0, 2, 3)], np.int64),
    )
    back = (
        np.array([[-6, 0, -3], [6, 0, -3], [6, 6, -3], [-6, 6, -3]], np.float64),
        np.array([(0, 1, 2), (0, 2, 3)], np.int64),
    )
    side = (
        np.array([[-6, 0, 6], [-6, 0, -3], [-6, 6, -3], [-6, 6, 6]], np.float64),
        np.array([(0, 1, 2), (0, 2, 3)], np.int64),
    )
    stage = (
        np.concatenate([floor[0], back[0], side[0]]),
        np.concatenate([floor[1], back[1] + 4, side[1] + 8]),
    )
    groups.append(("studio_walls", *stage))

    sv, sf = icosphere(3)
    groups.append(("milk_sphere", sv * 0.8 + np.array([-1.05, 0.81, 0.2]), sf))

    gv, gf = icosphere(1)
    gv = gv @ rot_y(20).T
    gv[:, 1] *= 1.25  # slightly elongated gem
    groups.append(("ruby_gem", gv * 0.6 + np.array([1.15, 0.76, 0.4]), gf))

    cv, cf = cube()
    cv = cv @ rot_y(30).T
    groups.append(("glass_cube", cv * 0.52 + np.array([0.05, 0.521, -1.0]), cf))
    return groups


def scene_json() -> dict:
    """The scene's .json: camera, light and the three media."""
    # Media definitions use the measured coefficients from the public
    # material dictionary format (sigma per mm; scale=10 means 1 unit=1cm).
    return {
        "scene": {
            "camera": [0.3, 2.6, 9.5],
            "cameraLookAt": [0.0, 0.8, -0.2],
            "fov": 36.0,
            "lightPos": [-1.6, 4.5, 4.2],
            "lightColor": [0.8, 0.8, 0.6],
            "lightIntensity": 100.0,
            "scale": 10.0,
        },
        # material ids follow .mtl definition order: 0 walls (no medium),
        # 1 milk sphere, 2 ruby gem, 3 glass cube.
        "1": {
            "sigma_s": [18.2052, 20.3826, 22.3698],
            "sigma_a": [0.00153, 0.0046, 0.01993],
            "g": [0.75, 0.714, 0.681],
            "ior": 1.33,
        },
        "2": {
            "sigma_s": [0.18, 0.07, 0.03],
            "sigma_a": [0.061, 0.97, 1.45],
            "g": [0.943, 0.953, 0.952],
            "ior": 1.77,
        },
        "3": {
            "sigma_s": [0.00011, 0.00014, 0.00014],
            "sigma_a": [0.00189, 0.00183, 0.002],
            "g": [0.943, 0.953, 0.952],
            "ior": 1.5,
        },
    }


def build(outdir: str):
    os.makedirs(outdir, exist_ok=True)
    groups_ = groups()
    mtl_names = [name for name, _, _ in groups_]
    obj_path = os.path.join(outdir, "showcase.obj")
    with open(obj_path, "w") as f:
        f.write("# showcase scene for complex_materials_renderer_tpu\n")
        f.write("mtllib showcase.mtl\n")
        base = 1
        for name, verts, faces in groups_:
            f.write(f"o {name}\n")
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            f.write(f"usemtl {name}\n")
            for a, b, c in faces:
                f.write(f"f {base + a} {base + b} {base + c}\n")
            base += len(verts)

    with open(os.path.join(outdir, "showcase.mtl"), "w") as f:
        for name in mtl_names:
            f.write(f"newmtl {name}\nKd 0.8 0.8 0.8\n\n")

    with open(os.path.join(outdir, "showcase.json"), "w") as f:
        json.dump(scene_json(), f, indent=4)

    n_tris = sum(len(fc) for _, _, fc in groups_)
    print(f"wrote {obj_path}: {n_tris} triangles, materials {mtl_names}")


if __name__ == "__main__":
    build(sys.argv[1] if len(sys.argv) > 1 else "scenes")
