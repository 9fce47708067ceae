"""Authoring tool: create the companion media .json for an .obj scene.

Rebuild of the reference's resources/scenes/mat_parser.py (SURVEY C8):
lists the scene's materials, maps chosen ones to participating-media
coefficients — from the bundled material dictionary or manual entry — and
writes ``<scene>.json`` in the format the loader consumes
(scene/media.py, contract at reference model.cpp:44-103).

Improvements over the reference tool: a non-interactive flag mode
(``--material idx=name`` pairs, ``--scene-defaults``) for scripted
pipelines, no pywavefront dependency (uses the framework's own .obj/.mtl
parser), and the dictionary ships inside the package.

The port's counterpart of complex_materials_renderer_tpu/tools/mat_parser.py,
with its own MATERIAL_DICTIONARY and the port's .obj parser; it writes
the same JSON.

Interactive:      python -m complex_materials_renderer_tpu_torch.tools.mat_parser scene.obj
Non-interactive:  ... scene.obj --scene-defaults --material 0=milk --material 2=glass
"""

from __future__ import annotations

import argparse
import json

from ..scene.obj import parse_obj

# Measured/artistic media coefficients (sigma_s / sigma_a per RGB in 1/mm,
# g per RGB, scalar ior) — the standard participating-media values for
# these liquids (Narasimhan et al.-style measurements) plus artistic gems.
MATERIAL_DICTIONARY = {
    "sprite": {
        "sigma_s": [0.00011, 0.00014, 0.00014],
        "sigma_a": [0.00189, 0.00183, 0.002],
        "g": [0.943, 0.953, 0.952],
        "ior": 1.33,
    },
    "coca cola": {
        "sigma_s": [0.00254, 0.00299, 0.0],
        "sigma_a": [0.10014, 0.16503, 0.2468],
        "g": [0.965, 0.972, 0.0],
        "ior": 1.33,
    },
    "apple juice": {
        "sigma_s": [0.00257, 0.00311, 0.00413],
        "sigma_a": [0.01296, 0.02347, 0.05218],
        "g": [0.947, 0.949, 0.945],
        "ior": 1.33,
    },
    "grape juice": {
        "sigma_s": [0.00138, 0.0, 0.0],
        "sigma_a": [0.10404, 0.23958, 0.29325],
        "g": [0.961, 0.0, 0.0],
        "ior": 1.33,
    },
    "budweiser": {
        "sigma_s": [0.00029, 0.00055, 0.00059],
        "sigma_a": [0.01149, 0.02491, 0.05579],
        "g": [0.917, 0.956, 0.982],
        "ior": 1.33,
    },
    "milk": {
        "sigma_s": [18.2052, 20.3826, 22.3698],
        "sigma_a": [0.00153, 0.0046, 0.01993],
        "g": [0.75, 0.714, 0.681],
        "ior": 1.33,
    },
    "presso": {
        "sigma_s": [7.78262, 8.1305, 8.53875],
        "sigma_a": [4.79838, 6.57512, 8.84925],
        "g": [0.907, 0.896, 0.88],
        "ior": 1.33,
    },
    "chardonnay": {
        "sigma_s": [0.00021, 0.00033, 0.00048],
        "sigma_a": [0.01078, 0.01186, 0.024],
        "g": [0.914, 0.958, 0.975],
        "ior": 1.33,
    },
    "emerald (not physically based)": {
        "sigma_s": [0.18, 0.07, 0.03],
        "sigma_a": [0.97, 0.061, 1.45],
        "g": [0.943, 0.953, 0.952],
        "ior": 1.52,
    },
    "ruby (not physically based)": {
        "sigma_s": [0.18, 0.07, 0.03],
        "sigma_a": [0.061, 0.97, 1.45],
        "g": [0.943, 0.953, 0.952],
        "ior": 1.77,
    },
    "glass (not physically based)": {
        "sigma_s": [0.00011, 0.00014, 0.00014],
        "sigma_a": [0.00189, 0.00183, 0.002],
        "g": [0.943, 0.953, 0.952],
        "ior": 1.5,
    },
    "sapphire (not physically based)": {
        "sigma_s": [0.18, 0.07, 0.03],
        "sigma_a": [0.97, 1.45, 0.061],
        "g": [0.943, 0.953, 0.952],
        "ior": 1.77,
    },
}

DEFAULT_SCENE = {
    "camera": [0.0, 1.75, 6.5],
    "cameraLookAt": [0.0, 0.9, 0.0],
    "fov": 36.0,
    "lightPos": [-1.001, 1.75, 5.0],
    "lightColor": [0.8, 0.8, 0.6],
    "lightIntensity": 100.0,
    "scale": 10.0,
}


def _parse_vec(prompt: str, n: int = 3):
    raw = input(prompt)
    vals = [float(x) for x in raw.split(",")]
    if len(vals) != n:
        raise ValueError(f"expected {n} comma-separated values")
    return vals


def _scene_from_input():
    return {
        "camera": _parse_vec("Camera position (x, y, z): "),
        "cameraLookAt": _parse_vec("Camera look-at point (x, y, z): "),
        "fov": float(input("Camera FOV (degrees): ")),
        "lightPos": _parse_vec("Light position (x, y, z): "),
        "lightColor": _parse_vec("Light color (r, g, b): "),
        "lightIntensity": float(input("Light intensity: ")),
        "scale": float(
            input("Scale (1: unit=1mm; 10: unit=1cm; 1000: unit=1m): ")
        ),
    }


def _medium_from_input():
    entry = {
        "sigma_s": _parse_vec("RGB scattering sigma_s (r, g, b): "),
        "sigma_a": _parse_vec("RGB absorption sigma_a (r, g, b): "),
    }
    g_raw = input("RGB anisotropy g (blank for isotropic): ").strip()
    entry["g"] = [float(x) for x in g_raw.split(",")] if g_raw else [0.0, 0.0, 0.0]
    entry["ior"] = float(input("Index of refraction: "))
    return entry


def _resolve_dictionary_name(name: str):
    if name in MATERIAL_DICTIONARY:
        return MATERIAL_DICTIONARY[name]
    matches = [k for k in MATERIAL_DICTIONARY if k.startswith(name)]
    if len(matches) == 1:
        return MATERIAL_DICTIONARY[matches[0]]
    raise KeyError(f"unknown material '{name}'; options: {list(MATERIAL_DICTIONARY)}")


def run_interactive(obj_path: str, out_path: str) -> None:
    mesh = parse_obj(obj_path)
    doc = {}
    if input("Use default scene settings? (y/n): ").strip() == "y":
        doc["scene"] = dict(DEFAULT_SCENE)
    else:
        doc["scene"] = _scene_from_input()

    while True:
        print("Found materials:")
        for i, name in enumerate(mesh.material_names):
            print(f"{i}: {name}")
        choice = input("Index of material to turn into a medium: ").strip()
        if input("Use a predefined material? (y/n): ").strip() == "y":
            print("Available materials:")
            keys = list(MATERIAL_DICTIONARY)
            for i, k in enumerate(keys):
                print(f"{i}: {k}")
            pick = keys[int(input("Index of the material to use: "))]
            doc[str(int(choice))] = dict(MATERIAL_DICTIONARY[pick])
        else:
            doc[str(int(choice))] = _medium_from_input()
        if input("Change another material into a medium? (y/n): ").strip() == "n":
            break

    with open(out_path, "w") as f:
        json.dump(doc, f, indent=4)
    print(f"wrote {out_path}")


def run_batch(obj_path: str, out_path: str, assignments, scene_defaults: bool) -> None:
    mesh = parse_obj(obj_path)
    # Batch mode always writes a scene block (the loader requires one for
    # camera placement); --scene-defaults documents the intent explicitly.
    del scene_defaults
    doc = {"scene": dict(DEFAULT_SCENE)}
    for spec in assignments:
        idx, _, name = spec.partition("=")
        idx = int(idx)
        if idx < 0 or (mesh.material_names and idx >= len(mesh.material_names)):
            raise IndexError(
                f"material index {idx} out of range for {mesh.material_names}"
            )
        doc[str(idx)] = dict(_resolve_dictionary_name(name))
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=4)
    print(f"wrote {out_path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("obj", help=".obj scene file")
    parser.add_argument("--out", default=None, help="output json path")
    parser.add_argument(
        "--material",
        action="append",
        default=[],
        help="non-interactive: idx=dictionary-name (repeatable)",
    )
    parser.add_argument("--scene-defaults", action="store_true")
    parser.add_argument(
        "--list-materials", action="store_true", help="print the dictionary and exit"
    )
    args = parser.parse_args(argv)

    if args.list_materials:
        print(json.dumps(MATERIAL_DICTIONARY, indent=2))
        return 0

    out = args.out or args.obj.rsplit(".", 1)[0] + ".json"
    if args.material:
        run_batch(args.obj, out, args.material, args.scene_defaults)
    else:
        run_interactive(args.obj, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
