"""How ``correct`` is decided: the program's image at pixels drawn from
the seed against the plain reference's radiance of the same pixels,
worked out again from the scene files, the camera and the configuration's
settings.

Each checked pixel's error is its largest channel's gap over the larger of
the reference's largest channel and ``FLOOR``: relative for lit pixels,
absolute in units of FLOOR for dark ones; a pixel that is not finite has
the error ``ERR_CAP``. Two numbers are compared, each with a limit of its own
from the cell's ``limits/<cell>.json``:

- ``flip_pct``: the share of checked pixels whose error passes ``FLIP``.
  A decision that float rounding turns the other way (a Fresnel or
  roulette draw against its threshold, a hit at an edge) sends one sample
  down another path and, in parity mode, every later sample of that pixel
  onto other draws, so a few pixels of a sound render read far off.
- ``median_err``: the median error over the checked pixels whose
  reference is not zero; rounding alone leaves it near float32's epsilon.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .reference import volpath
from .reference.scene import read_scene

FLOOR = 0.01
FLIP = 1e-3
ERR_CAP = 1e30  # the error of a pixel that is not finite: a number, so the line stays JSON


def camera_position(position, look_at, azimuth_deg: float) -> tuple:
    """``position`` turned about the vertical axis through ``look_at``."""
    a = math.radians(azimuth_deg)
    x, y, z = (float(p) - float(q) for p, q in zip(position, look_at))
    c, s = math.cos(a), math.sin(a)
    return (look_at[0] + c * x + s * z, look_at[1] + y, look_at[2] - s * x + c * z)


def draws(seed: int, traffic: dict) -> tuple:
    """(camera azimuth in degrees, (K, 2) checked pixels as x, y): the
    run's camera within the traffic's azimuth range, and distinct pixels
    of the frame, each from its own stream of the seed."""
    span = float(traffic["camera_azimuth_deg"])
    azimuth = float(np.random.default_rng([seed, 0]).uniform(-span, span))
    w, h = traffic["width"], traffic["height"]
    k = min(int(traffic["check_pixels"]), w * h)
    idx = np.sort(np.random.default_rng([seed, 1]).choice(w * h, size=k, replace=False))
    return azimuth, np.stack([idx % w, idx // w], axis=1)


def settings(cfg: dict) -> volpath.Settings:
    opt = cfg["options"]
    if opt.get("rng") != "parity" or opt.get("direct") != "scatter":
        raise ValueError("the reference renders parity RNG with the scatter estimator only")
    return volpath.Settings(max_depth=opt["max_depth"], rr_depth=opt["rr_depth"],
                            nee_max_media=opt["nee_max_media"], tir=opt["tir"],
                            background=opt["background"])


def reference(cfg: dict, traffic: dict, azimuth: float, pixels, device,
              dtype=torch.float64) -> np.ndarray:
    """(K, 3) float64: the reference's radiance of ``pixels`` in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = read_scene(cfg["scene"])
    tables = volpath.Tables(scene, settings(cfg), device, dtype)
    pos = camera_position(scene.camera_pos, scene.look_at, azimuth)
    cam = volpath.make_camera(pos, scene.look_at, scene.fov, tables.device, dtype)
    out = volpath.render_pixels(tables, cam, pixels, traffic["width"], traffic["height"],
                                traffic["samples"])
    return out.to(torch.float64).cpu().numpy()


def compare(program: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers compared, of (K, 3) program and reference values."""
    program = np.asarray(program, np.float64)
    ref = np.asarray(ref, np.float64)
    top = np.abs(ref).max(axis=-1)
    with np.errstate(invalid="ignore"):
        err = np.abs(program - ref).max(axis=-1) / np.maximum(top, FLOOR)
    err = np.where(np.isfinite(program).all(axis=-1) & np.isfinite(err), err, ERR_CAP)
    lit = top > 0
    return {"flip_pct": float(100.0 * (err > FLIP).mean()),
            "median_err": float(np.median(err[lit])) if lit.any() else ERR_CAP}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown


def check_image(image: np.ndarray, cfg: dict, traffic: dict, azimuth: float, pixels, device,
                log) -> dict:
    """The numbers compared for the program's (H, W, 3) ``image``."""
    t0 = time.perf_counter()
    ref = reference(cfg, traffic, azimuth, pixels, device)
    log(f"reference: {len(pixels)} pixels at {traffic['samples']} spp on {device} in "
        f"{time.perf_counter() - t0:.3f} s")
    return compare(image[pixels[:, 1], pixels[:, 0]], ref)
