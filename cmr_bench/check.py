"""How ``correct`` is decided: the program's image at pixels drawn from
the seed against the plain reference's radiance of the same pixels,
worked out again from the scene files, the camera and the configuration's
settings: its stream (``rng``: parity, counter or ld), its direct-light
estimator (``direct``: scatter or analytic) and, with ``spp_mode:
adaptive``, each checked pixel's sample count as the render reports it
(``Renderer.sample_counts``): the reference's pixel is then the mean of
its samples 0 .. count - 1.

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

An adaptive render is also held to its budget, whatever the limits file
says (``budget``): its counts sum to exactly width x height x samples,
and no pixel has fewer than ``MIN_SAMPLES``, 2, the least that the
adaptive rule states for a pixel (a warm-up of at least 2 samples a
pixel; a pixel's variance wants two). The floor is not the warm-up's
share, max(2, min(samples // 4, 32)) a pixel: the program does not give
every pixel that share when a call holds fewer lanes than the frame has
pixels (at 1920x1080, 1,048,576 lanes a call, each warm-up call goes to
the same first pixels in tile order), and its later rounds apportion
each round's lanes to the pixels' deficits by largest remainder, which
brings a pixel near its target share but does not promise it (a run of
the rule at 1920x1080@32 over a field of a few bright pixels ends with
some pixels at 7). So that floor could refuse a sound render.

The counts are the program's own, and the reference renders each
checked pixel at its count: it cannot work them out again without
rendering the whole frame, since the allocation follows every sample's
radiance. A render that spread the same total otherwise, at least 2 a
pixel, and reported the counts it used would pass. How the counts are
spread over the pixels is the program's allocation rule, which this
check does not judge: a Tier-1 test of the repository holds it
byte-equal to the JAX package's (``tests/test_torch_adaptive.py``).
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
MIN_SAMPLES = 2  # an adaptive render's fewest samples a pixel: the rule's least (see above)
RNGS = ("parity", "counter", "ld")
DIRECTS = ("scatter", "analytic")


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
    if opt["rng"] not in RNGS or opt["direct"] not in DIRECTS:
        raise ValueError(f"the reference renders rng {'|'.join(RNGS)} with direct "
                         f"{'|'.join(DIRECTS)}, not {opt['rng']!r} with {opt['direct']!r}")
    return volpath.Settings(max_depth=opt["max_depth"], rr_depth=opt["rr_depth"],
                            nee_max_media=opt["nee_max_media"], tir=opt["tir"],
                            background=opt["background"], rng=opt["rng"],
                            direct=opt["direct"])


def adaptive(cfg: dict) -> bool:
    return cfg["options"].get("spp_mode", "uniform") == "adaptive"


def reference(cfg: dict, traffic: dict, azimuth: float, pixels, device,
              dtype=torch.float64, counts=None) -> np.ndarray:
    """(K, 3) float64: the reference's radiance of ``pixels`` in ``dtype``,
    each pixel over ``counts`` (K,) samples where given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = read_scene(cfg["scene"])
    tables = volpath.Tables(scene, settings(cfg), device, dtype)
    pos = camera_position(scene.camera_pos, scene.look_at, azimuth)
    cam = volpath.make_camera(pos, scene.look_at, scene.fov, tables.device, dtype)
    out = volpath.render_pixels(tables, cam, pixels, traffic["width"], traffic["height"],
                                traffic["samples"], counts)
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


def budget(counts: np.ndarray, traffic: dict) -> dict:
    """An adaptive render's (H, W) sample counts against its budget:
    ``samples_sum`` must equal its limit, the frame's width x height x
    samples, and ``fewest_samples`` reach its limit, ``MIN_SAMPLES``."""
    return {"samples_sum": {"value": int(counts.sum()),
                            "limit": traffic["width"] * traffic["height"] * traffic["samples"]},
            "fewest_samples": {"value": int(counts.min()), "limit": MIN_SAMPLES}}


def judge(numbers: dict, limits: dict, held: dict | None = None) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit, and where ``held`` (``budget``) is given, its sum equal to the
    budget and its fewest samples at least the least."""
    shown = {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    if held is not None:
        ok = (ok and held["samples_sum"]["value"] == held["samples_sum"]["limit"]
              and held["fewest_samples"]["value"] >= held["fewest_samples"]["limit"])
        shown.update(held)
    return ok, shown


def check_image(image: np.ndarray, cfg: dict, traffic: dict, azimuth: float, pixels, device,
                log, counts=None) -> dict:
    """The numbers compared for the program's (H, W, 3) ``image``, rendered
    with the (H, W) sample ``counts`` where given."""
    t0 = time.perf_counter()
    own = None if counts is None else counts[pixels[:, 1], pixels[:, 0]]
    ref = reference(cfg, traffic, azimuth, pixels, device, counts=own)
    spp = traffic["samples"] if own is None else f"{own.sum() / len(own):.3f} (mean)"
    log(f"reference: {len(pixels)} pixels at {spp} spp on {device} in "
        f"{time.perf_counter() - t0:.3f} s")
    return compare(image[pixels[:, 1], pixels[:, 0]], ref)
