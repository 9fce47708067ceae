"""The control of a cell's correctness check: the plain reference put in
the program's place and computed in the nearest precision below the
float32 the configurations state (bfloat16: the program's float32 work
is no matrix product that TF32 would touch), compared with the float64
reference by the check's own numbers. A sound check reads it as not
correct.

    python3 -m cmr_bench.control --workload <name> --seeds <a,b,c> [--dtype bfloat16]

Each seed draws the camera and the checked pixels as a run with that seed
does (``check.draws``), at the cell's own frame and sample count, and both
sides render the configuration's stream and direct-light estimator. Under
``spp_mode: adaptive`` both sides render each checked pixel at a count of
its own (``control_counts``): ``check.MIN_SAMPLES`` each, and the rest of
K x samples (K checked pixels) spread over them by one multinomial draw
with weights exp(N(0, 1)), a heavy tail as a noise-driven allocation has,
all from the seed's stream 2 (``numpy.random.default_rng([seed, 2])``):
the counts' mean is the budget's, ``samples`` a pixel. One JSON
line a seed: the numbers, and ``correct`` as the cell's limits judge them.
It runs on the first card, or with ``--device cpu`` on the CPU. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import check, spec


def control_counts(seed: int, k: int, samples: int) -> np.ndarray:
    """(k,) per-pixel sample counts of mean ``samples``, at least
    ``check.MIN_SAMPLES`` each (the module's docstring says how)."""
    rng = np.random.default_rng([seed, 2])
    w = np.exp(rng.standard_normal(k))
    extra = rng.multinomial(k * max(samples - check.MIN_SAMPLES, 0), w / w.sum())
    return check.MIN_SAMPLES + extra


def control_numbers(cfg: dict, traffic: dict, seed: int, device, dtype) -> dict:
    azimuth, pixels = check.draws(seed, traffic)
    counts = (control_counts(seed, len(pixels), traffic["samples"]) if check.adaptive(cfg)
              else None)
    ref = check.reference(cfg, traffic, azimuth, pixels, device, counts=counts)
    low = check.reference(cfg, traffic, azimuth, pixels, device, dtype=dtype, counts=counts)
    return check.compare(low, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(cfg, traffic, seed, args.device, getattr(torch, args.dtype))
        correct, shown = check.judge(numbers, limits)
        print(json.dumps({"workload": cell["name"], "seed": seed, "dtype": args.dtype,
                          "correct": correct, "checks": shown,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
