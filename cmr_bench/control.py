"""The control of a cell's correctness check: the plain reference put in
the program's place and computed in the nearest precision below the
float32 the configurations state (bfloat16: the program's float32 work
is no matrix product that TF32 would touch), compared with the float64
reference by the check's own numbers. A sound check reads it as not
correct.

    python3 -m cmr_bench.control --workload <name> --seeds <a,b,c> [--dtype bfloat16]

Each seed draws the camera and the checked pixels as a run with that seed
does (``check.draws``), at the cell's own frame and sample count. One JSON
line a seed: the numbers, and ``correct`` as the cell's limits judge them.
It runs on the first card, or with ``--device cpu`` on the CPU. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import check, spec


def control_numbers(cfg: dict, traffic: dict, seed: int, device, dtype) -> dict:
    azimuth, pixels = check.draws(seed, traffic)
    ref = check.reference(cfg, traffic, azimuth, pixels, device)
    low = check.reference(cfg, traffic, azimuth, pixels, device, dtype=dtype)
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
