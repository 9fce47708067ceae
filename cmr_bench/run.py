"""Run one cell of the port's benchmark once.

    python3 -m cmr_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up loads the configuration's scene, builds one ``Renderer`` of
``complex_materials_renderer_tpu_torch`` with the configuration's settings
and the traffic's frame, at a camera drawn from the seed, and renders once
with every tile call after the first of its shape skipped
(``tracing.WarmShapes``): that captures every graph the window replays.
The window is a closed loop of one client: renders start until
``--seconds`` have passed, each when the last returned its image, and it
ends when the last one returns. Then the memory peak is read, the
program's state let go, and the last image judged against the plain
reference at pixels drawn from the seed (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, each from ``metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.

Exit codes: 4 without the cards the cell asks for, 5 when JAX or the JAX
package is loaded once the window has closed; no result is printed then.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

EXIT_NO_CARDS = 4
EXIT_JAX = 5
BANNED = ("jax", "jaxlib", "flax", "complex_materials_renderer_tpu")


def log(msg: str) -> None:
    print(f"[cmr_bench {time.perf_counter() - T0:8.3f} s] {msg}", file=sys.stderr, flush=True)


def banned_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _visible_cards(chips: int) -> None:
    """Show the process the first ``chips`` cards (of those already
    visible), before anything starts CUDA."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(chips)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def _cache_dirs(root: str) -> None:
    """Kernel caches at fixed places inside the checkout (the port builds
    its own libraries into its ``build/`` there)."""
    base = os.path.join(root, "build", "cmr_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def _k1_launches() -> int:
    """K1 launches so far: those its wrapper launched and those graph
    replays ran, counted on each card (reads each card's count)."""
    from complex_materials_renderer_tpu_torch.kernels import megakernel, pass_control

    n = megakernel.trace_paths_mega.launches
    for d in pass_control.counted_devices():
        n += int(pass_control.device_counts(d)[0])
    return n


def _breakdown(rec) -> dict:
    """The card's time by tile-call shape and its idle gaps by what the
    host was doing, each a mean over the cards, at most 10 of each."""
    n = max(1, len(rec.cards))
    ops: dict = {}
    for s in (s for s in rec.spans if math.isfinite(s.device_s)):
        name = f"megarender tile call {s.shape[0]}x{s.shape[1]} at {s.shape[2]} spp"
        ops[name] = ops.get(name, 0.0) + s.device_s / n
    gaps: dict = {}
    longest = (0.0, "")
    for card in rec.cards:
        own = sorted((s for s in rec.spans if s.card == card), key=lambda s: s.start_s)
        t, last_render = 0.0, None
        for s in own:
            if last_render is None:
                kind = "window start to the first tile call"
            elif s.render == last_render:
                kind = "between tile calls of a render (renderer.py: band read, accumulation)"
            else:
                kind = "between renders (render() return, the next render's first call)"
            gap = max(0.0, s.start_s - t)
            gaps[kind] = gaps.get(kind, 0.0) + gap / n
            longest = max(longest, (gap, f"longest single gap, cuda:{card}: {kind}"))
            t, last_render = s.start_s + s.device_s, s.render
        kind = "the last tile call to the window's end"
        gaps[kind] = gaps.get(kind, 0.0) + max(0.0, rec.window_s - t) / n
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    idle = top(gaps)[:9] + ([[longest[1], longest[0]]] if longest[1] else [])
    return {"device_ops": top(ops), "idle_gaps": idle}


def run_cell(cfg: dict, traffic: dict, limits: dict, *, seed: int, seconds: float, trace: bool,
             device: str, end_to_end: list, per_layer: list, t0: float = T0) -> dict:
    """One run of a cell; returns the result line's object."""
    import numpy as np
    import torch

    from complex_materials_renderer_tpu_torch.config import RenderOptions
    from complex_materials_renderer_tpu_torch.render import megarender
    from complex_materials_renderer_tpu_torch.renderer import Renderer
    from complex_materials_renderer_tpu_torch.scene import load_scene

    from . import check, hostinfo, tracing
    from .record import Record

    marks = {"imports": time.perf_counter() - t0}
    azimuth, pixels = check.draws(seed, traffic)
    scene = load_scene(cfg["scene"], RenderOptions())
    so = scene.options
    opts = dataclasses.replace(
        so, **cfg["options"], width=traffic["width"], height=traffic["height"],
        num_samples=traffic["samples"], device=device,
        camera_pos=check.camera_position(so.camera_pos, so.camera_look_at, azimuth))
    n_cap = len(megarender.captures)
    marks["scene_load"] = time.perf_counter() - t0
    renderer = Renderer(scene, opts)
    marks["renderer"] = time.perf_counter() - t0
    on_card = renderer.device.type == "cuda"
    cards = (list(range(torch.cuda.device_count())) if opts.shard == "auto"
             else [renderer.device.index or 0]) if on_card else []
    with tracing.WarmShapes() as warm:
        renderer.render()
    for c in cards:
        torch.cuda.synchronize(c)
    marks["warm_up"] = time.perf_counter() - t0
    phases = dict(renderer.timer.items())
    capture_s = sum(c.seconds for c in megarender.captures[n_cap:])
    log(f"set-up: camera azimuth {azimuth:+.6f} deg, shapes warmed {sorted(warm.shapes)}, "
        f"phases {phases}, {len(megarender.captures) - n_cap} captures in {capture_s:.3f} s, "
        f"seconds from the start at the end of each step {marks}")
    k1_start = _k1_launches()

    spans = tracing.Spans(cards) if trace else None
    latencies = []
    image = None
    with spans if spans is not None else contextlib.nullcontext():
        t_start = time.perf_counter()
        while not latencies or time.perf_counter() - t_start < seconds:
            if spans is not None:
                spans.render = len(latencies)
            t = time.perf_counter()
            image = renderer.render()
            latencies.append(time.perf_counter() - t)
        t_end = time.perf_counter()
    k1 = _k1_launches() - k1_start
    w, h, spp = traffic["width"], traffic["height"], traffic["samples"]
    rec = Record(paths_per_render=w * h * spp, setup_s=t_start - t0, window_s=t_end - t_start,
                 latencies_s=latencies, accel_build_s=phases.get("accel_build", 0.0),
                 capture_s=capture_s, k1_launches=k1, cards=cards)
    if spans is not None:
        rec.spans = spans.spans()
        if spans.dispatch_s:
            log(f"bands: {len(spans.dispatch_s)}; host ms to queue a band (dispatch_cells) "
                f"{1e3 * min(spans.dispatch_s):.3f}-{1e3 * max(spans.dispatch_s):.3f}, "
                f"to combine it {1e3 * min(spans.combine_s):.3f}-{1e3 * max(spans.combine_s):.3f}")
    log(f"window: {len(latencies)} renders in {rec.window_s:.4f} s, latencies s "
        + " ".join(f"{x:.4f}" for x in latencies[:12]) + (" ..." if len(latencies) > 12 else "")
        + f"; K1 launches {k1}")
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)

    metrics = {}
    for m in (per_layer if trace else end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": len(cards), "memory_peak_bytes": int(peak),
           "power_limit_w": hostinfo.power_limits(len(cards)) if on_card else [],
           "host_cpu": hostinfo.cpu_model()}
    out = {"correct": False, "attempted": len(latencies), "failed": 0, "metrics": metrics,
           "device": dev}
    if trace:
        busy = [v for v in rec.busy_s().values() if math.isfinite(v)]
        dev["busy_s"] = float(np.mean(busy)) if busy else 0.0
        dev["window_s"] = rec.window_s
        out["breakdown"] = _breakdown(rec)

    # The program's state goes before the reference runs on the first card.
    last = np.asarray(image)
    for cache in [getattr(renderer, "_passes", None),
                  *getattr(renderer, "_shard_passes", {}).values()]:
        if cache is not None:
            megarender.release(cache.tables)
    del renderer, image, spans
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.check_image(last, cfg, traffic, azimuth, pixels,
                                "cuda:0" if on_card else "cpu", log)
    out["correct"], out["checks"] = check.judge(numbers, limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    _visible_cards(int(cell["chips"]))
    _cache_dirs(spec.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); {n} visible")
        return EXIT_NO_CARDS
    out = run_cell(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                   spec.limits(cell["name"]), seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda",
                   end_to_end=spec.metrics_of(bench, "end_to_end", cell["name"]),
                   per_layer=spec.metrics_of(bench, "per_layer", cell["name"]))
    found = banned_modules()
    if found:
        log(f"loaded after the window: {', '.join(found)}")
        return EXIT_JAX
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
