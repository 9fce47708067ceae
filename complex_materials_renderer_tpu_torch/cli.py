"""Command-line entry point.

Counterpart of complex_materials_renderer_tpu/cli.py: parse args -> load
scene -> build the cluster grid -> render -> write <out>.hdr -> report
timings (the host phases, each render's band spans and the card's
segments: K1 by width, sorts, the rest, K1's lane occupancy;
utils/timing.py). Run as ``python -m complex_materials_renderer_tpu_torch
scene.obj [flags]``; ``--device cpu`` runs the plain PyTorch versions of
the kernels on the CPU, the default ``cuda`` the CUDA kernels.
"""

from __future__ import annotations

import sys

from .config import RenderOptions, parse_argv
from .io import write_hdr
from .renderer import Renderer
from .scene import load_scene
from .utils.timing import PhaseTimer


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    options = parse_argv(argv, RenderOptions())

    timer = PhaseTimer()
    with timer.phase("scene_load"):
        scene = load_scene(options.obj_path, options)
    # Scene JSON overrides camera/light/scale; CLI-set samples, background
    # and output name stay in force (the reference's precedence).
    renderer = Renderer(scene, scene.options)

    if scene.options.profile:
        import torch.profiler as tp

        activities = [tp.ProfilerActivity.CPU]
        if renderer.device.type == "cuda":
            activities.append(tp.ProfilerActivity.CUDA)
        with tp.profile(activities=activities,
                        on_trace_ready=tp.tensorboard_trace_handler(scene.options.profile)):
            image = renderer.render()
    else:
        image = renderer.render()

    with timer.phase("write"):
        out_path = f"{scene.options.out_name}.hdr"
        write_hdr(out_path, image)

    print(f"wrote {out_path} ({scene.options.width}x{scene.options.height}, "
          f"{scene.options.num_samples} spp, aov={scene.options.aov}, "
          f"device={renderer.device})")
    print(timer.report())
    print(renderer.timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
