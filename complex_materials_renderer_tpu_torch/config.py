"""Render configuration.

Counterpart of complex_materials_renderer_tpu/config.py (the reference
``Options`` class and CLI parser, source/utils.hpp:21-35,
source/utils.cpp:36-89). Defaults and flags are those of the JAX package,
plus ``--device`` (cuda | cpu).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class RenderOptions:
    # --- fields mirroring reference Options (utils.hpp:24-34) ---
    num_samples: int = 256
    background: int = 1  # 0 none, 1 checkerboard, 2 cornell (utils.cpp:47-50)
    obj_path: str = "scenes/showcase.obj"
    out_name: str = "out"
    camera_pos: Tuple[float, float, float] = (0.2, 4.2, 6.5)
    camera_look_at: Tuple[float, float, float] = (0.0, 4.1, 0.2)
    camera_fov: float = 36.0
    light_pos: Tuple[float, float, float] = (-1.001, 5.0, 6.0)
    light_color: Tuple[float, float, float] = (0.8, 0.8, 0.6)
    light_intensity: float = 100.0
    scale: float = 10.0

    # --- hardcoded in the reference, configurable here ---
    width: int = 1920  # main.cpp:41
    height: int = 1080  # main.cpp:42
    max_depth: int = 32  # volpath:609
    rr_depth: int = 16  # volpath:787
    nee_max_media: int = 4  # bound on media crossings along shadow rays (volpath:350 while-loop)

    # --- extensions of the JAX package ---
    aov: str = "beauty"  # beauty | depth | normal | topology
    backend: str = "auto"  # auto (cluster on cuda, bvh on cpu) | cluster (the CUDA
    # kernels) | bvh (plain PyTorch walk)
    engine: str = "auto"  # auto | mega (fused kernel) | wavefront | binned | pair
    tir: str = "reflect"  # reflect | kill (reference-faithful TIR termination)
    direct: str = "scatter"  # scatter (reference estimator) | analytic
    # (closed-form in-scatter direct term: same converged image, lower
    # variance in media, no extra RNG — ops/medium.analytic_direct_scale)
    rng: str = "parity"  # parity (sequential per pixel, ref volpath:575)
    # | counter (hashed per-(pixel,sample)) | ld (Owen-scrambled Sobol,
    # lowest-variance mode — ops/rng.py)
    sample_chunk: int = 0  # samples per device pass; 0 = auto
    spp_mode: str = "uniform"  # uniform (reference semantics: every pixel
    # gets -s samples) | adaptive (same TOTAL budget, per-pixel counts
    # proportional to measured per-pixel std after a uniform warmup —
    # lower image RMSE at equal cost; counter/ld RNG + mega-family
    # engines only. Renderer.render_adaptive)
    shard: str = "auto"  # auto | none — tile-shard over the visible cards
    leaf_size: int = 4  # BVH max triangles per leaf
    cluster_size: int = 0  # tracer cluster width; 0 = auto (128,
    # shrunk to 16*ceil(T/16) for scenes that fit in one cluster: the
    # kernel statically unrolls the FULL width, so a tiny scene would
    # pay 128 triangle tests per visit for a handful of real triangles)
    super_factor: int = 0  # clusters per super-cluster; 0 = auto (16)
    partition: str = "auto"  # auto | off | media — opaque/media cluster segregation
    quads: str = "auto"  # auto (merge coplanar tri pairs into quad slots) | off
    checkpoint: str = ""  # optional .npz accumulate-buffer checkpoint path
    profile: str = ""  # optional dir for a torch.profiler trace of the render
    device: str = "cuda"  # cuda (the H100 kernels) | cpu (plain PyTorch)

    def clamp(self) -> "RenderOptions":
        """Mirror reference clamping: background outside [0,2] -> 0 (utils.cpp:80-84)."""
        if self.background > 2 or self.background < 0:
            self.background = 0
        return self


HELP_TEXT = """Complex Materials Renderer (PyTorch/CUDA) help:
\t-o\t--out\tSets the name of the output file (default: 'out')
\t-s\t--samples\tSets the sample count for the render (default: 256)
\t-b\t--background\tSets the axis-aligned texture for diffuse background (default: 1)
\t\t0\tNone
\t\t1\tCheckerboard pattern
\t\t2\tCornell box (paints vertical planes based on their normals)
\t--width/--height\tRender resolution (default: 1920x1080)
\t--aov\tOutput channel: beauty (default) | depth | normal | topology
\t--max-depth\tMaximum path depth (default: 32)
\t--rr-depth\tPath depth after which russian roulette starts (default: 16)
\t--rng\tparity (reference-matching PCG stream) | counter (decorrelated,
\t\tsample-parallel) | ld (Owen-scrambled Sobol: same image in the
\t\tlimit, converges fastest; sample-parallel)
\t--backend\tauto (default: cluster on cuda, bvh on cpu) | cluster (the CUDA kernels)
\t\t| bvh (threaded-BVH walk in plain PyTorch: portable, slow on the card)
\t--engine\tauto (default: mega on cuda with the cluster backend, else wavefront) | mega
\t\t(fused path kernel) | wavefront (bounce-by-bounce loop) | binned (bounce
\t\tloop, per-lane candidate lists served in rounds; CMR_BINNED_LIST,
\t\tCMR_BINNED_CAP) | pair (bounce loop, cluster-major pair sweep)
\t--tir\treflect (default) | kill (reference-faithful TIR termination)
\t--direct\tMedia direct-light estimator: scatter (default, reference
\t\testimator) | analytic (closed-form expectation: same image in the
\t\tlimit, less noise in media, same RNG stream)
\t--shard\tauto (default: with several visible cards, rows tile-sharded over
\t\tall of them, every card's call of a band queued before its one host
\t\tread: the same image; one card renders alone) | none. Sharded renders take
\t\tpair through the wavefront loop and ignore --tir, as the JAX package
\t\tdoes; --spp-mode adaptive refuses auto with several cards
\t--nee-bound\tMax media crossings along shadow rays (default: 4)
\t--sample-chunk\tSamples per bounded device pass (default: 0 = auto)
\t--spp-mode\tuniform (default: every pixel gets -s samples) | adaptive
\t\t(same total budget, per-pixel counts by measured noise; refuses
\t\t--checkpoint, then --rng parity, then engines outside mega|binned|pair,
\t\tthen --shard auto with several cards)
\t--cluster-size\tCluster width in triangles (default:
\t\t0 = auto: 128, shrunk for scenes that fit in one cluster)
\t--super-factor\tClusters per super-cluster culling group (default: auto)
\t--partition\tOpaque/media cluster segregation: auto (default: on for
\t\t>128-cluster media scenes) | off | media
\t--quads\tMerge coplanar triangle pairs into quad slots: auto (default) | off
\t--checkpoint\tAccumulate-buffer checkpoint path (resumes if present;
\t\trejects a checkpoint written with different settings, including -s,
\t\tsince the buffer is pre-scaled by samples/num_samples)
\t--profile\tDirectory for a torch.profiler trace of the render
\t--device\tcuda (default: the CUDA kernels) | cpu (plain PyTorch)
Any bare argument is treated as the .obj scene path."""


def parse_argv(argv, options: RenderOptions | None = None) -> RenderOptions:
    """Parse CLI arguments in the reference's style (utils.cpp:36-89).

    Reference semantics preserved: flags may appear anywhere, a bare
    argument is the scene path, missing flag values are silently ignored,
    background is clamped to 0 when out of range.
    """
    opt = options or RenderOptions()
    i = 0
    n = len(argv)

    def take_value(i):
        return (argv[i + 1], i + 1) if i + 1 < n else (None, i)

    while i < n:
        a = argv[i]
        if a in ("-h", "--help"):
            print(HELP_TEXT)
            raise SystemExit(0)
        elif a in ("-o", "--out"):
            v, i = take_value(i)
            if v is not None:
                opt.out_name = v
        elif a in ("-s", "--samples"):
            v, i = take_value(i)
            if v is not None:
                opt.num_samples = int(v)
        elif a in ("-b", "--background"):
            v, i = take_value(i)
            if v is not None:
                opt.background = int(v)
                opt.clamp()
        elif a == "--width":
            v, i = take_value(i)
            if v is not None:
                opt.width = int(v)
        elif a == "--height":
            v, i = take_value(i)
            if v is not None:
                opt.height = int(v)
        elif a == "--aov":
            v, i = take_value(i)
            if v is not None:
                opt.aov = v
        elif a == "--max-depth":
            v, i = take_value(i)
            if v is not None:
                opt.max_depth = int(v)
        elif a == "--rr-depth":
            v, i = take_value(i)
            if v is not None:
                opt.rr_depth = int(v)
        elif a == "--nee-bound":
            v, i = take_value(i)
            if v is not None:
                opt.nee_max_media = int(v)
        elif a == "--rng":
            v, i = take_value(i)
            if v is not None:
                if v not in ("parity", "counter", "ld"):
                    raise ValueError(
                        f"--rng must be parity|counter|ld, got {v!r}"
                    )
                opt.rng = v
        elif a == "--backend":
            v, i = take_value(i)
            if v is not None:
                opt.backend = v
        elif a == "--engine":
            v, i = take_value(i)
            if v is not None:
                opt.engine = v
        elif a == "--tir":
            v, i = take_value(i)
            if v is not None:
                opt.tir = v
        elif a == "--direct":
            v, i = take_value(i)
            if v is not None:
                if v not in ("scatter", "analytic"):
                    raise ValueError(
                        f"--direct must be scatter|analytic, got {v!r}"
                    )
                opt.direct = v
        elif a == "--sample-chunk":
            v, i = take_value(i)
            if v is not None:
                opt.sample_chunk = int(v)
        elif a == "--spp-mode":
            v, i = take_value(i)
            if v is not None:
                if v not in ("uniform", "adaptive"):
                    raise ValueError(
                        f"--spp-mode must be uniform|adaptive, got {v!r}"
                    )
                opt.spp_mode = v
        elif a == "--cluster-size":
            v, i = take_value(i)
            if v is not None:
                opt.cluster_size = int(v)
        elif a == "--super-factor":
            v, i = take_value(i)
            if v is not None:
                opt.super_factor = int(v)
        elif a == "--partition":
            v, i = take_value(i)
            if v is not None:
                # Validate here: resolve_partition treats any unknown
                # string as 'auto', so a typo would silently enable auto
                # segregation (advisor finding, round 3).
                if v not in ("auto", "off", "media"):
                    raise ValueError(
                        f"--partition must be auto|off|media, got {v!r}"
                    )
                opt.partition = v
        elif a == "--quads":
            v, i = take_value(i)
            if v is not None:
                if v not in ("auto", "off"):
                    raise ValueError(f"--quads must be auto|off, got {v!r}")
                opt.quads = v
        elif a == "--shard":
            v, i = take_value(i)
            if v is not None:
                opt.shard = v
        elif a == "--checkpoint":
            v, i = take_value(i)
            if v is not None:
                opt.checkpoint = v
        elif a == "--profile":
            v, i = take_value(i)
            if v is not None:
                opt.profile = v
        elif a == "--device":
            v, i = take_value(i)
            if v is not None:
                if v not in ("cuda", "cpu"):
                    raise ValueError(f"--device must be cuda|cpu, got {v!r}")
                opt.device = v
        else:
            opt.obj_path = a
        i += 1
    return opt
