"""High-level renderer: scene -> device tables -> image.

Counterpart of complex_materials_renderer_tpu/renderer.py (``Renderer``
:87): builds the acceleration structure (the cluster grid with the JAX
package's automatic choices of width, opaque/media partition and super
fan-out, or the threaded BVH), lays it out on the device, and renders the
AOVs in one pass or the beauty pass in bounded row x sample chunks, with
an optional checkpoint that resumes to the same image.

Engines: ``mega`` (the megakernel), ``binned`` and ``pair`` (the
wavefront bounce over the binned tracer or the pair sweep, under the
megakernel's pass loop), all on the cluster backend only, and
``wavefront`` (the bounce-by-bounce loop, both backends). Backends:
``cluster`` and ``bvh``. ``auto`` picks as the JAX package does, with the
card in the TPU's role: the cluster backend and the megakernel on
``cuda``, the BVH and the wavefront loop on the CPU.

``--spp-mode adaptive`` spreads the same total budget over the pixels by
their measured noise (``render_adaptive``, the mega-family engines and a
stateless RNG only). ``--shard auto`` with more than one visible card
renders bands tile-sharded over all of them as one program over the
cards (parallel/sharding.py): every card's call of a band is queued
before the band's one host read, and each card replays its own graphs.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch

from .accel import build_bvh, build_clusters
from .config import RenderOptions
from .kernels.cluster_grid import DeviceClusterGrid, device_cluster_grid
from .kernels.megakernel import MAX_SUPERS
from .kernels.traverse import device_bvh
from .ops.camera import Camera, make_camera
from .render.aov import render_aov
from .render.hitinfo import make_lights, make_scene_arrays
from .scene import Scene
from .utils.device import resolve_device
from .utils.timing import PhaseTimer

# Pass shaping, read once at import from the environment with the JAX
# package's defaults (renderer.py:39-40): LANES_PER_PASS bounds the
# wavefront width, PATHS_PER_PASS the lanes x samples of one pass.
LANES_PER_PASS = int(os.environ.get("CMR_LANES_PER_PASS", 1 << 16))
PATHS_PER_PASS = int(os.environ.get("CMR_PATHS_PER_PASS", 1 << 20))


def _mega_env_knobs() -> dict:
    """The megakernel tuning knobs, read once per render: CMR_MEGA_DYN
    (schedule mode), CMR_MEGA_SCHED (phase widths), CMR_MEGA_SORTKEY
    (dir | pos) and CMR_MEGA_DEBUG (the megakernel's ablations, a
    comma-separated set of ``kernels.megakernel.ABLATIONS`` tokens)."""
    return dict(
        schedule_mode=os.environ.get("CMR_MEGA_DYN", "auto"),
        schedule=os.environ.get("CMR_MEGA_SCHED", ""),
        sortkey=os.environ.get("CMR_MEGA_SORTKEY", "dir"),
        debug=os.environ.get("CMR_MEGA_DEBUG", ""),
    )


def _engine_knobs(engine: str) -> dict:
    """Keyword arguments of the megarender pass loop for a mega-family
    engine: the tuning knobs and the trace engine, with the binned
    engine's list length and serving cap (CMR_BINNED_LIST, CMR_BINNED_CAP)."""
    knobs = _mega_env_knobs()
    knobs["trace_engine"] = engine
    if engine == "binned":
        knobs["binned_list"] = int(os.environ.get("CMR_BINNED_LIST", 8))
        knobs["binned_cap"] = int(os.environ.get("CMR_BINNED_CAP", 12))
    return knobs


def resolve_partition(partition: str, num_tris: int, width: int,
                      has_media: bool) -> bool:
    """Resolve --partition {auto,off,media} to a bool (segregate or not):
    'auto' segregates opaque and media clusters exactly when the scene has
    media and the unpartitioned grid has more than 128 clusters."""
    if partition == "media":
        return True
    if partition == "off":
        return False
    return has_media and -(-num_tris // width) > 128


def _auto_sample_chunk(width: int, height: int) -> int:
    lanes = min(LANES_PER_PASS, width * height)
    return max(1, PATHS_PER_PASS // lanes)


def _auto_row_chunk(width: int) -> int:
    return max(1, LANES_PER_PASS // width)


class _BandRead:
    """A band's copy to the host, queued on its card's current stream right
    behind the work that makes it, into page-locked memory, so that the card
    goes on from the call to the copy with no round trip through the host:
    ``wait()`` is the host's wait for the call, ``read()`` its wait for the
    copy, which gives the band as an array. On the CPU neither waits."""

    def __init__(self, t: torch.Tensor):
        self.host, self.made, self.copied = t, None, None
        if t.is_cuda:
            stream = torch.cuda.current_stream(t.device)
            self.made = stream.record_event()
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.copied = stream.record_event()

    def wait(self) -> None:
        if self.made is not None:
            self.made.synchronize()

    def read(self) -> np.ndarray:
        if self.copied is not None:
            self.copied.synchronize()
        return self.host.numpy()


def auto_cluster_width(cluster_size: int, num_tris: int) -> int:
    """Cluster width: the option, or 128 shrunk down the {16, 32, 64}
    ladder for scenes that fit in one cluster (renderer.py:120-127)."""
    if cluster_size:
        return cluster_size
    width = 128
    if num_tris <= 128:
        width = 16
        while width < num_tris:
            width *= 2
    return width


class Renderer:
    def __init__(self, scene: Scene, options: Optional[RenderOptions] = None,
                 device=None):
        self.options = options or scene.options
        opt = self.options
        self.device = resolve_device(device if device is not None else opt.device)
        self.timer = PhaseTimer()
        if opt.backend not in ("auto", "cluster", "bvh"):
            raise ValueError(f"--backend must be auto|cluster|bvh, got {opt.backend!r}")
        # auto: the CUDA kernels on the card, the portable BVH walk on the
        # CPU (renderer.py:92-95, with the card in the TPU's role).
        backend = opt.backend
        if backend == "auto":
            backend = "cluster" if self.device.type == "cuda" else "bvh"
        if backend == "bvh":
            if self.device.type == "cuda":
                warnings.warn(
                    "--backend bvh on the card is the plain PyTorch BVH walk (one "
                    "small op per lane step, gathers per node), far slower than the "
                    "cluster backend's CUDA kernels; use --backend cluster or auto",
                    stacklevel=2,
                )
            with self.timer.phase("accel_build"):
                self._host_accel = build_bvh(scene.triangles, leaf_size=opt.leaf_size)
            with self.timer.phase("upload"):
                self.accel = device_bvh(self._host_accel, scene.triangles, opt.leaf_size,
                                        self.device)
        else:
            self._build_cluster_grid(scene)
        with self.timer.phase("upload"):
            self.scene_arrays = make_scene_arrays(
                scene.triangles, scene.mat_ids, scene.media, opt.scale,
                opt.background, device=self.device,
            )
        self.camera: Camera = make_camera(
            opt.camera_pos, opt.camera_look_at, opt.camera_fov, device=self.device
        )
        self.lights = make_lights(
            opt.light_pos, opt.light_color, opt.light_intensity, device=self.device
        )
        self.triangles = scene.triangles

    def _build_cluster_grid(self, scene: Scene) -> None:
        opt = self.options
        with self.timer.phase("accel_build"):
            ntris = int(scene.triangles.shape[0])
            width = auto_cluster_width(opt.cluster_size, ntris)
            has_media = any(int(m) >= 0 for m in scene.media.mat_id)
            media_mats = (
                set(int(m) for m in scene.media.mat_id if int(m) >= 0)
                if resolve_partition(opt.partition, ntris, width, has_media)
                else None
            )

            def _build(sf):
                return build_clusters(
                    scene.triangles, scene.mat_ids, cluster_size=width,
                    media_mats=media_mats, super_factor=sf,
                    quads=opt.quads != "off" and opt.aov == "beauty",
                )

            # 0 = auto: fan-out 16, doubled until the grid fits the
            # megakernel's super cap (renderer.py:175-182).
            sf = opt.super_factor or 16
            self._host_accel = _build(sf)
            while opt.super_factor == 0 and self._host_accel.super_bounds.shape[0] > MAX_SUPERS:
                sf *= 2
                self._host_accel = _build(sf)
        with self.timer.phase("upload"):
            self.accel = device_cluster_grid(self._host_accel, self.device)

    def _resolve_engine(self) -> str:
        """The bounce-loop engine (renderer.py:616): 'auto' takes the
        megakernel on the card with the cluster grid and the wavefront loop
        otherwise (the only engine on the BVH). The binned and pair engines
        warn, as the JAX package's do: they are kept, tested alternatives,
        not the fast path."""
        engine = self.options.engine
        is_cluster = isinstance(self.accel, DeviceClusterGrid)
        if engine == "auto":
            return "mega" if self.device.type == "cuda" and is_cluster else "wavefront"
        if engine in ("mega", "binned", "pair") and not is_cluster:
            raise ValueError(f"--engine {engine} requires --backend cluster")
        if engine in ("binned", "pair"):
            warnings.warn(
                f"--engine {engine} renders the image of --engine mega through the "
                "wavefront bounce loop and its own trace kernels; it is an alternative "
                "kept for study, not the fast path (PERF.md has its speed on the card). "
                "Use --engine mega (or auto) for production.",
                stacklevel=2,
            )
        if engine in ("mega", "wavefront", "binned", "pair"):
            return engine
        raise ValueError(f"--engine must be auto|mega|wavefront|binned|pair, got {engine!r}")

    def _shard_devices(self) -> list:
        """The devices ``--shard auto`` spreads a render over: every
        visible card when the renderer runs on the card, else its one
        device."""
        if self.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [self.device]

    def render(self, checkpoint_path: Optional[str] = None) -> np.ndarray:
        """Render the configured beauty image as an (H, W, 3) float32 array.

        ``checkpoint_path``: optional .npz path; the framebuffer and the
        per-row-block RNG state are saved after every pass, and an
        interrupted render resumes from it to the same image (the file is
        removed on completion).

        Each call is a root span of the port's recorder (utils/timing.py),
        with a span for each band and sample chunk's tile call (or, over
        several cards, dispatch and combine), wait for the card, read and
        accumulation, and a snapshot of each device's counters at its end.
        """
        opt = self.options
        devices = self._shard_devices()
        sharded = opt.shard == "auto" and len(devices) > 1
        with self.timer.render(devices if sharded else [self.device]):
            return self._render(checkpoint_path, devices)

    def _render(self, checkpoint_path, devices) -> np.ndarray:
        opt = self.options
        checkpoint_path = checkpoint_path or (opt.checkpoint or None)
        resolution = (opt.width, opt.height)
        if opt.aov != "beauty":
            img = render_aov(self.triangles, self.camera, self.accel, resolution, opt.aov)
            return img.cpu().numpy()
        if opt.spp_mode == "adaptive":
            if checkpoint_path:
                raise ValueError(
                    "--spp-mode adaptive does not support --checkpoint "
                    "(per-pixel sample counts are not resumable state yet); "
                    "drop one of the two flags"
                )
            return self.render_adaptive()
        if opt.shard == "auto" and len(devices) > 1:
            return self._render_sharded(devices)

        beauty_fn = self._beauty_fn()
        chunk = opt.sample_chunk or _auto_sample_chunk(opt.width, opt.height)
        chunk = max(1, min(chunk, opt.num_samples))
        rows = _auto_row_chunk(opt.width)

        acc = np.zeros((opt.height, opt.width, 3), np.float32)
        rng_rows: dict = {}
        done_rows: dict = {}
        fingerprint = self._render_fingerprint()
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = np.load(checkpoint_path, allow_pickle=True)
            ck_fp = str(state["fingerprint"]) if "fingerprint" in state else ""
            if ck_fp != fingerprint:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written by a "
                    "different render (scene/options fingerprint mismatch: "
                    f"{ck_fp!r} vs {fingerprint!r}); delete it or render "
                    "with the original settings"
                )
            if (
                tuple(state["shape"]) == acc.shape
                and int(state["rows"]) == rows
                and int(state["chunk"]) == chunk
            ):
                acc = np.array(state["acc"], np.float32)
                done_rows = dict(zip(state["row_ids"].tolist(), state["done"].tolist()))
                for i, row0 in enumerate(state["row_ids"].tolist()):
                    rng_rows[row0] = state["rng"][i]

        timer = self.timer
        for row0 in range(0, opt.height, rows):
            tile_h = min(rows, opt.height - row0)
            rng_state = (
                torch.from_numpy(np.asarray(rng_rows[row0], np.int64)).to(self.device)
                if row0 in rng_rows else None
            )
            done = done_rows.get(row0, 0)
            while done < opt.num_samples:
                n = min(chunk, opt.num_samples - done)
                with timer.phase("tile_call"):
                    img, rng_state = beauty_fn(
                        self.camera, self.scene_arrays, self.accel, self.lights,
                        (opt.width, tile_h), n,
                        max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                        nee_max_media=opt.nee_max_media, rng_mode=opt.rng,
                        row_offset=row0, full_resolution=resolution,
                        sample_offset=done, rng_state=rng_state, return_rng=True,
                    )
                with timer.phase("band_wait"):
                    read = _BandRead(img)
                    read.wait()
                with timer.phase("band_read"):
                    band = read.read()
                with timer.phase("band_accumulate"):
                    acc[row0 : row0 + tile_h] += band * np.float32(n / opt.num_samples)
                    done += n
                    if checkpoint_path:
                        rng_rows[row0] = rng_state.cpu().numpy().astype(np.uint32)
                        done_rows[row0] = done
                        self._save_checkpoint(
                            checkpoint_path, acc, rows, chunk, done_rows,
                            rng_rows, fingerprint,
                        )
        if checkpoint_path and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)
        return acc

    def _keep_passes(self) -> None:
        """Hold the pass loop's cache of this renderer's tables (the media
        and light rows, and on the card the CUDA graph of each call shape),
        so that row blocks and later renders reuse it."""
        from .render.megarender import pass_cache

        self._passes = pass_cache(self.scene_arrays, self.accel, self.lights)

    def _beauty_fn(self):
        """The tile renderer the single-device loop calls each pass: the
        megarender pass loop with the engine's knobs, or the wavefront loop
        (on the card each a CUDA graph per call shape)."""
        from .render.integrator import render_beauty
        from .render.megarender import render_beauty_mega

        opt = self.options
        engine = self._resolve_engine()
        self._keep_passes()
        if engine not in ("mega", "binned", "pair"):
            return partial(render_beauty, tir=opt.tir, direct=opt.direct)
        knobs = _engine_knobs(engine)
        if (knobs["schedule_mode"] == "auto"
                and opt.width * opt.height * opt.num_samples < (1 << 18)):
            # Preview-sized jobs take the dynamic mode, as in the JAX
            # package (renderer.py:317-327).
            knobs["schedule_mode"] = "all"
        return partial(render_beauty_mega, tir=opt.tir, direct=opt.direct, **knobs)

    def _keep_shard_passes(self, devices) -> dict:
        """This renderer's tables on each of ``devices`` (``replicate``: the
        same copies at every call) with their pass loop caches held, as
        ``_keep_passes`` holds one card's, so that every band and later
        render replays each card's graphs."""
        from .parallel.sharding import replicate
        from .render.megarender import pass_cache

        tables = replicate((self.camera, self.scene_arrays, self.accel, self.lights), devices)
        self._shard_passes = {d: pass_cache(*objs[1:]) for d, objs in tables.items()}
        return tables

    def _render_sharded(self, devices) -> np.ndarray:
        """The beauty pass in bands tile-sharded over ``devices``
        (renderer.py:240-288): each band is at most LANES_PER_PASS lanes a
        tile shard; the counter and ld modes also chunk the samples by
        PATHS_PER_PASS, parity keeps every sample of a band in one call so
        that each pixel's stream stays sequential. A band's calls are all
        queued (``dispatch_cells``) before its one host read, of the
        combined image."""
        from .parallel.sharding import (
            combine_cells,
            dispatch_cells,
            make_render_mesh,
            mesh_cells,
        )

        opt = self.options
        resolution = (opt.width, opt.height)
        engine = self._resolve_engine()
        mesh = make_render_mesh(devices)
        n_tile = mesh.shape["tile"]
        band = min(max(1, (LANES_PER_PASS * n_tile) // opt.width), opt.height)
        if opt.rng in ("counter", "ld"):
            chunk = opt.sample_chunk or max(
                1, PATHS_PER_PASS // (min(LANES_PER_PASS, band * opt.width)))
            chunk = max(1, min(chunk, opt.num_samples))
        else:
            chunk = opt.num_samples
        acc = np.zeros((opt.height, opt.width, 3), np.float32)
        cells = mesh_cells(mesh)
        tables = self._keep_shard_passes([mesh.devices[s][t] for s, t in cells])
        timer = self.timer
        for row0 in range(0, opt.height, band):
            band_h = min(band, opt.height - row0)
            done = 0
            while done < opt.num_samples:
                n = min(chunk, opt.num_samples - done)
                with timer.phase("dispatch"):
                    images = dispatch_cells(
                        cells, tables, (opt.width, band_h), n, mesh,
                        max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                        nee_max_media=opt.nee_max_media, rng_mode=opt.rng,
                        row_offset=row0, full_resolution=resolution, sample_offset=done,
                        engine=engine, direct=opt.direct,
                    )
                with timer.phase("combine"):
                    img = combine_cells(images, mesh.shape["sample"], mesh.shape["tile"],
                                        band_h, mesh.devices[0][0])
                with timer.phase("band_wait"):
                    read = _BandRead(img)
                    read.wait()
                with timer.phase("band_read"):
                    out = read.read()
                with timer.phase("band_accumulate"):
                    acc[row0:row0 + band_h] += out * (n / opt.num_samples)
                    done += n
        return acc

    def render_adaptive(self, snapshot_cb=None, sample_base: int = 0) -> np.ndarray:
        """Adaptive per-pixel sample allocation at the uniform budget
        (``--spp-mode adaptive``, renderer.py:406-614): the total is
        width x height x num_samples samples, but each pixel's count
        follows its measured noise.

        A uniform warmup (a quarter of the budget, at most 32 spp, at
        least 2) accumulates each pixel's sum, sum of squares and count;
        every later round re-targets the counts toward the 3x3-box-smoothed
        per-pixel std mixed with a uniform floor that decays as the counts
        grow, and apportions the round's lanes by largest remainder. Lanes
        go out in 32x32-tile pixel order through ``render_samples_mega``
        in calls of one fixed width. The allocation is host numpy, as in
        the JAX package, so both allocate the same lanes.

        ``snapshot_cb(avg_spp, image_fn)`` is called after each round;
        ``image_fn()`` gives the current estimate, and a truthy return
        stops the render after that round. ``sample_base`` is added to
        every per-pixel sample index. As in the JAX package the warmup is
        not clamped to the budget, so with ``num_samples == 1`` it issues
        2 samples a pixel (ROADMAP R2).
        """
        opt = self.options
        if opt.rng not in ("counter", "ld"):
            raise ValueError(
                "--spp-mode adaptive requires a stateless RNG "
                "(--rng counter|ld); parity's sequential per-pixel stream "
                "has no defined order under per-pixel sample counts"
            )
        engine = self._resolve_engine()
        if engine not in ("mega", "binned", "pair"):
            raise ValueError(
                "--spp-mode adaptive requires the mega-family engines "
                "(cluster backend); got engine="
                f"{engine!r} (backend {type(self.accel).__name__})"
            )
        if opt.shard == "auto" and len(self._shard_devices()) > 1:
            raise ValueError(
                "--spp-mode adaptive is single-device for now; pass "
                "--shard none (tile-DP sharding of adaptive rounds is a "
                "planned extension)"
            )
        from .render.megarender import _tile_perm, render_samples_mega

        self._keep_passes()
        knobs = _engine_knobs(engine)
        W, H = opt.width, opt.height
        r = W * H
        n_total = r * opt.num_samples
        # One lane width for every call.
        ch = min(LANES_PER_PASS, r)
        l_call = min(PATHS_PER_PASS, -(-n_total // ch) * ch)
        # Lanes go out in 32x32-tile pixel order, the uniform path's.
        perm, _inv = _tile_perm(W, H)
        rank = np.empty(r, np.int64)
        rank[perm] = np.arange(r)

        n = np.zeros(r, np.int64)
        acc = np.zeros((r, 3), np.float64)
        acc2 = np.zeros((r, 3), np.float64)
        warmup = max(2 * r, min(n_total // 4, 32 * r))
        issued = 0

        def weights():
            """Per-pixel targets: the smoothed std mixed with a uniform
            floor of 0.25 at a 64-spp average, shrinking as 1/sqrt(avg)
            to no less than 0.08."""
            avg = max(float(issued) / r, 1.0)
            frac = float(np.clip(0.25 * np.sqrt(64.0 / avg), 0.08, 0.25))
            nn = np.maximum(n, 2)[:, None]
            var = np.maximum(acc2 / nn - (acc / nn) ** 2, 0.0).mean(-1)
            sig = np.sqrt(var * (nn[:, 0] / np.maximum(nn[:, 0] - 1, 1)))
            s = sig.reshape(H, W)
            p = np.pad(s, 1, mode="edge")
            s = (
                p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
                + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
                + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]
            ).reshape(-1) / 9.0
            m = s.mean()
            if not np.isfinite(m) or m <= 0.0:
                return np.ones(r)
            return frac + (1.0 - frac) * (s / m)

        def apportion(budget, want):
            """Largest-remainder apportionment of ``budget`` lanes to the
            pixels in proportion to ``want`` (non-negative, not all 0)."""
            q = budget * (want / want.sum())
            c = np.floor(q).astype(np.int64)
            short = budget - int(c.sum())
            if short > 0:
                frac = q - c
                c[np.argpartition(-frac, short - 1)[:short]] += 1
            return c

        with self.timer.render([self.device]):
            while issued < n_total:
                # Rounds grow with the samples issued (about a third of
                # them, at most 8 calls) once the warmup is done.
                if issued < warmup:
                    lanes = int(min(l_call, warmup - issued))
                else:
                    lanes = int(min(n_total - issued, 8 * l_call, max(l_call, issued // 3)))
                if issued < warmup:
                    base, extra = divmod(lanes, r)
                    counts = np.full(r, base, np.int64)
                    if extra:
                        # The first ``extra`` pixels in tile order.
                        counts[rank < extra] += 1
                else:
                    # Catch up toward the global target, so that the warmup
                    # counts against each pixel's share.
                    w = weights()
                    target = n_total * (w / w.sum())
                    deficit = np.maximum(target - n, 0.0)
                    if deficit.sum() <= 0:
                        deficit = w
                    counts = apportion(lanes, deficit)
                sel = np.repeat(np.arange(r, dtype=np.int64), counts)
                sel = sel[np.argsort(rank[sel], kind="stable")]
                # The k-th lane of pixel p in this round takes sample n[p] + k
                # (a pixel's lanes are consecutive in ``sel``).
                first = np.r_[True, sel[1:] != sel[:-1]]
                pos = np.arange(lanes, dtype=np.int64)
                run0 = pos[first][np.cumsum(first) - 1]
                sidx_all = (sample_base + n[sel] + (pos - run0)).astype(np.uint32)
                rad = np.empty((lanes, 3), np.float64)
                for o in range(0, lanes, l_call):
                    m = min(l_call, lanes - o)
                    pix = np.zeros((l_call, 2), np.int32)
                    pix[:m, 0] = sel[o:o + m] % W
                    pix[:m, 1] = sel[o:o + m] // W
                    sidx = np.zeros(l_call, np.uint32)
                    sidx[:m] = sidx_all[o:o + m]
                    val = np.zeros(l_call, bool)
                    val[:m] = True
                    out = render_samples_mega(
                        self.camera, self.scene_arrays, self.accel, self.lights,
                        torch.from_numpy(pix), torch.from_numpy(sidx.astype(np.int64)),
                        torch.from_numpy(val), (W, H),
                        max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                        nee_max_media=opt.nee_max_media, rng_mode=opt.rng,
                        tir=opt.tir, direct=opt.direct, **knobs,
                    )
                    rad[o:o + m] = out.cpu().numpy().astype(np.float64)[:m]
                for c in range(3):
                    acc[:, c] += np.bincount(sel, weights=rad[:, c], minlength=r)
                    acc2[:, c] += np.bincount(sel, weights=rad[:, c] ** 2, minlength=r)
                n += np.bincount(sel, minlength=r)
                issued += lanes
                if snapshot_cb is not None:
                    stop = snapshot_cb(
                        issued / r,
                        lambda: (acc / np.maximum(n, 1)[:, None])
                        .astype(np.float32).reshape(H, W, 3),
                    )
                    if stop:
                        break
        self.sample_counts = n.reshape(H, W)
        img = (acc / np.maximum(n, 1)[:, None]).astype(np.float32)
        return img.reshape(H, W, 3)

    def _render_fingerprint(self) -> str:
        """Identity of the accumulation a checkpoint belongs to
        (renderer.py:654-670)."""
        opt = self.options
        fields = (
            opt.obj_path, opt.width, opt.height, opt.num_samples,
            opt.max_depth, opt.rr_depth, opt.nee_max_media, opt.rng,
            opt.background, float(opt.scale), tuple(opt.camera_pos),
            tuple(opt.camera_look_at), float(opt.camera_fov),
            tuple(opt.light_pos), tuple(opt.light_color),
            float(opt.light_intensity),
        )
        return hashlib.sha256(repr(fields).encode()).hexdigest()[:16]

    @staticmethod
    def _save_checkpoint(path, acc, rows, chunk, done_rows, rng_rows, fingerprint):
        row_ids = sorted(done_rows)
        tmp = path + ".tmp"
        rng_obj = np.empty(len(row_ids), dtype=object)
        for i, r in enumerate(row_ids):
            rng_obj[i] = np.asarray(rng_rows[r])
        np.savez(
            tmp,
            acc=acc,
            shape=np.asarray(acc.shape),
            rows=rows,
            chunk=chunk,
            row_ids=np.asarray(row_ids, np.int64),
            done=np.asarray([done_rows[r] for r in row_ids], np.int64),
            rng=rng_obj,
            fingerprint=fingerprint,
        )
        # np.savez appends .npz when the name lacks it.
        actual = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(actual, path)

    def stats(self) -> dict:
        return dict(self.timer.items())
