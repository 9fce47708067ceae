"""High-level renderer: scene -> device tables -> image.

Counterpart of complex_materials_renderer_tpu/renderer.py (``Renderer``
:87): builds the acceleration structure (the cluster grid with the JAX
package's automatic choices of width, opaque/media partition and super
fan-out, or the threaded BVH), lays it out on the device, and renders the
AOVs in one pass or the beauty pass in bounded row x sample chunks, with
an optional checkpoint that resumes to the same image.

Engines: ``mega`` (the megakernel, cluster backend only) and
``wavefront`` (the bounce-by-bounce loop, both backends); ``auto`` takes
``mega`` on the cluster backend and ``wavefront`` on the BVH. Backends:
``cluster`` (= ``auto``) and ``bvh``. The other paths of the JAX package
raise ``NotImplementedError`` naming their ROADMAP item: adaptive
sampling, the binned and pair engines, and sharding over several devices.
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

# Pass shaping (renderer.py:39-40 of the JAX package): LANES_PER_PASS bounds
# the wavefront width, PATHS_PER_PASS the lanes x samples of one pass.
LANES_PER_PASS = 1 << 16
PATHS_PER_PASS = 1 << 20


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch/CUDA package yet ({item})")


def _mega_env_knobs() -> dict:
    """The megakernel tuning knobs, read once per render: CMR_MEGA_DYN
    (schedule mode), CMR_MEGA_SCHED (phase widths), CMR_MEGA_SORTKEY
    (dir | pos) and CMR_MEGA_DEBUG (the TPU ablations, not ported)."""
    return dict(
        schedule_mode=os.environ.get("CMR_MEGA_DYN", "auto"),
        schedule=os.environ.get("CMR_MEGA_SCHED", ""),
        sortkey=os.environ.get("CMR_MEGA_SORTKEY", "dir"),
        debug=os.environ.get("CMR_MEGA_DEBUG", ""),
    )


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
        if opt.backend == "bvh":
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
        megakernel on the cluster backend and the wavefront loop on the
        BVH, the only engine there."""
        engine = self.options.engine
        is_cluster = isinstance(self.accel, DeviceClusterGrid)
        if engine == "auto":
            return "mega" if is_cluster else "wavefront"
        if engine in ("mega", "binned", "pair") and not is_cluster:
            raise ValueError(f"--engine {engine} requires --backend cluster")
        if engine in ("mega", "wavefront"):
            return engine
        item = {"binned": "ROADMAP Queue 1, item 13",
                "pair": "ROADMAP Queue 1, item 14"}.get(engine, "ROADMAP Queue 1")
        raise _not_ported(f"--engine {engine}", item)

    def render(self, checkpoint_path: Optional[str] = None) -> np.ndarray:
        """Render the configured beauty image as an (H, W, 3) float32 array.

        ``checkpoint_path``: optional .npz path; the framebuffer and the
        per-row-block RNG state are saved after every pass, and an
        interrupted render resumes from it to the same image (the file is
        removed on completion).
        """
        from .render.integrator import render_beauty
        from .render.megarender import render_beauty_mega

        opt = self.options
        checkpoint_path = checkpoint_path or (opt.checkpoint or None)
        resolution = (opt.width, opt.height)
        if opt.aov != "beauty":
            with self.timer.phase("render"):
                img = render_aov(self.triangles, self.camera, self.accel, resolution, opt.aov)
                return img.cpu().numpy()
        if opt.spp_mode == "adaptive":
            raise _not_ported("--spp-mode adaptive", "ROADMAP Queue 1, item 11")
        if (opt.shard == "auto" and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise _not_ported(
                "Sharding over several devices (pass --shard none to render on one)",
                "ROADMAP Queue 1, item 12",
            )
        if self._resolve_engine() == "mega":
            knobs = _mega_env_knobs()
            if (knobs["schedule_mode"] == "auto"
                    and opt.width * opt.height * opt.num_samples < (1 << 18)):
                # Preview-sized jobs take the dynamic mode, as in the JAX
                # package (renderer.py:317-327).
                knobs["schedule_mode"] = "all"
            beauty_fn = partial(render_beauty_mega, tir=opt.tir, direct=opt.direct, **knobs)
        else:
            beauty_fn = partial(render_beauty, tir=opt.tir, direct=opt.direct)

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

        with self.timer.phase("render"):
            for row0 in range(0, opt.height, rows):
                tile_h = min(rows, opt.height - row0)
                rng_state = (
                    torch.from_numpy(np.asarray(rng_rows[row0], np.int64)).to(self.device)
                    if row0 in rng_rows else None
                )
                done = done_rows.get(row0, 0)
                while done < opt.num_samples:
                    n = min(chunk, opt.num_samples - done)
                    img, rng_state = beauty_fn(
                        self.camera, self.scene_arrays, self.accel, self.lights,
                        (opt.width, tile_h), n,
                        max_depth=opt.max_depth, rr_depth=opt.rr_depth,
                        nee_max_media=opt.nee_max_media, rng_mode=opt.rng,
                        row_offset=row0, full_resolution=resolution,
                        sample_offset=done, rng_state=rng_state, return_rng=True,
                    )
                    acc[row0 : row0 + tile_h] += img.cpu().numpy() * np.float32(n / opt.num_samples)
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
