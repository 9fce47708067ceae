"""Tile and sample sharding of the beauty pass.

Counterpart of complex_materials_renderer_tpu/parallel/sharding.py, where
``shard_map`` runs one program over the devices of a ('sample', 'tile')
mesh. Here a mesh is a small grid of ``torch.device``s and each shard is
one call of the engine's own beauty pass:

- the frame's rows are split over 'tile': shard t renders
  ``ceil(H / n_tile)`` rows from ``row_offset + t * rows_per_tile`` (the
  last shard's rows past the frame are rendered and cropped), with no
  communication while tracing;
- the samples are split over 'sample': shard s renders
  ``num_samples / n_sample`` samples from ``sample_offset + s *
  samples_per_dev``, which needs a stateless RNG (counter or ld); the
  partial images of a tile are averaged over 'sample', the ``pmean``;
- the scene tables, accel, camera and lights are copied to each distinct
  device of the mesh once: ``to_device`` keeps each copy while its source
  lives and hands out the same copy at every call, so each card's
  ``PassCache`` and CUDA graphs (render/megarender.py) serve every later
  call over the same tables.

A render is one program over the cards, as the ``shard_map`` is, in two
steps. ``dispatch_cells`` queues every shard's call from this one thread,
card by card, each under its card's guard on that card's current stream;
on the card a call is a graph replay with its input copies and output
clones and reads nothing back, so each card works while the next is given
its calls. ``combine_cells`` then takes the mean over 'sample' and stacks
the tiles on the mesh's first device, the images moving from card to
card by peer copies on side streams (``side_stream``), each behind its
shard's call: no card's stream waits on another card's, so each card
goes on to its next call while the band is gathered. The caller's one
host read, of the combined image, is the JAX package's
``block_until_ready``. A device may appear in the
mesh more than once: each appearance is a shard of its own, queued in
mesh order on its device's one stream, where it shares the device's
counters and graphs (the tests build 8 shards on the one CPU this way).
Seeds derive from the global (pixel, sample), so a tile split renders
the single-device image bit for bit, and a sample split differs from it
only by the order of the mean's sums.

Two quirks of the reference are kept (ROADMAP R5, R6): ``engine='pair'``
renders through the wavefront ``render_beauty`` (sharding.py:103-116 of
the JAX package takes only mega and binned to the megarender pass loop),
and ``tir`` is not passed to the shards, so a sharded render always
reflects at total internal reflection (sharding.py:118-135).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from functools import partial

import torch
from torch.utils.weak import WeakIdKeyDictionary

@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A ('sample', 'tile') grid of devices: ``devices[s][t]`` renders
    sample slice s of tile t. ``shape`` maps each axis name to its size,
    as ``jax.sharding.Mesh.shape`` does."""

    devices: tuple  # (n_sample, n_tile) tuple of tuples of torch.device

    @property
    def shape(self) -> dict:
        return {"sample": len(self.devices), "tile": len(self.devices[0])}


def visible_devices() -> list:
    """Every visible CUDA device; raises when there is none."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device is available; pass the devices of the mesh "
            "explicitly (e.g. [torch.device('cpu')] * 8) to shard on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_device(device) -> torch.device:
    """``device`` as a torch.device with an index on CUDA; raises when it
    is not there. ``cpu`` and ``cpu:0`` stay distinct: the tests take them
    for two devices."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a mesh device must be cuda or cpu, got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"the mesh names {dev}, but no CUDA device is available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"the mesh names cuda:{index}, but only {torch.cuda.device_count()} "
            "CUDA device(s) are visible"
        )
    return torch.device("cuda", index)


def make_render_mesh(devices=None, sample_parallel: int = 1) -> RenderMesh:
    """A ('sample', 'tile') mesh over ``devices`` (default: every visible
    CUDA device), ``sample_parallel`` rows of ``len(devices) /
    sample_parallel`` tiles."""
    devices = [mesh_device(d) for d in (visible_devices() if devices is None else devices)]
    n = len(devices)
    if n == 0:
        raise ValueError("a render mesh needs at least one device")
    sample_parallel = max(1, sample_parallel)
    if n % sample_parallel:
        raise ValueError(f"{n} devices not divisible by sample axis {sample_parallel}")
    n_tile = n // sample_parallel
    return RenderMesh(tuple(tuple(devices[s * n_tile:(s + 1) * n_tile])
                            for s in range(sample_parallel)))


def _tensors(obj):
    """Every tensor in ``obj``, through dataclasses and named tuples."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for x in obj:
            yield from _tensors(x)


def _ref(x):
    """A weak reference to ``x`` where it takes one, else ``x`` itself
    behind the same call."""
    try:
        return weakref.ref(x)
    except TypeError:
        return lambda: x


# {watched object: {(id(source), device): (the source's fields, copy)}}:
# the copies ``to_device`` made. The watched object is the source, or,
# where it takes no weak reference (a named tuple), its first tensor; the
# entries go with it.
_COPIES = WeakIdKeyDictionary()


def _release(entries: dict) -> None:
    """The copies' source is gone: their kept ``PassCache``s go too."""
    from ..render import megarender

    megarender.release([copy for _, copy in entries.values()])


def _moved(obj, device):
    """A new ``obj`` with its tensors copied to ``device``."""
    def move(x):
        return x.to(device, copy=True) if isinstance(x, torch.Tensor) else to_device(x, device)

    if isinstance(obj, torch.Tensor):
        return move(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: move(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init
        })
    return type(obj)(*(move(x) for x in obj))


def to_device(obj, device):
    """``obj`` with every tensor in it (through dataclasses and named
    tuples) on ``device``; everything else is kept as it is. An ``obj``
    already there is returned itself; otherwise its copy, made at the first
    call and the same object at every later one until ``obj`` is dropped
    (so that ``megarender.pass_cache`` finds the copy's graphs again)."""
    device = torch.device(device)
    if all(x.device == device for x in _tensors(obj)):
        return obj
    try:
        weakref.ref(obj)
        watched, fields = obj, None
    except TypeError:
        watched, fields = next(_tensors(obj)), tuple(_ref(x) for x in obj)
    entries = _COPIES.get(watched)
    if entries is None:
        entries = _COPIES[watched] = {}
        weakref.finalize(watched, _release, entries).atexit = False
    key = (id(obj), device)
    hit = entries.get(key)
    if hit is not None and (fields is None or (
            type(hit[1]) is type(obj)
            and all(f() is x for f, x in zip(hit[0], obj)))):
        return hit[1]
    copy = _moved(obj, device)
    entries[key] = (fields, copy)
    return copy


def replicate(objs, devices) -> dict:
    """{device: ``objs`` with their tensors on it} for each distinct
    device of ``devices`` (``to_device``: the same objects at every call)."""
    return {d: [to_device(x, d) for x in objs] for d in dict.fromkeys(devices)}


def mesh_cells(mesh: RenderMesh) -> list:
    """Every (s, t) shard of ``mesh``, sample-major."""
    return [(s, t) for s in range(mesh.shape["sample"]) for t in range(mesh.shape["tile"])]


def _beauty_fn(engine: str):
    """The per-shard beauty pass of ``engine`` (sharding.py:103-116):
    mega and binned run the megarender pass loop, every other engine the
    wavefront loop, pair included (ROADMAP R5)."""
    if engine in ("mega", "binned"):
        from ..render.megarender import render_beauty_mega

        return partial(render_beauty_mega, trace_engine=engine)
    from ..render.integrator import render_beauty

    return render_beauty


def _device_guard(device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def dispatch_cells(cells, tables: dict, resolution, num_samples: int, mesh: RenderMesh,
                   max_depth: int = 32, rr_depth: int = 16, nee_max_media: int = 4,
                   rng_mode: str = "parity", row_offset: int = 0, full_resolution=None,
                   sample_offset: int = 0, engine: str = "wavefront",
                   direct: str = "scatter") -> dict:
    """Queue the shards ``cells`` ((s, t) pairs) of ``mesh`` from
    ``tables`` ({device: (camera, scene, accel, lights)}, see
    ``replicate``); returns {(s, t): (rows_per_tile, W, 3) float32 image
    on the shard's device}. Every call is queued from this thread, device
    by device, the shards of one device in mesh order on its current
    stream; nothing is read back (``combine_cells`` collects)."""
    width, height = resolution
    full_resolution = tuple(full_resolution) if full_resolution else (width, height)
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    if n_sample > 1 and rng_mode not in ("counter", "ld"):
        raise ValueError(
            "sample-parallel rendering requires an order-independent "
            "rng mode ('counter' or 'ld')"
        )
    if num_samples % n_sample:
        raise ValueError(f"{num_samples} samples not divisible by sample axis {n_sample}")
    rows_per_tile = math.ceil(height / n_tile)
    samples_per_dev = num_samples // n_sample
    beauty = _beauty_fn(engine)

    by_device: dict = {}
    for s, t in cells:
        by_device.setdefault(mesh.devices[s][t], []).append((s, t))
    images: dict = {}
    for device, own in by_device.items():
        with _device_guard(device):
            for s, t in own:
                images[(s, t)] = beauty(
                    *tables[device], (width, rows_per_tile), samples_per_dev,
                    max_depth=max_depth, rr_depth=rr_depth, nee_max_media=nee_max_media,
                    rng_mode=rng_mode, row_offset=row_offset + t * rows_per_tile,
                    full_resolution=full_resolution,
                    sample_offset=sample_offset + s * samples_per_dev, direct=direct,
                )
    return images


_SIDE: dict = {}  # {card index: its side stream}


def side_stream(device):
    """The side stream of the card ``device``, made at its first use, on
    which ``combine_cells`` moves and stacks the shards' images; None off
    the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(index)
    return _SIDE[index]


def combine_cells(images: dict, n_sample: int, n_tile: int, height: int,
                  device) -> torch.Tensor:
    """The (height, W, 3) image on ``device`` from every shard's image:
    the mean over 'sample' of each tile, the tiles stacked, the pad rows
    cropped; nothing is read back. On cards the image is made on
    ``device``'s side stream (``side_stream``), and each image comes over
    on its own card's side stream, which waits only for the image's call:
    no card's current stream waits on another card's. ``on_current``
    makes the image complete on ``device``'s current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return _stack({c: img.to(device) for c, img in images.items()}, n_sample, n_tile, height)
    # The streams the shards' calls ran on, read before a side stream is
    # made current on ``device``.
    made = {img.device: torch.cuda.current_stream(img.device) for img in images.values()}
    moved = {}
    with torch.cuda.stream(side_stream(device)):
        for cell, img in images.items():
            side = side_stream(img.device)
            side.wait_stream(made[img.device])
            img.record_stream(side)
            with torch.cuda.stream(side):
                moved[cell] = img.to(device)
        return _stack(moved, n_sample, n_tile, height)


def on_current(img: torch.Tensor) -> torch.Tensor:
    """``img`` from ``combine_cells``, with its card's current stream made
    to wait for the side stream that made it."""
    if img.is_cuda:
        current = torch.cuda.current_stream(img.device)
        current.wait_stream(side_stream(img.device))
        img.record_stream(current)
    return img


def _stack(images: dict, n_sample: int, n_tile: int, height: int) -> torch.Tensor:
    tiles = [torch.stack([images[(s, t)] for s in range(n_sample)]).mean(dim=0)
             for t in range(n_tile)]
    return torch.cat(tiles)[:height]


def render_beauty_sharded(camera, scene, accel, lights, resolution, num_samples: int,
                          max_depth: int = 32, rr_depth: int = 16, nee_max_media: int = 4,
                          rng_mode: str = "parity", mesh: RenderMesh | None = None,
                          row_offset: int = 0, full_resolution=None, sample_offset: int = 0,
                          engine: str = "wavefront", direct: str = "scatter") -> torch.Tensor:
    """Render (H, W, 3), rows sharded over 'tile', samples over 'sample'
    (sharding.py:50). ``row_offset``, ``full_resolution`` and
    ``sample_offset`` place this call as a band and sample chunk of a
    larger render, as in the single-device passes. ``engine``: mega and
    binned run the megarender pass loop on each shard, any other the
    wavefront loop. Returns a tensor on the mesh's first device, queued
    there: reading it is the call's one host read."""
    if mesh is None:
        mesh = make_render_mesh()
    cells = mesh_cells(mesh)
    tables = replicate((camera, scene, accel, lights), [mesh.devices[s][t] for s, t in cells])
    images = dispatch_cells(
        cells, tables, resolution, num_samples, mesh,
        max_depth=max_depth, rr_depth=rr_depth, nee_max_media=nee_max_media,
        rng_mode=rng_mode, row_offset=row_offset, full_resolution=full_resolution,
        sample_offset=sample_offset, engine=engine, direct=direct,
    )
    return on_current(combine_cells(images, mesh.shape["sample"], mesh.shape["tile"],
                                    resolution[1], mesh.devices[0][0]))
