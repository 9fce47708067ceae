"""Rendering over several processes, one per host, on ``torch.distributed``.

Counterpart of complex_materials_renderer_tpu/parallel/multihost.py. The
global mesh is the processes x their local shards: process p holds the
global shards p * n_local ... (p + 1) * n_local - 1 of a ('sample',
'tile') mesh laid out as in ``make_render_mesh``. That layout stands for
the JAX package's ``make_global_render_mesh`` (its mesh over every
device of the job), which has no function of its own here. Tracing is
communication-free; each process queues its own shards' calls
(``dispatch_cells``, one program over its cards), and one
``all_gather`` of equal-height padded bands (every process's shard
images, after a small one that checks that every process holds as many
shards) assembles the frame on every process. The mean over 'sample' is
taken there, after the gather, in the order one process takes it, so no
``all_reduce`` is needed and the image is that of
``render_beauty_sharded`` on the same global mesh bit for bit, also when
the 'sample' axis crosses processes. With a process group of one the
gather still runs, so a one-process job checks the collective.
The group serves each device type with its own backend, NCCL for CUDA
tensors and gloo for CPU ones, so the collectives follow the devices the
job renders on, whatever the host holds.

Usage (one process per host, all started with the same arguments):

    from complex_materials_renderer_tpu_torch.parallel import multihost
    multihost.init_distributed("host0:29500", num_processes, process_id)
    img = multihost.render_multihost(camera, scene, accel, lights,
                                     (w, h), spp, rng_mode="counter")

``render_multihost`` returns the full image on every process. The
coordinator may also be a ``file://`` path shared by the processes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .sharding import (
    RenderMesh,
    combine_cells,
    dispatch_cells,
    make_render_mesh,
    mesh_device,
    on_current,
    render_beauty_sharded,
    replicate,
    visible_devices,
)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the job's process group (multihost.py:30): a no-op when it is
    already joined, or with a single process and no coordinator.
    ``coordinator_address`` is ``host:port`` (TCP) or a ``file://`` path.
    CPU tensors go over gloo and, where CUDA and NCCL are there, CUDA
    tensors over NCCL."""
    if is_initialized():
        return
    if coordinator_address is None and num_processes in (None, 1):
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs coordinator_address, num_processes and "
            "process_id: nothing here discovers a cluster"
        )
    method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = "cpu:gloo"
    if torch.cuda.is_available() and dist.is_nccl_available():
        backend += ",cuda:nccl"
    dist.init_process_group(backend, init_method=method, world_size=int(num_processes),
                            rank=int(process_id))


def group_backend(device_type: str) -> str | None:
    """The backend the joined group uses for tensors of ``device_type``
    ('cpu:gloo,cuda:nccl' form, or one name for every type)."""
    name = str(dist.get_backend())
    if ":" not in name:
        return name
    return dict(part.split(":", 1) for part in name.split(",")).get(device_type)


_BACKEND = {"cpu": "gloo", "cuda": "nccl"}


def render_multihost(camera, scene, accel, lights, resolution, num_samples: int,
                     sample_parallel: int = 1, devices=None, **kw) -> np.ndarray:
    """Render (H, W, 3) over every process of the job (multihost.py:62);
    returns the full image as numpy on each process.

    ``devices`` are this process's shards (default: every visible CUDA
    device; a device may be named more than once); every process must
    hold as many. Without a process group this is
    ``render_beauty_sharded`` over ``devices``. ``kw`` goes to the shards'
    beauty pass as in ``render_beauty_sharded``."""
    width, height = resolution
    local = [mesh_device(d) for d in (visible_devices() if devices is None else devices)]
    if not is_initialized():
        mesh = make_render_mesh(local, sample_parallel)
        img = render_beauty_sharded(camera, scene, accel, lights, resolution, num_samples,
                                    mesh=mesh, **kw)
        return img.cpu().numpy()

    world, rank = dist.get_world_size(), dist.get_rank()
    if len({d.type for d in local}) != 1:
        raise ValueError(f"a process's shards must all be cuda or all cpu, got {local}")
    comm = local[0]
    if group_backend(comm.type) != _BACKEND[comm.type]:
        raise ValueError(
            f"the process group serves {comm.type} tensors with "
            f"{group_backend(comm.type)!r}, not {_BACKEND[comm.type]!r}; join it "
            "through init_distributed"
        )
    n_local = len(local)
    counts = [torch.zeros(1, dtype=torch.int64, device=comm) for _ in range(world)]
    dist.all_gather(counts, torch.full((1,), n_local, dtype=torch.int64, device=comm))
    if any(int(c) != n_local for c in counts):
        raise ValueError(f"every process must hold as many shards; got {[int(c) for c in counts]}")
    n = world * n_local
    sample_parallel = max(1, sample_parallel)
    if n % sample_parallel:
        raise ValueError(f"{n} devices not divisible by sample axis {sample_parallel}")
    n_tile = n // sample_parallel
    # The global mesh; the shards of other processes are not addressable
    # here and stay None.
    grid = [[None] * n_tile for _ in range(sample_parallel)]
    own = []
    for i, device in enumerate(local):
        s, t = divmod(rank * n_local + i, n_tile)
        grid[s][t] = device
        own.append((s, t))
    mesh = RenderMesh(tuple(tuple(row) for row in grid))
    tables = replicate((camera, scene, accel, lights), local)
    images = dispatch_cells(own, tables, resolution, num_samples, mesh, **kw)
    mine = torch.stack([images[c].to(comm) for c in own]).contiguous()
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    every = torch.cat(parts)
    cells = {divmod(g, n_tile): every[g] for g in range(n)}
    out = on_current(combine_cells(cells, sample_parallel, n_tile, height, comm)).cpu().numpy()
    if out.shape != (height, width, 3):
        raise RuntimeError(
            f"the gathered image has shape {out.shape}, expected {(height, width, 3)}; "
            "multi-process assembly mismatch"
        )
    return out
