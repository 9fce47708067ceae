"""Pass control: the mega pass's scalar decisions kept on the device.

The JAX package runs a tile render as one jit program: between kernel
calls its ``_make_advance`` (render/megarender.py :213-314) sums ``alive``
for the spill loop's ``while_loop`` and for ``live_blocks``, tests
``any(alive)`` for the dynamic modes' ``while_loop`` and ``cond``s and
carries ``dim0``, all as traced values that never reach the host. The port
keeps the same values in a control block, a small int32 tensor on the
device (``CTRL_*``; ``csrc/pass_control.cuh`` holds the same layout), that
K1 reads (``kernels.megakernel.trace_paths_mega(..., ctrl=)``) and that the
control kernel of ``csrc/pass_control.cu`` updates after each sort or K1
launch. ``pass_control`` launches it on CUDA tensors and runs
``pass_control_plain``, its plain PyTorch version, on CPU tensors; neither
reads a value back to the host.

On the card a pass plan (render/megarender.py ``PassPlan``) is captured as
a CUDA graph whose loops are conditional nodes: ``cond_handle``,
``cond_begin`` and ``cond_end`` add them during a torch capture, and the
control kernel sets their condition. The control kernel has no TPU
counterpart; its bound is its launch latency (it reads one byte a lane).
"""

from __future__ import annotations

import ctypes

import torch

CTRL_LIVE, CTRL_DIM0, CTRL_RUN, CTRL_NALIVE, CTRL_COND = 0, 1, 2, 3, 4
CTRL_LEN = 8
BLOCK = 1024  # lanes per live block

# Flags of one control launch (csrc/pass_control.cu).
INIT = 1  # dim0 = ``dim0``; and as SET_FULL
SET_FULL = 2  # live_blocks = every block of the lanes, run flag 1
SET_LIVE = 4  # live_blocks = ceil(alive / 1024), run flag = alive > 0
AFTER_K1 = 8  # the K1 launch before ran: dim0 += ``advance`` (and counted)
COND = 16  # condition = alive > ``threshold`` (and the graph's handle)
DEVICE_COUNT = 32  # count K1's runs and this kernel's in ``device_counts``

_COUNTS: dict = {}


def new_ctrl(device) -> torch.Tensor:
    """A zeroed control block on ``device``."""
    return torch.zeros(CTRL_LEN, dtype=torch.int32, device=device)


def device_counts(device) -> torch.Tensor:
    """The (2,) int64 counts on ``device`` of the K1 launches that ran and
    of the control launches, made by the launches flagged DEVICE_COUNT
    (graph replays and the CPU executor; render/megarender.py)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in _COUNTS:
        _COUNTS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _COUNTS[key]


def counted_devices():
    """The devices that hold device counts."""
    return list(_COUNTS)


def pass_control_plain(alive: torch.Tensor, ctrl: torch.Tensor, counts: torch.Tensor,
                       flags: int, dim0: int = 0, advance: int = 0, threshold: int = 0) -> None:
    """The control kernel in plain PyTorch, on any device: updates ``ctrl``
    (and ``counts``) in place from the alive lanes, with tensor operations
    only (no value goes to the host)."""
    n = alive.shape[0]
    n_alive = alive.sum(dtype=torch.int32)
    if flags & AFTER_K1:
        ran = (ctrl[CTRL_RUN] != 0) & (ctrl[CTRL_LIVE] > 0)
        ctrl[CTRL_DIM0] = ctrl[CTRL_DIM0] + ran.to(torch.int32) * advance
        if flags & DEVICE_COUNT:
            counts[0] += ran.to(torch.int64)
    if flags & INIT:
        ctrl[CTRL_DIM0] = dim0
    if flags & (INIT | SET_FULL):
        ctrl[CTRL_LIVE] = -(-n // BLOCK)
        ctrl[CTRL_RUN] = 1
    if flags & SET_LIVE:
        ctrl[CTRL_LIVE] = torch.div(n_alive + (BLOCK - 1), BLOCK, rounding_mode="floor")
        ctrl[CTRL_RUN] = (n_alive > 0).to(torch.int32)
    ctrl[CTRL_NALIVE] = n_alive
    if flags & COND:
        ctrl[CTRL_COND] = (n_alive > threshold).to(torch.int32)
    if flags & DEVICE_COUNT:
        counts[1] += 1


def pass_control(alive: torch.Tensor, ctrl: torch.Tensor, counts: torch.Tensor, flags: int,
                 dim0: int = 0, advance: int = 0, threshold: int = 0, handle=None) -> None:
    """Update the control block ``ctrl`` after a sort or a K1 launch (the
    ``flags`` above). ``handle``: a graph conditional handle (``cond_handle``)
    that a COND launch also sets. CUDA tensors launch the kernel of
    ``csrc/pass_control.cu`` on the current stream (counted in
    ``pass_control.launches`` unless the stream is being captured), CPU
    tensors run ``pass_control_plain``."""
    if alive.device.type == "cpu":
        if handle is not None:
            raise ValueError("a graph conditional handle needs CUDA tensors")
        pass_control_plain(alive, ctrl, counts, flags, dim0, advance, threshold)
        return
    from . import build

    dev = alive.device
    for name, t, dt, shape in (("alive", alive, torch.bool, alive.shape),
                               ("ctrl", ctrl, torch.int32, (CTRL_LEN,)),
                               ("counts", counts, torch.int64, (2,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape "
                             f"{tuple(shape)} on {dev}")
    if alive.dim() != 1:
        raise ValueError("alive must be one-dimensional")
    fn = build.pass_control().cmr_pass_control_launch
    if handle is not None:
        flags |= 64  # SET_HANDLE
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = fn(ctypes.c_void_p(alive.data_ptr()), alive.shape[0],
                 ctypes.c_void_p(ctrl.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
                 flags, int(dim0), int(advance), int(threshold),
                 0 if handle is None else handle, ctypes.c_void_p(stream.cuda_stream))
        if not torch.cuda.is_current_stream_capturing():
            pass_control.launches += 1
    if err != 0:
        raise RuntimeError(f"pass control launch failed: {build.error_string(err)}")


pass_control.launches = 0  # CUDA launches made by pass_control outside a capture


def _check(err: int, what: str) -> None:
    if err != 0:
        from . import build

        raise RuntimeError(f"{what} failed: {build.error_string(err)}")


_BODY_STREAMS: dict = {}


def body_stream(device) -> torch.cuda.ExternalStream:
    """The stream that conditional bodies on ``device`` are captured on: one
    of the port's own, made once a device (torch's pool hands its streams
    out in turn, so one of them would in time be the stream being
    captured)."""
    from . import build

    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _BODY_STREAMS:
        out = ctypes.c_void_p(0)
        _check(build.pass_control().cmr_graph_body_stream(index, ctypes.byref(out)),
               "creating a stream")
        _BODY_STREAMS[index] = torch.cuda.ExternalStream(out.value,
                                                         device=torch.device("cuda", index))
    return _BODY_STREAMS[index]


def cond_handle(stream: torch.cuda.Stream) -> int:
    """A conditional handle in the graph that ``stream`` is capturing."""
    from . import build

    out = ctypes.c_ulonglong(0)
    _check(build.pass_control().cmr_graph_cond_handle(ctypes.c_void_p(stream.cuda_stream),
                                                      ctypes.byref(out)),
           "cudaGraphConditionalHandleCreate")
    return out.value


def cond_begin(stream: torch.cuda.Stream, handle: int, loop: bool,
               body_stream: torch.cuda.Stream) -> None:
    """Add a conditional node on ``handle`` (WHILE with ``loop``, else IF)
    to ``stream``'s capture and start capturing ``body_stream`` into its
    body."""
    from . import build

    _check(build.pass_control().cmr_graph_cond_begin(
        ctypes.c_void_p(stream.cuda_stream), handle, int(loop),
        ctypes.c_void_p(body_stream.cuda_stream)), "adding a conditional node")


def cond_end(body_stream: torch.cuda.Stream) -> None:
    """End the capture of a conditional node's body."""
    from . import build

    _check(build.pass_control().cmr_graph_cond_end(ctypes.c_void_p(body_stream.cuda_stream)),
           "ending a conditional body's capture")
