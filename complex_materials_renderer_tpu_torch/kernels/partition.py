"""The compaction sort of the pass plan: dead lanes last, live lanes by the
coherence key, the state permuted in place.

Counterpart of the sort in complex_materials_renderer_tpu/render/
megarender.py ``_partition_live`` (:114-146), which ``jnp.argsort`` does
in XLA: no Pallas kernel, so this kernel replaces no TPU kernel. Its
permutation is the stable argsort's, so the images are the same.

On CUDA tensors ``partition`` launches the hand-written partition of
``csrc/partition.cu`` (four launches a sort: the key with its digit
histograms and the state's copy into a scratch, two stable radix passes
over the 19-bit key, and the move of the state back in place by the
permutation with the dropped lanes' bank rows), or raises; on CPU tensors it
runs ``partition_plain``: ``coherence_key``, ``torch.argsort(stable=True)``,
a gather and a copy a field and, at a phase shrink, the bank scatter.

The kernel sorts a 19-bit key: a live key has 18 bits (direction octant 3,
Morton cell 15) and a dead lane's 0xFFFFFFFF becomes ``DEAD_KEY`` (1 << 18),
above every live key, so the stable order is the same. Its two passes take
``DIGIT_BITS`` bits each, low digit first.

The kernel works in a ``Scratch`` made before a capture (render/
megarender.py ``PassPlan.prepare``) and kept with the graph, which reads
it by address; sorts that share one run in the order of one stream.
"""

from __future__ import annotations

import ctypes

import torch

from .megakernel import MegaState, _require

DEAD_KEY = 1 << 18  # a dead lane's key in the kernel
DIGIT_BITS = (10, 9)  # the kernel's radix passes, low digit first
LAUNCHES_PER_SORT = 4
MAX_LANES = 1 << 24


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit ints for Morton codes (classic bit smear)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def coherence_key(org, direction, alive, world_lo, world_hi, sortkey: str = "dir"):
    """The compaction sort key as u32 words in int64: (direction octant,
    Morton cell of the origin), or cell-major for ``sortkey='pos'``; dead
    lanes 0xFFFFFFFF, so they sort last."""
    extent = torch.clamp(world_hi - world_lo, min=1e-6)
    rel = (org - world_lo) / extent
    q = torch.clamp(rel * 32.0, 0.0, 31.0).to(torch.int64)
    cell = (_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1) | _spread3(q[:, 2])
    octant = ((direction[:, 0] > 0).to(torch.int64) * 4
              + (direction[:, 1] > 0).to(torch.int64) * 2
              + (direction[:, 2] > 0).to(torch.int64))
    key = (cell << 3) | octant if sortkey == "pos" else (octant << 15) | cell
    return torch.where(alive, key, torch.full_like(key, 0xFFFFFFFF))


def partition_plain(state: MegaState, lane: torch.Tensor, world_lo, world_hi,
                    sortkey: str = "dir", banks=None) -> torch.Tensor:
    """The plain version, on any device: sort ``state`` and ``lane`` in
    place by the stable argsort of ``coherence_key``; with ``banks`` =
    (rad_bank, rng_bank, keep), write the rad and rng rows of the lanes
    sorted to positions >= ``keep`` into the banks at their lane ids.
    Returns the permutation (int64)."""
    perm = torch.argsort(coherence_key(state.org, state.dir, state.alive, world_lo, world_hi,
                                       sortkey), stable=True)
    for x in (*state, lane):
        x.copy_(x[perm])
    if banks is not None:
        rad_bank, rng_bank, keep = banks
        drop = lane[keep:]
        rad_bank[drop] = state.rad[keep:]
        rng_bank[drop] = state.rng[keep:]
    return perm


class Scratch:
    """The kernel's working memory for sorts of up to ``lanes`` lanes on the
    card ``device`` (the state's copy, keys, indices, the permutation and
    the look-back words), zeroed when made: its control words are zero
    between sorts. A graph reads it by address, so whoever captures a sort
    keeps it as long as the graph (``PassPlan`` does). Made outside a
    capture; after a failed sort, make a new one."""

    def __init__(self, device, lanes: int):
        from . import build

        if not 0 < lanes <= MAX_LANES:
            raise ValueError(f"the partition takes 1 to {MAX_LANES} lanes, got {lanes}")
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the partition's scratch is made before a capture, not inside it")
        perm_offset = ctypes.c_longlong(0)
        size = build.partition().cmr_partition_scratch_bytes(lanes, ctypes.byref(perm_offset))
        self.lanes = lanes
        self.buf = torch.zeros(size, dtype=torch.uint8, device=device)
        self.perm_offset = perm_offset.value

    def perm(self, n: int) -> torch.Tensor:
        return self.buf[self.perm_offset:self.perm_offset + 4 * n].view(torch.int32)


def partition(state: MegaState, lane: torch.Tensor, world_lo: torch.Tensor,
              world_hi: torch.Tensor, sortkey: str = "dir", banks=None,
              scratch: Scratch | None = None) -> torch.Tensor:
    """Sort the wavefront in place: dead lanes last, live lanes by
    (direction octant, Morton cell of the origin), or cell-major for
    ``sortkey='pos'``, stably, like ``jnp.argsort``; with ``banks`` =
    (rad_bank, rng_bank, keep) also bank the lanes sorted to positions >=
    ``keep`` (a phase shrink). CUDA tensors launch the kernel on the current
    stream in ``scratch`` (a ``Scratch`` on their card, required), counted
    in ``partition.launches`` (captured or not), and return the permutation
    as int32 in the scratch, valid until its next sort; CPU tensors run
    ``partition_plain``."""
    if sortkey not in ("dir", "pos"):
        raise ValueError(f"sortkey must be dir|pos, got {sortkey!r}")
    dev = state.org.device
    if dev.type == "cpu":
        return partition_plain(state, lane, world_lo, world_hi, sortkey, banks)
    from . import build

    n = lane.shape[0]
    for name, t, dt, shape in (
            ("org", state.org, torch.float32, (n, 3)), ("dir", state.dir, torch.float32, (n, 3)),
            ("thr", state.thr, torch.float32, (n, 3)), ("rad", state.rad, torch.float32, (n, 3)),
            ("rng", state.rng, torch.int64, (n,)), ("depth", state.depth, torch.int32, (n,)),
            ("alive", state.alive, torch.bool, (n,)), ("aux", state.aux, torch.int64, (n,)),
            ("lane", lane, torch.int64, (n,)), ("world_lo", world_lo, torch.float32, (3,)),
            ("world_hi", world_hi, torch.float32, (3,))):
        _require(t, name, dt, shape, dev)
    rad_bank = rng_bank = None
    keep = bank_rows = 0
    if banks is not None:
        rad_bank, rng_bank, keep = banks
        bank_rows = rng_bank.shape[0]
        _require(rad_bank, "rad_bank", torch.float32, (bank_rows, 3), dev)
        _require(rng_bank, "rng_bank", torch.int64, (bank_rows,), dev)
    if scratch is None:
        raise ValueError("a partition on the card takes a Scratch made before it")
    if scratch.buf.device != dev or scratch.lanes < n:
        raise ValueError(f"the scratch holds {scratch.lanes} lanes on {scratch.buf.device}, "
                         f"not {n} on {dev}")
    with torch.cuda.device(dev):
        ptr = lambda t: ctypes.c_void_p(t.data_ptr()) if t is not None else None  # noqa: E731
        err = build.partition().cmr_partition_launch(
            *(ptr(t) for t in (*state[:4], state.rng, state.depth, state.alive, state.aux, lane,
                               world_lo, world_hi)),
            n, int(sortkey == "pos"), ptr(rad_bank), ptr(rng_bank), bank_rows, int(keep),
            ptr(scratch.buf), scratch.lanes,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        partition.launches += LAUNCHES_PER_SORT
    if err != 0:
        raise RuntimeError(f"partition launch failed: {build.error_string(err)}")
    return scratch.perm(n)


partition.launches = 0  # kernel launches made by partition on CUDA tensors (a capture's once)
