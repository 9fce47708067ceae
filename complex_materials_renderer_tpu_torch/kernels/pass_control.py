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

Every control launch names the plan step that ends there, a *site*
(``Site``: a label such as "K1 at width w, cap c, phase i", "sort before
phase i" or "pass head", what the step ran, and a K1 site's launch width),
from a table filled as the plans are captured (``site_index``). The executors'
launches count, always, in a block of counters on each card
(``device_counts``, the layout ``CNT_*`` and ``SITE_*`` of
``csrc/pass_control.cuh``): the K1 launches that ran and the control
launches (indices 0 and 1), and for each site its visits, the K1 launches
that ran just before it, their live lanes and the lanes they covered, the
walk counts those launches left (their lanes' bounces, the super boxes
entered, the clusters tested and the group boxes entered: K1 adds them to
the block's accumulator
``CNT_WALK`` and the site's control launch moves them to the site), and
on the card the nanoseconds of the segments that end there (%globaltimer
at each control launch's entry, less the last stamp). A captured call
starts and ends with a stamp (``stamp``), which keeps its interval in a
ring of the block. The CPU executor counts everything but the time.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

CTRL_LIVE, CTRL_DIM0, CTRL_RUN, CTRL_NALIVE, CTRL_COND = 0, 1, 2, 3, 4
CTRL_ITER, CTRL_RUNG, CTRL_EXTENT = 5, 6, 7
CTRL_LEN = 8
BLOCK = 1024  # lanes per live block
MAX_RUNGS = 8  # rungs of one launch-shape ladder (csrc/pass_control.cu)

# Flags of one control launch (csrc/pass_control.cu).
INIT = 1  # dim0 = ``dim0``; and as SET_FULL
SET_FULL = 2  # live_blocks = every block of the lanes, run flag 1
SET_LIVE = 4  # live_blocks = ceil(alive / 1024), run flag = alive > 0
AFTER_K1 = 8  # the K1 launch before ran: dim0 += ``advance`` (and counted)
COND = 16  # condition = alive > ``threshold`` (and the graph's handle)
DEVICE_COUNT = 32  # count K1's runs and this kernel's in ``device_counts``
_SET_HANDLE = 64  # set by ``pass_control`` when it is given a handle
ITER_RESET = 128  # the iteration counter = 0 (before the condition)
ITER_STEP = 256  # the iteration counter += 1 (before the condition)
ITER_CAP = 512  # COND also needs iteration < ``cap``
ITER_GRACE = 1024  # COND is alive > 0 while iteration < ``cap``, alive > ``threshold`` after
RUNGS = 2048  # the ladder rung that holds the count (or the extent) and its IF nodes
EXTENT = 4096  # record the last true byte's index + 1; with RUNGS, the rungs' value
NOT_K1 = 8192  # with AFTER_K1: the kernel before was not K1 (no K1 count)
_SET_RUNG_HANDLES = 16384  # set by ``pass_control`` when it is given rung handles
SITE_COUNT = 32768  # count the launch at its site

# The counter block of a device (int64; csrc/pass_control.cuh CNT_*, WALK_*, SITE_*).
CNT_K1, CNT_CONTROL, CNT_LAST, CNT_CALLS, CNT_CALL_NS, CNT_CALIBRATE = 0, 1, 2, 3, 4, 5
CNT_WALK = 8  # K1's walk accumulator: WALK_LEN counts that K1 launches add to
WALK_BOUNCES, WALK_SUPERS, WALK_CLUSTERS, WALK_GROUPS = 0, 1, 2, 3
WALK_LEN = 4
CNT_HEAD = 16
CNT_RING = 128  # call intervals kept, (start, end) ns from CNT_HEAD
CNT_SITES = CNT_HEAD + 2 * CNT_RING
SITE_VISITS, SITE_K1, SITE_LIVE, SITE_LANES = 0, 1, 2, 3
# The walk counts, in WALK_* order.
SITE_BOUNCES, SITE_SUPERS, SITE_CLUSTERS, SITE_GROUPS = 4, 5, 6, 7
SITE_NS = 8
SITE_FIELDS = 9
SITE_KEYS = ("visits", "k1", "live", "lanes", "bounces", "supers", "clusters", "groups",
             "ns")  # by index
MAX_SITES = 512
CNT_LEN = CNT_SITES + MAX_SITES * SITE_FIELDS
STAMP_START, STAMP_END, STAMP_CALIBRATE = 0, 1, 2


class Site(NamedTuple):
    """A plan step that ends at a control launch: its ``label``, what its
    segment ran (``kind``: 'k1', 'sort' or 'other') and, for a K1 site,
    the width K1 is launched at."""

    label: str
    kind: str = "other"
    width: Optional[int] = None


# The site table, in the order the plans named them. Site 0 takes the
# launches that name none; site 1 the tail of a captured call, from its last
# control launch to its end stamp (``stamp``).
SITE_OTHER, SITE_CALL_END = 0, 1
_SITES: list = [Site("other"), Site("call end")]
_SITE_INDEX: dict = {site.label: i for i, site in enumerate(_SITES)}

_COUNTS: dict = {}
_KERNEL_COUNTS: dict = {}
# The kernels whose launches graph replays count on the card (``kernel_counts``).
COUNTED_KERNELS = ("K3", "K4", "K5", "K6")


def new_ctrl(device) -> torch.Tensor:
    """A zeroed control block on ``device``."""
    return torch.zeros(CTRL_LEN, dtype=torch.int32, device=device)


def _device_key(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def site_index(site) -> int:
    """The index of ``site`` (a ``Site``, a label of an 'other' site, or an
    index already), added to the table at its first use; raises when the
    table is full (nothing is dropped) or when the label stands for
    another site already."""
    if isinstance(site, int):
        return site
    if isinstance(site, str):
        site = Site(site)
    i = _SITE_INDEX.get(site.label)
    if i is None:
        if len(_SITES) >= MAX_SITES:
            raise RuntimeError(f"the pass control's site table is full ({MAX_SITES} sites); "
                               f"cannot add {site.label!r}")
        i = _SITE_INDEX[site.label] = len(_SITES)
        _SITES.append(site)
    elif _SITES[i] != site:
        raise ValueError(f"site {site.label!r} is {_SITES[i]}, not {site}")
    return i


def sites() -> list:
    """Each ``Site`` so far, by index."""
    return list(_SITES)


def site_labels() -> list:
    """The label of each site so far, by index."""
    return [site.label for site in _SITES]


def device_counts(device) -> torch.Tensor:
    """The (CNT_LEN,) int64 counter block on ``device``: [0] the K1 launches
    that ran and [1] the control launches, made by the launches flagged
    DEVICE_COUNT (graph replays and the CPU executor; render/megarender.py);
    then the call ring and the sites' counts (``site_counts``), made by the
    launches flagged SITE_COUNT (every executor's) and by ``stamp``."""
    key = _device_key(device)
    if key not in _COUNTS:
        _COUNTS[key] = torch.zeros(CNT_LEN, dtype=torch.int64, device=key)
    return _COUNTS[key]


def walk_counts(device) -> torch.Tensor:
    """The (WALK_LEN,) view of ``device``'s counter block that K1's
    launches there add their walk counts to (``CNT_WALK``)."""
    return device_counts(device).narrow(0, CNT_WALK, WALK_LEN)


def site_counts(block) -> dict:
    """{label: [visits, K1 launches that ran, their live lanes, the lanes
    they covered, their bounces, supers entered, clusters tested, groups
    entered, ns]} of the sites in ``block``, a counter block or a prefix of
    one, on the host (a list, or a tensor read here)."""
    block = block.tolist() if isinstance(block, torch.Tensor) else list(block)
    out = {}
    for i, label in enumerate(site_labels()):
        base = CNT_SITES + i * SITE_FIELDS
        fields = block[base:base + SITE_FIELDS]
        if len(fields) == SITE_FIELDS and any(fields):
            out[label] = fields
    return out


def call_intervals(block, since: int = 0) -> list:
    """The (start, end) ns of the calls stamped in ``block`` (on the host)
    from call number ``since`` on, as far as the ring still holds them."""
    block = block.tolist() if isinstance(block, torch.Tensor) else list(block)
    calls = block[CNT_CALLS]
    out = []
    for i in range(max(since, calls - CNT_RING), calls):
        j = CNT_HEAD + 2 * (i % CNT_RING)
        out.append((block[j], block[j + 1]))
    return out


def kernel_counts(device) -> torch.Tensor:
    """The (4,) int64 counts on ``device`` of the K3, K4, K5 and K6 launches
    that graph replays ran (``COUNTED_KERNELS``): a captured launch adds one
    to its count on the card where it launches (``count_launch``)."""
    key = _device_key(device)
    if key not in _KERNEL_COUNTS:
        _KERNEL_COUNTS[key] = torch.zeros(len(COUNTED_KERNELS), dtype=torch.int64, device=key)
    return _KERNEL_COUNTS[key]


def counted_devices():
    """The devices that hold device counts."""
    return sorted(set(_COUNTS) | set(_KERNEL_COUNTS))


def count_launch(wrapper, kernel: str, device) -> None:
    """Count one launch of ``kernel`` by ``wrapper``: in ``wrapper.launches``
    on the host, or, while the stream is being captured, on the card (an
    add captured beside the launch, so that each replay of it counts)."""
    if torch.cuda.is_current_stream_capturing():
        kernel_counts(device).narrow(0, COUNTED_KERNELS.index(kernel), 1).add_(1)
    else:
        wrapper.launches += 1


def ladder(rule, hi: int, lo: int = 1):
    """The rungs of a launch-shape rule over the counts [lo, hi]: a list of
    (first count, last count, rule value), ascending, where ``rule`` is
    monotone in the count (each value holds one run of counts)."""
    rungs = []
    c = lo
    while c <= hi:
        v = rule(c)
        a, b = c, hi
        while a < b:  # the last count of this run
            m = (a + b + 1) // 2
            if rule(m) == v:
                a = m
            else:
                b = m - 1
        rungs.append((c, a, v))
        c = a + 1
    if len(rungs) > MAX_RUNGS:
        raise ValueError(f"a ladder of {len(rungs)} rungs exceeds {MAX_RUNGS}")
    return rungs


def rung_edges(rungs) -> list:
    """The control kernel's edges of ``ladder`` rungs: rung i holds the
    values in [edges[i], edges[i + 1])."""
    return [a for a, _, _ in rungs] + [rungs[-1][1] + 1] if rungs else [0]


def pass_control_plain(alive: torch.Tensor, ctrl: torch.Tensor, counts: torch.Tensor,
                       flags: int, dim0: int = 0, advance: int = 0, threshold: int = 0,
                       cap: int = 0, edges=(), site: int = SITE_OTHER) -> None:
    """The control kernel in plain PyTorch, on any device: updates ``ctrl``
    (and ``counts``) in place from the true bytes of ``alive``, with tensor
    operations only (no value goes to the host). A site's nanoseconds stay
    0: there is no card's clock to read."""
    n = alive.shape[0]
    n_alive = alive.sum(dtype=torch.int32)
    if flags & SITE_COUNT:
        k1 = (ctrl[CTRL_RUN] != 0) & (ctrl[CTRL_LIVE] > 0) if flags & AFTER_K1 \
            and not flags & NOT_K1 else torch.zeros((), dtype=torch.bool, device=ctrl.device)
        k1 = k1.to(torch.int64)
        base = CNT_SITES + site * SITE_FIELDS
        counts[base + SITE_VISITS] += 1
        counts[base + SITE_K1] += k1
        counts[base + SITE_LIVE] += k1 * ctrl[CTRL_NALIVE].to(torch.int64)
        counts[base + SITE_LANES] += k1 * ctrl[CTRL_LIVE].to(torch.int64) * BLOCK
        counts[base + SITE_BOUNCES:base + SITE_BOUNCES + WALK_LEN] += \
            counts[CNT_WALK:CNT_WALK + WALK_LEN]
        counts[CNT_WALK:CNT_WALK + WALK_LEN] = 0
    if flags & AFTER_K1:
        ran = (ctrl[CTRL_RUN] != 0) & (ctrl[CTRL_LIVE] > 0)
        ctrl[CTRL_DIM0] = ctrl[CTRL_DIM0] + ran.to(torch.int32) * advance
        if flags & DEVICE_COUNT and not flags & NOT_K1:
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
    extent = None
    if flags & EXTENT:
        idx = torch.arange(1, n + 1, dtype=torch.int32, device=alive.device)
        extent = torch.where(alive, idx, torch.zeros_like(idx)).amax() if n else \
            torch.zeros((), dtype=torch.int32, device=alive.device)
        ctrl[CTRL_EXTENT] = extent
    if flags & ITER_RESET:
        ctrl[CTRL_ITER] = 0
    if flags & ITER_STEP:
        ctrl[CTRL_ITER] = ctrl[CTRL_ITER] + 1
    if flags & COND:
        go = n_alive > threshold
        if flags & ITER_CAP:
            go = go & (ctrl[CTRL_ITER] < cap)
        if flags & ITER_GRACE:
            go = n_alive > torch.where(ctrl[CTRL_ITER] < cap, 0, threshold)
        ctrl[CTRL_COND] = go.to(torch.int32)
    if flags & RUNGS:
        value = extent if flags & EXTENT else n_alive
        rung = torch.full((), -1, dtype=torch.int32, device=alive.device)
        for i in range(len(edges) - 1):
            inside = (value >= edges[i]) & (value < edges[i + 1])
            rung = torch.where(inside, i, rung)
        ctrl[CTRL_RUNG] = rung
    if flags & DEVICE_COUNT:
        counts[1] += 1


def pass_control(alive: torch.Tensor, ctrl: torch.Tensor, counts: torch.Tensor, flags: int,
                 dim0: int = 0, advance: int = 0, threshold: int = 0, cap: int = 0,
                 edges=(), handle=None, handles=None, site: int = SITE_OTHER) -> None:
    """Update the control block ``ctrl`` after a sort or a launch (the
    ``flags`` above) from the true bytes of the one-dimensional bool tensor
    ``alive``. ``handle``: a graph conditional handle (``cond_handle``) that
    a COND launch also sets; ``edges`` and ``handles``: a RUNGS launch's
    ladder (``rung_edges``) and a handle per rung, each set to whether its
    rung holds the value. ``counts``: a counter block (``device_counts``'
    layout), where a SITE_COUNT launch also counts at ``site``. CUDA
    tensors launch the kernel of ``csrc/pass_control.cu`` on the current
    stream (counted in ``pass_control.launches`` unless the stream is being
    captured), CPU tensors run ``pass_control_plain``."""
    if flags & RUNGS and not 2 <= len(edges) <= MAX_RUNGS + 1:
        raise ValueError(f"a ladder takes 1 to {MAX_RUNGS} rungs, got edges {list(edges)}")
    if not 0 <= site < MAX_SITES:
        raise ValueError(f"site {site} is not below {MAX_SITES}")
    if tuple(counts.shape) != (CNT_LEN,):
        raise ValueError(f"counts must be a counter block of shape ({CNT_LEN},), "
                         f"got {tuple(counts.shape)}")
    if alive.device.type == "cpu":
        if handle is not None or any(h is not None for h in handles or ()):
            raise ValueError("a graph conditional handle needs CUDA tensors")
        pass_control_plain(alive, ctrl, counts, flags, dim0, advance, threshold, cap, edges,
                           site)
        return
    from . import build

    dev = alive.device
    for name, t, dt, shape in (("alive", alive, torch.bool, alive.shape),
                               ("ctrl", ctrl, torch.int32, (CTRL_LEN,)),
                               ("counts", counts, torch.int64, (CNT_LEN,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape "
                             f"{tuple(shape)} on {dev}")
    if alive.dim() != 1:
        raise ValueError("alive must be one-dimensional")
    fn = build.pass_control().cmr_pass_control_launch
    if handle is not None:
        flags |= _SET_HANDLE
    n_rungs = len(edges) - 1 if flags & RUNGS else 0
    c_edges = (ctypes.c_int * (n_rungs + 1))(*(int(e) for e in edges)) if n_rungs else None
    c_handles = None
    if handles is not None and any(h is not None for h in handles):
        if len(handles) != n_rungs or any(h is None for h in handles):
            raise ValueError("a RUNGS launch takes one handle a rung, or none")
        c_handles = (ctypes.c_ulonglong * n_rungs)(*(int(h) for h in handles))
        flags |= _SET_RUNG_HANDLES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = fn(ctypes.c_void_p(alive.data_ptr()), alive.shape[0],
                 ctypes.c_void_p(ctrl.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
                 flags, int(dim0), int(advance), int(threshold), int(cap), int(site),
                 0 if handle is None else handle, n_rungs, c_edges, c_handles,
                 ctypes.c_void_p(stream.cuda_stream))
        if not torch.cuda.is_current_stream_capturing():
            pass_control.launches += 1
    if err != 0:
        raise RuntimeError(f"pass control launch failed: {build.error_string(err)}")


pass_control.launches = 0  # CUDA launches made by pass_control outside a capture


def stamp(device, which: int) -> None:
    """Launch a STAMP_START, STAMP_END or STAMP_CALIBRATE stamp into the
    counter block of the card ``device``, on its current stream."""
    from . import build

    counts = device_counts(device)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream(counts.device)
        _check(build.pass_control().cmr_pass_stamp_launch(
            ctypes.c_void_p(counts.data_ptr()), which, ctypes.c_void_p(stream.cuda_stream)),
            "a stamp launch")


def _check(err: int, what: str) -> None:
    if err != 0:
        from . import build

        raise RuntimeError(f"{what} failed: {build.error_string(err)}")


_BODY_STREAMS: dict = {}


def body_stream(device, depth: int = 0) -> torch.cuda.ExternalStream:
    """The stream that conditional bodies at nesting ``depth`` on ``device``
    are captured on: one of the port's own a depth, made once (torch's pool
    hands its streams out in turn, so one of them would in time be the
    stream being captured; a nested body is captured while its parent's
    capture is open, so each depth has its own)."""
    from . import build

    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if (index, depth) not in _BODY_STREAMS:
        out = ctypes.c_void_p(0)
        _check(build.pass_control().cmr_graph_body_stream(index, ctypes.byref(out)),
               "creating a stream")
        _BODY_STREAMS[index, depth] = torch.cuda.ExternalStream(
            out.value, device=torch.device("cuda", index))
    return _BODY_STREAMS[index, depth]


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


class HostLoop:
    """The executor that reads the control block on the host at each loop,
    guard and ladder: the CPU executor, and on the card the eager executor
    that the graph is compared with.

    With ``device_ctrl`` the kernels take the control block themselves
    (K1's run flag, live_blocks and dim0; K5's live blocks; K6's pair
    count), and every other step is a tensor operation, so only the loop
    control (``read``, ``read_field``) brings a value to the host (the CPU
    executor; its K1 and control launches count in the device counts as a
    graph's do). Without, the host reads the control block before each such
    kernel call and passes its values as ints (the eager executor)."""

    capturing = False

    def __init__(self, device, device_ctrl: bool):
        self.counts = device_counts(device)
        self.device_ctrl = device_ctrl

    def control(self, alive, ctrl, flags, site=SITE_OTHER, handle=None, handles=None, **kw):
        """A control launch that ends the step ``site`` (a ``Site``, a label
        or an index: ``site_index``)."""
        pass_control(alive, ctrl, self.counts,
                     flags | SITE_COUNT | (DEVICE_COUNT if self.device_ctrl else 0),
                     site=site_index(site), **kw)

    def cond(self):
        return None

    def conds(self, n: int):
        return [None] * n

    @staticmethod
    def read(ctrl) -> bool:
        """The host read of a loop or guard condition."""
        return bool(ctrl[CTRL_COND])

    @staticmethod
    def read_field(ctrl, field: int) -> int:
        """The host read of one field of the control block."""
        return int(ctrl[field])

    def loop(self, handle, ctrl, body):
        while self.read(ctrl):
            body(handle)

    def guard(self, handle, ctrl, body):
        if self.read(ctrl):
            body(handle)

    def rungs(self, handles, ctrl, bodies, host=None):
        """Run the body of the rung that the control block holds (the CPU
        executor, or any executor without a ``host`` call), or ``host`` with
        the control block's ``field`` as a host int (the eager executor:
        ``host`` is ``(field, fn)``)."""
        if host is not None and not self.device_ctrl:
            field, fn = host
            fn(self.read_field(ctrl, field))
            return
        i = self.read_field(ctrl, CTRL_RUNG)
        if i >= 0:
            bodies[i](handles[i])

    def k1(self, kern, state, cap, ctrl):
        ex = {"ex": self} if getattr(kern, "takes_executor", False) else {}
        if self.device_ctrl:
            kern(state, max_iters=cap, ctrl=ctrl, **ex)
            return
        live, dim0, run = ctrl[:3].tolist()
        if run and live > 0:
            kern(state, max_iters=cap, live_blocks=live, dim0=dim0, **ex)


class GraphCapture:
    """The executor that records a plan into the CUDA graph being captured:
    each loop a conditional WHILE node, each guard and each rung of a
    ladder an IF node, whose condition the control kernel sets on the card;
    the kernels take the control block. A body is captured on a stream of
    its own depth (``body_stream``), and what the bodies allocate comes from
    a memory pool of the graph's (``body_pool``)."""

    capturing = True
    device_ctrl = True

    def __init__(self, device):
        self.device = device
        self.counts = device_counts(device)
        kernel_counts(device)  # made before the capture, which only records
        self.body_pool = torch.cuda.MemPool()
        self.depth = 0

    def control(self, alive, ctrl, flags, site=SITE_OTHER, handle=None, handles=None, **kw):
        pass_control(alive, ctrl, self.counts, flags | DEVICE_COUNT | SITE_COUNT, handle=handle,
                     handles=handles, site=site_index(site), **kw)

    def cond(self):
        return cond_handle(torch.cuda.current_stream(self.device))

    def conds(self, n: int):
        return [self.cond() for _ in range(n)]

    def loop(self, handle, ctrl, body):
        self._conditional(handle, True, body)

    def guard(self, handle, ctrl, body):
        self._conditional(handle, False, body)

    def rungs(self, handles, ctrl, bodies, host=None):
        for h, body in zip(handles, bodies):
            self._conditional(h, False, body)

    def _conditional(self, handle, loop, body):
        stream = body_stream(self.device, self.depth)
        cond_begin(torch.cuda.current_stream(self.device), handle, loop, stream)
        self.depth += 1
        try:
            with torch.cuda.stream(stream):
                if self.depth == 1:
                    with torch.cuda.use_mem_pool(self.body_pool):
                        body(handle)
                else:
                    body(handle)
        finally:
            self.depth -= 1
            cond_end(stream)

    def k1(self, kern, state, cap, ctrl):
        ex = {"ex": self} if getattr(kern, "takes_executor", False) else {}
        kern(state, max_iters=cap, ctrl=ctrl, **ex)


def executor(device, ex=None):
    """``ex``, or the executor of a call made outside a plan on ``device``:
    the CPU executor on the CPU, the eager executor on the card."""
    if ex is not None:
        return ex
    device = torch.device(device)
    return HostLoop(device, device_ctrl=device.type == "cpu")
