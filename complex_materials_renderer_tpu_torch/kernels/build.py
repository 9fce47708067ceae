"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes):

- ``megakernel.cu`` (K1), one library per ``--nee-bound`` value
  (``-DCMR_NEE_MAX_MEDIA=n``: the NEE K-list length is a template
  parameter) and ablation mask (``-DCMR_MEGA_ABLATE=m``, the
  ``CMR_MEGA_DEBUG`` tokens, ``megakernel.ablation_mask``; 0 is the
  default kernel), each holding the kernel for every group size G (1, 2,
  4, 8, 16 and 32 threads per lane), chosen at launch;
- ``cluster_trace.cu`` (K3), with every G likewise;
- ``binned_listing.cu`` (K4), one per list length (``-DCMR_LIST_LEN=L``),
  each holding both variants (the one-thread walk and the tile walk) at
  every group size;
- ``binned_round.cu`` (K5), one per (list length, ``--nee-bound``), each
  holding every payload at 1, 2, 4 and 8 threads per lane (thread block
  clusters of 2, 4, 8 and 16 CTAs);
- ``pair_sweep.cu`` (K6), one per ``--nee-bound``, each holding every
  payload at every group size G;
- ``pass_control.cu``, the mega pass's control kernel, its call stamps
  and the CUDA graph conditional nodes of its loops (render/megarender.py
  ``PassPlan``);
- ``partition.cu``, the pass plan's compaction sort (kernels/partition.py).

Lists and K-lists live in registers, so their lengths are compile-time;
a library is built for any value asked for, at its first use. Libraries
go to ``build/kernels/`` beside the package (listed in ``.gitignore``),
named by a digest of the sources and flags, so a changed source is
rebuilt.

``--fmad=false`` and no ``--use_fast_math``: every product, ``1/x`` and
``sqrtf`` is IEEE-rounded, as in the plain PyTorch version that the kernel
is checked against (nvcc would otherwise fuse ``a*b+c`` into one FMA).

A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "csrc")
_REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# kind -> (source, names of the -D values in the key, launch function, its argtypes)
_KINDS = {
    "megakernel": ("megakernel.cu", ("CMR_NEE_MAX_MEDIA", "CMR_MEGA_ABLATE"),
                   "cmr_megakernel_launch", [_vp] * 6 + [_ci] + [_vp] * 9 + [_ci] * 17 + [_vp] * 2),
    "cluster_trace": ("cluster_trace.cu", (), "cmr_cluster_trace_launch",
                      [_vp] * 8 + [_ci] * 8 + [_vp]),
    "binned_listing": ("binned_listing.cu", ("CMR_LIST_LEN",), "cmr_binned_listing_launch",
                       [_vp] * 7 + [_ci] * 7 + [_vp]),
    "binned_round": ("binned_round.cu", ("CMR_LIST_LEN", "CMR_NEE_MAX_MEDIA"),
                     "cmr_binned_round_launch",
                     [_vp, _ci] + [_vp] * 5 + [_ci] * 9 + [_vp] * 2),
    "pair_sweep": ("pair_sweep.cu", ("CMR_NEE_MAX_MEDIA",), "cmr_pair_sweep_launch",
                   [_vp, _ci] + [_vp] * 4 + [_ci] * 8 + [_vp] * 2),
    "pass_control": ("pass_control.cu", (), "cmr_pass_control_launch",
                     [_vp, _ci, _vp, _vp] + [_ci] * 6 + [ctypes.c_ulonglong, _ci] + [_vp] * 3),
    "partition": ("partition.cu", (), "cmr_partition_launch",
                  [_vp] * 11 + [_ci] * 2 + [_vp] * 2 + [_ci] * 2 + [_vp, _ci, _vp]),
}

_lock = threading.Lock()
_libs: dict = {}  # key (kind, *values) -> loaded library
build_log: list = []  # (library, seconds, nvcc output) of each build in this process


def build_dir() -> str:
    return os.path.join(_REPO, "build", "kernels")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(source: str, defines: dict) -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(_CSRC)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(_CSRC, f), "rb") as fh:
                h.update(fh.read())
    h.update(repr(sorted(defines.items())).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    tag = "_".join(f"{k}{v}" for k, v in sorted(defines.items()))
    return os.path.join(build_dir(), f"lib{stem}_{tag}_{h.hexdigest()[:12]}.so")


def _compile(source: str, defines: dict, verbose: bool) -> str:
    out = _lib_path(source, defines)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
           *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, os.path.join(_CSRC, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {source} {defines}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_log.append((os.path.basename(out), secs, proc.stdout + proc.stderr))
    return out


def _load(key, path: str):
    _, _, launch, argtypes = _KINDS[key[0]]
    lib = ctypes.CDLL(path)
    fn = getattr(lib, launch)
    fn.argtypes = argtypes
    fn.restype = _ci
    for name in ("cmr_megakernel_k_nee", "cmr_megakernel_ablate", "cmr_k_nee", "cmr_list_len"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _ci
    if hasattr(lib, "cmr_binned_listing_empty"):
        lib.cmr_binned_listing_empty.argtypes = [_ci, _ci, _vp]
        lib.cmr_binned_listing_empty.restype = _ci
    if hasattr(lib, "cmr_graph_cond_handle"):
        lib.cmr_pass_control_empty.argtypes = [_vp]
        lib.cmr_graph_cond_handle.argtypes = [_vp, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.cmr_graph_cond_begin.argtypes = [_vp, ctypes.c_ulonglong, _ci, _vp]
        lib.cmr_graph_cond_end.argtypes = [_vp]
        lib.cmr_graph_body_stream.argtypes = [_ci, ctypes.POINTER(_vp)]
        lib.cmr_pass_stamp_launch.argtypes = [_vp, _ci, _vp]
        for name in ("cmr_pass_control_empty", "cmr_graph_cond_handle", "cmr_graph_cond_begin",
                     "cmr_graph_cond_end", "cmr_graph_body_stream", "cmr_pass_stamp_launch"):
            getattr(lib, name).restype = _ci
    if hasattr(lib, "cmr_partition_scratch_bytes"):
        lib.cmr_partition_scratch_bytes.argtypes = [_ci, ctypes.POINTER(ctypes.c_longlong)]
        lib.cmr_partition_scratch_bytes.restype = ctypes.c_longlong
    if hasattr(lib, "cmr_binned_round_max_clusters"):
        lib.cmr_binned_round_max_clusters.argtypes = [_ci, _ci, ctypes.POINTER(_ci)]
        lib.cmr_binned_round_max_clusters.restype = _ci
    lib.cmr_error_string.argtypes = [_ci]
    lib.cmr_error_string.restype = ctypes.c_char_p
    return lib


def build(keys, verbose: bool = False) -> None:
    """Build and load the libraries of ``keys`` ((kind, *values), e.g.
    ("binned_round", 8, 4)), one nvcc process per library, all started
    together."""
    todo = []
    for key in keys:
        key = tuple(key)
        if key[0] not in _KINDS:
            raise ValueError(f"unknown kernel library {key!r}")
        if key not in _libs and key not in todo:
            todo.append(key)
    if not todo:
        return
    jobs = [(_KINDS[k[0]][0], dict(zip(_KINDS[k[0]][1], k[1:]))) for k in todo]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        paths = list(pool.map(lambda job: _compile(*job, verbose), jobs))
    with _lock:
        for key, path in zip(todo, paths):
            if key not in _libs:
                _libs[key] = _load(key, path)


def prebuild(nee_bounds=(), verbose: bool = False, cluster_trace: bool = True,
             list_lens=(), rounds=(), sweeps=(), ablations=()) -> None:
    """Build at once the pass control and partition libraries, the
    megakernel for each value of ``nee_bounds`` and for each (nee bound,
    ablation mask) of ``ablations``, (with ``cluster_trace``) the
    closest-hit kernel, the listing for each of ``list_lens``, the round
    for each (list length, nee bound) of ``rounds`` and the sweep for each
    nee bound of ``sweeps``."""
    build([("pass_control",), ("partition",)]
          + [("megakernel", n, 0) for n in sorted(set(nee_bounds))]
          + [("megakernel", n, m) for n, m in sorted(set(ablations))]
          + ([("cluster_trace",)] if cluster_trace else [])
          + [("binned_listing", L) for L in sorted(set(list_lens))]
          + [("binned_round", L, n) for L, n in sorted(set(rounds))]
          + [("pair_sweep", n) for n in sorted(set(sweeps))], verbose)


def _library(key):
    with _lock:
        lib = _libs.get(key)
    if lib is None:
        build([key])
        lib = _libs[key]
    return lib


def megakernel(nee_max_media: int, ablate: int = 0):
    """The launch function of the megakernel built for ``nee_max_media``
    and the ablation mask ``ablate`` (0: the default kernel)."""
    lib = _library(("megakernel", nee_max_media, ablate))
    if lib.cmr_megakernel_k_nee() != 2 * nee_max_media + 2:
        raise RuntimeError("megakernel library built for another K-list length")
    if lib.cmr_megakernel_ablate() != ablate:
        raise RuntimeError("megakernel library built for another ablation mask")
    return lib.cmr_megakernel_launch


def cluster_trace():
    """The launch function of the closest-hit kernel (K3)."""
    return _library(("cluster_trace",)).cmr_cluster_trace_launch


def binned_listing(list_len: int):
    """The launch function of the listing kernel (K4) for ``list_len``."""
    lib = _library(("binned_listing", list_len))
    if lib.cmr_list_len() != list_len:
        raise RuntimeError("listing library built for another list length")
    return lib.cmr_binned_listing_launch


def listing_empty(list_len: int):
    """The launch function of an empty kernel on the grid of a listing
    launch (the launch floor beside K4's bound)."""
    return _library(("binned_listing", list_len)).cmr_binned_listing_empty


def _round_library(list_len: int, nee_max_media: int):
    lib = _library(("binned_round", list_len, nee_max_media))
    if lib.cmr_list_len() != list_len or lib.cmr_k_nee() != 2 * nee_max_media + 2:
        raise RuntimeError("round library built for another list or K-list length")
    return lib


def binned_round(list_len: int, nee_max_media: int):
    """The launch function of the round kernel (K5) for ``list_len`` and
    ``nee_max_media``."""
    return _round_library(list_len, nee_max_media).cmr_binned_round_launch


def round_max_clusters(list_len: int, nee_max_media: int, payload: int, group: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the round kernel's instance for
    (payload id, threads per lane): how many of its thread block clusters
    the card holds at once."""
    out = _ci(0)
    err = _round_library(list_len, nee_max_media).cmr_binned_round_max_clusters(
        payload, group, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cluster occupancy query failed: {error_string(err)}")
    return out.value


def pair_sweep(nee_max_media: int):
    """The launch function of the pair sweep (K6) for ``nee_max_media``."""
    lib = _library(("pair_sweep", nee_max_media))
    if lib.cmr_k_nee() != 2 * nee_max_media + 2:
        raise RuntimeError("sweep library built for another K-list length")
    return lib.cmr_pair_sweep_launch


def pass_control():
    """The pass control library (``csrc/pass_control.cu``): the control
    kernel's launch function and the graph functions beside it."""
    lib = _library(("pass_control",))
    return lib


def partition():
    """The partition library (``csrc/partition.cu``): the launch function
    and the scratch size beside it."""
    return _library(("partition",))


def error_string(err: int) -> str:
    """``err`` with CUDA's name for it (a library is loaded by then)."""
    lib = next(iter(_libs.values()))
    return f"{err} ({lib.cmr_error_string(err).decode()})"
