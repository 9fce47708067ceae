"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes): the megakernel (``megakernel.cu``) and
the closest-hit kernel (``cluster_trace.cu``). The megakernel is templated
on the NEE K-list length, and one library is built per ``--nee-bound``
value asked for (``-DCMR_NEE_MAX_MEDIA=n``), for any value, at its first
use. Libraries go to ``build/kernels/`` beside
the package (listed in ``.gitignore``), named by a digest of the sources
and flags, so a changed source is rebuilt.

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

_lock = threading.Lock()
_libs: dict = {}  # nee_max_media -> megakernel library; "cluster_trace" -> K3's
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


def _load_megakernel(path: str):
    lib = ctypes.CDLL(path)
    fn = lib.cmr_megakernel_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci] + [vp] * 8 + [ci] * 15 + [vp]
    fn.restype = ci
    lib.cmr_megakernel_k_nee.argtypes = []
    lib.cmr_megakernel_k_nee.restype = ci
    lib.cmr_error_string.argtypes = [ci]
    lib.cmr_error_string.restype = ctypes.c_char_p
    return lib


def _load_cluster_trace(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cmr_cluster_trace_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.cmr_cluster_trace_launch.restype = ci
    lib.cmr_error_string.argtypes = [ci]
    lib.cmr_error_string.restype = ctypes.c_char_p
    return lib


def prebuild(nee_bounds, verbose: bool = False, cluster_trace: bool = True) -> None:
    """Build the megakernel for each value of ``nee_bounds`` and (with
    ``cluster_trace``) the closest-hit kernel at once, one nvcc process per
    library, all started together."""
    todo = [n for n in sorted(set(nee_bounds)) if n not in _libs]
    jobs = [("megakernel.cu", {"CMR_NEE_MAX_MEDIA": n}) for n in todo]
    if cluster_trace and "cluster_trace" not in _libs:
        todo.append("cluster_trace")
        jobs.append(("cluster_trace.cu", {}))
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        paths = list(pool.map(lambda job: _compile(*job, verbose), jobs))
    with _lock:
        for key, path in zip(todo, paths):
            if key not in _libs:
                load = _load_cluster_trace if key == "cluster_trace" else _load_megakernel
                _libs[key] = load(path)


def megakernel(nee_max_media: int):
    """The launch function of the megakernel built for ``nee_max_media``."""
    with _lock:
        lib = _libs.get(nee_max_media)
    if lib is None:
        prebuild([nee_max_media], cluster_trace=False)
        lib = _libs[nee_max_media]
    if lib.cmr_megakernel_k_nee() != 2 * nee_max_media + 2:
        raise RuntimeError("megakernel library built for another K-list length")
    return lib.cmr_megakernel_launch


def cluster_trace():
    """The launch function of the closest-hit kernel (K3)."""
    with _lock:
        lib = _libs.get("cluster_trace")
    if lib is None:
        prebuild([])
        lib = _libs["cluster_trace"]
    return lib.cmr_cluster_trace_launch


def error_string(err: int) -> str:
    """``err`` with CUDA's name for it (a library is loaded by then)."""
    lib = next(iter(_libs.values()))
    return f"{err} ({lib.cmr_error_string(err).decode()})"
