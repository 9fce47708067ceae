"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes). The megakernel is templated on the NEE
K-list length, and one library is built per ``--nee-bound`` value asked
for (``-DCMR_NEE_MAX_MEDIA=n``). Libraries go to ``build/kernels/`` beside
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
_libs: dict = {}
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


def prebuild(nee_bounds, verbose: bool = False) -> None:
    """Build the megakernel for each value of ``nee_bounds`` at once, one
    nvcc process per library, all started together."""
    todo = [n for n in sorted(set(nee_bounds)) if n not in _libs]
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        paths = list(pool.map(
            lambda n: _compile("megakernel.cu", {"CMR_NEE_MAX_MEDIA": n}, verbose), todo
        ))
    with _lock:
        for n, path in zip(todo, paths):
            if n not in _libs:
                _libs[n] = _load_megakernel(path)


def megakernel(nee_max_media: int):
    """The launch function of the megakernel built for ``nee_max_media``."""
    with _lock:
        lib = _libs.get(nee_max_media)
    if lib is None:
        prebuild([nee_max_media])
        lib = _libs[nee_max_media]
    if lib.cmr_megakernel_k_nee() != 2 * nee_max_media + 2:
        raise RuntimeError("megakernel library built for another K-list length")
    return lib.cmr_megakernel_launch


def error_string(err: int) -> str:
    """``err`` with CUDA's name for it (a library is loaded by then)."""
    lib = next(iter(_libs.values()))
    return f"{err} ({lib.cmr_error_string(err).decode()})"
