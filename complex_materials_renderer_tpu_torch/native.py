"""ctypes bindings to the port's host library, ``csrc/host/cmr_native.cpp``.

Counterpart of complex_materials_renderer_tpu/native.py: the OBJ parser,
the binned-SAH threaded-BVH builder and the RLE .hdr writer, in C++, with
the same C ABI and arithmetic as the JAX package's ``native/cmr_native.cpp``,
so both packages parse, build and write the same arrays and bytes.

The library is built at first use by the C++ compiler (``$CXX``, else
``c++`` or ``g++``) into ``build/host/`` beside the package (listed in
``.gitignore``), named by a digest of the source, the flags and the
compiler's ``--version``, so a changed source or compiler is rebuilt. The
port never loads the JAX package's library.

Unlike the JAX package, nothing falls back quietly: a library that fails to
build or load raises ``RuntimeError`` with the compiler's output, and a call
that fails raises ``OSError``. Only ``CMR_NO_NATIVE`` (any non-empty value,
as in the JAX package) sends ``parse_obj``, ``build_bvh`` and ``write_hdr``
to their Python versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from typing import List

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "host",
                       "cmr_native.cpp")
_REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# No -march=native: build/ may move between hosts. -ffp-contract=off: the
# compiler fuses no a*b+c of its own on any host; the source writes those
# that the JAX package's library fuses as std::fma (see its header), so the
# arrays and bytes do not depend on the host.
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-ffp-contract=off"]

_lock = threading.Lock()
_lib = None
build_log: list = []  # (library, seconds, compiler output) of each build in this process

_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_int_p = ctypes.POINTER(ctypes.c_int)


def disabled() -> bool:
    """Whether ``CMR_NO_NATIVE`` sends the callers to their Python versions."""
    return bool(os.environ.get("CMR_NO_NATIVE"))


def build_dir() -> str:
    return os.path.join(_REPO, "build", "host")


def compiler() -> List[str]:
    """The C++ compiler's command: ``$CXX`` (split like a shell word list),
    else ``c++`` or ``g++`` on the PATH."""
    cxx = os.environ.get("CXX")
    if cxx:
        return shlex.split(cxx)
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return [found]
    raise RuntimeError("no C++ compiler found (set CXX): the port's host library is built "
                       f"from {_SOURCE}")


def _lib_path(cxx: List[str]) -> str:
    try:
        ver = subprocess.run([*cxx, "--version"], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {' '.join(cxx)}: {e}") from e
    h = hashlib.sha256()
    with open(_SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(f"{ver.returncode}\n{ver.stdout}{ver.stderr}".encode())
    return os.path.join(build_dir(), f"libcmr_native_{h.hexdigest()[:12]}.so")


def _compile() -> str:
    cxx = compiler()
    out = _lib_path(cxx)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    # Several processes may build at once (test workers, the processes of a
    # multi-process render): each writes its own file, then renames it.
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cxx, *CXX_FLAGS, "-o", tmp, _SOURCE]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler: {' '.join(cmd)}: {e}") from e
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(tmp):
        raise RuntimeError(f"the C++ compiler failed ({proc.returncode}) on the host library:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_log.append((os.path.basename(out), secs, proc.stdout + proc.stderr))
    return out


def _bind(lib) -> None:
    lib.cmr_free.argtypes = [ctypes.c_void_p]
    lib.cmr_free.restype = None
    lib.cmr_parse_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(_c_float_p), _c_int_p,
        ctypes.POINTER(_c_int_p), _c_int_p,
        ctypes.POINTER(_c_int_p),
        ctypes.POINTER(ctypes.c_char_p), _c_int_p,
    ]
    lib.cmr_parse_obj.restype = ctypes.c_int
    lib.cmr_build_bvh.argtypes = [
        _c_float_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_c_float_p), ctypes.POINTER(_c_float_p),
        ctypes.POINTER(_c_int_p), ctypes.POINTER(_c_int_p),
        ctypes.POINTER(_c_int_p), ctypes.POINTER(_c_int_p),
        ctypes.POINTER(_c_int_p), _c_int_p,
    ]
    lib.cmr_build_bvh.restype = ctypes.c_int
    lib.cmr_write_hdr.argtypes = [ctypes.c_char_p, _c_float_p, ctypes.c_int, ctypes.c_int]
    lib.cmr_write_hdr.restype = ctypes.c_int


def load():
    """The host library, built at its first use in this process."""
    global _lib
    with _lock:
        if _lib is None:
            path = _compile()
            try:
                lib = ctypes.CDLL(path, use_errno=True)
            except OSError as e:
                raise RuntimeError(f"cannot load the host library {path}: {e}") from e
            _bind(lib)
            _lib = lib
        return _lib


def _failed(call: str, rc: int, path) -> OSError:
    err = ctypes.get_errno()
    if err:
        return OSError(err, f"{call}: {os.strerror(err)}", os.fsdecode(path))
    return OSError(f"{call} failed ({rc}) on {os.fsdecode(path)}")


def _take_array(lib, ptr, shape, dtype):
    """Copy a malloc'd buffer into numpy and free it."""
    count = int(np.prod(shape))
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_int
    try:
        if count == 0:
            return np.zeros(shape, dtype)
        arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))
        return arr.copy().astype(dtype, copy=False).reshape(shape)
    finally:
        lib.cmr_free(ptr)


def parse_obj(path):
    """(vertices (V, 3) float32, indices (F, 3) int32, material ids (F,)
    int32, material names) of the .obj at ``path``; raises ``OSError``
    (``FileNotFoundError`` for a missing file) as ``open`` would."""
    lib = load()
    verts_p, idx_p, mat_p = _c_float_p(), _c_int_p(), _c_int_p()
    names_p = ctypes.c_char_p()
    nverts, ntris, nmats = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ctypes.set_errno(0)
    rc = lib.cmr_parse_obj(
        os.fsencode(path),
        ctypes.byref(verts_p), ctypes.byref(nverts),
        ctypes.byref(idx_p), ctypes.byref(ntris),
        ctypes.byref(mat_p),
        ctypes.byref(names_p), ctypes.byref(nmats),
    )
    if rc != 0:
        raise _failed("cmr_parse_obj", rc, path)
    vertices = _take_array(lib, verts_p, (nverts.value, 3), np.float32)
    indices = _take_array(lib, idx_p, (ntris.value, 3), np.int32)
    mat_ids = _take_array(lib, mat_p, (ntris.value,), np.int32)
    blob = ctypes.cast(names_p, ctypes.c_void_p)
    names: List[str] = []
    # '\0'-joined names, double-'\0' terminated.
    offset = 0
    for _ in range(nmats.value):
        s = ctypes.string_at(ctypes.c_void_p(blob.value + offset))
        names.append(s.decode(errors="replace"))
        offset += len(s) + 1
    lib.cmr_free(blob)
    return vertices, indices, mat_ids, names


def build_bvh(triangles: np.ndarray, leaf_size: int = 4):
    """The FlatBVH fields (bmin, bmax, left, count, miss, tri_order) of the
    binned-SAH threaded BVH over ``triangles`` (T, 3, 3), T >= 1. The
    library's right-child links are dropped (the walk follows miss links)."""
    tris = np.ascontiguousarray(triangles, np.float32)
    if tris.ndim != 3 or tris.shape[1:] != (3, 3) or tris.shape[0] == 0:
        raise ValueError(f"expected (T >= 1, 3, 3) triangles, got {tris.shape}")
    if int(leaf_size) < 1:
        raise ValueError(f"leaf_size must be at least 1, got {leaf_size}")
    lib = load()
    num_tris = tris.shape[0]
    bmin_p, bmax_p = _c_float_p(), _c_float_p()
    left_p, count_p, miss_p, right_p, order_p = (_c_int_p() for _ in range(5))
    n_nodes = ctypes.c_int()
    rc = lib.cmr_build_bvh(
        tris.ctypes.data_as(_c_float_p), num_tris, int(leaf_size),
        ctypes.byref(bmin_p), ctypes.byref(bmax_p),
        ctypes.byref(left_p), ctypes.byref(count_p),
        ctypes.byref(miss_p), ctypes.byref(right_p),
        ctypes.byref(order_p), ctypes.byref(n_nodes),
    )
    if rc != 0:
        raise RuntimeError(f"cmr_build_bvh failed ({rc}) on {num_tris} triangles")
    n = n_nodes.value
    bmin = _take_array(lib, bmin_p, (n, 3), np.float32)
    bmax = _take_array(lib, bmax_p, (n, 3), np.float32)
    left = _take_array(lib, left_p, (n,), np.int32)
    count = _take_array(lib, count_p, (n,), np.int32)
    miss = _take_array(lib, miss_p, (n,), np.int32)
    lib.cmr_free(right_p)
    order = _take_array(lib, order_p, (num_tris,), np.int32)
    return bmin, bmax, left, count, miss, order


def write_hdr(path, image: np.ndarray) -> None:
    """Write the (H, W, 3) float32 ``image`` to ``path`` as RLE Radiance
    RGBE; raises ``OSError`` when the file cannot be written."""
    img = np.ascontiguousarray(image[..., :3], np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3[4]) image, got {image.shape}")
    lib = load()
    h, w = img.shape[:2]
    ctypes.set_errno(0)
    rc = lib.cmr_write_hdr(os.fsencode(path), img.ctypes.data_as(_c_float_p), w, h)
    if rc != 0:
        raise _failed("cmr_write_hdr", rc, path)
