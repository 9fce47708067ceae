"""The port's host library (native.py, csrc/host/cmr_native.cpp) against
the JAX package's native library and the port's Python paths.

The library is built here with the C++ compiler into build/host/.
Tolerance: none. Arrays and file bytes are equal, with one stated
exception: a coordinate whose decimal lies just past a float32 midpoint
but within half a float64 ulp of it parses one float32 ulp apart in the
Python parser (``float`` then float32: two roundings) and in the C++ one
(``strtof``: one); the port follows the JAX package's C++ parse there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu import native as jnative
from complex_materials_renderer_tpu_torch import native
from complex_materials_renderer_tpu_torch.accel.bvh import _build_bvh_python, build_bvh
from complex_materials_renderer_tpu_torch.io import hdr as thdr
from complex_materials_renderer_tpu_torch.scene.obj import _parse_obj_python, parse_obj

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("showcase", "vessel", "isobox", "gembox")
BVH_FIELDS = ("bmin", "bmax", "left", "count", "miss", "tri_order")

# The JAX package's library is loaded before any test sets CMR_NO_NATIVE
# (it reads the switch once, at its first load).
assert jnative.load() is not None


def _scene_path(name):
    return os.path.join(REPO, "scenes", f"{name}.obj")


def _mesh_equal(a, b):
    """``a`` and ``b`` are (vertices, indices, material ids, names)."""
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert list(a[3]) == list(b[3])


def _write_heightfield(path, n=256):
    """An n x n heightfield of 2 n^2 triangles (131,072 at n = 256)."""
    x, z = np.meshgrid(np.linspace(-4.0, 4.0, n + 1), np.linspace(-4.0, 4.0, n + 1))
    y = 0.3 * np.sin(3.0 * x) * np.cos(2.0 * z)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    i = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None]).ravel() + 1
    faces = np.stack([i, i + 1, i + n + 2, i, i + n + 2, i + n + 1], -1).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in verts))
        f.write("".join(f"f {a} {b} {c}\n" for a, b, c in faces))


_MTL = "newmtl glass\nKd 1 1 1\nnewmtl  metal \t\nnewmtl smoke\n"

_OBJS = {
    # Negative indices count back from the vertices read so far.
    "negative": "v 0 0 0\nv 1 0 0\nv 1 1 0\nf -3 -2 -1\nv 0 1 0\nf -4 -2 -1\nf 1 -3 4\n",
    # A quad, a pentagon and a hexagon: fan triangulation; vt/vn suffixes.
    "ngons": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\nv -0.5 0.5 0\n"
              "f 1 2 3 4\nf 1/1 2/2 3/3 5/4 4/5\nf 1//1 2//2 3//3 5//4 4//5 6//6\n"),
    # usemtl before any mtllib resolves to -1; after it, to the .mtl's order.
    "usemtl_order": ("usemtl glass\nv 0 0 0\nv 1 0 0\nv 1 1 0\nf 1 2 3\nmtllib m.mtl\n"
                     "usemtl metal\nf 1 2 3\nusemtl glass\nf 3 2 1\nusemtl smoke\nf 2 3 1\n"),
    # A material that no .mtl declares, and a missing .mtl.
    "undeclared": ("mtllib m.mtl\nmtllib absent.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\n"
                   "usemtl chrome\nf 1 2 3\nusemtl glass\nf 1 2 3\n"),
    # Trailing spaces, tabs and CRs after names; leading whitespace on lines.
    "whitespace": ("mtllib m.mtl  \r\n  v 0 0 0\r\nv 1 0 0\t\r\nv 1 1 0\r\n"
                   "usemtl metal \t \r\nf 1 2 3\r\n\tusemtl glass   \nf 1 2 3 \n"),
    # Comments and blank lines, and lines the parsers skip.
    "comments": ("# a comment\n\nmtllib m.mtl\n# v 9 9 9\nv 0 0 0\nvn 0 0 1\nvt 0 0\nv 1 0 0\n"
                 "v 1 1 0\no thing\ng group\ns off\n  # indented comment\nusemtl smoke\n"
                 "f 1 2 3\n"),
}


def _write_case(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    if name == "heightfield":
        _write_heightfield(path)
        return str(path)
    (tmp_path / "m.mtl").write_text(_MTL)
    if name == "nine_digits":
        rs = np.random.default_rng(9)
        v = rs.uniform(-1e3, 1e3, (300, 3))
        text = "".join(f"v {a:.9g} {b:.9g} {c:.9g}\n" for a, b, c in v)
        text += "".join(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}\n" for k in range(100))
    else:
        text = _OBJS[name]
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


@pytest.mark.parametrize("name", list(SCENES) + ["heightfield", "nine_digits", *_OBJS])
def test_parse_obj_equal(name, tmp_path):
    path = _scene_path(name) if name in SCENES else _write_case(tmp_path, name)
    got = parse_obj(path)
    _mesh_equal(got, jnative.parse_obj(path))
    _mesh_equal(got, _parse_obj_python(path))
    if name == "heightfield":
        assert got.indices.shape == (131072, 3)


def test_parse_obj_long_decimal(tmp_path):
    """A decimal just past the float32 midpoint between 1 (an even
    mantissa) and 1 + 2^-23: ``strtof`` rounds it up; ``float`` rounds it
    to the midpoint itself, which float32 then ties to even, down."""
    lo = np.float32(1.0)
    hi = np.nextafter(lo, np.float32(2.0))
    mid = (float(lo) + float(hi)) / 2.0
    text = f"{mid:.30f}1"  # past the midpoint by 1e-31, far below a float64 ulp
    path = tmp_path / "long.obj"
    path.write_text(f"v {text} 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\n")
    got = parse_obj(str(path))
    _mesh_equal(got, jnative.parse_obj(str(path)))
    assert got.vertices[0, 0] == hi
    assert _parse_obj_python(str(path)).vertices[0, 0] == lo


def _random_tris(n, seed, size=0.4):
    rs = np.random.default_rng(seed)
    base = rs.uniform(-2.0, 2.0, size=(n, 1, 3))
    return (base + rs.uniform(-size, size, size=(n, 3, 3))).astype(np.float32)


def _soup(which):
    if which in SCENES:
        mesh = _parse_obj_python(_scene_path(which))
        return mesh.vertices[mesh.indices]
    if which == "coincident":
        # Every centroid the same: the median splits.
        return np.repeat(_random_tris(1, seed=5), 41, axis=0)
    if which == "tiny":
        return _random_tris(3000, seed=17, size=1e-3)
    return _random_tris(777, seed=int(which[-1]))


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("which", list(SCENES) + ["soup1", "soup2", "tiny", "coincident"])
def test_build_bvh_equals_jax_native(which, leaf_size):
    tris = _soup(which)
    got = build_bvh(tris, leaf_size=leaf_size)
    want = jnative.build_bvh(tris, leaf_size)
    for name, y in zip(BVH_FIELDS, want):
        x = getattr(got, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


HDR_CASES = ["4", "7", "8", "512", "1920", "32768", "rgba", "zeros", "huge"]


def _hdr_image(case):
    rs = np.random.default_rng(HDR_CASES.index(case))
    if case == "zeros":
        return np.zeros((5, 64, 3), np.float32)
    if case == "huge":
        img = (rs.random((6, 40, 3)) * 1e38).astype(np.float32)
        img[0, :8] = 1e31
        img[1, :] = 3.4e38
        img[2, ::3] = 0.0
        return img
    if case == "rgba":
        return (rs.random((7, 33, 4)) * 4.0).astype(np.float32)
    width = int(case)
    height = 1 if width > 32767 else (3 if width >= 512 else 5)
    img = (rs.lognormal(0.0, 2.0, (height, width, 3))).astype(np.float32)
    img[:, width // 3: width // 2] = 0.75  # runs for the RLE
    img[0, : min(width, 200)] = 0.0
    return img


@pytest.mark.parametrize("case", HDR_CASES)
def test_write_hdr_bytes_equal(case, tmp_path, monkeypatch):
    img = _hdr_image(case)
    port, jax_native, python = (tmp_path / f"{k}.hdr" for k in ("port", "jax", "py"))
    thdr.write_hdr(str(port), img)
    assert jnative.write_hdr(str(jax_native), img[..., :3])
    monkeypatch.setenv("CMR_NO_NATIVE", "1")
    thdr.write_hdr(str(python), img)
    data = [p.read_bytes() for p in (port, jax_native, python)]
    assert data[0] == data[1]
    assert data[0] == data[2]
    assert thdr.read_hdr(str(port)).shape == img.shape[:2] + (3,)


def test_missing_obj_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        parse_obj(str(tmp_path / "absent.obj"))
    with pytest.raises(IsADirectoryError):
        parse_obj(str(tmp_path))


def test_unwritable_hdr_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        thdr.write_hdr(str(tmp_path / "absent" / "x.hdr"), np.zeros((2, 8, 3), np.float32))
    with pytest.raises(ValueError):
        thdr.write_hdr(str(tmp_path / "x.hdr"), np.zeros((2, 8), np.float32))


def test_bvh_input_errors():
    with pytest.raises(ValueError, match="zero triangles"):
        build_bvh(np.zeros((0, 3, 3), np.float32))
    with pytest.raises(ValueError):
        native.build_bvh(np.zeros((4, 9), np.float32))
    with pytest.raises(ValueError):
        native.build_bvh(_random_tris(4, seed=1), leaf_size=0)


def test_no_native_gives_python(tmp_path, monkeypatch):
    tris = _soup("showcase")
    path = _scene_path("vessel")
    monkeypatch.setenv("CMR_NO_NATIVE", "1")
    got = build_bvh(tris, leaf_size=4)
    want = _build_bvh_python(tris, leaf_size=4)
    assert all(getattr(got, f).tobytes() == getattr(want, f).tobytes() for f in BVH_FIELDS)
    # The trees differ from the C++ one on showcase (only miss is equal).
    monkeypatch.delenv("CMR_NO_NATIVE")
    assert build_bvh(tris, leaf_size=4).tri_order.tobytes() != want.tri_order.tobytes()
    monkeypatch.setenv("CMR_NO_NATIVE", "1")
    _mesh_equal(parse_obj(path), _parse_obj_python(path))
    with pytest.raises(FileNotFoundError):
        parse_obj(str(tmp_path / "absent.obj"))
    with pytest.raises(ValueError, match="zero triangles"):
        build_bvh(np.zeros((0, 3, 3), np.float32))


_FAILING_BUILD = r"""
import os, sys
from complex_materials_renderer_tpu_torch import native
from complex_materials_renderer_tpu_torch.scene.obj import parse_obj

native.build_dir = lambda: sys.argv[1]
try:
    parse_obj(sys.argv[2])
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def test_failed_build_raises(tmp_path):
    out = tmp_path / "build"
    env = {k: v for k, v in os.environ.items() if k != "CMR_NO_NATIVE"}
    proc = subprocess.run(
        [sys.executable, "-c", _FAILING_BUILD, str(out), _scene_path("isobox")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": REPO, "CXX": "/bin/false"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "the C++ compiler failed" in proc.stdout
    assert not any(f.endswith(".so") for f in os.listdir(out))


_MAPS = r"""
import sys
import numpy as np
from complex_materials_renderer_tpu_torch import native
from complex_materials_renderer_tpu_torch.accel import build_bvh
from complex_materials_renderer_tpu_torch.io import write_hdr
from complex_materials_renderer_tpu_torch.scene import load_scene
from complex_materials_renderer_tpu_torch.config import RenderOptions

scene = load_scene(sys.argv[1], RenderOptions(obj_path=sys.argv[1], device="cpu"))
build_bvh(scene.triangles)
write_hdr(sys.argv[2], np.ones((4, 16, 3), np.float32))
print(native.load()._name)
print(open("/proc/self/maps").read())
"""


def test_library_lies_under_build_host(tmp_path):
    assert native.load()._name.startswith(os.path.join(REPO, "build", "host") + os.sep)
    env = {k: v for k, v in os.environ.items() if k != "CMR_NO_NATIVE"}
    proc = subprocess.run(
        [sys.executable, "-c", _MAPS, _scene_path("isobox"), str(tmp_path / "x.hdr")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    name, maps = proc.stdout.split("\n", 1)
    assert os.path.dirname(name) == os.path.join(REPO, "build", "host")
    assert name in maps
    assert "cmr_native.so" not in maps
    assert os.path.join(REPO, "native") + os.sep not in maps
