"""Host layer of the PyTorch port against the JAX package: option
parsing, scene loading, the cluster build and its device layout, and the
.hdr writer give equal fields, arrays and bytes."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu import config as jconfig
from complex_materials_renderer_tpu.accel import clusters as jclusters
from complex_materials_renderer_tpu.io import hdr as jhdr
from complex_materials_renderer_tpu.kernels.pallas_trace import device_cluster_grid as jax_device_grid
from complex_materials_renderer_tpu.scene import load_scene as jax_load_scene
from complex_materials_renderer_tpu_torch import config as tconfig
from complex_materials_renderer_tpu_torch import renderer as trenderer
from complex_materials_renderer_tpu_torch.accel import clusters as tclusters
from complex_materials_renderer_tpu_torch.io import hdr as thdr
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.scene import load_scene as torch_load_scene

from helpers import make_test_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("showcase", "isobox", "gembox", "vessel")

# The argv cases of tests/test_cli.py, plus the port's --device.
ARGV_CASES = [
    ["-s", "64", "-b", "2", "-o", "name", "path/to/scene.obj"],
    ["-b", "7"],
    ["-b", "-3"],
    ["-b", "2"],
    ["foo.obj", "-s", "2"],
    ["--width", "64", "--height", "48", "--aov", "depth", "--rng", "counter",
     "--max-depth", "8", "--backend", "naive", "--shard", "none"],
    ["--cluster-size", "32", "--partition", "media"],
    [],
    ["--direct", "analytic"],
    ["--rng", "ld", "--tir", "kill", "--nee-bound", "2", "--super-factor", "4",
     "--quads", "off", "--engine", "mega", "--sample-chunk", "3"],
]


def _fields(opt, drop=("device",)):
    return {k: v for k, v in dataclasses.asdict(opt).items() if k not in drop}


@pytest.mark.parametrize("argv", ARGV_CASES, ids=lambda a: " ".join(a) or "defaults")
def test_parse_argv_matches(argv):
    a = jconfig.parse_argv(list(argv), jconfig.RenderOptions())
    b = tconfig.parse_argv(list(argv), tconfig.RenderOptions())
    assert _fields(a, drop=()) == _fields(b)
    assert b.device == "cuda"


@pytest.mark.parametrize("argv", [["--direct", "analytical"], ["--partition", "x"]])
def test_parse_argv_rejects_alike(argv):
    with pytest.raises(ValueError):
        jconfig.parse_argv(list(argv))
    with pytest.raises(ValueError):
        tconfig.parse_argv(list(argv))


def test_parse_device_flag():
    assert tconfig.parse_argv(["--device", "cpu"]).device == "cpu"
    assert tconfig.parse_argv(["--device", "cuda"]).device == "cuda"
    with pytest.raises(ValueError):
        tconfig.parse_argv(["--device", "tpu"])
    with pytest.raises(SystemExit):
        tconfig.parse_argv(["--help"])


@pytest.mark.parametrize("name", SCENES)
def test_load_scene_matches(name):
    path = os.path.join(REPO, "scenes", f"{name}.obj")
    a = jax_load_scene(path)
    b = torch_load_scene(path)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    assert a.triangles.dtype == b.triangles.dtype
    np.testing.assert_array_equal(a.mat_ids, b.mat_ids)
    for fa, fb in zip(a.media, b.media):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    assert list(a.material_names) == list(b.material_names)
    assert _fields(a.options, drop=()) == _fields(b.options)


def _scene_tris(name):
    if name == "helpers":
        tris, mats, _ = make_test_scene()
        return tris, mats
    s = jax_load_scene(os.path.join(REPO, "scenes", f"{name}.obj"))
    return s.triangles, s.mat_ids


BUILDS = [
    ("helpers", dict(cluster_size=8)),
    ("helpers", dict(cluster_size=8, media_mats={1})),
    ("helpers", dict(cluster_size=16, quads=True, super_factor=1)),
    ("isobox", dict(cluster_size=16, quads=True)),
    ("gembox", dict(cluster_size=128, quads=True)),
    ("gembox", dict(cluster_size=32, quads=False, super_factor=4, media_mats={1, 2, 3})),
    ("showcase", dict(cluster_size=128, quads=True)),
    ("showcase", dict(cluster_size=32, quads=False, super_factor=1)),
    ("showcase", dict(cluster_size=64, quads=True, super_factor=4, media_mats={1, 2, 3})),
    ("vessel", dict(cluster_size=128, quads=True, super_factor=16)),
]


@pytest.mark.parametrize("name,kw", BUILDS, ids=lambda x: str(x))
def test_build_clusters_and_layout_match(name, kw):
    tris, mats = _scene_tris(name)
    a = jclusters.build_clusters(tris, mats, **kw)
    b = tclusters.build_clusters(tris, mats, **kw)
    for field in a._fields:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray) or va is None:
            if va is None:
                assert vb is None, field
            else:
                np.testing.assert_array_equal(va, vb, err_msg=field)
                assert va.dtype == vb.dtype, field
        else:
            assert va == vb, field
    ja = jax_device_grid(a)
    tb = device_cluster_grid(b, "cpu")
    for f in ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
              "bounds", "super_bounds", "tri_index", "mat", "qa", "qb", "run_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)), getattr(tb, f).numpy(), err_msg=f)
    for f in ("num_clusters", "num_supers", "num_opaque_supers", "runs_per_cluster",
              "run_size", "super_factor"):
        assert getattr(ja, f) == getattr(tb, f), f
    if "media_mats" in kw:
        assert tb.num_opaque_supers > 0


def test_pair_quads_matches():
    tris, _ = _scene_tris("gembox")
    mats = jax_load_scene(os.path.join(REPO, "scenes", "gembox.obj")).mat_ids
    a = jclusters.pair_quads(tris, mats)
    b = tclusters.pair_quads(tris, mats)
    assert len(a) == len(b)
    for va, vb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_slot_cap_error_alike():
    class Huge:
        bounds = np.zeros((1 << 17, 8), np.float32)
        v0x = np.zeros((1, 128), np.float32)

    with pytest.raises(ValueError, match="2\\^24"):
        jax_device_grid(Huge())
    with pytest.raises(ValueError, match="2\\^24"):
        device_cluster_grid(Huge(), "cpu")


@pytest.mark.parametrize("args", [
    ("media", 14, 128, False), ("off", 10 ** 6, 128, True), ("auto", 41248, 128, True),
    ("auto", 1378, 128, True), ("auto", 41248, 128, False), ("auto", 128 * 128, 128, True),
    ("auto", 128 * 128 + 1, 128, True),
])
def test_resolve_partition_matches(args):
    from complex_materials_renderer_tpu.renderer import resolve_partition

    assert trenderer.resolve_partition(*args) == resolve_partition(*args)


def test_auto_width_ladder():
    # renderer.py:120-127 of the JAX package.
    assert trenderer.auto_cluster_width(0, 12) == 16
    assert trenderer.auto_cluster_width(0, 17) == 32
    assert trenderer.auto_cluster_width(0, 100) == 128
    assert trenderer.auto_cluster_width(0, 5000) == 128
    assert trenderer.auto_cluster_width(32, 5000) == 32


def _hdr_images():
    rs = np.random.default_rng(11)
    wide = (rs.random((24, 64, 3)) * 5.0).astype(np.float32)
    wide[:, 10:30] = 1.25  # constant runs for the RLE
    wide[5, :] = 0.0
    wide[7, 3] = 1e-38
    wide[9, 9] = 6.5e4
    narrow = (rs.random((4, 5, 3)) * 2.0).astype(np.float32)  # flat scanlines
    rgba = rs.random((3, 16, 4)).astype(np.float32)
    return {"wide": wide, "narrow": narrow, "rgba": rgba}


@pytest.mark.parametrize("name", ["wide", "narrow", "rgba"])
def test_write_hdr_bytes_equal(name, tmp_path):
    img = _hdr_images()[name]
    pa, pb = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    jhdr.write_hdr(pa, img)
    thdr.write_hdr(pb, img)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(jhdr.read_hdr(pa), thdr.read_hdr(pb))
