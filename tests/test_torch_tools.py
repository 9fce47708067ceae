"""The port's tools/ against the JAX package's (tests/test_tools.py
mirrored): mat_parser's batch and interactive JSON byte-equal to the JAX
tool's, the scene generators byte-equal to the committed scenes/, compare
on .hdr files, and the golden tool: ``render_golden`` on the CPU passes
the flip-budgeted gate of tests/test_torch_cli.py (non-flip RMSE <= 1e-3,
at most 24 pixels with |diff| > 1e-2) against tests/golden, and
``generate`` writes only where it is told."""

import builtins
import json
import os

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.tools import mat_parser as jax_mat_parser
from complex_materials_renderer_tpu_torch.io import write_hdr
from complex_materials_renderer_tpu_torch.scene import load_scene
from complex_materials_renderer_tpu_torch.tools import compare, goldens, make_scenes, mat_parser
from complex_materials_renderer_tpu_torch.tools import make_showcase
from complex_materials_renderer_tpu_torch.tools.mat_parser import MATERIAL_DICTIONARY, main

from test_torch_support import flip_gate

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLIP_BUDGET = 24


def _tiny_obj(tmp_path):
    (tmp_path / "t.mtl").write_text("newmtl a\nnewmtl b\n")
    (tmp_path / "t.obj").write_text(
        "mtllib t.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl b\nf 1 2 3\n"
    )
    return str(tmp_path / "t.obj")


def test_batch_mode_writes_consumable_json(tmp_path):
    obj = _tiny_obj(tmp_path)
    assert main([obj, "--scene-defaults", "--material", "1=milk"]) == 0
    doc = json.loads((tmp_path / "t.json").read_text())
    assert "scene" in doc
    assert doc["1"]["sigma_s"] == MATERIAL_DICTIONARY["milk"]["sigma_s"]
    assert doc["1"]["ior"] == 1.33
    # The port's scene loader consumes it.
    assert load_scene(obj).media.mat_id.tolist() == [1]


def test_prefix_resolution(tmp_path):
    obj = _tiny_obj(tmp_path)
    assert main([obj, "--material", "0=ruby"]) == 0
    assert json.loads((tmp_path / "t.json").read_text())["0"]["ior"] == 1.77


def test_list_materials(capsys):
    assert main(["ignored.obj", "--list-materials"]) == 0
    out = capsys.readouterr().out
    assert "milk" in out and "sigma_s" in out
    assert main(["ignored.obj", "--list-materials"]) == 0
    port_out = capsys.readouterr().out
    assert jax_mat_parser.main(["ignored.obj", "--list-materials"]) == 0
    assert capsys.readouterr().out == port_out


def test_dictionary_equals_the_jax_tools():
    assert mat_parser.MATERIAL_DICTIONARY == jax_mat_parser.MATERIAL_DICTIONARY
    assert mat_parser.DEFAULT_SCENE == jax_mat_parser.DEFAULT_SCENE


def test_batch_json_byte_equal_to_the_jax_tools(tmp_path):
    obj = os.path.join(REPO, "scenes", "showcase.obj")
    args = ["--scene-defaults", "--material", "1=milk", "--material", "2=ruby",
            "--material", "3=glass"]
    out_port, out_jax = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert main([obj, "--out", out_port, *args]) == 0
    assert jax_mat_parser.main([obj, "--out", out_jax, *args]) == 0
    with open(out_port, "rb") as a, open(out_jax, "rb") as b:
        assert a.read() == b.read()


# One interactive session: custom scene values, a dictionary material, a
# hand-entered medium with blank g, then stop.
_ANSWERS = ["n", "0,1,2", "0,0,0", "40", "1,2,3", "0.5,0.5,0.5", "80", "10",
            "1", "y", "5", "y",
            "0", "n", "0.1,0.2,0.3", "0.01,0.02,0.03", "", "1.4", "n"]


def _interactive(module, monkeypatch, obj, out):
    answers = iter(_ANSWERS)
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
    module.run_interactive(obj, out)
    with open(out, "rb") as f:
        return f.read()


def test_interactive_json_byte_equal_to_the_jax_tools(tmp_path, monkeypatch, capsys):
    obj = os.path.join(REPO, "scenes", "showcase.obj")
    port = _interactive(mat_parser, monkeypatch, obj, str(tmp_path / "port.json"))
    port_out = capsys.readouterr().out
    jax = _interactive(jax_mat_parser, monkeypatch, obj, str(tmp_path / "jax.json"))
    assert port == jax
    assert capsys.readouterr().out.replace("jax.json", "port.json") == port_out
    doc = json.loads(port)
    assert doc["1"] == MATERIAL_DICTIONARY[list(MATERIAL_DICTIONARY)[5]]
    assert doc["0"]["g"] == [0.0, 0.0, 0.0] and doc["scene"]["fov"] == 40.0


def test_compare_tool(tmp_path):
    rng = np.random.default_rng(3)
    a = (rng.random((8, 16, 3)) * 2).astype(np.float32)
    b = a * 1.02  # beyond rgbe quantization
    pa, pb = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    write_hdr(pa, a)
    write_hdr(pb, b)
    stats = compare.compare(pa, pb)
    assert stats["rmse"] < 0.05 and stats["shape"] == [8, 16, 3]
    assert compare.main([pa, pa, "--threshold", "1e-6"]) == 0
    assert compare.main([pa, pb, "--threshold", "1e-9"]) == 1


def test_make_scenes_reproduces_the_committed_scenes(tmp_path):
    make_scenes.build_all(str(tmp_path))
    names = sorted(os.listdir(os.path.join(REPO, "scenes")))
    assert sorted(os.listdir(tmp_path)) == names and len(names) == 12
    for name in names:
        with open(tmp_path / name, "rb") as a, open(os.path.join(REPO, "scenes", name), "rb") as b:
            assert a.read() == b.read(), name


def test_make_showcase_alone(tmp_path):
    make_showcase.build(str(tmp_path))
    for ext in ("obj", "mtl", "json"):
        with open(tmp_path / f"showcase.{ext}", "rb") as a, \
                open(os.path.join(REPO, "scenes", f"showcase.{ext}"), "rb") as b:
            assert a.read() == b.read(), ext


def test_render_golden_showcase_passes_the_gate():
    path, spp = goldens.GOLDEN_CONFIGS["showcase"]
    img = goldens.render_golden(path, spp, device="cpu")
    ref = goldens.load_golden("showcase")
    assert img.shape == ref.shape == (64, 64, 3) and img.dtype == np.float32
    nonflip, flips = flip_gate(img, ref)
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)


def test_generate_writes_only_where_it_is_told(tmp_path):
    golden_dir = os.path.join(REPO, "tests", "golden")
    before = {f: os.stat(os.path.join(golden_dir, f)).st_mtime_ns for f in os.listdir(golden_dir)}
    out = tmp_path / "goldens"
    written = goldens.generate({"isobox"}, str(out), device="cpu")
    assert written == [str(out / "isobox.npz")] and os.listdir(out) == ["isobox.npz"]
    after = {f: os.stat(os.path.join(golden_dir, f)).st_mtime_ns for f in os.listdir(golden_dir)}
    assert after == before
    with np.load(written[0]) as z:
        img, spp = np.asarray(z["img"]), int(z["spp"])
    assert spp == 2
    nonflip, flips = flip_gate(img, goldens.load_golden("isobox"))
    assert nonflip <= 1e-3 and flips <= FLIP_BUDGET, (nonflip, flips)
    with pytest.raises(ValueError, match="JAX package's goldens"):
        goldens.generate({"isobox"}, golden_dir, device="cpu")
    assert goldens.OUT_DIR == os.path.join(REPO, "build", "goldens")
