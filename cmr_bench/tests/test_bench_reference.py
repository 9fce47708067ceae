"""The plain reference against the port at tiny sizes, through the
harness's own run and comparison; and the control, which must fail."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell

from cmr_bench import check, control, run

CELLS = ("showcase-1080p-frames", "vessel-1080p-frames", "showcase-preview")


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    cfg, traffic, limits, e2e, per_layer = tiny_cell(cell)
    out = run.run_cell(cfg, traffic, limits, seed=2**31 + 7, seconds=0.0, trace=False,
                       device="cpu", end_to_end=e2e, per_layer=per_layer)
    assert out["correct"], out["checks"]
    assert out["checks"]["median_err"]["value"] < 1e-5
    assert out["attempted"] == 1 and set(out["metrics"]) == {m["name"] for m in e2e}


def test_traced_run_reports_its_layers_and_sharded_run_is_correct(monkeypatch):
    """The four-card cell's path on two logical devices of the CPU."""
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    monkeypatch.setattr(Renderer, "_shard_devices",
                        lambda self: [torch.device("cpu"), torch.device("cpu", 0)])
    cfg, traffic, limits, e2e, per_layer = tiny_cell("showcase-1080p-frames-4card", height=20)
    out = run.run_cell(cfg, traffic, limits, seed=11, seconds=0.0, trace=True, device="cpu",
                       end_to_end=e2e, per_layer=per_layer)
    assert out["correct"], out["checks"]
    assert {"accel_build_s", "enqueue_ms_per_call.frames",
            "k1_launches_per_mpath.frames"} <= set(out["metrics"])
    assert "breakdown" in out and list(out)[-1] == "checks"


def test_reference_matches_port_pixel_for_pixel():
    """Every pixel of a 24x16 showcase frame at 2 spp."""
    import dataclasses

    from complex_materials_renderer_tpu_torch.config import RenderOptions
    from complex_materials_renderer_tpu_torch.renderer import Renderer
    from complex_materials_renderer_tpu_torch.scene import load_scene

    cfg, traffic, *_ = tiny_cell("showcase-1080p-frames", width=24, height=16)
    scene = load_scene(cfg["scene"], RenderOptions())
    opts = dataclasses.replace(scene.options, **cfg["options"], width=24, height=16,
                               num_samples=2, device="cpu")
    img = Renderer(scene, opts).render()
    ys, xs = np.mgrid[0:16, 0:24]
    pix = np.stack([xs.ravel(), ys.ravel()], 1)
    ref = check.reference(cfg, traffic, 0.0, pix, "cpu")
    prog = img.reshape(-1, 3).astype(np.float64)
    rel = np.abs(prog - ref).max(-1) / np.maximum(np.abs(ref).max(-1), check.FLOOR)
    assert rel.max() < check.FLIP and np.median(rel) < 1e-6
    lit = np.abs(ref).max(-1) > 0
    assert check.compare(prog, ref) == {"flip_pct": 0.0, "median_err": float(np.median(rel[lit]))}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg, traffic, limits, *_ = tiny_cell(cell, width=32, height=24)
    for seed in (1, 2, 3):
        numbers = control.control_numbers(cfg, traffic, seed, "cpu", torch.bfloat16)
        correct, _ = check.judge(numbers, limits)
        assert not correct, numbers


def test_compare_numbers():
    ref = np.array([[0.5, 0.2, 0.1], [0.0, 0.0, 0.0], [2.0, 1.0, 1.0], [0.003, 0.0, 0.0]])
    assert check.compare(ref, ref) == {"flip_pct": 0.0, "median_err": 0.0}
    prog = ref.copy()
    prog[2, 0] = 2.2  # 10% off: a flip
    prog[1, 1] = np.nan
    out = check.compare(prog, ref)
    assert out["flip_pct"] == 50.0
    assert out["median_err"] == pytest.approx(0.0)
    assert check.compare(ref * (1 + 1e-4), ref)["median_err"] == pytest.approx(1e-4)


def test_reference_on_card_matches_cpu(card):
    cfg, traffic, *_ = tiny_cell("vessel-1080p-frames", width=32, height=24)
    pix = check.draws(5, traffic)[1]
    a = check.reference(cfg, traffic, 0.5, pix, card)
    b = check.reference(cfg, traffic, 0.5, pix, "cpu")
    assert np.abs(a - b).max() < 1e-9


pytestmark = []
test_reference_on_card_matches_cpu = pytest.mark.gpu(test_reference_on_card_matches_cpu)
