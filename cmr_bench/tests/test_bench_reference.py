"""The plain reference against the port at tiny sizes, through the
harness's own run and comparison, for each stream (parity, counter, ld),
each direct-light estimator (scatter, analytic) and adaptive per-pixel
counts; and the control, which must fail."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell

from cmr_bench import check, control, run

CELLS = ("showcase-1080p-frames", "vessel-1080p-frames", "showcase-preview")
# showcase-default's options overridden: the estimators a final render takes
# (README.md's estimator-efficiency stack), and the counter stream.
ESTIMATORS = {
    "ld-analytic": dict(rng="ld", direct="analytic"),
    "counter-scatter": dict(rng="counter", direct="scatter"),
    "ld-analytic-adaptive": dict(rng="ld", direct="analytic", spp_mode="adaptive"),
}
# (cell, options, samples a pixel): the cells as they stand, then showcase's
# frames under each estimator; adaptive at 8 so that its rounds re-target.
SETTINGS = [pytest.param(c, {}, 2, id=c) for c in CELLS] + [
    pytest.param("showcase-1080p-frames", o, 8 if "adaptive" in k else 2, id=k)
    for k, o in ESTIMATORS.items()]


@pytest.mark.parametrize("cell,options,samples", SETTINGS)
def test_tiny_run_is_correct(cell, options, samples):
    cfg, traffic, limits, e2e, per_layer = tiny_cell(cell, samples=samples, options=options)
    out = run.run_cell(cfg, traffic, limits, seed=2**31 + 7, seconds=0.0, trace=False,
                       device="cpu", end_to_end=e2e, per_layer=per_layer)
    assert out["correct"], out["checks"]
    assert out["checks"]["median_err"]["value"] < 1e-5
    assert out["attempted"] == 1 and set(out["metrics"]) == {m["name"] for m in e2e}
    if options.get("spp_mode") == "adaptive":
        assert out["checks"]["samples_sum"] == {"value": 16 * 16 * 8, "limit": 16 * 16 * 8}
        assert out["checks"]["fewest_samples"]["value"] >= 2
    else:
        assert set(out["checks"]) == {"flip_pct", "median_err"}


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


@pytest.mark.parametrize("direct", ["scatter", "analytic"])
@pytest.mark.parametrize("rng", ["parity", "counter", "ld"])
def test_reference_matches_port_pixel_for_pixel(rng, direct):
    """Every pixel of a 24x16 showcase frame at 2 spp, under each stream
    and direct-light estimator."""
    import dataclasses

    from complex_materials_renderer_tpu_torch.config import RenderOptions
    from complex_materials_renderer_tpu_torch.renderer import Renderer
    from complex_materials_renderer_tpu_torch.scene import load_scene

    cfg, traffic, *_ = tiny_cell("showcase-1080p-frames", width=24, height=16,
                                 options=dict(rng=rng, direct=direct))
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


@pytest.mark.parametrize("cell,options,samples", SETTINGS)
def test_control_is_not_correct(cell, options, samples):
    cfg, traffic, limits, *_ = tiny_cell(cell, width=32, height=24, samples=samples,
                                         options=options)
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


def test_adaptive_counts_reach_the_reference():
    """Under a stateless stream a pixel with a count c of its own reads the
    mean of its samples 0 .. c - 1, which is what a uniform render at c
    samples reads there; parity, sequential in a pixel, refuses counts."""
    cfg, traffic, *_ = tiny_cell("showcase-1080p-frames", width=8, height=4,
                                 options=ESTIMATORS["ld-analytic"])
    pix = check.draws(9, traffic)[1]
    counts = np.arange(len(pix)) % 3 + 1
    got = check.reference(cfg, traffic, 0.3, pix, "cpu", counts=counts)
    uniform = [check.reference(cfg, dict(traffic, samples=s), 0.3, pix, "cpu") for s in (1, 2, 3)]
    want = np.stack([uniform[c - 1][i] for i, c in enumerate(counts)])
    assert np.abs(got - want).max() < 1e-12
    parity, *_ = tiny_cell("showcase-1080p-frames", width=8, height=4)
    with pytest.raises(ValueError):
        check.reference(parity, traffic, 0.3, pix, "cpu", counts=counts)


@pytest.mark.parametrize("options", [{}, ESTIMATORS["ld-analytic"]], ids=["parity", "ld"])
def test_reference_on_card_matches_cpu(card, options):
    cfg, traffic, *_ = tiny_cell("vessel-1080p-frames", width=32, height=24, options=options)
    pix = check.draws(5, traffic)[1]
    a = check.reference(cfg, traffic, 0.5, pix, card)
    b = check.reference(cfg, traffic, 0.5, pix, "cpu")
    assert np.abs(a - b).max() < 1e-9


pytestmark = []
test_reference_on_card_matches_cpu = pytest.mark.gpu(test_reference_on_card_matches_cpu)
