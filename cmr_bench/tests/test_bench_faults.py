"""A run with the timed path broken underneath the harness comes out as
not correct: the tile renderer returns its state unchanged, renders half
of its samples and takes the mean over them, leaves out the exchange
between devices, or alters its answer; adaptive sampling's samples call
returns its state unchanged or alters its answer, or the render reports
counts off its budget; the ld stream draws two sites in each other's
place. The look for a card is skipped: the run is on the CPU at a tiny
size."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell

from cmr_bench import run

ADAPTIVE = dict(rng="ld", direct="analytic", spp_mode="adaptive")


def _tile_fault(kind):
    from complex_materials_renderer_tpu_torch.render import megarender

    real = megarender.render_beauty_mega

    def broken(camera, scene, grid, lights, resolution, num_samples, *a, **kw):
        if kw.get("return_rng") is not True:
            kw["return_rng"] = False
        if kind == "half":
            out = real(camera, scene, grid, lights, resolution, max(1, num_samples // 2), *a, **kw)
        else:
            out = real(camera, scene, grid, lights, resolution, num_samples, *a, **kw)
        img, rng = out if kw["return_rng"] else (out, None)
        if kind == "unchanged":
            img = torch.zeros_like(img)
        elif kind == "altered":
            img = img * 1.01
        return (img, rng) if kw["return_rng"] else img

    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_tile_fault_is_caught(monkeypatch, kind):
    from complex_materials_renderer_tpu_torch.render import megarender

    monkeypatch.setattr(megarender, "render_beauty_mega", _tile_fault(kind))
    cfg, traffic, limits, e2e, per_layer = tiny_cell("showcase-1080p-frames", samples=4)
    out = run.run_cell(cfg, traffic, limits, seed=3, seconds=0.0, trace=False, device="cpu",
                       end_to_end=e2e, per_layer=per_layer)
    assert not out["correct"], out["checks"]


def test_exchange_left_out_is_caught(monkeypatch):
    from complex_materials_renderer_tpu_torch.parallel import sharding
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    real = sharding.combine_cells

    def first_card_only(images, n_sample, n_tile, height, device):
        kept = {k: (v if k[1] == 0 else torch.zeros_like(v)) for k, v in images.items()}
        return real(kept, n_sample, n_tile, height, device)

    monkeypatch.setattr(sharding, "combine_cells", first_card_only)
    monkeypatch.setattr(Renderer, "_shard_devices",
                        lambda self: [torch.device("cpu"), torch.device("cpu", 0)])
    cfg, traffic, limits, e2e, per_layer = tiny_cell("showcase-1080p-frames-4card", height=20)
    out = run.run_cell(cfg, traffic, limits, seed=4, seconds=0.0, trace=False, device="cpu",
                       end_to_end=e2e, per_layer=per_layer)
    assert not out["correct"], out["checks"]


def _adaptive_run(**options):
    cfg, traffic, limits, e2e, per_layer = tiny_cell("showcase-1080p-frames", samples=8,
                                                     options=options or ADAPTIVE)
    return run.run_cell(cfg, traffic, limits, seed=5, seconds=0.0, trace=False, device="cpu",
                        end_to_end=e2e, per_layer=per_layer)


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_samples_fault_is_caught(monkeypatch, kind):
    from complex_materials_renderer_tpu_torch.render import megarender

    real = megarender.render_samples_mega

    def broken(*a, **kw):
        out = real(*a, **kw)
        return torch.zeros_like(out) if kind == "unchanged" else out * 1.01

    monkeypatch.setattr(megarender, "render_samples_mega", broken)
    out = _adaptive_run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["short", "starved"])
def test_adaptive_counts_off_budget_are_caught(monkeypatch, kind):
    """The counts one short of the budget, or one pixel at a single sample
    with the sum kept: not correct, whatever the image reads."""
    from complex_materials_renderer_tpu_torch.renderer import Renderer

    real = Renderer.render_adaptive

    def off_budget(self, *a, **kw):
        img = real(self, *a, **kw)
        n = self.sample_counts.reshape(-1)
        n[np.argmax(n)] -= 1
        if kind == "starved":
            n[np.argmin(n)] -= 1
            n[np.argmax(n)] += 2
        return img

    monkeypatch.setattr(Renderer, "render_adaptive", off_budget)
    out = _adaptive_run()
    budget = out["checks"]["samples_sum"]
    assert budget["limit"] == 16 * 16 * 8
    assert (budget["value"] == budget["limit"] - 1 if kind == "short"
            else out["checks"]["fewest_samples"]["value"] == 1)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("adaptive", [False, True], ids=["uniform", "adaptive"])
def test_ld_sites_swapped_is_caught(monkeypatch, adaptive):
    """K1's ld stream with its first two draw sites (the boundary's Fresnel
    draw and the free flight's) in each other's place."""
    from complex_materials_renderer_tpu_torch.kernels import megakernel

    real = megakernel._make_draw

    def swapped(*a, **kw):
        draw = real(*a, **kw)
        return lambda state, mask, site: draw(state, mask, {0: 1, 1: 0}.get(site, site))

    monkeypatch.setattr(megakernel, "_make_draw", swapped)
    out = _adaptive_run(**(ADAPTIVE if adaptive else dict(rng="ld", direct="analytic")))
    assert not out["correct"], out["checks"]
