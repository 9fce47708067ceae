"""A run with the timed path broken underneath the harness comes out as
not correct: the tile renderer returns its state unchanged, renders half
of its samples and takes the mean over them, leaves out the exchange
between devices, or alters its answer. The look for a card is skipped:
the run is on the CPU at a tiny size."""

import pytest
import torch

from conftest import tiny_cell

from cmr_bench import run


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
