"""Shared pieces of the benchmark's own tests: the checkout's root on the
path, a fixture for the card tests, and one cell's files cut to a size the
CPU renders in seconds.

Run from the checkout's root: ``python -m pytest -q cmr_bench/tests``
(the card tests: ``-m gpu``, on a machine with a card).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The first card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def tiny_cell(cell_name: str, width=16, height=16, samples=2, check_pixels=None, options=None):
    """(config, traffic, limits, end-to-end, per-layer) of ``cell_name``
    at a tiny frame, its config on the port's CPU path of the card's
    engine (the cluster grid and the megakernel's plain version), with
    ``options`` over the configuration's."""
    from cmr_bench import spec

    bench = spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(cell["config"])
    cfg["options"].update(backend="cluster", engine="mega", **(options or {}))
    traffic = dict(spec.traffic(cell["traffic"]), width=width, height=height, samples=samples,
                   check_pixels=check_pixels or width * height)
    return (cfg, traffic, spec.limits(cell_name), spec.metrics_of(bench, "end_to_end", cell_name),
            spec.metrics_of(bench, "per_layer", cell_name))
