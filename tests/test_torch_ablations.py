"""The megakernel's CMR_MEGA_DEBUG ablations in the port: the plain K1 of
each token against the JAX package's ``trace_paths_mega(..., debug=token)``
run interpreted, on the same state; the images of the exact ablations
against the default; the render layers' handling of ``debug``.

Tolerance of the state comparisons: that of the default K1
(tests/test_torch_megakernel.py): rng, depth and alive equal on every lane
but at most 2 flip lanes per 1024, dir, thr and rad within atol 1e-5, org
within atol 1e-4. Under 'nodist' the distance walk is gone and seg_len is
t_max, so a lane passing through a medium moves 1e4 along its direction:
the direction's last-ulp differences (about 1e-6) become 1e-2 in org, where
one ulp is 1e-3; org is held within atol 1e-2 there.

Images: 'nofuse', 'ordered' and 'carrywalk' render the default image within
atol 1e-6 (JAX tests/test_megakernel.py:264-320); 'nonee' changes it."""

import os
import re

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch import renderer as trenderer
from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.kernels import megakernel as tmk
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.ops.camera import make_camera
from complex_materials_renderer_tpu_torch.render import megarender as tmr
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays

from helpers import make_test_scene
from test_torch_support import assert_states_close, k1_case, run_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_depth=4, rr_depth=2, nee_max_media=1)
TOL = dict(atol=1e-5, org_atol=1e-4)
NODIST_TOL = dict(atol=1e-5, org_atol=1e-2)


def _tol(debug):
    return NODIST_TOL if "nodist" in debug else TOL


@pytest.mark.parametrize("debug", tmk.ABLATION_SETS)
def test_token_matches_jax(debug):
    a, b = run_both(k1_case(lanes=1024, seed=20), debug=debug, **KW)
    assert_states_close(a, b, **_tol(debug))
    if debug == "nophys":
        # Every lane bounces at most max_depth times, +0.01 each.
        assert a["depth"].max() <= KW["max_depth"] and np.abs(a["rad"][:, 0]).max() > 0


@pytest.mark.parametrize("debug", ["nophys", "notrace", "cullonly"])
def test_block_lockstep_with_dead_lanes(debug):
    """Under nophys, lanes dead at entry in a block with a live lane take
    the block's unmasked flips, +0.01 and depth + 1; notrace and cullonly
    go through the masked physics, which leaves a dead lane as it was; a
    block with no live lane stays as it was."""
    case = k1_case(lanes=2048, seed=21)
    f = case[4]
    f["alive"][:300] = False
    f["alive"][1024:] = False
    before = {k: v.copy() for k, v in f.items()}
    a, b = run_both(case, debug=debug, **KW)
    assert_states_close(a, b, **TOL)
    dead = np.r_[0:300, 1024:2048]
    if debug == "nophys":
        iters = int(a["depth"][:1024].max())
        assert iters > 0
        np.testing.assert_array_equal(b["depth"][:300], np.full(300, iters))
        np.testing.assert_array_equal(b["dir"][:300], before["dir"][:300] * (-1.0) ** iters)
        dead = dead[300:]
    for name in ("org", "dir", "rad", "depth", "alive"):
        np.testing.assert_array_equal(b[name][dead], before[name][dead], err_msg=name)


@pytest.mark.parametrize("debug", ["nofuse", "ordered"])
def test_unfused_on_partitioned_grid_matches_jax(debug):
    """The occlusion walk over the opaque supers and the K-list walk over
    the media supers of a partitioned grid."""
    case = k1_case(lanes=1024, seed=22, media_mats={1})
    assert case[1].num_opaque_supers > 0
    a, b = run_both(case, debug=debug, **KW)
    assert_states_close(a, b, **TOL)


def test_nofuse_analytic_direct_matches_jax():
    a, b = run_both(k1_case(lanes=1024, seed=23), debug="nofuse", analytic_direct=True,
                    tir_kill=True, **KW)
    assert_states_close(a, b, **TOL)


@pytest.mark.parametrize("debug", tmk.EXACT_ABLATIONS)
def test_exact_ablations_keep_the_plain_state(debug):
    """The exact walks give the default plain K1's state bit for bit."""
    _, tgrid, media9, misc, f = k1_case(lanes=1024, seed=24)
    out = []
    for d in ("", debug):
        st = tmk.from_jax_arrays(**f)
        tmk.trace_paths_mega(tgrid, torch.from_numpy(np.array(media9)),
                             torch.from_numpy(np.array(misc)), st, debug=d, **KW)
        out.append(st)
    for x, y in zip(*out):
        assert torch.equal(x, y)


def _objects(media_mats=None):
    tris, mats, media = make_test_scene()
    scene = make_scene_arrays(tris, mats, media, 1.0, 1, device="cpu")
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8, media_mats=media_mats),
                               "cpu")
    camera = make_camera((0.0, 1.5, 5.0), (0.0, 1.0, 0.0), 36.0)
    lights = make_lights((2.0, 4.0, 3.0), (0.8, 0.8, 0.6), 100.0)
    return camera, scene, grid, lights


_IMAGES: dict = {}


def _image(debug="", media_mats=None, **kw):
    key = (debug, media_mats is not None, tuple(sorted(kw.items())))
    if key not in _IMAGES:
        _IMAGES[key] = tmr.render_beauty_mega(*_objects(media_mats), (8, 8), 1, debug=debug,
                                              **KW, **kw).numpy()
    return _IMAGES[key]


@pytest.mark.parametrize("debug,media_mats", [
    ("nofuse", None), ("nofuse", {1}), ("ordered", None), ("carrywalk", None)])
def test_exact_ablations_render_the_default_image(debug, media_mats):
    ref = _image(media_mats=media_mats)
    assert np.isfinite(ref).all() and ref.max() > 0
    np.testing.assert_allclose(_image(debug, media_mats), ref, atol=1e-6)


def test_nonee_changes_the_image():
    assert not np.allclose(_image("nonee"), _image())


@pytest.mark.parametrize("engine", ["binned", "pair"])
def test_binned_and_pair_ignore_debug(engine):
    ref = _image(trace_engine=engine)
    np.testing.assert_array_equal(_image("nonee,nophys", trace_engine=engine), ref)


def test_renderer_reads_cmr_mega_debug(monkeypatch):
    monkeypatch.setenv("CMR_MEGA_DEBUG", "nonee,nodist")
    assert trenderer._engine_knobs("mega")["debug"] == "nonee,nodist"
    monkeypatch.delenv("CMR_MEGA_DEBUG")
    assert trenderer._engine_knobs("mega")["debug"] == ""


def test_ablation_mask():
    A = tmk.ABLATIONS
    assert tmk.ablation_mask("") == 0
    assert tmk.ablation_mask("nonee,nodist") == A["nonee"] | A["nodist"]
    assert tmk.ablation_mask(" nofuse , ") == A["nofuse"]
    # The JAX kernel's walk takes 'ordered' over 'carrywalk'.
    assert tmk.ablation_mask("carrywalk,ordered") == A["ordered"]
    with pytest.raises(ValueError, match="unknown CMR_MEGA_DEBUG token"):
        tmk.ablation_mask("nofuse,fast")
    # The megakernel refuses an unknown token.
    with pytest.raises(ValueError, match="unknown CMR_MEGA_DEBUG token"):
        tmr.render_beauty_mega(*_objects(), (8, 8), 1, debug="nodsit", **KW)


def test_ablation_bits_match_the_cuda_source():
    """Each token's bit is the one csrc/megakernel.cu reads."""
    with open(os.path.join(REPO, "complex_materials_renderer_tpu_torch", "csrc",
                           "megakernel.cu")) as f:
        src = f.read()
    names = {"nofuse": "NOFUSE", "ordered": "ORDERED", "cullonly": "CULLONLY",
             "notrace": "NOTRACE", "nophys": "NOPHYS", "nodist": "NODIST", "nonee": "NONEE"}
    for tok, name in names.items():
        m = re.search(rf"constexpr bool {name} = ABLATE & (\d+);", src)
        assert m and int(m.group(1)) == tmk.ABLATIONS[tok], tok
    # carrywalk has no bit there: it runs the nofuse library at one thread
    # a lane, its other tokens kept; beside ordered it is dropped.
    A = tmk.ABLATIONS
    assert "ABLATE & 4" not in src
    assert tmk.cuda_instance(A["carrywalk"]) == (A["nofuse"], True)
    assert tmk.cuda_instance(A["carrywalk"] | A["nonee"]) == (A["nofuse"] | A["nonee"], True)
    assert tmk.cuda_instance(tmk.ablation_mask("carrywalk,ordered")) == (A["ordered"], False)
    for debug in ("",) + tmk.ABLATION_SETS:
        lib, one_thread = tmk.cuda_instance(tmk.ablation_mask(debug))
        assert not lib & A["carrywalk"] and one_thread == (debug == "carrywalk"), debug
