"""The plain version of the path-tracing megakernel (K1) against the JAX
package's ``trace_paths_mega`` run interpreted, on the same state.

Tolerance: rng, depth and alive equal on every lane except at most 2
flip lanes per 1024 (a lane whose depth or alive differ: one path
decision resolved the other way by a last-ulp difference of expf, logf,
sinf or cosf between XLA and PyTorch). On the other lanes dir, thr and rad
agree within atol 1e-5, and org within atol 1e-4: a path's origin is the
end of its last segment, so it carries the direction's last-ulp
differences (~1e-6 after a few refractions) times the length of the
segments it travelled, several scene units. The worst org error of these
cases is printed by ``PYTHONPATH=. python tests/test_torch_support.py``."""

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.kernels import megakernel as jmk
from complex_materials_renderer_tpu_torch.kernels import megakernel as tmk

from test_torch_support import assert_states_close, k1_case, run_both

torch.set_num_threads(1)

KW = dict(max_depth=8, rr_depth=4, nee_max_media=1)
TOL = dict(atol=1e-5, org_atol=1e-4)


def test_parity_runs_paths_to_termination():
    a, b = run_both(k1_case(lanes=1024, seed=0), **KW)
    assert not a["alive"].any() and a["depth"].max() > 2
    assert np.abs(a["rad"]).max() > 0
    assert_states_close(a, b, **TOL)


def test_counter_one_iteration_live_blocks_pass_through():
    case = k1_case(lanes=2048, seed=1)
    before = {k: v.copy() for k, v in case[4].items()}
    a, b = run_both(case, max_iters=1, live_blocks=1, **KW)
    assert_states_close(a, b, **TOL)
    # One bounce: every lane of block 0 took exactly one iteration.
    assert set(np.unique(a["depth"][:1024])) <= {0, 1, 2}
    # Block 1 is beyond live_blocks: bit-equal pass-through in both.
    for name in ("org", "dir", "thr", "rad", "depth", "alive"):
        np.testing.assert_array_equal(b[name][1024:], before[name][1024:], err_msg=name)
        np.testing.assert_array_equal(a[name][1024:], before[name][1024:], err_msg=name)
    np.testing.assert_array_equal(b["rng"][1024:], before["rng"][1024:].astype(np.int64))


def test_ld_sobol_rows_from_dim0():
    case = k1_case(lanes=1024, seed=2, ld=True)
    a, b = run_both(case, ld=True, dim0=2, **KW)
    assert_states_close(a, b, **TOL)
    # ld draws leave the sample index in place.
    np.testing.assert_array_equal(b["rng"], case[4]["rng"].astype(np.int64))


def test_state_is_updated_in_place():
    *_, f = k1_case(lanes=1024, seed=3)
    jgrid, tgrid, media9, misc, _ = k1_case(lanes=1024, seed=3)
    st = tmk.from_jax_arrays(**f)
    ptrs = [t.data_ptr() for t in st]
    out = tmk.trace_paths_mega(tgrid, torch.from_numpy(np.array(media9)),
                               torch.from_numpy(np.array(misc)), st, max_iters=1, **KW)
    assert [t.data_ptr() for t in out] == ptrs
    assert out.depth.sum() > 0


def test_caps_raise_alike():
    from complex_materials_renderer_tpu.scene.scene import _empty_media
    from complex_materials_renderer_tpu_torch.kernels import cluster_grid as tcg

    jgrid, tgrid, media9, misc, f = k1_case(lanes=1024, seed=4)
    st = tmk.from_jax_arrays(**f)
    big = tcg.DeviceClusterGrid(**{**tgrid.__dict__, "num_supers": 1025})
    with pytest.raises(ValueError, match="super-clusters"):
        tmk.trace_paths_mega(big, torch.from_numpy(np.array(media9)),
                             torch.from_numpy(np.array(misc)), st, **KW)
    m = _empty_media()
    many = type(m)(mat_id=np.arange(64, dtype=np.int32), sigma_s=np.ones((64, 3), np.float32),
                   sigma_a=np.ones((64, 3), np.float32), g=np.zeros((64, 3), np.float32),
                   ior=np.ones(64, np.float32))
    with pytest.raises(ValueError, match="63-medium"):
        jmk.pack_media(many, 1.0)
    with pytest.raises(ValueError, match="63-medium"):
        tmk.pack_media(many, 1.0)
    np.testing.assert_array_equal(np.asarray(jmk.pack_media(m, 2.0)), tmk.pack_media(m, 2.0).numpy())
    few = type(m)(*(a[:5] for a in many))
    np.testing.assert_array_equal(np.asarray(jmk.pack_media(few, 3.5)), tmk.pack_media(few, 3.5).numpy())


def test_fresh_state_and_from_jax_arrays():
    rs = np.random.default_rng(5)
    o = rs.normal(size=(64, 3)).astype(np.float32)
    d = rs.normal(size=(64, 3)).astype(np.float32)
    w = rs.integers(0, 2**32, size=64, dtype=np.uint32)
    js = jmk.fresh_state(o, d, w)
    ts = tmk.fresh_state(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(w.astype(np.int64)))
    back = tmk.from_jax_arrays(*(np.asarray(x) for x in js))
    for x, y, z in zip(js, ts, back):
        np.testing.assert_array_equal(np.asarray(x).astype(np.float64), y.numpy().astype(np.float64))
        assert y.dtype == z.dtype
        np.testing.assert_array_equal(y.numpy(), z.numpy())
