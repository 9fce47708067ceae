"""The plain megakernel (K1) against the JAX ``trace_paths_mega``
(interpreted) in its other modes: TIR kill with the analytic direct term,
an opaque/media partitioned grid, and a coincident double medium shell
that fills the NEE K-list with duplicates. Tolerances as in
test_torch_megakernel.py."""

import numpy as np
import torch

from test_torch_support import assert_states_close, k1_case, run_both

torch.set_num_threads(1)

KW = dict(max_depth=8, rr_depth=4, nee_max_media=1)
TOL = dict(atol=1e-5, org_atol=1e-4)


def test_tir_kill_with_analytic_direct():
    a, b = run_both(k1_case(lanes=1024, seed=10), tir_kill=True, analytic_direct=True, **KW)
    assert_states_close(a, b, **TOL)
    assert np.abs(a["rad"]).max() > 0


def test_partitioned_grid():
    case = k1_case(lanes=1024, seed=11, media_mats={1})
    assert case[1].num_opaque_supers > 0
    a, b = run_both(case, **KW)
    assert_states_close(a, b, **TOL)


def test_coincident_shell_nee():
    a, b = run_both(k1_case(lanes=1024, seed=12, duplicate_shell=True), max_depth=6, rr_depth=3,
                    nee_max_media=1)
    assert_states_close(a, b, **TOL)


def test_ld_dim_base_is_clipped():
    # dim0 beyond the table: both packages clip the row base to
    # SOBOL_DIMS - 8 * max_iters.
    case = k1_case(lanes=1024, seed=13, ld=True)
    a, b = run_both(case, ld=True, dim0=5000, max_iters=2, **KW)
    assert_states_close(a, b, **TOL)
