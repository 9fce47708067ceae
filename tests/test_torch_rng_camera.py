"""RNG streams and camera rays of the PyTorch port against the JAX
package: integer outputs bit-equal over 1e5 lanes (words >= 2^31
included), draws bit-equal as float32, rays within 2 ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu.ops import camera as jcam
from complex_materials_renderer_tpu.ops import rng as jrng
from complex_materials_renderer_tpu_torch.ops import camera as tcam
from complex_materials_renderer_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

N = 100_000


def _words(seed, n=N):
    rs = np.random.default_rng(seed)
    w = rs.integers(0, 2**32, size=n, dtype=np.uint32)
    w[:4] = [0, 1, 2**31, 2**32 - 1]
    assert (w >= 2**31).sum() > n // 3
    return w


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def test_pcg_step_output_and_draws():
    w = _words(1)
    np.testing.assert_array_equal(_u32(jrng.step(jnp.asarray(w))), trng.step(_t(w)).numpy())
    np.testing.assert_array_equal(_u32(jrng._output(jnp.asarray(w))), trng._output(_t(w)).numpy())
    sj, vj = jrng.next_float(jnp.asarray(w))
    st, vt = trng.next_float(_t(w))
    np.testing.assert_array_equal(_u32(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    assert vt.dtype == torch.float32


def test_masked_draw():
    w = _words(2)
    mask = np.random.default_rng(3).random(N) < 0.5
    sj, vj = jrng.next_float_masked(jnp.asarray(w), jnp.asarray(mask))
    st, vt = trng.next_float_masked(_t(w), torch.from_numpy(mask))
    np.testing.assert_array_equal(_u32(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(st.numpy()[~mask], w[~mask].astype(np.int64))


def test_seeds_and_hashes():
    p = _words(4)
    s = _words(5)
    np.testing.assert_array_equal(
        _u32(jrng.seed_from_pixel(jnp.asarray(p))), trng.seed_from_pixel(_t(p)).numpy()
    )
    for sample in (0, 7, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(
            _u32(jrng.seed_counter(jnp.asarray(p), sample)),
            trng.seed_counter(_t(p), sample).numpy(),
        )
    np.testing.assert_array_equal(
        _u32(jrng.seed_counter(jnp.asarray(p), jnp.asarray(s))),
        trng.seed_counter(_t(p), _t(s)).numpy(),
    )
    np.testing.assert_array_equal(_u32(jrng._reverse_bits32(jnp.asarray(p))),
                                  trng._reverse_bits32(_t(p)).numpy())
    np.testing.assert_array_equal(_u32(jrng._lk_hash(jnp.asarray(p), jnp.asarray(s))),
                                  trng._lk_hash(_t(p), _t(s)).numpy())


def test_sobol_matrices_equal():
    a = jrng.sobol_matrices()
    b = trng.sobol_matrices()
    assert b.shape == (trng.SOBOL_DIMS, 30) and b.dtype == np.uint32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sample", [0, 3, 2**31 + 1])
def test_ld_seed_and_draws(sample):
    p = _words(6)
    sj = jrng.seed_ld(jnp.asarray(p), sample)
    st = trng.seed_ld(_t(p), sample)
    np.testing.assert_array_equal(_u32(sj), st.numpy())
    for _ in range(3):  # dims 0, 1, 2
        sj, vj = jrng.next_float(sj)
        st, vt = trng.next_float(st)
        np.testing.assert_array_equal(_u32(sj), st.numpy())
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    mask = np.zeros(N, bool)
    sj, vj = jrng.next_float_masked(sj, jnp.asarray(mask))
    st, vt = trng.next_float_masked(st, torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    assert int(st[0, 2]) == 4


def test_ld_lane_sample_indices():
    # Per-lane sample indices (the sample-packed lanes of the renderer).
    p = _words(7, 4096)
    s = _words(8, 4096)
    np.testing.assert_array_equal(
        _u32(jrng.seed_ld(jnp.asarray(p), jnp.asarray(s))), trng.seed_ld(_t(p), _t(s)).numpy()
    )


def _camera_pair(pos, look, fov):
    return jcam.make_camera(pos, look, fov), tcam.make_camera(pos, look, fov)


@pytest.mark.parametrize("pos,look,fov,res", [
    ((0.0, 1.5, 5.0), (0.0, 1.0, 0.0), 36.0, (64, 48)),
    ((3.0, 2.0, -7.5), (0.5, 0.25, 1.0), 60.0, (512, 512)),
    ((-1.0, 4.0, 2.0), (0.0, 0.0, 0.0), 20.0, (100, 33)),
])
def test_camera_and_rays(pos, look, fov, res):
    cj, ct = _camera_pair(pos, look, fov)
    for a, b in zip(cj, ct):
        np.testing.assert_array_max_ulp(np.asarray(a), b.numpy(), maxulp=2)
    rs = np.random.default_rng(9)
    w, h = res
    n = min(N, w * h)
    pix = np.stack([rs.integers(0, w, n), rs.integers(0, h, n)], -1).astype(np.int32)
    jit = rs.random((n, 2)).astype(np.float32)
    oj, dj = jcam.generate_rays(cj, jnp.asarray(pix), jnp.asarray(jit), res)
    ot, dt = tcam.generate_rays(ct, torch.from_numpy(pix), torch.from_numpy(jit), res)
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    np.testing.assert_array_max_ulp(np.asarray(dj), dt.numpy(), maxulp=2)
