"""Counter/stream random number generation, bit-equal to
complex_materials_renderer_tpu/ops/rng.py.

uint32 words are held in ``torch.int64`` tensors with values in
[0, 2^32): PyTorch has no full uint32 arithmetic, so every multiply, add
and left shift is followed by ``& 0xFFFFFFFF``, and every multiply of two
32-bit values goes through ``_mul32`` (a 16-bit split that keeps each
partial product below 2^49, where a plain int64 product of two 32-bit
words could overflow the sign bit).

Modes (see the JAX module's docstring for the sampler design):

- ``parity``: the reference's PCG32 RXS-M-XS stream (volpath:231-246),
  seeded with the linear pixel index;
- ``counter``: per-(pixel, sample) seeds through two PCG output rounds;
- ``ld``: Owen-scrambled Sobol', state rows ``[sample_index, pixel_hash,
  dim]`` of shape (R, 3); ``next_float`` dispatches on state rank.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_MULT = 747796405
_INC = 1
_OUT_MULT = 277803737
_GOLD = 0x9E3779B9
# float(0xFFFFFFFF) rounds to 2^32 in fp32, same as the GLSL literal.
_INV_U32 = float(np.float32(1.0) / np.float32(4294967295.0))


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for 32-bit words ``a`` (int64 tensor) and ``b``
    (int or int64 tensor), without int64 overflow."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def to_u32(x) -> torch.Tensor:
    """Any integer tensor (int32 bit patterns included) -> u32 words in int64."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def u32_to_float(word: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest uint32 -> float32 (the exact conversion of
    megakernel._u32_to_f32 and XLA's convert)."""
    return word.to(torch.float32)


def step(state: torch.Tensor) -> torch.Tensor:
    """One LCG step of the pcg32i stream (volpath:233-236)."""
    return (_mul32(state, _MULT) + _INC) & MASK32


def _output(state: torch.Tensor) -> torch.Tensor:
    """RXS-M-XS output permutation (volpath:239-246)."""
    shift = (state >> 28) + 4
    word = _mul32(torch.bitwise_right_shift(state, shift) ^ state, _OUT_MULT)
    return (word >> 22) ^ word


def next_float(state: torch.Tensor):
    """Step the stream and return (new_state, uniform float32 in [0, 1]).
    Rank-2 states dispatch to the ``ld`` sampler."""
    if state.dim() == 2:
        return _next_float_ld(state)
    state = step(state)
    word = _output(state)
    return state, u32_to_float(word) * _INV_U32


def next_float_masked(state: torch.Tensor, mask: torch.Tensor):
    """Draw only on lanes where ``mask`` is True (PCG modes); ``ld`` mode
    advances the dimension on every lane and ignores the mask."""
    new_state, value = next_float(state)
    if state.dim() == 2:
        return new_state, value
    return torch.where(mask, new_state, state), value


def seed_from_pixel(pixel_linear_index: torch.Tensor) -> torch.Tensor:
    """Reference seeding: rngState = width*y + x (volpath:575)."""
    return to_u32(pixel_linear_index)


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each 32-bit word (5 swap stages)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK32) | (x >> 16)


def _lk_hash(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras-style Owen permutation (Burley JCGT 2020 §3.3)."""
    x = x ^ _mul32(x, 0x3D20ADEA)
    x = (x + seed) & MASK32
    x = _mul32(x, (seed >> 16) | 1)
    x = x ^ _mul32(x, 0x05526C56)
    x = x ^ _mul32(x, 0x53A22864)
    return x


def _pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """One PCG step+output as a hash (``_output(step(x))``)."""
    return _output(step(x))


SOBOL_DIMS = 1024  # >= 2 camera dims + 8 draw sites x 32 bounces, plus slack
_SOBOL_BITS = 30  # torch's Joe-Kuo table resolution
_sobol_mat = None


def sobol_matrices() -> np.ndarray:
    """(SOBOL_DIMS, 30) uint32 direction numbers, top-aligned to 32 bits,
    from torch.quasirandom.SobolEngine exactly as the JAX package takes
    them."""
    global _sobol_mat
    if _sobol_mat is None:
        st = torch.quasirandom.SobolEngine(dimension=SOBOL_DIMS).sobolstate
        _sobol_mat = (st.numpy().astype(np.uint32)) << np.uint32(2)
    return _sobol_mat


def sobol_table(device) -> torch.Tensor:
    """The direction numbers as u32 words in an int64 tensor on ``device``."""
    return torch.from_numpy(sobol_matrices().astype(np.int64)).to(device)


def sobol_value(s: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """XOR of the direction numbers ``row`` (30,) selected by the bits of
    the sample indices ``s``."""
    v = torch.zeros_like(s)
    for j in range(_SOBOL_BITS):
        bit = (s >> j) & 1
        v = v ^ torch.where(bit != 0, row[j], torch.zeros_like(v))
    return v


def owen_draw(v: torch.Tensor, ph: torch.Tensor, dim) -> torch.Tensor:
    """Owen-scramble the Sobol value ``v`` with the (pixel, dim) key and
    convert to a float in [0, 1]."""
    key = _pcg_hash(ph ^ _mul32(to_u32(dim), _GOLD))
    word = _reverse_bits32(_lk_hash(_reverse_bits32(v), key))
    return u32_to_float(word) * _INV_U32


def _next_float_ld(state: torch.Tensor):
    """One Owen-scrambled Sobol draw. ``state`` rows are
    ``[sample_index, pixel_hash, dim]``; all lanes share the dim."""
    s, ph, d = state[:, 0], state[:, 1], state[:, 2]
    d_row = int(d.max().item()) % SOBOL_DIMS
    row = sobol_table(state.device)[d_row]
    value = owen_draw(sobol_value(s, row), ph, d)
    new_state = torch.stack([s, ph, (d + 1) & MASK32], dim=-1)
    return new_state, value


def seed_ld(pixel_linear_index: torch.Tensor, sample_index) -> torch.Tensor:
    """Fresh ld-mode state at dimension 0 for each (pixel, sample) lane;
    the sample index is Owen-shuffled by a per-pixel key."""
    p = to_u32(pixel_linear_index)
    ph = _output(step((_mul32(p, 0x9E3779B9) + 1) & MASK32))
    shuffle = _output(step((_mul32(p, 0x85EBCA6B) + 2) & MASK32))
    s = to_u32(torch.as_tensor(sample_index, device=p.device)).expand(p.shape)
    s = _reverse_bits32(_lk_hash(_reverse_bits32(s), shuffle))
    return torch.stack([s, ph, torch.zeros_like(p)], dim=-1)


def seed_counter(pixel_linear_index: torch.Tensor, sample_index) -> torch.Tensor:
    """Order-independent per-(pixel, sample) seed (two PCG output rounds)."""
    p = to_u32(pixel_linear_index)
    si = to_u32(torch.as_tensor(sample_index, device=p.device))
    s = _mul32(p, 0x9E3779B9)
    s = (s + _mul32(si, 0x85EBCA6B) + 1) & MASK32
    s = _output(step(s))
    s = _output(step(s))
    return s
