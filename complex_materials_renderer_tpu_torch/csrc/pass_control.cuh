// The pass control block: a small int32 tensor on the card that carries a
// pass's (or a trace loop's) decisions from one launch to the next, so that the mega pass runs
// with no host read between its first launch and its last
// (render/megarender.py ``PassPlan``; kernels/pass_control.py holds the
// same layout). The JAX package keeps these values as traced scalars of
// one jit program (render/megarender.py ``_make_advance`` :213-314 and
// kernels/megakernel.py :1487, :1548-1552, :1589-1592).

#pragma once

namespace cmr {

constexpr int CTRL_LIVE = 0;    // live_blocks: K1 runs lanes [0, live_blocks * 1024)
constexpr int CTRL_DIM0 = 1;    // the ld Sobol dimension base, before K1's clip
constexpr int CTRL_RUN = 2;     // run flag: 0 makes every CTA of K1 return at once
constexpr int CTRL_NALIVE = 3;  // the alive lanes that the control kernel last counted
constexpr int CTRL_COND = 4;    // the last loop or guard condition it computed
constexpr int CTRL_ITER = 5;    // a loop's iteration counter (for a cap on the card)
constexpr int CTRL_RUNG = 6;    // the rung of a launch-shape ladder it chose, -1 for none
constexpr int CTRL_EXTENT = 7;  // the last true byte's index + 1 that it last found
constexpr int CTRL_LEN = 8;
constexpr int CTRL_BLOCK_LANES = 1024;  // the unit of live_blocks

}  // namespace cmr
