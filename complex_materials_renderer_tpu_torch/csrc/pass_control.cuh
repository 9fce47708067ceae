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

// The counter block of a card (int64; kernels/pass_control.py
// ``device_counts`` holds the same layout): always-on counts that every
// graph replay updates, a ring of call intervals and per-site counts.
constexpr int CNT_K1 = 0;         // K1 launches that ran
constexpr int CNT_CONTROL = 1;    // control launches
constexpr int CNT_LAST = 2;       // %globaltimer of the last stamp (ns), 0 outside a call
constexpr int CNT_CALLS = 3;      // calls stamped (the ring's next slot, modulo CNT_RING)
constexpr int CNT_CALL_NS = 4;    // the calls' summed intervals (ns)
constexpr int CNT_CALIBRATE = 5;  // the last calibration stamp (ns)
constexpr int CNT_HEAD = 8;
constexpr int CNT_RING = 128;     // call intervals kept: (start, end) ns pairs
constexpr int CNT_SITES = CNT_HEAD + 2 * CNT_RING;
// A site's fields: the control launches at it, the K1 launches that ran
// just before them, the live lanes and the lanes those launches covered,
// and the nanoseconds of the segments that end there.
constexpr int SITE_VISITS = 0;
constexpr int SITE_K1 = 1;
constexpr int SITE_LIVE = 2;
constexpr int SITE_LANES = 3;
constexpr int SITE_NS = 4;
constexpr int SITE_FIELDS = 5;
constexpr int MAX_SITES = 512;
constexpr int SITE_CALL_END = 1;  // the segment from a call's last control launch to its end
constexpr int CNT_LEN = CNT_SITES + MAX_SITES * SITE_FIELDS;

}  // namespace cmr
