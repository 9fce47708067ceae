// Triangle tester over one cluster's run-major rows (K2), as __device__
// code. Replaces the Pallas tester
// complex_materials_renderer_tpu/kernels/cluster_test.py make_cluster_tester
// (:119), which is inlined in the TPU megakernel; here it is inlined in
// csrc/megakernel.cu (K1), csrc/cluster_trace.cu (K3), binned_round.cu (K5)
// and pair_sweep.cu (K6). Moller-Trumbore in the same operation order as
// the JAX tester (build with --fmad=false so no product is fused into an
// FMA), quad slots through the far-corner coefficients qa/qb with the
// scaled edge epsilon (K3: the additive one, ``inside_k3``), and the
// payloads:
//   FullState  'full': closest hit with the shading payload
//   DistState  'dist': (t, slot)
//   OcclState  'occl': t only
//   NeeState<K> 'nee': the K nearest media boundaries as packed int32 keys
//                       [t-bits & ~63 | media row] plus the opaque t_opq
//   DneeState<K> 'dnee': dist along ray set A and nee along set B from one
//                       origin, sharing s, q and the t numerator (K1's
//                       fused walk, ``group_cluster_dnee``)
// The K keys live in registers: every loop over them is unrolled with
// compile-time indices (a dynamically indexed per-thread array would go
// to local memory). The binned round (K5) and the pair sweep (K6) test one
// cluster against lanes that may have met it before, and the K-list insert
// is not idempotent, so they serve 'nee' only on the lanes whose list holds
// the cluster (the JAX tester's ``mask``, cluster_test.py:161-168,
// :307-308: a masked lane changes nothing, so it is skipped).
//
// The walk over one cluster is a group walk: a tile of G threads
// (cooperative_groups::thread_block_tile<G>, G in 1..32) serves one ray.
// Thread k tests slots k, k+G, ... of each run, so the tile's loads of a
// row are neighbouring addresses and a narrow launch still has G threads
// per ray to fill the card. Each slot's arithmetic is the one above. After
// every cluster the tile reduces to exactly the state the one-thread walk
// over the slots in order holds after that cluster, so every later box
// decision or list clear is the serial one and the results stay bit-equal
// to the plain versions:
//   'full'/'dist'/'occl' (``group_cluster_full``): the lexicographic
//     minimum of (t, slot) over the accepted slots (the serial strict
//     t < t_best keeps the lowest slot on ties); the winner's 'full'
//     payload comes from the thread that owns it (``group_payload``);
//   'nee' (``group_cluster_nee``, set B of ``group_cluster_dnee``): a media
//     key is valid only below t_opq as it stood before its slot, the
//     exclusive running minimum of the opaque hits in slot order (the
//     carried t_opq and a tile scan per round of G slots); the valid keys
//     are inserted in slot order on every thread of the tile (a ballot,
//     then one shuffle per key), the serial insertion sequence, so the
//     K-list and t_opq equal the serial ones.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

namespace cmr {

namespace cg = cooperative_groups;

constexpr int NEE_MAT_MASK = 63;
constexpr int KEY_EMPTY = 2147483647;
constexpr float T_MIN = 1e-4f;
constexpr float T_MAX = 1e4f;
constexpr float INF_F = 3e38f;
constexpr float TRI_EPS = 1e-6f;

struct FullState {
  float t, slot, u, v, nx, ny, nz, mat, px, py, pz;
};

struct DistState {
  float t, slot;
};

struct OcclState {
  float t;
};

template <int K>
struct NeeState {
  int key[K];
  float t_opq;
};

template <int K>
struct DneeState {
  DistState a;
  NeeState<K> b;
};

// The 12 components of one slot: v0, e1, e2, material id, qa, qb.
struct Slot {
  float ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z, mat, qa, qb;
};

__device__ __forceinline__ Slot load_slot(const float* __restrict__ row, int run, int j) {
  Slot s;
  s.ax = __ldg(row + 0 * run + j);
  s.ay = __ldg(row + 1 * run + j);
  s.az = __ldg(row + 2 * run + j);
  s.e1x = __ldg(row + 3 * run + j);
  s.e1y = __ldg(row + 4 * run + j);
  s.e1z = __ldg(row + 5 * run + j);
  s.e2x = __ldg(row + 6 * run + j);
  s.e2y = __ldg(row + 7 * run + j);
  s.e2z = __ldg(row + 8 * run + j);
  s.mat = __ldg(row + 9 * run + j);
  s.qa = __ldg(row + 10 * run + j);
  s.qb = __ldg(row + 11 * run + j);
  return s;
}

// Quad-generalized barycentric acceptance (cluster_test.py ``inside``).
__device__ __forceinline__ bool inside(const Slot& s, float uu, float vv) {
  const float qa1 = 1.0f - s.qa;
  const float qb1 = 1.0f - s.qb;
  const float one_eps = 1.0f + TRI_EPS;
  return (uu >= -TRI_EPS) && (vv >= -TRI_EPS) &&
         (uu * s.qb + vv * qa1 <= s.qb * one_eps) &&
         (uu * qb1 + vv * s.qa <= s.qa * one_eps);
}

// K3's acceptance (pallas_trace.py:301-308 of the JAX package): an additive
// epsilon on the far edges, where K2 scales it (``inside``); on a triangle
// slot (qa = qb = 0.5) K3 admits u+v <= 1 + 2e-6 and K2 u+v <= 1 + 1e-6.
__device__ __forceinline__ bool inside_k3(const Slot& s, float uu, float vv) {
  return (uu >= -TRI_EPS) && (vv >= -TRI_EPS) &&
         (uu * s.qb + vv * (1.0f - s.qa) <= s.qb + TRI_EPS) &&
         (uu * (1.0f - s.qb) + vv * s.qa <= s.qa + TRI_EPS);
}

template <bool ADDITIVE>
__device__ __forceinline__ bool accept_slot(const Slot& s, float uu, float vv) {
  return ADDITIVE ? inside_k3(s, uu, vv) : inside(s, uu, vv);
}

// The origin-only half of Moller-Trumbore: s = O - v0, q = s x e1 and
// the t numerator e2 . q (shared by both ray sets of 'dnee').
struct Origin {
  float sx, sy, sz, qx, qy, qz, t_num;
};

__device__ __forceinline__ Origin origin_terms(const Slot& s, float ox, float oy, float oz) {
  Origin o;
  o.sx = ox - s.ax;
  o.sy = oy - s.ay;
  o.sz = oz - s.az;
  o.qx = o.sy * s.e1z - o.sz * s.e1y;
  o.qy = o.sz * s.e1x - o.sx * s.e1z;
  o.qz = o.sx * s.e1y - o.sy * s.e1x;
  o.t_num = s.e2x * o.qx + s.e2y * o.qy + s.e2z * o.qz;
  return o;
}

// The direction half: (uu, vv, tt) of the ray direction d.
__device__ __forceinline__ void direction_terms(const Slot& s, const Origin& o, float dx,
                                                float dy, float dz, float& uu, float& vv,
                                                float& tt) {
  const float px = dy * s.e2z - dz * s.e2y;
  const float py = dz * s.e2x - dx * s.e2z;
  const float pz = dx * s.e2y - dy * s.e2x;
  const float det = s.e1x * px + s.e1y * py + s.e1z * pz;
  const float inv_det = 1.0f / (fabsf(det) > 1e-12f ? det : 1e30f);
  uu = (o.sx * px + o.sy * py + o.sz * pz) * inv_det;
  vv = (dx * o.qx + dy * o.qy + dz * o.qz) * inv_det;
  tt = o.t_num * inv_det;
}

// Media-table row of a material id (-1 = none), first match wins.
__device__ __forceinline__ int media_index(float mat, const float* media, int M) {
  for (int i = 0; i < M; ++i) {
    const float mid = media[i * 9];
    if (mat == mid && mid >= 0.0f) return i;
  }
  return -1;
}

// The shading payload of an accepted slot.
__device__ __forceinline__ void set_full(FullState& st, const Slot& s, float uu, float vv,
                                         float tt, float slot) {
  st.t = tt;
  st.slot = slot;
  st.u = uu;
  st.v = vv;
  st.nx = s.e1y * s.e2z - s.e1z * s.e2y;
  st.ny = s.e1z * s.e2x - s.e1x * s.e2z;
  st.nz = s.e1x * s.e2y - s.e1y * s.e2x;
  st.mat = s.mat;
  st.px = s.ax + uu * s.e1x + vv * s.e2x;
  st.py = s.ay + uu * s.e1y + vv * s.e2y;
  st.pz = s.az + uu * s.e1z + vv * s.e2z;
}

__device__ __forceinline__ void update_dist(DistState& st, const Slot& s, float uu, float vv,
                                            float tt, float slot) {
  if (inside(s, uu, vv) && tt > T_MIN && tt < st.t) {
    st.t = tt;
    st.slot = slot;
  }
}

// The packed key of a media boundary at tt of media row midx.
__device__ __forceinline__ int nee_key(float tt, int midx) {
  return (__float_as_int(tt) & ~NEE_MAT_MASK) | (midx > 0 ? midx : 0);
}

// 2-op sorted insertion; a candidate beyond the K-th key (or KEY_EMPTY)
// falls off.
template <int K>
__device__ __forceinline__ void insert_key(NeeState<K>& st, int cand) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int k = st.key[i];
    st.key[i] = min(cand, k);
    cand = max(cand, k);
  }
}

// Ray/AABB slab test of box b (8 floats: lo xyz, hi xyz, pad, pad)
// against [T_MIN, tmax]: true when the segment meets the box, with its
// entry (clamped to T_MIN) in tn.
__device__ __forceinline__ bool slab_entry(const float* __restrict__ b, float ox, float oy,
                                           float oz, float ix, float iy, float iz, float tmax,
                                           float& tn_out) {
  float s0 = (__ldg(b + 0) - ox) * ix;
  float s1 = (__ldg(b + 3) - ox) * ix;
  float tn = fminf(s0, s1);
  float tf = fmaxf(s0, s1);
  s0 = (__ldg(b + 1) - oy) * iy;
  s1 = (__ldg(b + 4) - oy) * iy;
  tn = fmaxf(tn, fminf(s0, s1));
  tf = fminf(tf, fmaxf(s0, s1));
  s0 = (__ldg(b + 2) - oz) * iz;
  s1 = (__ldg(b + 5) - oz) * iz;
  tn = fmaxf(tn, fminf(s0, s1));
  tf = fminf(tf, fmaxf(s0, s1));
  tn = fmaxf(tn, T_MIN);
  tf = fminf(tf, tmax);
  tn_out = tn;
  return tn <= tf;
}

__device__ __forceinline__ bool slab_hit(const float* __restrict__ b, float ox, float oy, float oz,
                                         float ix, float iy, float iz, float tmax) {
  float tn;
  return slab_entry(b, ox, oy, oz, ix, iy, iz, tmax, tn);
}

// Early-exit bound of the NEE set: min(K-th key's t, t_opq).
template <int K>
__device__ __forceinline__ float nee_bound(const NeeState<K>& st) {
  const int k = st.key[K - 1];
  const float kth = k == KEY_EMPTY ? INF_F : __int_as_float(k & ~NEE_MAT_MASK);
  return fminf(kth, st.t_opq);
}

// ------------------------------------------------------- the group walk --

// The lexicographic minimum of (t, slot) over the tile, on every thread.
template <int G>
__device__ __forceinline__ void tile_min_hit(const cg::thread_block_tile<G>& tile, float& t,
                                             float& slot) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ot = tile.shfl_xor(t, off);
    const float os = tile.shfl_xor(slot, off);
    if (ot < t || (ot == t && os < slot)) {
      t = ot;
      slot = os;
    }
  }
}

// The payload of 'dist' and 'occl': none beyond (t, slot).
struct NoPayload {};

__device__ __forceinline__ void set_full(NoPayload&, const Slot&, float, float, float, float) {}

// The closest hit over cluster c for the tile's ray: thread k tests slots
// k, k+G, ... of each run below the tile's bound (t, slot) as it stood at
// the cluster's start, keeping the payload of its own closest hit in
// ``mine`` (a FullState for 'full', NoPayload for 'dist' and 'occl'); then
// the tile takes the lexicographic minimum, the serial walk's state. For
// 'occl' t is the serial one whatever the slot.
template <int G, bool ADDITIVE, class Payload>
__device__ __forceinline__ void group_cluster_full(const cg::thread_block_tile<G>& tile,
                                                   const float* __restrict__ run_rows,
                                                   int row_w, int subs, int run, int c,
                                                   float ox, float oy, float oz, float dx,
                                                   float dy, float dz, float& t, float& slot,
                                                   Payload& mine) {
  float bt = t, bs = slot;
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    const int r_off = (c * subs + rr) * run;
    for (int j = tile.thread_rank(); j < run; j += G) {
      const Slot s = load_slot(row, run, j);
      const Origin o = origin_terms(s, ox, oy, oz);
      float uu, vv, tt;
      direction_terms(s, o, dx, dy, dz, uu, vv, tt);
      if (accept_slot<ADDITIVE>(s, uu, vv) && tt > T_MIN && tt < bt) {
        bt = tt;
        bs = (float)(r_off + j);
        set_full(mine, s, uu, vv, tt, bs);
      }
    }
  }
  tile_min_hit<G>(tile, bt, bs);
  t = bt;
  slot = bs;
}

// The closest hit (t, slot) of the tile with its payload, taken from the
// thread whose own closest hit is that slot (each slot is tested by one
// thread only). With no hit (slot -1) every thread holds the initial
// payload.
template <int G>
__device__ __forceinline__ FullState group_payload(const cg::thread_block_tile<G>& tile,
                                                   const FullState& mine, float t, float slot) {
  const int src = __ffs(tile.ballot(mine.slot == slot)) - 1;
  FullState st;
  st.t = t;
  st.slot = slot;
  st.u = tile.shfl(mine.u, src);
  st.v = tile.shfl(mine.v, src);
  st.nx = tile.shfl(mine.nx, src);
  st.ny = tile.shfl(mine.ny, src);
  st.nz = tile.shfl(mine.nz, src);
  st.mat = tile.shfl(mine.mat, src);
  st.px = tile.shfl(mine.px, src);
  st.py = tile.shfl(mine.py, src);
  st.pz = tile.shfl(mine.pz, src);
  return st;
}

// One round of G slots of a NEE set: thread k holds its slot's opaque
// hit ``own_opq`` (+inf: none), whether it is a media hit (``media_hit``),
// its t and its key. A media hit is valid below t_opq as it stood before
// its slot, the minimum of the carried ``opq`` and the opaque hits of the
// round's earlier slots (an exclusive prefix minimum over the tile); the
// valid keys are inserted on every thread in slot order. A round in which
// no thread meets a medium or an opaque slot below ``opq`` changes nothing
// and skips the scan (one vote).
template <int G, int K>
__device__ __forceinline__ void group_nee_round(const cg::thread_block_tile<G>& tile,
                                                float own_opq, bool media_hit, float tb, int key,
                                                float& opq, NeeState<K>& st) {
  if (!tile.any(media_hit || own_opq < opq)) return;
  const int k = tile.thread_rank();
  float incl = own_opq;
#pragma unroll
  for (int dl = 1; dl < G; dl <<= 1) {
    const float y = tile.shfl_up(incl, dl);
    if (k >= dl) incl = fminf(incl, y);
  }
  const float prev = tile.shfl_up(incl, 1);
  const float before = k == 0 ? opq : fminf(opq, prev);
  opq = fminf(opq, tile.shfl(incl, G - 1));
  unsigned valid = tile.ballot(media_hit && tb < before);
  while (valid) {
    const int src = __ffs(valid) - 1;
    valid &= valid - 1;
    insert_key<K>(st, tile.shfl(key, src));
  }
}

// The NEE terms of a slot tested along direction d from origin terms o.
__device__ __forceinline__ void nee_terms(const Slot& s, const Origin& o, float dx, float dy,
                                          float dz, const float* media, int M, float& own_opq,
                                          bool& media_hit, float& tb, int& key) {
  float uu, vv, tt;
  direction_terms(s, o, dx, dy, dz, uu, vv, tt);
  const int midx = media_index(s.mat, media, M);
  const bool valid_geom = inside(s, uu, vv) && tt > T_MIN;
  if (valid_geom && midx < 0) own_opq = tt;
  media_hit = valid_geom && midx >= 0;
  tb = tt;
  key = nee_key(tt, midx);
}

// 'nee' over cluster c for the tile's ray, in rounds of G slots of a run
// (slot j0 + k on thread k). ``st`` is the same on every thread before and
// after.
template <int G, int K>
__device__ __forceinline__ void group_cluster_nee(const cg::thread_block_tile<G>& tile,
                                                  const float* __restrict__ run_rows, int row_w,
                                                  int subs, int run, int c, float ox, float oy,
                                                  float oz, float dx, float dy, float dz,
                                                  const float* media, int M, NeeState<K>& st) {
  const int k = tile.thread_rank();
  float opq = st.t_opq;
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    for (int j0 = 0; j0 < run; j0 += G) {
      const int j = j0 + k;
      float own_opq = __int_as_float(0x7f800000), tb = 0.0f;  // +inf: no opaque hit
      bool media_hit = false;
      int key = KEY_EMPTY;
      if (j < run) {
        const Slot s = load_slot(row, run, j);
        nee_terms(s, origin_terms(s, ox, oy, oz), dx, dy, dz, media, M, own_opq, media_hit, tb,
                  key);
      }
      group_nee_round<G, K>(tile, own_opq, media_hit, tb, key, opq, st);
    }
  }
  st.t_opq = opq;
}

// 'dnee' over cluster c for the tile's ray sets A (da) and B (db), in
// rounds of G slots of a run (slot j0 + k on thread k). Set A as
// ``group_cluster_full`` without the payload, set B as
// ``group_cluster_nee``; the two share the origin terms of each slot.
// ``st`` is the same on every thread before and after.
template <int G, int K>
__device__ __forceinline__ void group_cluster_dnee(const cg::thread_block_tile<G>& tile,
                                                   const float* __restrict__ run_rows,
                                                   int row_w, int subs, int run, int c,
                                                   float ox, float oy, float oz, float dxa,
                                                   float dya, float dza, float dxb, float dyb,
                                                   float dzb, const float* media, int M,
                                                   DneeState<K>& st) {
  const int k = tile.thread_rank();
  DistState a = st.a;
  float opq = st.b.t_opq;
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    const int r_off = (c * subs + rr) * run;
    for (int j0 = 0; j0 < run; j0 += G) {
      const int j = j0 + k;
      float own_opq = __int_as_float(0x7f800000), tb = 0.0f;  // +inf: no opaque hit
      bool media_hit = false;
      int key = KEY_EMPTY;
      if (j < run) {
        const Slot s = load_slot(row, run, j);
        const Origin o = origin_terms(s, ox, oy, oz);
        float uu, vv, tt;
        direction_terms(s, o, dxa, dya, dza, uu, vv, tt);
        update_dist(a, s, uu, vv, tt, (float)(r_off + j));
        nee_terms(s, o, dxb, dyb, dzb, media, M, own_opq, media_hit, tb, key);
      }
      group_nee_round<G, K>(tile, own_opq, media_hit, tb, key, opq, st.b);
    }
  }
  tile_min_hit<G>(tile, a.t, a.slot);
  st.a = a;
  st.b.t_opq = opq;
}

}  // namespace cmr
