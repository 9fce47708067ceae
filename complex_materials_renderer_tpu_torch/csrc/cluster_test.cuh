// Triangle tester over one cluster's run-major rows (K2), as __device__
// code for one lane. Replaces the Pallas tester
// complex_materials_renderer_tpu/kernels/cluster_test.py make_cluster_tester
// (:119), which is inlined in the TPU megakernel; here it is inlined in
// csrc/megakernel.cu. Moller-Trumbore in the same operation order as the
// JAX tester (build with --fmad=false so no product is fused into an FMA),
// quad slots through the far-corner coefficients qa/qb with the scaled
// edge epsilon, and the payloads:
//   FullState  'full': closest hit with the shading payload
//   DistState  'dist': (t, slot)
//   OcclState  'occl': t only
//   NeeState<K> 'nee': the K nearest media boundaries as packed int32 keys
//                       [t-bits & ~63 | media row] plus the opaque t_opq
//   DneeState<K> 'dnee': dist along ray set A and nee along set B from one
//                       origin, sharing s, q and the t numerator
// The K keys live in registers: every loop over them is unrolled with
// compile-time indices (a dynamically indexed per-thread array would go
// to local memory). The 'nee' tester takes a per-lane accept flag (the
// JAX tester's ``mask``, cluster_test.py:161-168, :307-308): the binned
// round and the pair sweep test one cluster against lanes that may have
// met it before, and the K-list insert is not idempotent.
#pragma once

#include <cstdint>

namespace cmr {

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

__device__ __forceinline__ void update_full(FullState& st, const Slot& s, float uu, float vv,
                                            float tt, float slot) {
  if (inside(s, uu, vv) && tt > T_MIN && tt < st.t) {
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
}

__device__ __forceinline__ void update_dist(DistState& st, const Slot& s, float uu, float vv,
                                            float tt, float slot) {
  if (inside(s, uu, vv) && tt > T_MIN && tt < st.t) {
    st.t = tt;
    st.slot = slot;
  }
}

__device__ __forceinline__ void update_occl(OcclState& st, const Slot& s, float uu, float vv,
                                            float tt) {
  if (inside(s, uu, vv) && tt > T_MIN && tt < st.t) st.t = tt;
}

template <int K>
__device__ __forceinline__ void update_nee(NeeState<K>& st, const Slot& s, float uu, float vv,
                                           float tt, int midx, bool accept = true) {
  const bool med = midx >= 0;
  const bool valid_geom = inside(s, uu, vv) && tt > T_MIN && accept;
  if (valid_geom && !med && tt < st.t_opq) st.t_opq = tt;
  const bool valid = valid_geom && med && tt < st.t_opq;
  const int mat_i = midx > 0 ? midx : 0;
  int cand = valid ? ((__float_as_int(tt) & ~NEE_MAT_MASK) | mat_i) : KEY_EMPTY;
  // 2-op sorted insertion; a candidate beyond the K-th key falls off.
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int k = st.key[i];
    st.key[i] = min(cand, k);
    cand = max(cand, k);
  }
}

// One cluster c against one lane, slots in order.
__device__ __forceinline__ void test_cluster(const float* __restrict__ run_rows, int row_w,
                                            int subs, int run, int c, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            FullState& st) {
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    const int r_off = (c * subs + rr) * run;
    for (int j = 0; j < run; ++j) {
      const Slot s = load_slot(row, run, j);
      const Origin o = origin_terms(s, ox, oy, oz);
      float uu, vv, tt;
      direction_terms(s, o, dx, dy, dz, uu, vv, tt);
      update_full(st, s, uu, vv, tt, (float)(r_off + j));
    }
  }
}

__device__ __forceinline__ void test_cluster(const float* __restrict__ run_rows, int row_w,
                                            int subs, int run, int c, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            DistState& st) {
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    const int r_off = (c * subs + rr) * run;
    for (int j = 0; j < run; ++j) {
      const Slot s = load_slot(row, run, j);
      const Origin o = origin_terms(s, ox, oy, oz);
      float uu, vv, tt;
      direction_terms(s, o, dx, dy, dz, uu, vv, tt);
      update_dist(st, s, uu, vv, tt, (float)(r_off + j));
    }
  }
}

__device__ __forceinline__ void test_cluster(const float* __restrict__ run_rows, int row_w,
                                            int subs, int run, int c, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            OcclState& st) {
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    for (int j = 0; j < run; ++j) {
      const Slot s = load_slot(row, run, j);
      const Origin o = origin_terms(s, ox, oy, oz);
      float uu, vv, tt;
      direction_terms(s, o, dx, dy, dz, uu, vv, tt);
      update_occl(st, s, uu, vv, tt);
    }
  }
}

// 'nee' with the per-lane accept flag: a lane with accept == false changes
// nothing.
template <int K>
__device__ __forceinline__ void test_cluster(const float* __restrict__ run_rows, int row_w,
                                            int subs, int run, int c, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            const float* media, int M, bool accept,
                                            NeeState<K>& st) {
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    for (int j = 0; j < run; ++j) {
      const Slot s = load_slot(row, run, j);
      const Origin o = origin_terms(s, ox, oy, oz);
      float uu, vv, tt;
      direction_terms(s, o, dx, dy, dz, uu, vv, tt);
      update_nee<K>(st, s, uu, vv, tt, media_index(s.mat, media, M), accept);
    }
  }
}

template <int K>
__device__ __forceinline__ void test_cluster(const float* __restrict__ run_rows, int row_w,
                                            int subs, int run, int c, float ox, float oy,
                                            float oz, float dxa, float dya, float dza,
                                            float dxb, float dyb, float dzb,
                                            const float* media, int M, DneeState<K>& st) {
  for (int rr = 0; rr < subs; ++rr) {
    const float* row = run_rows + (long long)(c * subs + rr) * row_w;
    const int r_off = (c * subs + rr) * run;
    for (int j = 0; j < run; ++j) {
      const Slot s = load_slot(row, run, j);
      const Origin o = origin_terms(s, ox, oy, oz);
      float uu, vv, tt;
      direction_terms(s, o, dxa, dya, dza, uu, vv, tt);
      update_dist(st.a, s, uu, vv, tt, (float)(r_off + j));
      direction_terms(s, o, dxb, dyb, dzb, uu, vv, tt);
      update_nee<K>(st.b, s, uu, vv, tt, media_index(s.mat, media, M));
    }
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

}  // namespace cmr
