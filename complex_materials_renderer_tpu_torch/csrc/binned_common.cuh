// Pieces shared by the binned listing (K4), the binned round (K5) and the
// pair sweep (K6): the packed-key constants of
// complex_materials_renderer_tpu/kernels/binned_trace.py (:65-71) and
// pairsweep.py (:78-80) and, for each payload of the two serve loops, how
// its state is loaded, bounded, served by a tile of G threads (the group
// walk of cluster_test.cuh) and stored. Every thread of a tile holds the
// same state; the tile's thread 0 stores it.
//
// Payload state in memory: (ns, n) int32, one row per field, float fields
// as their bit patterns (the 'nee' keys are int32 already), so one buffer
// type carries every payload through the wrappers and the host sorts.
#pragma once

#include <type_traits>

#include "cluster_test.cuh"

namespace cmr {

constexpr int ID_BITS = 14;  // cluster id field of a listing key
constexpr int ID_MASK = (1 << ID_BITS) - 1;
constexpr int BIGC = 1 << 20;  // served / padding cluster sentinel
constexpr int SERVE_BLOCK = 1024;  // lanes (K5) or pairs (K6) of one TPU block

enum Payload { P_FULL = 0, P_DIST = 1, P_OCCL = 2, P_NEE = 3 };

// 1/d with |d| kept at or above 1e-12 (binned_trace.py:119-128).
__device__ __forceinline__ float slab_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v < 0.0f ? -tiny : tiny) : v);
}

// What a serve loop needs of the grid.
struct Grid {
  const float* __restrict__ run_rows;
  const float* media;
  int M, subs, run, row_w;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float bits_f(const int* st, int i, int n, int lane) {
  return __int_as_float(st[(long long)i * n + lane]);
}

__device__ __forceinline__ void put_f(int* st, int i, int n, int lane, float v) {
  st[(long long)i * n + lane] = __float_as_int(v);
}

// ---- 'full': (t, slot, u, v, nx, ny, nz, mat, px, py, pz) ----
__device__ __forceinline__ void load(FullState& s, const int* st, int n, int lane) {
  s.t = bits_f(st, 0, n, lane);
  s.slot = bits_f(st, 1, n, lane);
  s.u = bits_f(st, 2, n, lane);
  s.v = bits_f(st, 3, n, lane);
  s.nx = bits_f(st, 4, n, lane);
  s.ny = bits_f(st, 5, n, lane);
  s.nz = bits_f(st, 6, n, lane);
  s.mat = bits_f(st, 7, n, lane);
  s.px = bits_f(st, 8, n, lane);
  s.py = bits_f(st, 9, n, lane);
  s.pz = bits_f(st, 10, n, lane);
}

__device__ __forceinline__ void store(const FullState& s, int* st, int n, int lane) {
  put_f(st, 0, n, lane, s.t);
  put_f(st, 1, n, lane, s.slot);
  put_f(st, 2, n, lane, s.u);
  put_f(st, 3, n, lane, s.v);
  put_f(st, 4, n, lane, s.nx);
  put_f(st, 5, n, lane, s.ny);
  put_f(st, 6, n, lane, s.nz);
  put_f(st, 7, n, lane, s.mat);
  put_f(st, 8, n, lane, s.px);
  put_f(st, 9, n, lane, s.py);
  put_f(st, 10, n, lane, s.pz);
}

// The round's 'full' state on each thread of a tile: the tile's closest
// (t, slot) and the thread's own closest hit with its payload (the loaded
// state until the thread finds a closer hit); ``group_store`` takes the
// payload of the tile's hit from the thread that found it.
struct GroupFull {
  FullState mine;
  float t, slot;
};

__device__ __forceinline__ void load(GroupFull& s, const int* st, int n, int lane) {
  load(s.mine, st, n, lane);
  s.t = s.mine.t;
  s.slot = s.mine.slot;
}

__device__ __forceinline__ float bound_of(const GroupFull& s) { return s.t; }

template <int G>
__device__ __forceinline__ void group_serve(const cg::thread_block_tile<G>& tile, GroupFull& s,
                                            const Grid& g, int c, const Ray& r, bool) {
  group_cluster_full<G, false>(tile, g.run_rows, g.row_w, g.subs, g.run, c, r.ox, r.oy, r.oz,
                               r.dx, r.dy, r.dz, s.t, s.slot, s.mine);
}

// ---- 'dist': (t, slot) ----
__device__ __forceinline__ void load(DistState& s, const int* st, int n, int lane) {
  s.t = bits_f(st, 0, n, lane);
  s.slot = bits_f(st, 1, n, lane);
}

__device__ __forceinline__ void store(const DistState& s, int* st, int n, int lane) {
  put_f(st, 0, n, lane, s.t);
  put_f(st, 1, n, lane, s.slot);
}

__device__ __forceinline__ float bound_of(const DistState& s) { return s.t; }

__device__ __forceinline__ void seed(DistState& s, float t) {
  s.t = t;
  s.slot = -1.0f;
}

template <int G>
__device__ __forceinline__ void group_serve(const cg::thread_block_tile<G>& tile, DistState& s,
                                            const Grid& g, int c, const Ray& r, bool) {
  NoPayload none;
  group_cluster_full<G, false>(tile, g.run_rows, g.row_w, g.subs, g.run, c, r.ox, r.oy, r.oz,
                               r.dx, r.dy, r.dz, s.t, s.slot, none);
}

// ---- 'occl': (t,) ----
__device__ __forceinline__ void load(OcclState& s, const int* st, int n, int lane) {
  s.t = bits_f(st, 0, n, lane);
}

__device__ __forceinline__ void store(const OcclState& s, int* st, int n, int lane) {
  put_f(st, 0, n, lane, s.t);
}

__device__ __forceinline__ float bound_of(const OcclState& s) { return s.t; }

__device__ __forceinline__ void seed(OcclState& s, float t) { s.t = t; }

// The closest hit's t is the occluder's, whatever slot the tile reduces to.
template <int G>
__device__ __forceinline__ void group_serve(const cg::thread_block_tile<G>& tile, OcclState& s,
                                            const Grid& g, int c, const Ray& r, bool) {
  NoPayload none;
  float slot = -1.0f;
  group_cluster_full<G, false>(tile, g.run_rows, g.row_w, g.subs, g.run, c, r.ox, r.oy, r.oz,
                               r.dx, r.dy, r.dz, s.t, slot, none);
}

// ---- 'nee': K packed keys + t_opq; only the accepting lanes are served ----
template <int K>
__device__ __forceinline__ void load(NeeState<K>& s, const int* st, int n, int lane) {
#pragma unroll
  for (int i = 0; i < K; ++i) s.key[i] = st[(long long)i * n + lane];
  s.t_opq = bits_f(st, K, n, lane);
}

template <int K>
__device__ __forceinline__ void store(const NeeState<K>& s, int* st, int n, int lane) {
#pragma unroll
  for (int i = 0; i < K; ++i) st[(long long)i * n + lane] = s.key[i];
  put_f(st, K, n, lane, s.t_opq);
}

template <int K>
__device__ __forceinline__ float bound_of(const NeeState<K>& s) {
  return nee_bound<K>(s);
}

template <int K>
__device__ __forceinline__ void seed(NeeState<K>& s, float t) {
#pragma unroll
  for (int i = 0; i < K; ++i) s.key[i] = KEY_EMPTY;
  s.t_opq = t;
}

template <int G, int K>
__device__ __forceinline__ void group_serve(const cg::thread_block_tile<G>& tile, NeeState<K>& s,
                                            const Grid& g, int c, const Ray& r, bool accept) {
  if (accept)
    group_cluster_nee<G, K>(tile, g.run_rows, g.row_w, g.subs, g.run, c, r.ox, r.oy, r.oz, r.dx,
                            r.dy, r.dz, g.media, g.M, s);
}

// Thread 0 of the tile stores the state; 'full' takes the payload of the
// tile's hit from the thread that found it.
template <int G, class State>
__device__ __forceinline__ void group_store(const cg::thread_block_tile<G>& tile,
                                            const State& s, int* st, int n, int lane) {
  if constexpr (std::is_same<State, GroupFull>::value) {
    const FullState f = group_payload<G>(tile, s.mine, s.t, s.slot);
    if (tile.thread_rank() == 0) store(f, st, n, lane);
  } else if (tile.thread_rank() == 0) {
    store(s, st, n, lane);
  }
}

}  // namespace cmr
