// Cluster-major pair sweep (K6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel complex_materials_renderer_tpu/kernels/
// pairsweep.py _make_sweep_kernel (:111), launched by trace_pairs
// (pallas_call :340). The host has expanded every listed (lane, cluster)
// pair, sorted the pairs cluster-major and gathered each pair's ray and
// seed (the lane's current best t, or its nearest opaque t for 'nee').
// For each block of 1024 pairs the serve loop (:146-161) takes the
// smallest cluster id c left in the block, runs the triangle tester K2
// (csrc/cluster_test.cuh) on c for every pair of the block ('nee' accepts
// hits only on the pairs of cluster c, so each pair's K-list insert
// happens once) and marks the pairs of c served (BIGC), until none is
// left. Padding pairs carry BIGC and are never served. Outputs the
// per-pair payload state: 'dist' (t, slot), 'occl' (t), 'nee' (K keys,
// t_opq).
//
// What bounds it on this card: operations. Each pair needs the slot tests
// (46 + 17 f32 operations per slot) of the clusters it is served; it reads
// 8 words and writes its state once.
//
// What this design does about it: the order in which a block serves its
// clusters, ascending distinct ids, depends only on the block's cluster
// ids, never on a pair's state. So each pair's output is a fold over the
// ascending distinct ids of its own block, and pairs are independent once
// that list is known: 'dist' and 'occl' test every id of the list in
// order, 'nee' only the pair's own id (its other servings accept nothing
// and change nothing). A tile of G threads serves one pair with the group
// walk of K2 (bit-equal to the one-thread walk), G from the count of valid
// pairs (kernels/cluster_test.py ``group_size``), in chunks of
// SWEEP_THREADS threads, none straddling a 1024-pair block, so every SM
// has work. The grid covers the blocks that hold the valid pairs when
// those come first (the cluster-major sort puts the padding last); the
// pairs beyond, padding in the engines' sweeps, take one thread each in a
// second, strided pass (a launch holds a pair for each of its L x lanes
// list slots, and most of them are empty: PERF.md). For
// 'dist' and 'occl' each CTA derives its block's distinct ids: a bitmap of
// the grid's cluster ids in shared memory, set from the block's 1024 ids
// and compacted in ascending order by a CTA-wide scan, so the kernel does
// not rely on the pairs' order. An id at or beyond the grid's cluster
// count names no slots and is served with no test. The TPU kernel's
// chunk_blocks (blocks per grid step) only sizes its pipelined tiles; it
// does not change the launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -DCMR_NEE_MAX_MEDIA=n (K = 2n + 2).

#include <cuda_runtime.h>

#include "binned_common.cuh"

#ifndef CMR_NEE_MAX_MEDIA
#error "build with -DCMR_NEE_MAX_MEDIA=<--nee-bound>"
#endif

namespace cmr {

constexpr int K_NEE = 2 * CMR_NEE_MAX_MEDIA + 2;
constexpr int SWEEP_THREADS = 256;                 // threads of one CTA: SWEEP_THREADS / G pairs
constexpr int ID_WORDS = (1 << ID_BITS) / 32;      // the bitmap of every cluster id
constexpr int WORDS_PER_THREAD = ID_WORDS / SWEEP_THREADS;

struct SweepParams {
  Grid g;
  const float* __restrict__ rays;  // (7, n): ox, oy, oz, dx, dy, dz, seed
  const int* __restrict__ cid;     // (n,) cluster id; BIGC = padding
  int* state;                      // (ns, n)
  int n, cover, C;                 // cover: the pairs served a tile each
};

// The distinct cluster ids below C of one block's 1024 pairs, ascending,
// into ``ids``; returns their count. Called by every thread of the CTA.
__device__ int block_ids(const int* __restrict__ cid, int C, unsigned* bits, int* ids,
                         int* wsum) {
  const int tid = threadIdx.x;
  const int words = (C + 31) >> 5;
  for (int w = tid; w < words; w += SWEEP_THREADS) bits[w] = 0u;
  __syncthreads();
  for (int i = tid; i < SERVE_BLOCK; i += SWEEP_THREADS) {
    const int c = __ldg(cid + i);
    if (c >= 0 && c < C) atomicOr(bits + (c >> 5), 1u << (c & 31));
  }
  __syncthreads();
  // Thread t compacts words [t * WORDS_PER_THREAD, ...): an exclusive scan
  // of the counts gives each its first place in the list.
  unsigned w[WORDS_PER_THREAD];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < WORDS_PER_THREAD; ++j) {
    const int idx = tid * WORDS_PER_THREAD + j;
    w[j] = idx < words ? bits[idx] : 0u;
    cnt += __popc(w[j]);
  }
  const int ln = tid & 31, warp = tid >> 5;
  int incl = cnt;
#pragma unroll
  for (int dl = 1; dl < 32; dl <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, dl);
    if (ln >= dl) incl += y;
  }
  if (ln == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = ln < SWEEP_THREADS / 32 ? wsum[ln] : 0;
#pragma unroll
    for (int dl = 1; dl < 32; dl <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, dl);
      if (ln >= dl) v += y;
    }
    if (ln < SWEEP_THREADS / 32) wsum[ln] = v;
  }
  __syncthreads();
  int at = (warp > 0 ? wsum[warp - 1] : 0) + incl - cnt;
#pragma unroll
  for (int j = 0; j < WORDS_PER_THREAD; ++j) {
    unsigned m = w[j];
    while (m) {
      ids[at++] = (tid * WORDS_PER_THREAD + j) * 32 + __ffs(m) - 1;
      m &= m - 1;
    }
  }
  const int total = wsum[SWEEP_THREADS / 32 - 1];
  __syncthreads();
  return total;
}

// One chunk of SWEEP_THREADS / G pairs from pair ``base`` (within one
// 1024-pair block), a tile of G threads each. Called by every thread of
// the CTA.
template <class State, int G>
__device__ __forceinline__ void serve_chunk(const cg::thread_block_tile<G>& tile,
                                            const SweepParams& p, int base, unsigned* bits,
                                            int* ids, int* wsum) {
  constexpr bool OWN_ONLY = !(std::is_same<State, DistState>::value ||
                              std::is_same<State, OcclState>::value);
  const int n = p.n;
  const int pair = base + threadIdx.x / G;
  const Ray r{__ldg(p.rays + pair),         __ldg(p.rays + n + pair),
              __ldg(p.rays + 2 * n + pair), __ldg(p.rays + 3 * n + pair),
              __ldg(p.rays + 4 * n + pair), __ldg(p.rays + 5 * n + pair)};
  State st;
  seed(st, __ldg(p.rays + 6 * n + pair));
  if constexpr (OWN_ONLY) {
    const int c = __ldg(p.cid + pair);
    if (c >= 0 && c < p.C) group_serve<G>(tile, st, p.g, c, r, true);
  } else {
    const int block = base / SERVE_BLOCK;
    const int D = block_ids(p.cid + (long long)block * SERVE_BLOCK, p.C, bits, ids, wsum);
    for (int i = 0; i < D; ++i) group_serve<G>(tile, st, p.g, ids[i], r, true);
    __syncthreads();  // the next chunk rebuilds ids
  }
  group_store<G>(tile, st, p.state, n, pair);
}

// The grid holds one chunk of G threads per pair for each of the first
// ``cover`` pairs; the pairs beyond (the padding, when the valid pairs come
// first, as the cluster-major sort puts them) take one thread each,
// strided over the grid. Any order gives the same outputs: the one-thread
// walk equals the tile's.
template <class State, int G>
__global__ void __launch_bounds__(SWEEP_THREADS) pair_sweep(SweepParams p) {
  constexpr bool OWN_ONLY = !(std::is_same<State, DistState>::value ||
                              std::is_same<State, OcclState>::value);
  __shared__ unsigned bits[OWN_ONLY ? 1 : ID_WORDS];
  __shared__ int ids[OWN_ONLY ? 1 : SERVE_BLOCK];
  __shared__ int wsum[SWEEP_THREADS / 32];
  const cg::thread_block cta = cg::this_thread_block();
  serve_chunk<State, G>(cg::tiled_partition<G>(cta), p, blockIdx.x * (SWEEP_THREADS / G), bits,
                        ids, wsum);
  const cg::thread_block_tile<1> solo = cg::tiled_partition<1>(cta);
  for (int base = p.cover + blockIdx.x * SWEEP_THREADS; base < p.n;
       base += gridDim.x * SWEEP_THREADS)
    serve_chunk<State, 1>(solo, p, base, bits, ids, wsum);
}

template <class State, int G>
cudaError_t launch(const SweepParams& p, cudaStream_t stream) {
  pair_sweep<State, G><<<p.cover / (SWEEP_THREADS / G), SWEEP_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <class State>
cudaError_t launch_group(const SweepParams& p, int group, cudaStream_t stream) {
  switch (group) {
    case 1: return launch<State, 1>(p, stream);
    case 2: return launch<State, 2>(p, stream);
    case 4: return launch<State, 4>(p, stream);
    case 8: return launch<State, 8>(p, stream);
    case 16: return launch<State, 16>(p, stream);
    case 32: return launch<State, 32>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cmr

extern "C" {

int cmr_k_nee() { return cmr::K_NEE; }

// n and cover must be multiples of 1024, 1024 <= cover <= n; payload is
// 'dist', 'occl' or 'nee'; ``group`` (1, 2, 4, 8, 16 or 32) threads per
// pair. Launch on ``stream``; returns cudaGetLastError() right after the
// launch (cudaErrorInvalidValue for another payload or group).
int cmr_pair_sweep_launch(const float* media, int M, const float* run_rows, const float* rays,
                          const int* cid, int* state, int n, int cover, int C, int subs, int run,
                          int row_w, int payload, int group, void* stream) {
  using namespace cmr;
  const SweepParams p{Grid{run_rows, media, M, subs, run, row_w}, rays, cid, state, n, cover, C};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (payload) {
    case P_DIST: return (int)launch_group<DistState>(p, group, s);
    case P_OCCL: return (int)launch_group<OcclState>(p, group, s);
    case P_NEE: return (int)launch_group<NeeState<K_NEE>>(p, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
