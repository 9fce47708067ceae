// Binned round (K5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel complex_materials_renderer_tpu/kernels/
// binned_trace.py _make_round_kernel (:199), launched by trace_binned
// (pallas_call :473) once per round after the host has regrouped the lanes
// by their head cluster id. For each block of 1024 lanes below the live
// block count lb, up to cap_iters times while some lane of the block still
// lists a cluster (:236-238):
//   1. clear the list of a lane whose head entry can no longer beat the
//      lane's payload bound (lists are entry-ascending, so the whole list
//      goes, :241-258);
//   2. take c = the smallest head cluster id of the block (:259-262);
//   3. run the triangle tester K2 (csrc/cluster_test.cuh) on c for every
//      lane of the block; 'nee' accepts hits only on the lanes whose list
//      holds c, whose slot this serving removes (:263-288);
//   4. remove c from every list that holds it, shifting the rest up
//      (:289-300).
// Blocks at or beyond lb pass through; iters[b] counts the block's
// serving iterations (0 for a passed block).
//
// What bounds it on this card: operations. Each serving runs a whole
// cluster's slot tests (46 + 17 f32 operations per slot) on all 1024
// lanes, of which only the lanes holding c need them; the keys, state
// and rays are read once and written once.
//
// What this design does about it: one CUDA block of 1024 threads per TPU
// block, one thread per lane, so the block-shared choice of c is the TPU
// kernel's. The loop condition is a __syncthreads_or and c a warp
// __reduce_min_sync plus one pass through shared memory. All threads
// serve the same cluster, so its slots are broadcast loads. Keys (L, a
// template parameter) and state stay in registers; 1024 threads leave 64
// registers a thread, so larger L or K spill to local memory (the build
// prints ptxas's count).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -DCMR_LIST_LEN=L
// -DCMR_NEE_MAX_MEDIA=n (K = 2n + 2).

#include <cuda_runtime.h>

#include "binned_common.cuh"

#ifndef CMR_LIST_LEN
#error "build with -DCMR_LIST_LEN=<list length>"
#endif
#ifndef CMR_NEE_MAX_MEDIA
#error "build with -DCMR_NEE_MAX_MEDIA=<--nee-bound>"
#endif

namespace cmr {

constexpr int K_NEE = 2 * CMR_NEE_MAX_MEDIA + 2;

struct RoundParams {
  Grid g;
  const int* __restrict__ lb;      // (1,) live blocks
  const float* __restrict__ rays;  // (6, n)
  int* keys;                       // (L, n), updated in place
  int* state;                      // (ns, n), updated in place
  int* iters;                      // (n / 1024,)
  int n, C, cap_iters;
};

template <int L, class State>
__global__ void __launch_bounds__(SERVE_BLOCK, 1) binned_round(RoundParams p) {
  __shared__ int red[32];
  const int b = blockIdx.x;
  if (b >= __ldg(p.lb)) {
    if (threadIdx.x == 0) p.iters[b] = 0;
    return;
  }
  const int n = p.n;
  const int lane = b * SERVE_BLOCK + threadIdx.x;
  int keys[L];
#pragma unroll
  for (int i = 0; i < L; ++i) keys[i] = p.keys[(long long)i * n + lane];
  State st;
  load(st, p.state, n, lane);
  const Ray r{__ldg(p.rays + lane),         __ldg(p.rays + n + lane),
              __ldg(p.rays + 2 * n + lane), __ldg(p.rays + 3 * n + lane),
              __ldg(p.rays + 4 * n + lane), __ldg(p.rays + 5 * n + lane)};
  int it = 0;
  while (it < p.cap_iters) {
    if (!__syncthreads_or(keys[0] != KEY_EMPTY)) break;
    const int head = keys[0];
    if (head != KEY_EMPTY && __int_as_float(head & ~ID_MASK) >= bound_of(st)) {
#pragma unroll
      for (int i = 0; i < L; ++i) keys[i] = KEY_EMPTY;
    }
    const int c = block_min(keys[0] != KEY_EMPTY ? (keys[0] & ID_MASK) : BIGC, red);
    bool match[L];
    bool has_c = false;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      match[i] = keys[i] != KEY_EMPTY && (keys[i] & ID_MASK) == c;
      has_c = has_c || match[i];
    }
    if (c < BIGC) serve(st, p.g, min(c, p.C - 1), r, has_c);
    bool shift = false;
#pragma unroll
    for (int i = 0; i < L - 1; ++i) {
      shift = shift || match[i];
      if (shift) keys[i] = keys[i + 1];
    }
    if (shift || match[L - 1]) keys[L - 1] = KEY_EMPTY;
    ++it;
  }
#pragma unroll
  for (int i = 0; i < L; ++i) p.keys[(long long)i * n + lane] = keys[i];
  store(st, p.state, n, lane);
  if (threadIdx.x == 0) p.iters[b] = it;
}

}  // namespace cmr

extern "C" {

int cmr_list_len() { return CMR_LIST_LEN; }
int cmr_k_nee() { return cmr::K_NEE; }

// n must be a multiple of 1024. Launch on ``stream``; returns
// cudaGetLastError() right after the launch (cudaErrorInvalidValue for an
// unknown payload).
int cmr_binned_round_launch(const float* media, int M, const int* lb, const float* run_rows,
                            const float* rays, int* keys, int* state, int* iters, int n, int C,
                            int subs, int run, int row_w, int payload, int cap_iters,
                            void* stream) {
  using namespace cmr;
  RoundParams p{Grid{run_rows, media, M, subs, run, row_w}, lb, rays, keys, state, iters,
                n, C, cap_iters};
  const int blocks = n / SERVE_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int L = CMR_LIST_LEN;
  switch (payload) {
    case P_FULL: binned_round<L, FullState><<<blocks, SERVE_BLOCK, 0, s>>>(p); break;
    case P_DIST: binned_round<L, DistState><<<blocks, SERVE_BLOCK, 0, s>>>(p); break;
    case P_OCCL: binned_round<L, OcclState><<<blocks, SERVE_BLOCK, 0, s>>>(p); break;
    case P_NEE: binned_round<L, NeeState<K_NEE>><<<blocks, SERVE_BLOCK, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
