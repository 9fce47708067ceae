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
// left. Padding pairs carry BIGC and are never served; an all-padding
// block costs one reduction. Outputs the per-pair payload state: 'dist'
// (t, slot), 'occl' (t), 'nee' (K keys, t_opq).
//
// What bounds it on this card: operations. A serving runs a cluster's
// slot tests (46 + 17 f32 operations per slot) on all 1024 pairs of the
// block; pairs come cluster-major, so a block holds few distinct
// clusters. Each pair reads 8 words and writes its state once.
//
// What this design does about it: one CUDA block of 1024 threads per
// TPU block, one thread per pair, the block's minimum by a warp
// __reduce_min_sync and one pass through shared memory. The TPU kernel's
// chunk_blocks (blocks per grid step) only sizes its pipelined tiles; here
// every block is a CUDA block, so it does not change the launch.
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

struct SweepParams {
  Grid g;
  const float* __restrict__ rays;  // (7, n): ox, oy, oz, dx, dy, dz, seed
  const int* __restrict__ cid;     // (n,) cluster id; BIGC = padding
  int* state;                      // (ns, n)
  int n;
};

template <class State>
__global__ void __launch_bounds__(SERVE_BLOCK, 1) pair_sweep(SweepParams p) {
  __shared__ int red[32];
  const int n = p.n;
  const int pair = blockIdx.x * SERVE_BLOCK + threadIdx.x;
  const Ray r{__ldg(p.rays + pair),         __ldg(p.rays + n + pair),
              __ldg(p.rays + 2 * n + pair), __ldg(p.rays + 3 * n + pair),
              __ldg(p.rays + 4 * n + pair), __ldg(p.rays + 5 * n + pair)};
  State st;
  seed(st, __ldg(p.rays + 6 * n + pair));
  int cid = __ldg(p.cid + pair);
  for (;;) {
    const int c = block_min(cid, red);
    if (c >= BIGC) break;
    const bool mine = cid == c;
    serve(st, p.g, c, r, mine);
    if (mine) cid = BIGC;
  }
  store(st, p.state, n, pair);
}

}  // namespace cmr

extern "C" {

int cmr_k_nee() { return cmr::K_NEE; }

// n must be a multiple of 1024; payload is 'dist', 'occl' or 'nee'.
// Launch on ``stream``; returns cudaGetLastError() right after the launch
// (cudaErrorInvalidValue for another payload).
int cmr_pair_sweep_launch(const float* media, int M, const float* run_rows, const float* rays,
                          const int* cid, int* state, int n, int subs, int run, int row_w,
                          int payload, void* stream) {
  using namespace cmr;
  SweepParams p{Grid{run_rows, media, M, subs, run, row_w}, rays, cid, state, n};
  const int blocks = n / SERVE_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (payload) {
    case P_DIST: pair_sweep<DistState><<<blocks, SERVE_BLOCK, 0, s>>>(p); break;
    case P_OCCL: pair_sweep<OcclState><<<blocks, SERVE_BLOCK, 0, s>>>(p); break;
    case P_NEE: pair_sweep<NeeState<K_NEE>><<<blocks, SERVE_BLOCK, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
