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
// iters[b] counts the block's serving iterations.
//
// What bounds it on this card: operations. Each serving runs a whole
// cluster's slot tests (46 + 17 f32 operations per slot) on all 1024
// lanes ('full', 'dist', 'occl': a lane that does not hold c may still
// find a closer hit there, so the TPU kernel tests it and so does this
// one), of which only the lanes holding c need them; the keys, state and
// rays are read once and written once. The servings of a block are
// serial: each c is the block minimum after the previous serving's clear.
//
// What this design does about it: one TPU block is served by a thread
// block cluster of S CTAs of SERVE_THREADS threads on neighbouring SMs,
// with a tile of G threads per lane (S x SERVE_THREADS = 1024 x G), so
// that the few live blocks of a round still spread over the card. Each
// tile walks the served cluster with the group walk of K2, bit-equal to
// the one-thread walk. The block-wide steps are cluster-wide: every lane
// clears its own list, then ONE minimum per serving over the 1024 lanes
// gives both the loop condition and c (a lane whose head was empty
// before the clear offers BIGC + 1, so a minimum above BIGC means no lane
// listed anything): a warp minimum, one pass through shared memory for the
// CTA's partial, then the S partials read from the CTAs' shared memory
// through distributed shared memory after one cluster barrier; the
// partials alternate between two slots, so one barrier per serving
// suffices. 'nee' lanes that do not hold c skip the walk (their test
// would change nothing). The grid holds the live blocks only; S and G come
// from the live width (kernels/binned_trace.py ``round_split``). In a CUDA
// graph the live block count is on the card (``live``, the pass control
// block of kernels/pass_control.py, as K1 reads it): each rung of the
// (G, S) ladder is an IF node whose instance's grid covers the most live
// blocks of its rung, and a cluster at or beyond the live count returns at
// once. S = 16 is
// beyond the portable cluster size of 8 and is launched with
// cudaFuncAttributeNonPortableClusterSizeAllowed. A 512-thread CTA leaves
// up to 128 registers a thread for the L keys and the payload state.
//
// What still holds it from its bound (PERF.md): a block's servings stay
// serial and every lane of it tests each served cluster ('full', 'dist',
// 'occl'); the 'full' instances hold 80-84 registers, one CTA an SM, so
// a 64-block round runs in waves of the clusters the card can place.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -DCMR_LIST_LEN=L
// -DCMR_NEE_MAX_MEDIA=n (K = 2n + 2).

#include <cuda_runtime.h>

#include <climits>

#include "binned_common.cuh"

#ifndef CMR_LIST_LEN
#error "build with -DCMR_LIST_LEN=<list length>"
#endif
#ifndef CMR_NEE_MAX_MEDIA
#error "build with -DCMR_NEE_MAX_MEDIA=<--nee-bound>"
#endif

namespace cmr {

constexpr int K_NEE = 2 * CMR_NEE_MAX_MEDIA + 2;
constexpr int SERVE_THREADS = 512;  // threads of one CTA: SERVE_THREADS / G lanes

struct RoundParams {
  Grid g;
  const float* __restrict__ rays;  // (6, n)
  int* keys;                       // (L, n), updated in place
  int* state;                      // (ns, n), updated in place
  int* iters;                      // (n / 1024,)
  int n, C, cap_iters;
  const int* live;  // the live block count on the card, or null: every block of the grid
};

// Minimum of v over the cluster's threads, returned to every thread.
// ``red`` holds a warp minimum per warp, ``part`` the CTA's partial in the
// slot of this serving's parity.
__device__ __forceinline__ int cluster_min(const cg::cluster_group& cluster, int v, int* red,
                                           int* part) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  if (ln == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int m = ln < SERVE_THREADS / 32 ? red[ln] : INT_MAX;
    m = __reduce_min_sync(0xffffffffu, m);
    if (ln == 0) *part = m;
  }
  cluster.sync();
  const int m = ln < (int)cluster.num_blocks() ? *cluster.map_shared_rank(part, ln) : INT_MAX;
  return __reduce_min_sync(0xffffffffu, m);
}

template <int L, class State, int G>
__global__ void __launch_bounds__(SERVE_THREADS) binned_round(RoundParams p) {
  __shared__ int red[SERVE_THREADS / 32];
  __shared__ int part[2];
  const cg::cluster_group cluster = cg::this_cluster();
  const cg::thread_block_tile<G> tile = cg::tiled_partition<G>(cg::this_thread_block());
  const int S = (int)cluster.num_blocks();
  const int b = blockIdx.x / S;
  if (p.live != nullptr && b >= __ldg(p.live)) return;  // the whole cluster: no barrier waits
  const int n = p.n;
  const int lane = b * SERVE_BLOCK + (blockIdx.x % S) * (SERVE_THREADS / G) + threadIdx.x / G;
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
    const bool listed = keys[0] != KEY_EMPTY;
    if (listed && __int_as_float(keys[0] & ~ID_MASK) >= bound_of(st)) {
#pragma unroll
      for (int i = 0; i < L; ++i) keys[i] = KEY_EMPTY;
    }
    const int head = keys[0] != KEY_EMPTY ? (keys[0] & ID_MASK) : BIGC;
    const int c = cluster_min(cluster, listed ? head : BIGC + 1, red, part + (it & 1));
    if (c > BIGC) break;  // no lane of the block listed a cluster
    bool match[L];
    bool has_c = false;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      match[i] = keys[i] != KEY_EMPTY && (keys[i] & ID_MASK) == c;
      has_c = has_c || match[i];
    }
    if (c < BIGC) group_serve<G>(tile, st, p.g, min(c, p.C - 1), r, has_c);
    bool shift = false;
#pragma unroll
    for (int i = 0; i < L - 1; ++i) {
      shift = shift || match[i];
      if (shift) keys[i] = keys[i + 1];
    }
    if (shift || match[L - 1]) keys[L - 1] = KEY_EMPTY;
    ++it;
  }
  if (tile.thread_rank() == 0) {
#pragma unroll
    for (int i = 0; i < L; ++i) p.keys[(long long)i * n + lane] = keys[i];
  }
  group_store<G>(tile, st, p.state, n, lane);
  if (blockIdx.x % S == 0 && threadIdx.x == 0) p.iters[b] = it;
  cluster.sync();  // no CTA leaves while another may still read its partials
}

template <int G, class State>
cudaError_t launch(const RoundParams& p, int lb, cudaStream_t stream, int* max_clusters) {
  constexpr int L = CMR_LIST_LEN;
  const auto kernel = binned_round<L, State, G>;
  const int S = SERVE_BLOCK * G / SERVE_THREADS;
  if (S > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lb * S);
  cfg.blockDim = dim3(SERVE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class State>
cudaError_t launch_group(const RoundParams& p, int lb, int group, cudaStream_t stream,
                         int* max_clusters) {
  switch (group) {
    case 1: return launch<1, State>(p, lb, stream, max_clusters);
    case 2: return launch<2, State>(p, lb, stream, max_clusters);
    case 4: return launch<4, State>(p, lb, stream, max_clusters);
    case 8: return launch<8, State>(p, lb, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const RoundParams& p, int lb, int payload, int group, cudaStream_t stream,
                     int* max_clusters) {
  switch (payload) {
    case P_FULL: return launch_group<GroupFull>(p, lb, group, stream, max_clusters);
    case P_DIST: return launch_group<DistState>(p, lb, group, stream, max_clusters);
    case P_OCCL: return launch_group<OcclState>(p, lb, group, stream, max_clusters);
    case P_NEE: return launch_group<NeeState<K_NEE>>(p, lb, group, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cmr

extern "C" {

int cmr_list_len() { return CMR_LIST_LEN; }
int cmr_k_nee() { return cmr::K_NEE; }

// Serves the first lb blocks of 1024 lanes (n a multiple of 1024, lb >= 1)
// with thread block clusters of 1024 x group / 512 CTAs, ``group`` (1, 2,
// 4 or 8) threads per lane; with ``live`` (an int on the card) the grid
// holds lb blocks and serves the first *live of them. Launch on
// ``stream``; returns the launch's error, or cudaGetLastError() right after
// it (cudaErrorInvalidValue for an unknown payload or group). A cluster
// the card cannot place is an error; nothing falls back to a smaller one.
int cmr_binned_round_launch(const float* media, int M, const float* run_rows, const float* rays,
                            int* keys, int* state, int* iters, int n, int lb, int C, int subs,
                            int run, int row_w, int payload, int cap_iters, int group,
                            const int* live, void* stream) {
  using namespace cmr;
  const RoundParams p{Grid{run_rows, media, M, subs, run, row_w}, rays, keys, state, iters,
                      n, C, cap_iters, live};
  return (int)dispatch(p, lb, payload, group, (cudaStream_t)stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance for (payload, group) into
// *out; returns its error.
int cmr_binned_round_max_clusters(int payload, int group, int* out) {
  using namespace cmr;
  const RoundParams p{};
  return (int)dispatch(p, 1, payload, group, 0, out);
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
