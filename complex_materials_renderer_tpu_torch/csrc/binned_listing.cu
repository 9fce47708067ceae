// Per-lane candidate-cluster listing (K4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel complex_materials_renderer_tpu/kernels/
// binned_trace.py _make_listing_kernel (:88), launched by trace_binned
// (pallas_call :453) and by pairsweep.py trace_pairs (pallas_call :281).
// For each lane whose strict lower key t_lo is not EMPTY, it keeps the L
// smallest packed keys [entry-t f32 bits & ~ID_MASK | cluster id] above
// t_lo, over the clusters whose AABB the ray meets within [T_MIN, bound],
// sorted ascending, and writes tlim = the L-th key (EMPTY where fewer than
// L were found). The bits of a positive float order like its value, so
// the integer min/max chain sorts by entry and breaks ties by cluster id
// (:157-163): keys are unique, so a relist from t_lo = tlim neither
// repeats a cluster nor skips a dropped tie.
//
// What bounds it on this card: operations. A lane reads 9 words and writes
// L + 1; per lane it runs one slab test per super and per cluster of a
// super it meets (25 f32 operations each) and an L-step integer chain per
// cluster met; the boxes (32 bytes each) stay in L1 and L2.
//
// What this design does about it: one thread per lane, the keys in
// registers (L is a template parameter; the chain is unrolled). The TPU
// kernel gates a super for a whole 1024-lane block (any lane meets it)
// and skips a block whose lanes are all resolved; here both gates are per
// lane. A cluster box lies inside its super box and the slab arithmetic
// is monotone in the box, so a lane that misses a super misses each of
// its clusters, and a resolved lane (t_lo = EMPTY) lists nothing either
// way: the keys equal the TPU kernel's on every lane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -DCMR_LIST_LEN=L.

#include <cuda_runtime.h>

#include "binned_common.cuh"

#ifndef CMR_LIST_LEN
#error "build with -DCMR_LIST_LEN=<list length>"
#endif

namespace cmr {

constexpr int LIST_THREADS = 128;

struct ListingParams {
  const float* __restrict__ bounds;        // (C, 8)
  const float* __restrict__ super_bounds;  // (S, 8)
  const float* __restrict__ rays;          // (6, n): ox, oy, oz, dx, dy, dz
  const float* __restrict__ bound;         // (n,) walk bound
  const int* __restrict__ tlo;             // (n,) strict lower key; EMPTY = resolved
  int* keys;                               // (L, n)
  int* tlim;                               // (n,)
  int n, C, S, SF;
};

template <int L>
__global__ void __launch_bounds__(LIST_THREADS) binned_listing(ListingParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n) return;
  const int n = p.n;
  int slots[L];
#pragma unroll
  for (int i = 0; i < L; ++i) slots[i] = KEY_EMPTY;
  const int tlo = __ldg(p.tlo + lane);
  if (tlo != KEY_EMPTY) {
    const float ox = __ldg(p.rays + lane), oy = __ldg(p.rays + n + lane),
                oz = __ldg(p.rays + 2 * n + lane);
    const float ix = slab_inv(__ldg(p.rays + 3 * n + lane));
    const float iy = slab_inv(__ldg(p.rays + 4 * n + lane));
    const float iz = slab_inv(__ldg(p.rays + 5 * n + lane));
    const float bnd = __ldg(p.bound + lane);
    for (int sp = 0; sp < p.S; ++sp) {
      if (!slab_hit(p.super_bounds + sp * 8, ox, oy, oz, ix, iy, iz, bnd)) continue;
      const int lo = sp * p.SF;
      const int hi = min(lo + p.SF, p.C);
      for (int c = lo; c < hi; ++c) {
        float tn;
        if (!slab_entry(p.bounds + c * 8, ox, oy, oz, ix, iy, iz, bnd, tn)) continue;
        int key = (__float_as_int(tn) & ~ID_MASK) | c;
        if (key <= tlo) continue;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int s = slots[i];
          slots[i] = min(key, s);
          key = max(key, s);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) p.keys[(long long)i * n + lane] = slots[i];
  p.tlim[lane] = slots[L - 1];
}

}  // namespace cmr

extern "C" {

int cmr_list_len() { return CMR_LIST_LEN; }

// Launch on ``stream``; returns cudaGetLastError() right after the launch.
int cmr_binned_listing_launch(const float* bounds, const float* super_bounds, const float* rays,
                              const float* bound, const int* tlo, int* keys, int* tlim, int n,
                              int C, int S, int SF, void* stream) {
  cmr::ListingParams p{bounds, super_bounds, rays, bound, tlo, keys, tlim, n, C, S, SF};
  const int blocks = (n + cmr::LIST_THREADS - 1) / cmr::LIST_THREADS;
  cmr::binned_listing<CMR_LIST_LEN><<<blocks, cmr::LIST_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
