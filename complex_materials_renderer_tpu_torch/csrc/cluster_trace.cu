// Standalone closest-hit trace over the cluster grid (K3) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel complex_materials_renderer_tpu/kernels/
// pallas_trace.py _trace_kernel (:170), launched through _trace_core
// (:399, pallas_call :432) by trace_shaded_clusters (:368) and
// trace_closest_clusters (:385). For R rays and a per-lane bound t_max
// (inactive lanes are parked at t_max = 0) it finds the closest hit with
// T_MIN < t < t_max over the grid and writes the shading payload: t, slot,
// u, v, the unnormalised normal e1 x e2, the material id and the
// barycentric position a + u e1 + v e2. Misses keep t = t_max, slot -1,
// normal (0, 0, 1), mat -1, position 0.
//
// What bounds it on this card: latency, not the f32 rate. A ray reads 28
// bytes and writes 44, and the grid (tens to hundreds of KB for the
// shipped scenes) stays in L2, while each ray runs tens of slab tests and
// hundreds to thousands of f32 triangle tests. With one thread per ray
// each launch lasted one ray's dependent chain, so the wavefront's
// compacted launches of a few thousand rays cost as much as a full one.
// With the group walk below, what remains is each ray's box tests and the
// tile's reductions after each cluster: the 65,536-ray launch reaches
// ~26% of its operation bound, the compacted ones 1-8% (PERF.md).
//
// What the design does about it: a tile of G threads serves one ray
// (cluster_test.cuh ``group_cluster_full``), G a template parameter of 1,
// 2, 4, 8, 16 or 32 that the wrapper picks from the launch width
// (kernels/cluster_test.py ``group_size``), so that narrow launches still
// put enough threads on the card and the tile's loads of a cluster row are
// neighbouring addresses. The walk order is the TPU kernel's (supers
// 0..S-1, clusters sp*SF .. min(sp*SF+SF, C), slots in order), with every
// box gated by the slab entry against the ray's OWN t_best; every thread of
// the tile runs the same box tests on the same values, so the visits are
// uniform. The slots of a visited cluster are strided over the tile and
// the tile reduces after each cluster to the lexicographic minimum of
// (t, slot): exactly the one-thread walk's state, since its strict
// `tt < t_best` keeps the lowest slot on ties. So the results are
// bit-equal to the plain version for every G. The TPU kernel culls a box
// for a 1024-lane block when no lane of the block meets it (jnp.any); a
// box the ray itself misses cannot hold a hit that beats its t_best, so
// the per-ray walk returns the same hits. Triangle data is read from the
// run-major rows (run_rows, one row per run of a cluster) through the
// read-only path rather than from the per-component (C, width) arrays the
// TPU kernel reads: the rows hold the same values, and slot
// c*width + r*run + j of row (c*subs + r) is the same slot.
//
// K3's far-edge acceptance is not K2's: K3 accepts
// u*qb + v*(1-qa) <= qb + eps and u*(1-qb) + v*qa <= qa + eps
// (pallas_trace.py:301-308), where K2 scales the epsilon (``inside_k3``
// and ``inside`` in cluster_test.cuh).
//
// No NaN reaches the slab tests, so fminf/fmaxf (which drop a NaN where
// jnp.minimum/maximum propagate it) give the JAX results: safe_inv keeps
// 1/d finite and nonzero, the boxes are finite (empty pad clusters carry
// a point box at 1e30), and a parked lane (t_max <= T_MIN) tests nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false and no
// --use_fast_math keep every product and 1/x IEEE-rounded, in the
// operation order of the TPU kernel, like the plain PyTorch version it is
// checked against.

#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace cmr {

constexpr int TRACE_THREADS = 128;  // threads per block, TRACE_THREADS / G rays

struct TraceParams {
  const float* __restrict__ bounds;        // (C, 8)
  const float* __restrict__ super_bounds;  // (S, 8)
  const float* __restrict__ run_rows;      // (C*subs, row_w)
  const float* __restrict__ o;             // (R, 3)
  const float* __restrict__ d;             // (R, 3)
  const float* __restrict__ tmax;          // (R,) effective bound, 0 = parked
  float* fout;  // (9, R): t, u, v, nx, ny, nz, px, py, pz
  int* iout;    // (2, R): slot, mat
  int n, C, S, subs, run, row_w, SF;
};

__device__ __forceinline__ float trace_safe_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v < 0.0f ? -tiny : tiny) : v);
}

template <int G>
__global__ void __launch_bounds__(TRACE_THREADS) cluster_trace(TraceParams p) {
  const cg::thread_block_tile<G> tile = cg::tiled_partition<G>(cg::this_thread_block());
  const int lane = (blockIdx.x * TRACE_THREADS + threadIdx.x) / G;
  if (lane >= p.n) return;  // the whole tile
  const float t0 = __ldg(p.tmax + lane);
  FullState mine{t0, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, -1.0f, 0.0f, 0.0f, 0.0f};
  float t = t0, slot = -1.0f;
  // A lane whose bound is at most T_MIN can accept nothing (the TPU block
  // predicate max(t_max) > t_min, taken per lane).
  if (t > T_MIN) {
    const float ox = __ldg(p.o + 3 * lane), oy = __ldg(p.o + 3 * lane + 1),
                oz = __ldg(p.o + 3 * lane + 2);
    const float dx = __ldg(p.d + 3 * lane), dy = __ldg(p.d + 3 * lane + 1),
                dz = __ldg(p.d + 3 * lane + 2);
    const float ix = trace_safe_inv(dx), iy = trace_safe_inv(dy), iz = trace_safe_inv(dz);
    for (int sp = 0; sp < p.S; ++sp) {
      if (!slab_hit(p.super_bounds + sp * 8, ox, oy, oz, ix, iy, iz, t)) continue;
      const int lo = sp * p.SF;
      const int hi = min(lo + p.SF, p.C);
      for (int c = lo; c < hi; ++c) {
        if (!slab_hit(p.bounds + c * 8, ox, oy, oz, ix, iy, iz, t)) continue;
        group_cluster_full<G, true>(tile, p.run_rows, p.row_w, p.subs, p.run, c, ox, oy, oz,
                                    dx, dy, dz, t, slot, mine);
      }
    }
  }
  const FullState st = group_payload<G>(tile, mine, t, slot);
  if (tile.thread_rank() != 0) return;
  const int n = p.n;
  p.fout[0 * n + lane] = st.t;
  p.fout[1 * n + lane] = st.u;
  p.fout[2 * n + lane] = st.v;
  p.fout[3 * n + lane] = st.nx;
  p.fout[4 * n + lane] = st.ny;
  p.fout[5 * n + lane] = st.nz;
  p.fout[6 * n + lane] = st.px;
  p.fout[7 * n + lane] = st.py;
  p.fout[8 * n + lane] = st.pz;
  // Slot and material ids ride as exact floats below 2^24 (the grid
  // refuses larger ones).
  p.iout[0 * n + lane] = (int)st.slot;
  p.iout[1 * n + lane] = (int)st.mat;
}

template <int G>
int launch(const TraceParams& p, cudaStream_t stream) {
  const long long threads = (long long)p.n * G;
  const int blocks = (int)((threads + TRACE_THREADS - 1) / TRACE_THREADS);
  cluster_trace<G><<<blocks, TRACE_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace cmr

extern "C" {

// Launch on ``stream`` with ``group`` threads per ray (1, 2, 4, 8, 16 or
// 32); returns cudaGetLastError() right after the launch.
int cmr_cluster_trace_launch(const float* bounds, const float* super_bounds,
                             const float* run_rows, const float* o, const float* d,
                             const float* tmax, float* fout, int* iout, int n, int C, int S,
                             int subs, int run, int row_w, int SF, int group, void* stream) {
  const cmr::TraceParams p{bounds, super_bounds, run_rows, o, d, tmax, fout, iout,
                           n, C, S, subs, run, row_w, SF};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 1: return cmr::launch<1>(p, s);
    case 2: return cmr::launch<2>(p, s);
    case 4: return cmr::launch<4>(p, s);
    case 8: return cmr::launch<8>(p, s);
    case 16: return cmr::launch<16>(p, s);
    case 32: return cmr::launch<32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
