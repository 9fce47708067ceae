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
// What bounds it on this card: operations. A ray reads 28 bytes and writes
// 44, and the grid (tens to hundreds of KB for the shipped scenes) stays
// in L2, while each ray runs tens of slab tests and hundreds to thousands
// of f32 triangle tests. The tests are data-dependent: the lanes of a warp
// meet different clusters, so SMs idle on masked lanes (PERF.md holds the
// measured share of the bound).
//
// What this first design does about it: one thread per ray, the same
// walk order as the TPU kernel (supers 0..S-1, clusters sp*SF ..
// min(sp*SF+SF, C), slots in order), with every box gated by the slab
// entry against the lane's OWN t_best. The TPU kernel culls a box for a
// 1024-lane block when no lane of the block meets it (jnp.any); a box the
// lane itself misses cannot hold a hit that beats its t_best, and the
// strict `tt < t_best` update keeps the lowest slot on ties, so the
// per-lane walk returns the same hits. Triangle data is read from the
// run-major rows (run_rows, one row per run of a cluster) through the
// read-only path rather than from the per-component (C, width) arrays the
// TPU kernel reads: the rows hold the same values, and slot
// c*width + r*run + j of row (c*subs + r) is visited in the same order.
//
// K3's far-edge acceptance is not K2's: K3 accepts
// u*qb + v*(1-qa) <= qb + eps and u*(1-qb) + v*qa <= qa + eps
// (pallas_trace.py:301-308), where K2 (cluster_test.cuh ``inside``) scales
// the epsilon, <= qb*(1+eps). On a triangle slot (qa = qb = 0.5) K3 admits
// u+v <= 1 + 2e-6 and K2 u+v <= 1 + 1e-6, so K3 has its own test here.
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

constexpr int TRACE_THREADS = 128;

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

// K3's acceptance (pallas_trace.py:301-308): additive epsilon on the far
// edges; the t window is tested by the caller.
__device__ __forceinline__ bool inside_k3(const Slot& s, float uu, float vv) {
  return (uu >= -TRI_EPS) && (vv >= -TRI_EPS) &&
         (uu * s.qb + vv * (1.0f - s.qa) <= s.qb + TRI_EPS) &&
         (uu * (1.0f - s.qb) + vv * s.qa <= s.qa + TRI_EPS);
}

// One cluster c against one ray, slots in order (pallas_trace.py:268-320).
__device__ __forceinline__ void trace_cluster(const TraceParams& p, int c, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              FullState& st) {
  for (int rr = 0; rr < p.subs; ++rr) {
    const float* row = p.run_rows + (long long)(c * p.subs + rr) * p.row_w;
    const int r_off = (c * p.subs + rr) * p.run;
    for (int j = 0; j < p.run; ++j) {
      const Slot s = load_slot(row, p.run, j);
      const Origin og = origin_terms(s, ox, oy, oz);
      float uu, vv, tt;
      direction_terms(s, og, dx, dy, dz, uu, vv, tt);
      if (inside_k3(s, uu, vv) && tt > T_MIN && tt < st.t) {
        st.t = tt;
        st.slot = (float)(r_off + j);
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
  }
}

__global__ void __launch_bounds__(TRACE_THREADS) cluster_trace(TraceParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n) return;
  FullState st{__ldg(p.tmax + lane), -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, -1.0f,
               0.0f, 0.0f, 0.0f};
  // A lane whose bound is at most T_MIN can accept nothing (the TPU block
  // predicate max(t_max) > t_min, taken per lane).
  if (st.t > T_MIN) {
    const float ox = __ldg(p.o + 3 * lane), oy = __ldg(p.o + 3 * lane + 1),
                oz = __ldg(p.o + 3 * lane + 2);
    const float dx = __ldg(p.d + 3 * lane), dy = __ldg(p.d + 3 * lane + 1),
                dz = __ldg(p.d + 3 * lane + 2);
    const float ix = trace_safe_inv(dx), iy = trace_safe_inv(dy), iz = trace_safe_inv(dz);
    for (int sp = 0; sp < p.S; ++sp) {
      if (!slab_hit(p.super_bounds + sp * 8, ox, oy, oz, ix, iy, iz, st.t)) continue;
      const int lo = sp * p.SF;
      const int hi = min(lo + p.SF, p.C);
      for (int c = lo; c < hi; ++c) {
        if (!slab_hit(p.bounds + c * 8, ox, oy, oz, ix, iy, iz, st.t)) continue;
        trace_cluster(p, c, ox, oy, oz, dx, dy, dz, st);
      }
    }
  }
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

}  // namespace cmr

extern "C" {

// Launch on ``stream``; returns cudaGetLastError() right after the launch.
int cmr_cluster_trace_launch(const float* bounds, const float* super_bounds,
                             const float* run_rows, const float* o, const float* d,
                             const float* tmax, float* fout, int* iout, int n, int C, int S,
                             int subs, int run, int row_w, int SF, void* stream) {
  cmr::TraceParams p{bounds, super_bounds, run_rows, o, d, tmax, fout, iout,
                     n, C, S, subs, run, row_w, SF};
  const int blocks = (n + cmr::TRACE_THREADS - 1) / cmr::TRACE_THREADS;
  cmr::cluster_trace<<<blocks, cmr::TRACE_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
