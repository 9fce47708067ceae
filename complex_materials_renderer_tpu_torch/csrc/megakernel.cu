// Path-tracing megakernel (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel complex_materials_renderer_tpu/kernels/
// megakernel.py trace_paths_mega (:1475; pallas_call :1594, body
// _make_kernel :348): it advances R path lanes by up to max_iters bounce
// iterations each, with the traversal, the medium physics, the Fresnel
// boundaries, free flight, HG scattering, the NEE shadow march, diffuse
// shading, Russian roulette and the RNG all inside one launch.
//
// What bounds it on this card: operations. A lane reads and writes ~130
// bytes of state and the grid (a few hundred KB for the shipped scenes)
// stays in L2, while each bounce runs thousands of f32 slab and triangle
// tests. Those tests are data-dependent and divergent: lanes of one warp
// walk different clusters and die at different bounces, so the SMs also
// idle on masked lanes and on dependent loads of the triangle rows, which
// keeps the kernel well below the f32 rate (PERF.md).
//
// What this first design does about it: one thread per lane and a lane
// loop `for (it < max_iters && alive) bounce()`, so a dead lane costs
// nothing beyond its warp's stragglers (the caller compacts the wavefront
// between launches, as on the TPU). Each lane culls supers and clusters
// against its OWN bound instead of the TPU kernel's block-wide minimum:
// a culled box cannot hold a hit that beats the bound, and the strict
// `t < t_best` update keeps the lowest slot on ties, as the linear walk
// does, so the closest hits are the same. Triangle rows are read through
// the read-only path (__ldg); the media table and the light row are
// staged in shared memory; the NEE K-list stays in registers (K is a
// template parameter, every loop over it unrolled). It allocates nothing.
// Later work: warp-coherent traversal, rows staged in shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -DCMR_NEE_MAX_MEDIA=<n>, one
// library per --nee-bound value (the K-list length is a template
// parameter; large values spill registers). --fmad=false and no --use_fast_math keep every product, 1/x and
// sqrtf IEEE-rounded like the plain PyTorch version it is checked against.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_test.cuh"

#ifndef CMR_NEE_MAX_MEDIA
#error "build with -DCMR_NEE_MAX_MEDIA=<n>"
#endif

namespace cmr {

constexpr int K_NEE = 2 * CMR_NEE_MAX_MEDIA + 2;  // cluster_test.nee_list_len
constexpr int THREADS = 128;
constexpr int MAX_MEDIA = 63;
constexpr int DRAWS_PER_BOUNCE = 8;

constexpr float INV_FOURPI = 0.07957747154594767f;
constexpr float LN_CLAMP = 9.210340371976184f;
constexpr float INV_PI = 0.31830988618f;
constexpr float PI_F = 3.14159265359f;
constexpr float TWOPI_F = 6.28318530718f;
constexpr float REFLECTANCE = 0.8f;
constexpr float NO_INTERACTION = 500000.0f;
constexpr float ISO_EPS = 1e-4f;
constexpr float INV_U32 = 1.0f / 4294967295.0f;  // == 2^-32 in float

struct Params {
  const float* __restrict__ bounds;        // (C, 8)
  const float* __restrict__ super_bounds;  // (S, 8)
  const float* __restrict__ run_rows;      // (C*subs, row_w)
  const float* __restrict__ media9;        // (M, 9)
  const float* __restrict__ misc;          // (16,)
  const int* __restrict__ sob;             // (1024, 30) Sobol direction numbers
  int dim_base;                            // clipped ld dimension base
  float* org;
  float* dir;
  float* thr;
  float* rad;
  long long* rng;
  int* depth;
  unsigned char* alive;
  const long long* __restrict__ aux;
  int n_lanes, C, S, subs, run, row_w, M, SF;
  int background, max_depth, rr_depth, tir_kill, analytic_direct, ld, max_iters;
};

// ---------------------------------------------------------------- RNG --

__device__ __forceinline__ uint32_t pcg_step(uint32_t s) { return s * 747796405u + 1u; }

__device__ __forceinline__ uint32_t pcg_output(uint32_t s) {
  const uint32_t shift = (s >> 28) + 4u;
  const uint32_t word = ((s >> shift) ^ s) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t reverse_bits32(uint32_t x) { return __brev(x); }

__device__ __forceinline__ uint32_t lk_hash(uint32_t x, uint32_t seed) {
  x = x ^ (x * 0x3D20ADEAu);
  x = x + seed;
  x = x * ((seed >> 16) | 1u);
  x = x ^ (x * 0x05526C56u);
  x = x ^ (x * 0x53A22864u);
  return x;
}

__device__ __forceinline__ float u32_to_unit(uint32_t word) {
  return __uint2float_rn(word) * INV_U32;
}

struct Rng {
  uint32_t state;  // PCG32 state, or (ld) the shuffled sample index
  uint32_t ph;     // ld: pixel hash
  bool ld;
  const int* __restrict__ sob;
  int dim_base;
  int it;

  // Masked PCG draw, or the lockstep Owen-scrambled Sobol draw of site
  // ``site`` (megakernel.py make_draw); ld draws ignore the mask.
  __device__ __forceinline__ float draw(bool mask, int site) {
    if (!ld) {
      const uint32_t ns = pcg_step(state);
      const float value = u32_to_unit(pcg_output(ns));
      if (mask) state = ns;
      return value;
    }
    const int rbase = it * DRAWS_PER_BOUNCE + site;
    const int* row = sob + (dim_base + rbase) * 30;
    uint32_t v = 0u;
    for (int j = 0; j < 30; ++j) {
      if ((state >> j) & 1u) v ^= (uint32_t)__ldg(row + j);
    }
    const uint32_t dim_abs = (uint32_t)(dim_base + rbase);
    const uint32_t key = pcg_output(pcg_step(ph ^ (dim_abs * 0x9E3779B9u)));
    return u32_to_unit(reverse_bits32(lk_hash(reverse_bits32(v), key)));
  }
};

// ------------------------------------------------------------- helpers --

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 norm3(float x, float y, float z) {
  const float n = sqrtf(x * x + y * y + z * z);
  const float inv = 1.0f / fmaxf(n, 1e-20f);
  return V3{x * inv, y * inv, z * inv};
}

__device__ __forceinline__ float max3(float a, float b, float c) { return fmaxf(a, fmaxf(b, c)); }
__device__ __forceinline__ float min3(float a, float b, float c) { return fminf(a, fminf(b, c)); }

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v < 0.0f ? -tiny : tiny) : v);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// Full rs/rp Fresnel reflectance, trig-free (megakernel.py _fresnel_r).
__device__ __forceinline__ float fresnel_r(float n1, float n2, V3 d, V3 n) {
  const float cos1 = clip(fabsf(dot3(d, n)), 0.0f, 1.0f);
  const float sin1 = sqrtf(fmaxf(1.0f - cos1 * cos1, 0.0f));
  const float sin_t2 = n1 / n2 * sin1;
  const bool tir = sin_t2 >= 1.0f;
  const float s2 = clip(sin_t2, -1.0f, 1.0f);
  const float c2 = sqrtf(fmaxf(1.0f - s2 * s2, 0.0f));
  const float c1 = cos1;
  const float rs = (n1 * c1 - n2 * c2) / (n1 * c1 + n2 * c2);
  const float rp = (n1 * c2 - n2 * c1) / (n1 * c2 + n2 * c1);
  const float r = (rs * rs + rp * rp) * 0.5f;
  return tir ? 0.0f : r;
}

struct Boundary {
  V3 refl, trans;
  float r;
  bool tir;
};

// megakernel.py _boundary_event: reflected dir, transmitted dir
// (reflection under TIR), reflectance and the TIR flag.
__device__ __forceinline__ Boundary boundary_event(V3 d, V3 n, float ior) {
  const float d_dot_n = dot3(d, n);
  const bool going_out = d_dot_n > 0.0f;
  const float from_ior = going_out ? ior : 1.0f;
  const float to_ior = going_out ? 1.0f : ior;
  const float eta = from_ior / to_ior;
  const float cos_i = -d_dot_n;
  const float sin2_t = eta * eta * (1.0f - cos_i * cos_i);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
  const float k = eta * cos_i - cos_t;
  float fx = eta * d.x + k * n.x;
  float fy = eta * d.y + k * n.y;
  float fz = eta * d.z + k * n.z;
  if (tir) {
    fx = n.x;
    fy = n.y;
    fz = n.z;
  }
  const V3 f = norm3(fx, fy, fz);
  const float two_d = 2.0f * d_dot_n;
  const V3 rf = norm3(d.x - two_d * n.x, d.y - two_d * n.y, d.z - two_d * n.z);
  Boundary b;
  b.refl = rf;
  b.trans = tir ? rf : f;
  b.r = fresnel_r(from_ior, to_ior, d, n);
  b.tir = tir;
  return b;
}

struct Medium {
  bool has;
  float ss_r, ss_g, ss_b, sa_r, sa_g, sa_b, g, ior;
};

__device__ __forceinline__ Medium medium_row(const float* media, int i) {
  const float* row = media + i * 9;
  return Medium{true, row[1], row[2], row[3], row[4], row[5], row[6], row[7], row[8]};
}

__device__ __forceinline__ Medium no_medium() {
  return Medium{false, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
}

// First-match linear scan of the media table by material id (volpath:137-145).
__device__ __forceinline__ Medium media_scan(const float* media, int M, float mat) {
  const int i = media_index(mat, media, M);
  return i >= 0 ? medium_row(media, i) : no_medium();
}

__device__ __forceinline__ float albedo(float ss, float ext) {
  return ext > 0.0f ? ss / fmaxf(ext, 1e-30f) : -1.0f;
}

__device__ __forceinline__ float ff_weight(const Medium& m, float er, float eg, float eb) {
  float weight = max3(albedo(m.ss_r, er), albedo(m.ss_g, eg), albedo(m.ss_b, eb));
  weight = fmaxf(weight, -1.0f);
  return weight > 0.0f ? fmaxf(weight, 0.5f) : weight;
}

// The exponential candidate collision distance (NO_INTERACTION when the
// single-scatter draw declines), megakernel.py _free_flight_candidate.
__device__ __forceinline__ float free_flight_candidate(float rand, const Medium& m) {
  const float er = m.ss_r + m.sa_r;
  const float eg = m.ss_g + m.sa_g;
  const float eb = m.ss_b + m.sa_b;
  const float density = min3(er, eg, eb);
  const float weight = ff_weight(m, er, eg, eb);
  const bool draw = rand < weight;
  const float r_scaled = draw ? rand / weight : 0.0f;
  const float exp_sample = -logf(fmaxf(1.0f - r_scaled, 1e-37f)) / fmaxf(density, 1e-30f);
  return (draw && density > 0.0f) ? exp_sample : NO_INTERACTION;
}

struct Flight {
  bool success;
  float t, prob_fail, prob_success, tr_r, tr_g, tr_b;
};

__device__ __forceinline__ Flight sample_distance(float rand, const Medium& m, float dist) {
  const float er = m.ss_r + m.sa_r;
  const float eg = m.ss_g + m.sa_g;
  const float eb = m.ss_b + m.sa_b;
  const float density = min3(er, eg, eb);
  const float weight = ff_weight(m, er, eg, eb);
  const float sampled = free_flight_candidate(rand, m);
  Flight f;
  f.success = sampled < dist;
  f.t = f.success ? sampled : dist;
  const float pf0 = expf(-density * f.t);
  f.prob_success = density * pf0 * weight;
  f.prob_fail = weight * pf0 + (1.0f - weight);
  f.tr_r = expf(-er * f.t);
  f.tr_g = expf(-eg * f.t);
  f.tr_b = expf(-eb * f.t);
  if (max3(f.tr_r, f.tr_g, f.tr_b) < 1e-4f) {
    f.tr_r = 0.0f;
    f.tr_g = 0.0f;
    f.tr_b = 0.0f;
  }
  return f;
}

// HG direction sampling; i is the direction toward the collision.
__device__ __forceinline__ V3 hg_sample(V3 i, float g, float r1, float r2) {
  const bool iso = fabsf(g) < ISO_EPS;
  float cos_theta;
  if (iso) {
    cos_theta = 1.0f - 2.0f * r1;
  } else {
    const float tmp = (1.0f - g * g) / (1.0f - g + 2.0f * g * r1);
    cos_theta = (1.0f + g * g - tmp * tmp) / (2.0f * g);
  }
  const float sin_theta = sqrtf(fmaxf(0.0f, 1.0f - cos_theta * cos_theta));
  const float phi = TWOPI_F * r2;
  const float lx = sin_theta * cosf(phi);
  const float ly = sin_theta * sinf(phi);
  const float lz = cos_theta;
  const float nx = -i.x, ny = -i.y, nz = -i.z;
  float tx, ty, tz;
  if (fabsf(nx) > fabsf(ny)) {
    const float inv_a = 1.0f / sqrtf(fmaxf(nx * nx + nz * nz, 1e-20f));
    tx = nz * inv_a;
    ty = 0.0f;
    tz = -nx * inv_a;
  } else {
    const float inv_b = 1.0f / sqrtf(fmaxf(ny * ny + nz * nz, 1e-20f));
    tx = 0.0f;
    ty = nz * inv_b;
    tz = -ny * inv_b;
  }
  const float sx = ty * nz - tz * ny;
  const float sy = tz * nx - tx * nz;
  const float sz = tx * ny - ty * nx;
  return V3{sx * lx + tx * ly + nx * lz, sy * lx + ty * ly + ny * lz, sz * lx + tz * ly + nz * lz};
}

// Concentric square-to-disk map (volpath:272-297).
__device__ __forceinline__ void concentric_disk(float r1, float r2, float& ox, float& oy) {
  const float u = 2.0f * r1 - 1.0f;
  const float v = 2.0f * r2 - 1.0f;
  if (u == 0.0f && v == 0.0f) {
    ox = 0.0f * cosf(0.0f);
    oy = 0.0f * sinf(0.0f);
    return;
  }
  const bool use_u = u * u > v * v;
  float r, phi;
  if (use_u) {
    r = u;
    phi = (PI_F / 4.0f) * (v / u);
  } else {
    r = v;
    phi = (PI_F / 2.0f) - (u / (v == 0.0f ? 1.0f : v)) * (PI_F / 4.0f);
  }
  ox = r * cosf(phi);
  oy = r * sinf(phi);
}

// --------------------------------------------------------- traversals --

// Scene-box exit clamp of the walk bound (megakernel.py:546-567).
__device__ __forceinline__ float box_clamp(const float* misc, V3 o, V3 inv, float tmax) {
  const float ex = fmaxf((misc[8] - o.x) * inv.x, (misc[11] - o.x) * inv.x);
  const float ey = fmaxf((misc[9] - o.y) * inv.y, (misc[12] - o.y) * inv.y);
  const float ez = fmaxf((misc[10] - o.z) * inv.z, (misc[13] - o.z) * inv.z);
  const float tf = min3(ex, ey, ez);
  return fminf(tmax, fmaxf(tf, 0.0f) * 1.0001f + 10.0f * T_MIN);
}

// Closest hit ('full'): the linear super -> cluster walk, each box gated
// by the slab entry against the lane's current t_best.
__device__ FullState trace_full(const Params& p, V3 o, V3 d, float tmax) {
  const V3 inv{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  FullState st{box_clamp(p.misc, o, inv, tmax), -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, -1.0f,
               0.0f, 0.0f, 0.0f};
  for (int sp = 0; sp < p.S; ++sp) {
    if (!slab_hit(p.super_bounds + sp * 8, o.x, o.y, o.z, inv.x, inv.y, inv.z, st.t)) continue;
    const int lo = sp * p.SF;
    const int hi = min(lo + p.SF, p.C);
    for (int c = lo; c < hi; ++c) {
      if (!slab_hit(p.bounds + c * 8, o.x, o.y, o.z, inv.x, inv.y, inv.z, st.t)) continue;
      test_cluster(p.run_rows, p.row_w, p.subs, p.run, c, o.x, o.y, o.z, d.x, d.y, d.z, st);
    }
  }
  return st;
}

// The fused 'dnee' walk: (t, slot) along set A (da, bound tmax_a, box
// clamped) and the NEE K-list along set B (db, bound tmax_b) from one
// origin. A box is visited when either set still needs it under its own
// bound.
template <int K>
__device__ DneeState<K> trace_dnee(const Params& p, const float* media, V3 o, V3 da, float tmax_a,
                                   V3 db, float tmax_b) {
  const V3 ia{safe_inv(da.x), safe_inv(da.y), safe_inv(da.z)};
  const V3 ib{safe_inv(db.x), safe_inv(db.y), safe_inv(db.z)};
  DneeState<K> st;
  st.a.t = box_clamp(p.misc, o, ia, tmax_a);
  st.a.slot = -1.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) st.b.key[i] = KEY_EMPTY;
  st.b.t_opq = tmax_b;
  // A set whose bound is below T_MIN can accept nothing: skip its tests.
  const bool need_a = st.a.t > T_MIN;
  const bool need_b = tmax_b > T_MIN;
  if (!need_a && !need_b) return st;
  for (int sp = 0; sp < p.S; ++sp) {
    const float* sb = p.super_bounds + sp * 8;
    bool visit = false;
    if (need_a) visit = slab_hit(sb, o.x, o.y, o.z, ia.x, ia.y, ia.z, st.a.t);
    if (!visit && need_b) {
      visit = slab_hit(sb, o.x, o.y, o.z, ib.x, ib.y, ib.z, nee_bound<K>(st.b));
    }
    if (!visit) continue;
    const int lo = sp * p.SF;
    const int hi = min(lo + p.SF, p.C);
    for (int c = lo; c < hi; ++c) {
      const float* cb = p.bounds + c * 8;
      bool vc = false;
      if (need_a) vc = slab_hit(cb, o.x, o.y, o.z, ia.x, ia.y, ia.z, st.a.t);
      if (!vc && need_b) {
        vc = slab_hit(cb, o.x, o.y, o.z, ib.x, ib.y, ib.z, nee_bound<K>(st.b));
      }
      if (!vc) continue;
      test_cluster<K>(p.run_rows, p.row_w, p.subs, p.run, c, o.x, o.y, o.z, da.x, da.y, da.z,
                      db.x, db.y, db.z, media, p.M, st);
    }
  }
  return st;
}

// ----------------------------------------------------------------- NEE --

struct Light {
  V3 dir;
  float ldist, eff, lv_r, lv_g, lv_b;
};

__device__ __forceinline__ Light nee_setup(const float* misc, V3 pt, bool active) {
  const float tlx = misc[0] - pt.x;
  const float tly = misc[1] - pt.y;
  const float tlz = misc[2] - pt.z;
  Light l;
  l.ldist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
  const float inv = 1.0f / fmaxf(l.ldist, 1e-20f);
  l.dir = V3{tlx * inv, tly * inv, tlz * inv};
  l.lv_r = misc[3] * inv * inv;
  l.lv_g = misc[4] * inv * inv;
  l.lv_b = misc[5] * inv * inv;
  l.eff = active ? l.ldist : 0.0f;
  return l;
}

// Replay of the reference's per-leg shadow march over the K keys
// (megakernel.py nee_resolve :875-967). Returns the light times the
// transmittance through the media boundaries.
template <int K>
__device__ __forceinline__ V3 nee_resolve(const NeeState<K>& hits, const Light& l, bool active,
                                          const float* media, int M, int nee_max_media) {
  const float eff = l.eff;
  const float t_op = hits.t_opq;
  float tr_r = 1.0f, tr_g = 1.0f, tr_b = 1.0f;
  bool running = active;
  bool in_med = false;
  float ex_r = 0.0f, ex_g = 0.0f, ex_b = 0.0f;
  float last_t = 0.0f;
  float n_real = 0.0f;
  const float real_cap = (float)(2 * nee_max_media);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int key = hits.key[i];
    const bool empty = key == KEY_EMPTY;
    const float t_i = empty ? eff : __int_as_float(key & ~NEE_MAT_MASK);
    const int m_i = empty ? -1 : (key & NEE_MAT_MASK);
    const float rem = l.ldist - last_t;
    const bool dup = t_i <= last_t + T_MIN;
    const float cut = in_med ? last_t + fmaxf(rem, T_MIN) : last_t + 0.999f * rem;
    const float window = fminf(cut, eff);
    const bool opq = running && (t_op > last_t + T_MIN) && (t_op < window) && (t_op < t_i);
    if (opq) {
      tr_r = 0.0f;
      tr_g = 0.0f;
      tr_b = 0.0f;
    }
    running = running && !opq;
    const bool consider = running && !dup;
    const bool real = consider && (t_i < window);
    n_real = n_real + (real ? 1.0f : 0.0f);
    const bool ended = consider && !real;
    const Medium m = (m_i >= 0 && m_i < M) ? medium_row(media, m_i) : no_medium();
    const bool exitl = real && in_med;
    const float seg = fminf(t_i - last_t, rem);
    if (exitl) {
      tr_r = tr_r * (0.9f * expf(-ex_r * seg));
      tr_g = tr_g * (0.9f * expf(-ex_g * seg));
      tr_b = tr_b * (0.9f * expf(-ex_b * seg));
    }
    if (real && !in_med) {
      ex_r = m.ss_r + m.sa_r;
      ex_g = m.ss_g + m.sa_g;
      ex_b = m.ss_b + m.sa_b;
    }
    if (real) last_t = t_i;
    in_med = in_med != real;
    running = running && !ended;
  }
  if (running || n_real >= real_cap) {
    tr_r = 0.0f;
    tr_g = 0.0f;
    tr_b = 0.0f;
  }
  return V3{l.lv_r * tr_r, l.lv_g * tr_g, l.lv_b * tr_b};
}

// --------------------------------------------------------------- lane --

struct Lane {
  V3 o, d, th, ra;
  int depth;
  bool alive;
};

__device__ __forceinline__ void shade_color(int background, V3 pt, float nx, float& cr, float& cg,
                                            float& cb) {
  if (background == 1) {
    const float fx = floorf(pt.x);
    const float fy = floorf(pt.y);
    // floor-mod by 2 is 0 exactly when fmodf is (+-)0 for integer values
    const bool even = (fmodf(fx, 2.0f) == 0.0f) == (fmodf(fy, 2.0f) == 0.0f);
    cr = cg = cb = even ? 0.8f : 0.3f;
  } else if (background == 2) {
    const bool is_red = nx > 0.99f;
    const bool is_green = nx < -0.99f;
    cr = is_red ? 0.8f : (is_green ? 0.0f : 0.8f);
    cg = is_red ? 0.0f : (is_green ? 0.8f : 0.8f);
    cb = is_red ? 0.0f : (is_green ? 0.0f : 0.8f);
  } else {
    cr = cg = cb = 0.8f;
  }
}

// One bounce iteration of a live lane (megakernel.py bounce :992-1370,
// the default fused walk).
template <int K>
__device__ void bounce(const Params& p, const float* media, const float* misc, Lane& L, Rng& rng) {
  const Params& P = p;  // NOLINT: short name for the launch parameters
  FullState h = trace_full(P, L.o, L.d, T_MAX);
  const bool got_hit = h.slot >= 0.0f;  // the lane is alive
  const V3 n = norm3(h.nx, h.ny, h.nz);
  const Medium med = media_scan(media, P.M, h.mat);
  const V3 pt{h.px, h.py, h.pz};
  float col_r, col_g, col_b;
  shade_color(P.background, pt, n.x, col_r, col_g, col_b);
  const bool has_med = got_hit && med.has;

  // boundary event #1 (volpath:633-670)
  const Boundary b1 = boundary_event(L.d, n, med.ior);
  const float rand_f = rng.draw(has_med, 0);
  const bool do_reflect = has_med && (rand_f < b1.r);
  const bool transmitted = has_med && !do_reflect;
  const V3 da = do_reflect ? b1.refl : (transmitted ? b1.trans : L.d);
  if (do_reflect) L.o = pt;
  L.depth += has_med ? 1 : 0;

  // free-flight draw before the boundary trace
  const float rand_d = rng.draw(transmitted, 1);
  const float cand = free_flight_candidate(rand_d, med);

  const bool diffuse = got_hit && !has_med;
  const bool backface = diffuse && (dot3(L.d, n) > 0.0f);
  const bool shade = diffuse && !backface;

  const float density0 = min3(med.ss_r + med.sa_r, med.ss_g + med.sa_g, med.ss_b + med.sa_b);
  bool ad_gate = false;
  if (P.analytic_direct) {
    ad_gate = transmitted && (density0 > 0.0f);
    if (P.tir_kill) ad_gate = ad_gate && !b1.tir;
  }

  // fused dist+NEE walk
  const bool may_scatter = transmitted && (cand < T_MAX);
  const bool need_light = P.analytic_direct ? ad_gate : may_scatter;
  const bool light_active = need_light || shade;
  const Light lt = nee_setup(misc, pt, light_active);
  float bound = fminf(cand * 1.00001f + 10.0f * T_MIN, T_MAX);
  if (P.analytic_direct) {
    const float t_star =
        ad_gate ? LN_CLAMP / fmaxf(density0, 1e-30f) * 1.00001f + 10.0f * T_MIN : 0.0f;
    bound = fminf(fmaxf(bound, t_star), T_MAX);
  }
  const DneeState<K> dn =
      trace_dnee<K>(P, media, pt, da, transmitted ? bound : 0.0f, lt.dir, lt.eff);
  const float seg_len = dn.a.slot >= 0.0f ? dn.a.t : T_MAX;

  // free-flight sampling (volpath:691)
  const Flight fl = sample_distance(rand_d, med, seg_len);
  bool scatter = transmitted && fl.success;
  if (P.tir_kill) scatter = scatter && !b1.tir;
  const bool pass_med = transmitted && !scatter;

  // NEE (no RNG draws)
  const V3 li = nee_resolve<K>(dn.b, lt, light_active, media, P.M, CMR_NEE_MAX_MEDIA);
  const float tmp_g = 1.0f + med.g * med.g;
  const float phase_nee = INV_FOURPI * (1.0f - med.g * med.g) / (tmp_g * sqrtf(tmp_g));
  if (P.analytic_direct && ad_gate) {
    const float t_cap = fminf(seg_len, LN_CLAMP / fmaxf(density0, 1e-30f));
    const float er = med.ss_r + med.sa_r;
    const float eg = med.ss_g + med.sa_g;
    const float eb = med.ss_b + med.sa_b;
    const float ad_r = med.ss_r * (1.0f - expf(-er * t_cap)) / fmaxf(er, 1e-30f);
    const float ad_g = med.ss_g * (1.0f - expf(-eg * t_cap)) / fmaxf(eg, 1e-30f);
    const float ad_b = med.ss_b * (1.0f - expf(-eb * t_cap)) / fmaxf(eb, 1e-30f);
    L.ra.x = L.ra.x + L.th.x * ad_r * li.x * phase_nee;
    L.ra.y = L.ra.y + L.th.y * ad_g * li.y * phase_nee;
    L.ra.z = L.ra.z + L.th.z * ad_b * li.z * phase_nee;
  }

  // scatter branch (volpath:693-710)
  if (scatter) {
    const bool ps_pos = fl.prob_success > 0.0f;
    const float sc_r = ps_pos ? med.ss_r * fl.tr_r / fl.prob_success : 0.0f;
    const float sc_g = ps_pos ? med.ss_g * fl.tr_g / fl.prob_success : 0.0f;
    const float sc_b = ps_pos ? med.ss_b * fl.tr_b / fl.prob_success : 0.0f;
    L.th.x = L.th.x * sc_r;
    L.th.y = L.th.y * sc_g;
    L.th.z = L.th.z * sc_b;
    if (!P.analytic_direct) {
      L.ra.x = L.ra.x + L.th.x * li.x * phase_nee;
      L.ra.y = L.ra.y + L.th.y * li.y * phase_nee;
      L.ra.z = L.ra.z + L.th.z * li.z * phase_nee;
    }
  }
  const float r_ph1 = rng.draw(scatter, 2);
  const float r_ph2 = rng.draw(scatter, 3);
  V3 nd = da;
  if (scatter) {
    const V3 hg = hg_sample(V3{-da.x, -da.y, -da.z}, med.g, r_ph1, r_ph2);
    L.o = V3{pt.x + hg.x * fl.t, pt.y + hg.y * fl.t, pt.z + hg.z * fl.t};
    nd = hg;
  }

  // pass-through branch (volpath:713-756)
  if (pass_med) {
    const bool pf_pos = fl.prob_fail > 0.0f;
    L.th.x = L.th.x * (pf_pos ? fl.tr_r / fl.prob_fail : 0.0f);
    L.th.y = L.th.y * (pf_pos ? fl.tr_g / fl.prob_fail : 0.0f);
    L.th.z = L.th.z * (pf_pos ? fl.tr_b / fl.prob_fail : 0.0f);
  }
  // boundary event #2 with the stale entry normal (volpath:723-753)
  const Boundary b2 = boundary_event(da, n, med.ior);
  const float rand_f2 = rng.draw(pass_med, 4);
  if (pass_med) {
    L.o = V3{pt.x + da.x * fl.t, pt.y + da.y * fl.t, pt.z + da.z * fl.t};
    nd = rand_f2 < b2.r ? b2.refl : b2.trans;
  }

  // diffuse branch (volpath:758-779)
  const float r_d1 = rng.draw(shade, 5);
  const float r_d2 = rng.draw(shade, 6);
  if (shade) {
    float ddx, ddy;
    concentric_disk(r_d1, r_d2, ddx, ddy);
    const float temp = 1.0f - ddx * ddx - ddy * ddy;
    const float ddz = temp <= 0.0f ? 1e-10f : sqrtf(fmaxf(temp, 0.0f));
    L.th.x = L.th.x * REFLECTANCE;
    L.th.y = L.th.y * REFLECTANCE;
    L.th.z = L.th.z * REFLECTANCE;
    const bool visible = (dot3(V3{-L.d.x, -L.d.y, -L.d.z}, n) > 0.0f) &&
                         (dot3(V3{ddx, ddy, ddz}, n) > 0.0f);
    const float deval = visible ? REFLECTANCE * INV_PI * ddz : 0.0f;
    L.ra.x = L.ra.x + L.th.x * li.x * deval * col_r;
    L.ra.y = L.ra.y + L.th.y * li.y * deval * col_g;
    L.ra.z = L.ra.z + L.th.z * li.z * deval * col_b;
    const V3 wo = norm3(ddx, ddy, ddz);
    L.o = V3{pt.x + wo.x * T_MIN, pt.y + wo.y * T_MIN, pt.z + wo.z * T_MIN};
    nd = wo;
  }
  if (do_reflect || scatter || pass_med || shade) L.d = nd;

  // depth + russian roulette (volpath:786-797)
  const bool enders = scatter || shade;
  L.depth += (enders || pass_med) ? 1 : 0;
  const bool rr = enders && (L.depth > P.rr_depth);
  const float rand_rr = rng.draw(rr, 7);
  const float q = fminf(max3(L.th.x, L.th.y, L.th.z), 0.95f);
  const bool survive = rand_rr <= q;
  if (rr && survive) {
    const float boost = 1.0f / fmaxf(q, 1e-20f);
    L.th.x = L.th.x * boost;
    L.th.y = L.th.y * boost;
    L.th.z = L.th.z * boost;
  }
  const bool continuing = do_reflect || pass_med || (enders && (!rr || survive));
  bool alive = continuing && (L.depth < P.max_depth);
  if (P.tir_kill) alive = alive && !((transmitted && b1.tir) || (pass_med && b2.tir));
  L.alive = alive;
}

template <int K>
__global__ void __launch_bounds__(THREADS) megakernel(Params p) {
  __shared__ float s_media[MAX_MEDIA * 9];
  __shared__ float s_misc[16];
  for (int i = threadIdx.x; i < p.M * 9; i += blockDim.x) s_media[i] = p.media9[i];
  if (threadIdx.x < 16) s_misc[threadIdx.x] = p.misc[threadIdx.x];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;
  Lane L;
  L.alive = p.alive[lane] != 0;
  if (!L.alive) return;  // a dead lane never changes
  L.o = V3{p.org[3 * lane], p.org[3 * lane + 1], p.org[3 * lane + 2]};
  L.d = V3{p.dir[3 * lane], p.dir[3 * lane + 1], p.dir[3 * lane + 2]};
  L.th = V3{p.thr[3 * lane], p.thr[3 * lane + 1], p.thr[3 * lane + 2]};
  L.ra = V3{p.rad[3 * lane], p.rad[3 * lane + 1], p.rad[3 * lane + 2]};
  L.depth = p.depth[lane];
  Rng rng;
  rng.state = (uint32_t)p.rng[lane];
  rng.ph = (uint32_t)p.aux[lane];
  rng.ld = p.ld != 0;
  rng.sob = p.sob;
  rng.dim_base = p.dim_base;

  // A lane's k-th iteration is the block loop's k-th (the draws of dead
  // lanes are masked and ld dims advance in lockstep), so the per-lane
  // loop equals the TPU kernel's per-block while_loop.
  for (int it = 0; it < p.max_iters && L.alive; ++it) {
    rng.it = it;
    bounce<K>(p, s_media, s_misc, L, rng);
  }

  p.org[3 * lane] = L.o.x;
  p.org[3 * lane + 1] = L.o.y;
  p.org[3 * lane + 2] = L.o.z;
  p.dir[3 * lane] = L.d.x;
  p.dir[3 * lane + 1] = L.d.y;
  p.dir[3 * lane + 2] = L.d.z;
  p.thr[3 * lane] = L.th.x;
  p.thr[3 * lane + 1] = L.th.y;
  p.thr[3 * lane + 2] = L.th.z;
  p.rad[3 * lane] = L.ra.x;
  p.rad[3 * lane + 1] = L.ra.y;
  p.rad[3 * lane + 2] = L.ra.z;
  p.rng[lane] = (long long)rng.state;
  p.depth[lane] = L.depth;
  p.alive[lane] = L.alive ? 1 : 0;
}

}  // namespace cmr

extern "C" {

// Launch on ``stream``; returns cudaGetLastError() right after the launch.
int cmr_megakernel_launch(const float* bounds, const float* super_bounds, const float* run_rows,
                          const float* media9, const float* misc, const int* sob, int dim_base,
                          float* org, float* dir, float* thr, float* rad, long long* rng,
                          int* depth, unsigned char* alive, const long long* aux, int n_lanes,
                          int C, int S, int subs, int run, int row_w, int M, int SF,
                          int background, int max_depth, int rr_depth, int tir_kill,
                          int analytic_direct, int ld, int max_iters, void* stream) {
  cmr::Params p{bounds, super_bounds, run_rows, media9, misc, sob, dim_base,
                org, dir, thr, rad, rng, depth, alive, aux,
                n_lanes, C, S, subs, run, row_w, M, SF,
                background, max_depth, rr_depth, tir_kill, analytic_direct, ld, max_iters};
  const int blocks = (n_lanes + cmr::THREADS - 1) / cmr::THREADS;
  cmr::megakernel<cmr::K_NEE><<<blocks, cmr::THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int cmr_megakernel_k_nee() { return cmr::K_NEE; }

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
