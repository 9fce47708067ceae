// Path-tracing megakernel (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel complex_materials_renderer_tpu/kernels/
// megakernel.py trace_paths_mega (:1475; pallas_call :1594, body
// _make_kernel :348): it advances R path lanes by up to max_iters bounce
// iterations each, with the traversal, the medium physics, the Fresnel
// boundaries, free flight, HG scattering, the NEE shadow march, diffuse
// shading, Russian roulette and the RNG all inside one launch.
//
// What bounds it on this card: latency, not the f32 rate. A lane reads and
// writes ~130 bytes of state and the grid (a few hundred KB for the
// shipped scenes) stays in L2, while each bounce runs thousands of f32
// slab and triangle tests. The main path's phase schedule
// (render/megarender.py) launches 65,536 lanes for one bounce, then ever
// narrower compacted wavefronts and a last phase of 1,024 lanes that runs
// to termination. With one thread per lane every launch took about the
// time of one thread's walk, whatever its width (PERF.md, the
// launch-by-launch table). With the group walk below, what remains is
// each lane's own chain: the box tests, the tile's reductions after each
// cluster and the per-bounce physics. At the 65,536-lane launches the
// registers (~126 a thread) hold 512 threads an SM, so a launch runs in
// several waves; the narrow ones last about one lane's chain (2-13% of
// the operation bound, PERF.md).
//
// What the design does about it: a tile of G threads serves one lane, G a
// template parameter of 1, 2, 4, 8, 16 or 32 that the wrapper picks from
// the launch width (kernels/cluster_test.py ``group_size``), so a narrow
// launch still puts lanes x G threads on the card. Both walks of a bounce,
// the closest hit ('full') and the fused distance + NEE walk ('dnee'), are
// the group walks of cluster_test.cuh: the box tests run on every thread
// of the tile on the same values (uniform visits, each box gated against
// the lane's OWN bound instead of the TPU kernel's block-wide minimum: a
// culled box cannot hold a hit that beats the bound), the slots of a
// visited cluster are strided over the tile, and the tile reduces after
// each cluster to exactly the state of the one-thread walk (the
// lexicographic (t, slot) minimum; for the NEE set the exclusive running
// minimum of the opaque hits in slot order and the serial key insertion
// sequence). So every box decision, and the result, is the serial one:
// bit-equal to the plain version for every G. The per-bounce physics
// (Fresnel, free flight, HG, the NEE march, Russian roulette, the RNG
// draws) runs on every thread of the tile from the same values, so its
// branches and draws are uniform and nothing is staged per lane; thread 0
// of the tile writes the lane's state. The lane loop
// `for (it < max_iters && alive) bounce()` leaves a dead lane's tile idle
// beyond its warp's stragglers (the caller compacts the wavefront between
// launches, as on the TPU). Triangle rows are read through the read-only
// path (__ldg); the media table and the light row are staged in shared
// memory; the NEE K-list stays in registers (K is a template parameter,
// every loop over it unrolled). It allocates nothing.
//
// On a grid of many supers the default walks test a level of group boxes
// above the supers (LEVELS, a template parameter that the wrapper sets from
// the grid's super count, kernels/megakernel.py ``two_level_walk``): each
// group box is the bounds of consecutive supers, built once when the grid
// is uploaded, and a group that the lane misses under its bound skips all
// of its supers. On the many-super grid the flat walk slab-tested every
// super box in turn to enter about two. The order is still the index
// order, a group box holds each of its supers' boxes and the slab test is
// monotone in the box (binned_listing.cu says why), so a super of a missed
// group would have been missed under the same bound. The tile's G threads
// test G group, super or cluster boxes at once under the bound as it
// stands, then take the boxes met in order, each tested again under the
// bound as it then stands (``chunked``): every box entered, every hit and
// every state is the flat walk's. The flat instance (LEVELS false) is the
// walk of a grid of a few supers: on a grid of one super the two-level walk
// ran an H100's frames 4-6% slower (PERF.md §6). The ablation instances
// keep the flat walk always.
//
// Each launch counts its walk, always: per lane, the super boxes its two
// walks entered, the cluster boxes they entered and the group boxes they
// entered ('full' and 'dnee'; the ablations' own walks count nothing), in
// registers (every thread of a tile takes the same box decisions, so each
// holds the lane's counts), and its bounces. When a lane ends, thread 0 of
// its tile adds them with those of the warp's other lanes that end together
// to the card's accumulator (the counter block's CNT_WALK, pass_control.cuh),
// which the next control launch moves to its site.
//
// The ablation instances (CMR_MEGA_DEBUG, megakernel.py:398-401 and the
// sites named below of the JAX kernel) are other builds of this source,
// ``-DCMR_MEGA_ABLATE=<mask>`` with a bit per token (kernels/megakernel.py
// ``ABLATIONS``). Every token is a compile-time branch (``if constexpr``),
// so mask 0 is the default instance unchanged and no token costs the
// default a register. They split a bounce's time by its parts:
//   nofuse    the separate 'dist' walk, then the NEE march: an 'occl' walk
//             over the opaque supers and a 'nee' walk over the media
//             supers of a partitioned grid, one 'nee' walk otherwise
//             (JAX :831-874, :1170-1222); the same image as the fused walk;
//   ordered   unfused, nearest first: supers by their entry, clusters of a
//             super likewise, until the nearest entry left lies beyond the
//             bound (JAX :732-751); a hit replaces an equal-t one of a
//             higher slot, so the visit order never shows;
//   carrywalk unfused, the linear walk by one thread a lane with the hit
//             state in its registers and no tile (K1 before the group walk;
//             the JAX token is a state-residency A/B, :707-730): no
//             instance of its own, the nofuse instance launched at G = 1,
//             whose 'nee' walk is then the one-thread test
//             (kernels/megakernel.py ``cuda_instance``);
//   cullonly  every walk keeps its culls, the cluster body is the identity
//             (a max with the box entry, which the cull has already bounded,
//             keeps the walk alive in the compiled code); the fabricated
//             hit at t = 2 + t_walk * 1e-30 (JAX :592-598, :1016-1035);
//   notrace   no closest-hit walk: a fabricated hit (JAX :999-1011);
//   nophys    after the walk, the ray mirrored at the hit (JAX :1037-1047),
//             run in the JAX kernel's lockstep of 1024-lane blocks: every
//             lane of a block gets the unmasked flip, +0.01 and depth + 1 of
//             each of its block's iterations (a second, elementwise launch);
//   nodist    seg_len = t_max, no distance walk (JAX :1191-1192);
//   nonee     li = 1, no NEE walk (JAX :1212-1213).
// Any of nofuse, ordered, nonee and nodist unfuses the walk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -DCMR_NEE_MAX_MEDIA=<n>
// [-DCMR_MEGA_ABLATE=<mask>], one library per (--nee-bound value, mask)
// (the K-list length is a template parameter; large values spill
// registers), with every G instantiated.
// --fmad=false and no --use_fast_math keep every product, 1/x and sqrtf
// IEEE-rounded like the plain PyTorch version it is checked against.

#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_test.cuh"
#include "pass_control.cuh"

#ifndef CMR_NEE_MAX_MEDIA
#error "build with -DCMR_NEE_MAX_MEDIA=<n>"
#endif
#ifndef CMR_MEGA_ABLATE
#define CMR_MEGA_ABLATE 0
#endif

namespace cmr {

constexpr int K_NEE = 2 * CMR_NEE_MAX_MEDIA + 2;  // cluster_test.nee_list_len
constexpr int THREADS = 128;  // threads per block, THREADS / G lanes
constexpr int MAX_MEDIA = 63;
constexpr int DRAWS_PER_BOUNCE = 8;
constexpr int SOBOL_DIMS = 1024;  // rows of the Sobol table (ops/rng.py SOBOL_DIMS)

constexpr float INV_FOURPI = 0.07957747154594767f;
constexpr float LN_CLAMP = 9.210340371976184f;
constexpr float INV_PI = 0.31830988618f;
constexpr float PI_F = 3.14159265359f;
constexpr float TWOPI_F = 6.28318530718f;
constexpr float REFLECTANCE = 0.8f;
constexpr float NO_INTERACTION = 500000.0f;
constexpr float ISO_EPS = 1e-4f;
constexpr float INV_U32 = 1.0f / 4294967295.0f;  // == 2^-32 in float

// The ablation mask (kernels/megakernel.py ``ABLATIONS``).
constexpr int ABLATE = CMR_MEGA_ABLATE;
constexpr bool NOFUSE = ABLATE & 1;
constexpr bool ORDERED = ABLATE & 2;
constexpr bool CULLONLY = ABLATE & 8;
constexpr bool NOTRACE = ABLATE & 16;
constexpr bool NOPHYS = ABLATE & 32;
constexpr bool NODIST = ABLATE & 64;
constexpr bool NONEE = ABLATE & 128;
constexpr bool FUSED = !(NOFUSE || ORDERED || NODIST || NONEE);
constexpr int BLOCK_LANES = 1024;  // the JAX kernel's block: nophys's lockstep unit

struct Params {
  const float* __restrict__ bounds;        // (C, 8)
  const float* __restrict__ super_bounds;  // (S, 8)
  // (NG, 8) group boxes over consecutive supers: lo xyz, hi xyz, the end
  // of the group's supers (as a float), 0; read by the LEVELS walk only.
  const float* __restrict__ group_bounds;
  const float* __restrict__ run_rows;      // (C*subs, row_w)
  const float* __restrict__ media9;        // (M, 9)
  const float* __restrict__ misc;          // (16,)
  const int* __restrict__ sob;             // (1024, 30) Sobol direction numbers
  int dim_base;                            // clipped ld dimension base
  // The pass control block (pass_control.cuh), or null: then every lane of
  // [0, n_lanes) runs with ``dim_base``. Else the run flag, live_blocks and
  // the unclipped ld base come from the card.
  const int* __restrict__ ctrl;
  float* org;
  float* dir;
  float* thr;
  float* rad;
  long long* rng;
  int* depth;
  unsigned char* alive;
  const long long* __restrict__ aux;
  int n_lanes, C, S, NG, subs, run, row_w, M, SF, S_OPQ;
  int background, max_depth, rr_depth, tir_kill, analytic_direct, ld, max_iters;
  int* iters;  // nophys: each lane's iterations, then each 1024-lane block's most
  // K1's walk accumulator (pass_control.cuh CNT_WALK: WALK_LEN int64), or
  // null: the lanes add their bounces, supers entered, clusters tested and
  // groups entered there when they end.
  unsigned long long* walk;
};

// A lane's walk counts: the super boxes its walks entered, the cluster
// boxes they entered (whose slots the tile then tested) and the group boxes
// they entered (LEVELS only). Every thread of the tile takes the same box
// decisions, so each holds the lane's counts.
struct WalkTally {
  unsigned int supers, clusters, groups;
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

// The boxes [lo, hi) of ``boxes`` (8 floats a box) that ``meets`` holds
// under the lane's bound as it stands, visited in index order, G at a time:
// thread j of the tile tests box b0 + j under the bound at the chunk's
// start, and the tile takes the boxes met in order, each tested again under
// the bound as it then stands. The bound only falls during a walk and the
// slab test is monotone in it, so a box the first test misses would be
// missed again: every decision is the one-at-a-time walk's.
template <int G, class Meets, class Visit>
__device__ __forceinline__ void chunked(const cg::thread_block_tile<G>& tile, const float* boxes,
                                        int lo, int hi, Meets meets, Visit visit) {
  for (int b0 = lo; b0 < hi; b0 += G) {
    const int b = b0 + (int)tile.thread_rank();
    unsigned mask = tile.ballot(b < hi && meets(boxes + b * 8));
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1;
      if (meets(boxes + (b0 + k) * 8)) visit(b0 + k);
    }
  }
}

// The boxes [lo, hi) that ``meets`` holds, one at a time in index order.
template <class Meets, class Visit>
__device__ __forceinline__ void in_order(const float* boxes, int lo, int hi, Meets meets,
                                         Visit visit) {
  for (int b = lo; b < hi; ++b) {
    if (meets(boxes + b * 8)) visit(b);
  }
}

// K1's walk in index order: each super box that ``meets`` holds is
// entered, then each of its cluster boxes that ``meets`` holds is tested
// slot by slot (``test(c)``). With LEVELS the group boxes come first and a
// group that ``meets`` misses skips its supers; the group, super and
// cluster boxes are then tested G at a time (``chunked``), which shortens
// each lane's chain of box tests (on an H100 the many-super cell's frames
// ran 4-5% faster than with the group level alone, PERF.md §6).
template <int G, bool LEVELS, class Meets, class Test>
__device__ __forceinline__ void walk_boxes(const cg::thread_block_tile<G>& tile, const Params& p,
                                           Meets meets, Test test, WalkTally& tally) {
  const auto cluster = [&](int c) {
    ++tally.clusters;
    test(c);
  };
  const auto super = [&](int sp) {
    ++tally.supers;
    const int lo = sp * p.SF;
    const int hi = min(lo + p.SF, p.C);
    if constexpr (LEVELS && G > 1) {
      chunked<G>(tile, p.bounds, lo, hi, meets, cluster);
    } else {
      in_order(p.bounds, lo, hi, meets, cluster);
    }
  };
  if constexpr (LEVELS) {
    const auto group = [&](int g) {
      ++tally.groups;
      const int lo = g == 0 ? 0 : (int)__ldg(p.group_bounds + (g - 1) * 8 + 6);
      const int hi = (int)__ldg(p.group_bounds + g * 8 + 6);
      if constexpr (G > 1) {
        chunked<G>(tile, p.super_bounds, lo, hi, meets, super);
      } else {
        in_order(p.super_bounds, lo, hi, meets, super);
      }
    };
    if constexpr (G > 1) {
      chunked<G>(tile, p.group_bounds, 0, p.NG, meets, group);
    } else {
      in_order(p.group_bounds, 0, p.NG, meets, group);
    }
  } else {
    in_order(p.super_bounds, 0, p.S, meets, super);
  }
}

// Closest hit ('full'): the linear (group ->) super -> cluster walk, each
// box gated by the slab entry against the lane's current t_best, each
// visited cluster tested by the tile.
template <int G, bool LEVELS>
__device__ FullState trace_full(const cg::thread_block_tile<G>& tile, const Params& p, V3 o, V3 d,
                                float tmax, WalkTally& tally) {
  const V3 inv{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  const float t0 = box_clamp(p.misc, o, inv, tmax);
  FullState mine{t0, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, -1.0f, 0.0f, 0.0f, 0.0f};
  float t = t0, slot = -1.0f;
  const auto meets = [&](const float* b) {
    return slab_hit(b, o.x, o.y, o.z, inv.x, inv.y, inv.z, t);
  };
  walk_boxes<G, LEVELS>(tile, p, meets, [&](int c) {
    group_cluster_full<G, false>(tile, p.run_rows, p.row_w, p.subs, p.run, c, o.x, o.y, o.z, d.x,
                                 d.y, d.z, t, slot, mine);
  }, tally);
  return group_payload<G>(tile, mine, t, slot);
}

// The fused 'dnee' walk: (t, slot) along set A (da, bound tmax_a, box
// clamped) and the NEE K-list along set B (db, bound tmax_b) from one
// origin. A box (group, super or cluster) is visited when either set still
// needs it under its own bound.
template <int G, int K, bool LEVELS>
__device__ DneeState<K> trace_dnee(const cg::thread_block_tile<G>& tile, const Params& p,
                                   const float* media, V3 o, V3 da, float tmax_a, V3 db,
                                   float tmax_b, WalkTally& tally) {
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
  const auto meets = [&](const float* b) {
    bool visit = false;
    if (need_a) visit = slab_hit(b, o.x, o.y, o.z, ia.x, ia.y, ia.z, st.a.t);
    if (!visit && need_b) {
      visit = slab_hit(b, o.x, o.y, o.z, ib.x, ib.y, ib.z, nee_bound<K>(st.b));
    }
    return visit;
  };
  walk_boxes<G, LEVELS>(tile, p, meets, [&](int c) {
    group_cluster_dnee<G, K>(tile, p.run_rows, p.row_w, p.subs, p.run, c, o.x, o.y, o.z, da.x,
                             da.y, da.z, db.x, db.y, db.z, media, p.M, st);
  }, tally);
  return st;
}

// ------------------------------------------------ the ablation walks --
// Used by the instances built with CMR_MEGA_ABLATE != 0 only: the unfused
// walks 'dist', 'occl' and 'nee', and the 'full' walk in another order,
// with another tester or with the identity body.

// group_cluster_full for a walk out of slot order (ordered): on equal t the
// lower slot wins, so the result is the least (t, slot) whatever the order.
template <int G, class Payload>
__device__ __forceinline__ void group_cluster_lex(const cg::thread_block_tile<G>& tile,
                                                  const Params& p, int c, V3 o, V3 d, float& t,
                                                  float& slot, Payload& mine) {
  float bt = t, bs = slot;
  for (int rr = 0; rr < p.subs; ++rr) {
    const float* row = p.run_rows + (long long)(c * p.subs + rr) * p.row_w;
    const int r_off = (c * p.subs + rr) * p.run;
    for (int j = tile.thread_rank(); j < p.run; j += G) {
      const Slot s = load_slot(row, p.run, j);
      float uu, vv, tt;
      direction_terms(s, origin_terms(s, o.x, o.y, o.z), d.x, d.y, d.z, uu, vv, tt);
      const float sl = (float)(r_off + j);
      if (inside(s, uu, vv) && tt > T_MIN && (tt < bt || (tt == bt && sl < bs))) {
        bt = tt;
        bs = sl;
        set_full(mine, s, uu, vv, tt, sl);
      }
    }
  }
  tile_min_hit<G>(tile, bt, bs);
  t = bt;
  slot = bs;
}

// The 'nee' test of cluster c by one thread, slots in order: the serial
// form of group_cluster_nee<1, K>. At G = 1 the group form's votes and
// shuffles run per slot in a warp whose lanes diverge; on an H100 that
// took showcase's first 65,536-lane nofuse launch at G = 1 from about
// 0.28 to 0.69 ms.
template <int K>
__device__ __forceinline__ void thread_cluster_nee(const Params& p, const float* media, int c,
                                                   V3 o, V3 d, NeeState<K>& st) {
  for (int rr = 0; rr < p.subs; ++rr) {
    const float* row = p.run_rows + (long long)(c * p.subs + rr) * p.row_w;
    for (int j = 0; j < p.run; ++j) {
      const Slot s = load_slot(row, p.run, j);
      float own_opq = __int_as_float(0x7f800000), tb;
      bool media_hit;
      int key;
      nee_terms(s, origin_terms(s, o.x, o.y, o.z), d.x, d.y, d.z, media, p.M, own_opq,
                media_hit, tb, key);
      if (media_hit && tb < st.t_opq) insert_key<K>(st, key);
      st.t_opq = fminf(st.t_opq, own_opq);
    }
  }
}

// The linear walk over supers [s_lo, s_hi): each box gated by its slab
// entry against bound(), visit(c, entry) for each cluster met.
template <class Bound, class Visit>
__device__ __forceinline__ void walk_linear(const Params& p, int s_lo, int s_hi, V3 o, V3 inv,
                                            Bound bound, Visit visit) {
  for (int sp = s_lo; sp < s_hi; ++sp) {
    float tn;
    if (!slab_entry(p.super_bounds + sp * 8, o.x, o.y, o.z, inv.x, inv.y, inv.z, bound(), tn)) {
      continue;
    }
    const int lo = sp * p.SF;
    const int hi = min(lo + p.SF, p.C);
    for (int c = lo; c < hi; ++c) {
      if (!slab_entry(p.bounds + c * 8, o.x, o.y, o.z, inv.x, inv.y, inv.z, bound(), tn)) continue;
      visit(c, tn);
    }
  }
}

// ordered's next box of [lo, hi): the least (entry, index) after (e, i),
// entries against tmax; thread k of the tile scans boxes lo + k, lo + k +
// G, ..., then the tile takes the least. i < 0 when none is left.
template <int G>
__device__ __forceinline__ void next_box(const cg::thread_block_tile<G>& tile,
                                         const float* boxes, int lo, int hi, V3 o, V3 inv,
                                         float tmax, float& e, float& i) {
  float be = __int_as_float(0x7f800000), bi = -1.0f;
  for (int b = lo + tile.thread_rank(); b < hi; b += G) {
    float tn;
    if (!slab_entry(boxes + b * 8, o.x, o.y, o.z, inv.x, inv.y, inv.z, tmax, tn)) continue;
    const float fb = (float)b;
    if ((tn > e || (tn == e && fb > i)) && (tn < be || (tn == be && fb < bi))) {
      be = tn;
      bi = fb;
    }
  }
  tile_min_hit<G>(tile, be, bi);
  e = be;
  i = bi;
}

// The nearest-first walk (megakernel.py:732-751): supers by their entry
// against tmax0, the clusters of each by their entry against the bound at
// the super's visit. A box is visited while its entry is at most the bound
// (a hit at the bound itself may still win on its slot).
template <int G, class Bound, class Visit>
__device__ __forceinline__ void walk_ordered(const cg::thread_block_tile<G>& tile,
                                             const Params& p, int s_lo, int s_hi, V3 o, V3 inv,
                                             float tmax0, Bound bound, Visit visit) {
  float es = -1.0f, is = -1.0f;
  for (;;) {
    next_box<G>(tile, p.super_bounds, s_lo, s_hi, o, inv, tmax0, es, is);
    if (is < 0.0f || es > bound()) return;
    const int lo = (int)is * p.SF;
    const int hi = min(lo + p.SF, p.C);
    const float tc = bound();
    float ec = -1.0f, ic = -1.0f;
    for (;;) {
      next_box<G>(tile, p.bounds, lo, hi, o, inv, tc, ec, ic);
      if (ic < 0.0f || ec > bound()) break;
      visit((int)ic, ec);
    }
  }
}

template <int G, class Bound, class Visit>
__device__ __forceinline__ void walk(const cg::thread_block_tile<G>& tile, const Params& p,
                                     int s_lo, int s_hi, V3 o, V3 inv, float tmax0, Bound bound,
                                     Visit visit) {
  if constexpr (ORDERED) {
    walk_ordered<G>(tile, p, s_lo, s_hi, o, inv, tmax0, bound, visit);
  } else {
    walk_linear(p, s_lo, s_hi, o, inv, bound, visit);
  }
}

// The closest hit below t over supers [s_lo, s_hi) into (t, slot) and, for
// a FullState payload, the thread's own hit in ``mine``.
template <int G, class Payload>
__device__ __forceinline__ void abl_closest(const cg::thread_block_tile<G>& tile, const Params& p,
                                            int s_lo, int s_hi, V3 o, V3 d, float& t,
                                            float& slot, Payload& mine) {
  if (!(t > T_MIN)) return;  // such a bound accepts nothing
  const V3 inv{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  walk<G>(tile, p, s_lo, s_hi, o, inv, t, [&] { return t; }, [&](int c, float tn) {
    if constexpr (CULLONLY) {
      t = fmaxf(t, tn);  // tn <= t: the identity
    } else if constexpr (ORDERED) {
      group_cluster_lex<G>(tile, p, c, o, d, t, slot, mine);
    } else {
      group_cluster_full<G, false>(tile, p.run_rows, p.row_w, p.subs, p.run, c, o.x, o.y, o.z,
                                   d.x, d.y, d.z, t, slot, mine);
    }
  });
}

// 'full' of the ablation instances (the scene-box clamped bound).
template <int G>
__device__ FullState abl_full(const cg::thread_block_tile<G>& tile, const Params& p, V3 o, V3 d,
                              float tmax) {
  const V3 inv{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  const float t0 = box_clamp(p.misc, o, inv, tmax);
  FullState mine{t0, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, -1.0f, 0.0f, 0.0f, 0.0f};
  float t = t0, slot = -1.0f;
  abl_closest<G>(tile, p, 0, p.S, o, d, t, slot, mine);
  return group_payload<G>(tile, mine, t, slot);
}

// The unfused 'dist' walk: the distance to the next boundary, t_max on a miss.
template <int G>
__device__ float abl_seg_len(const cg::thread_block_tile<G>& tile, const Params& p, V3 o, V3 d,
                             float tmax) {
  const V3 inv{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float t = box_clamp(p.misc, o, inv, tmax), slot = -1.0f;
  NoPayload none;
  abl_closest<G>(tile, p, 0, p.S, o, d, t, slot, none);
  return slot >= 0.0f ? t : T_MAX;
}

// 'nee' over supers [s_lo, s_hi): the K nearest media keys and t_opq.
template <int G, int K>
__device__ NeeState<K> abl_nee(const cg::thread_block_tile<G>& tile, const Params& p,
                               const float* media, int s_lo, int s_hi, V3 o, V3 d, float tmax) {
  NeeState<K> st;
#pragma unroll
  for (int i = 0; i < K; ++i) st.key[i] = KEY_EMPTY;
  st.t_opq = tmax;
  if (!(tmax > T_MIN)) return st;
  const V3 inv{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  walk<G>(tile, p, s_lo, s_hi, o, inv, tmax, [&] { return nee_bound<K>(st); },
          [&](int c, float tn) {
            if constexpr (CULLONLY) {
              st.t_opq = fmaxf(st.t_opq, tn);  // tn <= t_opq: the identity
            } else if constexpr (G == 1) {
              thread_cluster_nee<K>(p, media, c, o, d, st);
            } else {
              group_cluster_nee<G, K>(tile, p.run_rows, p.row_w, p.subs, p.run, c, o.x, o.y,
                                      o.z, d.x, d.y, d.z, media, p.M, st);
            }
          });
  return st;
}

// cullonly's fused walk: trace_dnee's culls with the identity body.
template <int K>
__device__ DneeState<K> cull_dnee(const Params& p, V3 o, V3 da, float tmax_a, V3 db,
                                  float tmax_b) {
  const V3 ia{safe_inv(da.x), safe_inv(da.y), safe_inv(da.z)};
  const V3 ib{safe_inv(db.x), safe_inv(db.y), safe_inv(db.z)};
  DneeState<K> st;
  st.a.t = box_clamp(p.misc, o, ia, tmax_a);
  st.a.slot = -1.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) st.b.key[i] = KEY_EMPTY;
  st.b.t_opq = tmax_b;
  const bool need_a = st.a.t > T_MIN;
  const bool need_b = tmax_b > T_MIN;
  if (!need_a && !need_b) return st;
  // A box is met when either set meets it; the max with that set's entry
  // (at most its bound) changes nothing.
  auto meet = [&](const float* b) {
    float tn;
    if (need_a && slab_entry(b, o.x, o.y, o.z, ia.x, ia.y, ia.z, st.a.t, tn)) {
      st.a.t = fmaxf(st.a.t, tn);
      return true;
    }
    if (need_b && slab_entry(b, o.x, o.y, o.z, ib.x, ib.y, ib.z, st.b.t_opq, tn)) {
      st.b.t_opq = fmaxf(st.b.t_opq, tn);
      return true;
    }
    return false;
  };
  for (int sp = 0; sp < p.S; ++sp) {
    if (!meet(p.super_bounds + sp * 8)) continue;
    const int lo = sp * p.SF;
    const int hi = min(lo + p.SF, p.C);
    for (int c = lo; c < hi; ++c) meet(p.bounds + c * 8);
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

// The unfused NEE march (megakernel.py nee_march :831-874): on a
// partitioned grid an 'occl' walk over the opaque supers [0, S_OPQ) and a
// 'nee' walk over the media supers, one 'nee' walk otherwise.
template <int G, int K>
__device__ V3 nee_march(const cg::thread_block_tile<G>& tile, const Params& p, const float* media,
                        const float* misc, V3 pt, bool active) {
  const Light lt = nee_setup(misc, pt, active);
  NeeState<K> hits;
  if (p.S_OPQ > 0) {
    float t_op = lt.eff, slot = -1.0f;
    NoPayload none;
    abl_closest<G>(tile, p, 0, p.S_OPQ, pt, lt.dir, t_op, slot, none);
    hits = abl_nee<G, K>(tile, p, media, p.S_OPQ, p.S, pt, lt.dir, lt.eff);
    hits.t_opq = fminf(t_op, hits.t_opq);
  } else {
    hits = abl_nee<G, K>(tile, p, media, 0, p.S, pt, lt.dir, lt.eff);
  }
  return nee_resolve<K>(hits, lt, active, media, p.M, CMR_NEE_MAX_MEDIA);
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

// The closest hit of a bounce: the 'full' walk, or an ablation's.
template <int G, bool LEVELS>
__device__ __forceinline__ FullState first_hit(const cg::thread_block_tile<G>& tile,
                                               const Params& p, const Lane& L,
                                               WalkTally& tally) {
  if constexpr (NOTRACE || CULLONLY) {
    float t = 2.0f;
    if constexpr (!NOTRACE) t = 2.0f + abl_full<G>(tile, p, L.o, L.d, T_MAX).t * 1e-30f;
    return FullState{t, 0.0f, 0.3f, 0.3f, 0.0f, 1.0f, 0.0f, 0.0f,
                     L.o.x + t * L.d.x, L.o.y + t * L.d.y, L.o.z + t * L.d.z};
  } else if constexpr (ORDERED) {
    return abl_full<G>(tile, p, L.o, L.d, T_MAX);
  } else {
    return trace_full<G, LEVELS>(tile, p, L.o, L.d, T_MAX, tally);
  }
}

// One bounce iteration of a live lane (megakernel.py bounce :992-1370,
// the default fused walk), on every thread of the lane's tile; the walks'
// box visits counted in ``tally``.
template <int G, int K, bool LEVELS>
__device__ void bounce(const cg::thread_block_tile<G>& tile, const Params& p, const float* media,
                       const float* misc, Lane& L, Rng& rng, WalkTally& tally) {
  const Params& P = p;  // NOLINT: short name for the launch parameters
  const FullState h = first_hit<G, LEVELS>(tile, P, L, tally);
  const bool got_hit = h.slot >= 0.0f;  // the lane is alive
  if constexpr (NOPHYS) {  // mirror the ray at the hit
    if (got_hit) L.o = V3{h.px, h.py, h.pz};
    L.d = V3{-L.d.x, -L.d.y, -L.d.z};
    L.ra.x = L.ra.x + 0.01f;
    L.depth += 1;
    L.alive = got_hit && (L.depth < P.max_depth);
    return;
  }
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
  DneeState<K> dn;
  float seg_len;
  if constexpr (FUSED) {
    if constexpr (CULLONLY) {
      dn = cull_dnee<K>(P, pt, da, transmitted ? bound : 0.0f, lt.dir, lt.eff);
    } else {
      dn = trace_dnee<G, K, LEVELS>(tile, P, media, pt, da, transmitted ? bound : 0.0f, lt.dir,
                                    lt.eff, tally);
    }
    seg_len = dn.a.slot >= 0.0f ? dn.a.t : T_MAX;
  } else if constexpr (NODIST) {
    seg_len = T_MAX;
  } else {
    seg_len = abl_seg_len<G>(tile, P, pt, da, transmitted ? bound : 0.0f);
  }

  // free-flight sampling (volpath:691)
  const Flight fl = sample_distance(rand_d, med, seg_len);
  bool scatter = transmitted && fl.success;
  if (P.tir_kill) scatter = scatter && !b1.tir;
  const bool pass_med = transmitted && !scatter;

  // NEE (no RNG draws)
  V3 li;
  if constexpr (NONEE) {
    li = V3{1.0f, 1.0f, 1.0f};
  } else if constexpr (FUSED) {
    li = nee_resolve<K>(dn.b, lt, light_active, media, P.M, CMR_NEE_MAX_MEDIA);
  } else {
    li = nee_march<G, K>(tile, P, media, misc, pt, (P.analytic_direct ? ad_gate : scatter) || shade);
  }
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

template <int K, int G, bool LEVELS>
__global__ void __launch_bounds__(THREADS) megakernel(Params p) {
  // The launch covers the static width n_lanes. With a control block, a CTA
  // at or beyond live_blocks * 1024 lanes returns at once, and every CTA
  // does when the run flag is 0: their lanes keep their state, as the TPU
  // kernel's blocks beyond live_blocks do (megakernel.py :1589-1609). The
  // ld base is clipped here as the JAX wrapper clips it (:1548-1552).
  int n_lanes = p.n_lanes;
  int dim_base = p.dim_base;
  if (p.ctrl != nullptr) {
    if (p.ctrl[CTRL_RUN] == 0) return;
    n_lanes = min(n_lanes, max(p.ctrl[CTRL_LIVE], 0) * CTRL_BLOCK_LANES);
    if (p.ld) {
      dim_base = min(max(p.ctrl[CTRL_DIM0], 0), SOBOL_DIMS - p.max_iters * DRAWS_PER_BOUNCE);
    }
  }
  if ((int)(blockIdx.x * (THREADS / G)) >= n_lanes) return;  // the whole CTA
  __shared__ float s_media[MAX_MEDIA * 9];
  __shared__ float s_misc[16];
  for (int i = threadIdx.x; i < p.M * 9; i += blockDim.x) s_media[i] = p.media9[i];
  if (threadIdx.x < 16) s_misc[threadIdx.x] = p.misc[threadIdx.x];
  __syncthreads();

  const cg::thread_block_tile<G> tile = cg::tiled_partition<G>(cg::this_thread_block());
  const int lane = (blockIdx.x * THREADS + threadIdx.x) / G;
  if (lane >= n_lanes) return;  // the whole tile
  Lane L;
  L.alive = p.alive[lane] != 0;
  if (!L.alive) return;  // a dead lane never changes
  L.o = V3{p.org[3 * lane], p.org[3 * lane + 1], p.org[3 * lane + 2]};
  L.d = V3{p.dir[3 * lane], p.dir[3 * lane + 1], p.dir[3 * lane + 2]};
  L.th = V3{p.thr[3 * lane], p.thr[3 * lane + 1], p.thr[3 * lane + 2]};
  L.ra = V3{p.rad[3 * lane], p.rad[3 * lane + 1], p.rad[3 * lane + 2]};
  L.depth = p.depth[lane];
  [[maybe_unused]] const int depth0 = L.depth;
  Rng rng;
  rng.state = (uint32_t)p.rng[lane];
  rng.ph = (uint32_t)p.aux[lane];
  rng.ld = p.ld != 0;
  rng.sob = p.sob;
  rng.dim_base = dim_base;

  // A lane's k-th iteration is the block loop's k-th (the draws of dead
  // lanes are masked and ld dims advance in lockstep), so the per-lane
  // loop equals the TPU kernel's per-block while_loop.
  WalkTally tally{0u, 0u, 0u};
  int it = 0;
  for (; it < p.max_iters && L.alive; ++it) {
    rng.it = it;
    bounce<G, K, LEVELS>(tile, p, s_media, s_misc, L, rng, tally);
  }

  if (tile.thread_rank() != 0) return;
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
  if constexpr (NOPHYS) {  // depth grows by one an iteration
    p.iters[lane] = L.depth - depth0;
    atomicMax(p.iters + p.n_lanes + lane / BLOCK_LANES, L.depth - depth0);
  }
  if (p.walk != nullptr) {
    // The lanes of a warp that end here together add their counts once.
    // No CTA barrier and no shared-memory add in the walks: on an H100 the
    // barrier cost launches run to the end up to 8%, and the adds up to 31%
    // on a grid of 172 supers (PERF.md).
    const cg::coalesced_group ends = cg::coalesced_threads();
    const unsigned int bounces = cg::reduce(ends, (unsigned int)it, cg::plus<unsigned int>());
    const unsigned int supers = cg::reduce(ends, tally.supers, cg::plus<unsigned int>());
    const unsigned int clusters = cg::reduce(ends, tally.clusters, cg::plus<unsigned int>());
    if (ends.thread_rank() == 0) {
      atomicAdd(p.walk + WALK_BOUNCES, (unsigned long long)bounces);
      atomicAdd(p.walk + WALK_SUPERS, (unsigned long long)supers);
      atomicAdd(p.walk + WALK_CLUSTERS, (unsigned long long)clusters);
    }
    if constexpr (LEVELS) {
      const unsigned int groups = cg::reduce(ends, tally.groups, cg::plus<unsigned int>());
      if (ends.thread_rank() == 0) atomicAdd(p.walk + WALK_GROUPS, (unsigned long long)groups);
    }
  }
}

#if CMR_MEGA_ABLATE & 32
// nophys, after the megakernel: each lane runs the iterations its 1024-lane
// block ran beyond its own (the JAX kernel's lockstep, megakernel.py
// :1386-1394; a dead lane of a live block, too): the unmasked flip, +0.01
// added once an iteration, depth + 1.
__global__ void __launch_bounds__(THREADS) nophys_block_tail(Params p) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= p.n_lanes) return;
  const int extra = p.iters[p.n_lanes + lane / BLOCK_LANES] - p.iters[lane];
  if (extra <= 0) return;
  float dx = p.dir[3 * lane], dy = p.dir[3 * lane + 1], dz = p.dir[3 * lane + 2];
  float ra = p.rad[3 * lane];
  for (int k = 0; k < extra; ++k) {
    dx = -dx;
    dy = -dy;
    dz = -dz;
    ra = ra + 0.01f;
  }
  p.dir[3 * lane] = dx;
  p.dir[3 * lane + 1] = dy;
  p.dir[3 * lane + 2] = dz;
  p.rad[3 * lane] = ra;
  p.depth[lane] += extra;
}
#endif

template <int G, bool LEVELS>
int launch(const Params& p, cudaStream_t stream) {
  const long long threads = (long long)p.n_lanes * G;
  const int blocks = (int)((threads + THREADS - 1) / THREADS);
#if CMR_MEGA_ABLATE & 32
  // nophys: the per-lane and per-block iteration counts start at 0.
  const size_t words = (size_t)p.n_lanes + (p.n_lanes + BLOCK_LANES - 1) / BLOCK_LANES;
  const cudaError_t zero = cudaMemsetAsync(p.iters, 0, words * sizeof(int), stream);
  if (zero != cudaSuccess) return (int)zero;
#endif
  megakernel<K_NEE, G, LEVELS><<<blocks, THREADS, 0, stream>>>(p);
#if CMR_MEGA_ABLATE & 32
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  nophys_block_tail<<<(p.n_lanes + THREADS - 1) / THREADS, THREADS, 0, stream>>>(p);
#endif
  return (int)cudaGetLastError();
}

// The instance of G and LEVELS; the ablation instances have the flat walk
// alone.
template <int G>
int launch_levels(const Params& p, cudaStream_t stream) {
  if constexpr (ABLATE == 0) {
    if (p.group_bounds != nullptr) return launch<G, true>(p, stream);
  }
  return launch<G, false>(p, stream);
}

}  // namespace cmr

extern "C" {

// Launch on ``stream`` with ``group`` threads per lane (1, 2, 4, 8, 16 or
// 32); returns cudaGetLastError() right after the launch.
// ``group_bounds``: the grid's ``n_groups`` group boxes, for the two-level
// walk, or null for the flat walk (which the ablation instances take either
// way). ``ctrl``: the pass control block (CTRL_LEN int32 on the card) or
// null. ``iters`` (nophys only, else null): n_lanes + one int a 1024-lane
// block, which the launch zeroes first. ``walk``: WALK_LEN int64 on the
// card that the launch adds its walk counts to (the counter block's
// CNT_WALK), or null.
int cmr_megakernel_launch(const float* bounds, const float* super_bounds,
                          const float* group_bounds, const float* run_rows, const float* media9,
                          const float* misc, const int* sob, int dim_base, const int* ctrl,
                          float* org, float* dir, float* thr, float* rad, long long* rng,
                          int* depth, unsigned char* alive, const long long* aux, int n_lanes,
                          int C, int S, int n_groups, int subs, int run, int row_w, int M, int SF,
                          int s_opq,
                          int background, int max_depth, int rr_depth, int tir_kill,
                          int analytic_direct, int ld, int max_iters, int group, int* iters,
                          long long* walk, void* stream) {
  const cmr::Params p{bounds, super_bounds, group_bounds, run_rows, media9, misc, sob, dim_base,
                      ctrl, org, dir, thr, rad, rng, depth, alive, aux,
                      n_lanes, C, S, n_groups, subs, run, row_w, M, SF, s_opq,
                      background, max_depth, rr_depth, tir_kill, analytic_direct, ld, max_iters,
                      iters, reinterpret_cast<unsigned long long*>(walk)};
  const cudaStream_t s = (cudaStream_t)stream;
  if (cmr::NOPHYS && iters == nullptr) return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1: return cmr::launch_levels<1>(p, s);
    case 2: return cmr::launch_levels<2>(p, s);
    case 4: return cmr::launch_levels<4>(p, s);
    case 8: return cmr::launch_levels<8>(p, s);
    case 16: return cmr::launch_levels<16>(p, s);
    case 32: return cmr::launch_levels<32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int cmr_megakernel_k_nee() { return cmr::K_NEE; }

int cmr_megakernel_ablate() { return cmr::ABLATE; }

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
