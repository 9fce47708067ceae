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
// repeats a cluster nor skips a dropped tie. Keys are unique, so the
// output is a set: it does not depend on the order of the visit.
//
// What bounds it on this card: operations. A lane reads 9 words and writes
// L + 1; an exact listing must test at least the boxes of the clusters
// whose key ends at or below the lane's final tlim, and the supers that
// hold them (25 f32 operations each); the boxes (32 bytes each) stay in
// L1 and L2. At the main path's widths the launch itself costs more than
// that work on a scene of a few clusters.
//
// Two variants, both built into every library; the wrapper takes 0 on a
// grid of a few supers (a tile has too little to share or cull there) and
// on a grid of more than MAX_SUPERS supers (variant 1 holds the super
// boxes in shared memory; variant 0 takes any count), and 1 elsewhere
// (binned_trace.listing_split):
//
// 0: the first port (one thread per lane, 128-thread CTAs): every super in
//    index order, every cluster of a super the ray meets, each key above
//    t_lo through the L-step chain. The TPU kernel gates a super for a
//    whole 1024-lane block (any lane meets it) and skips a block whose
//    lanes are all resolved; here both gates are per lane. A cluster box
//    lies inside its super box and the slab arithmetic is monotone in the
//    box, so a lane that misses a super misses each of its clusters, and a
//    resolved lane (t_lo = EMPTY) lists nothing either way.
//
// 1: the tile walk (LIST_CTA-thread CTAs over ``span`` lanes each):
//    - the CTA compacts its listing lanes (a block prefix over
//      t_lo != EMPTY) and serves each with a tile of G threads, G the
//      largest power of two (at most 32, and at most the grid's supers)
//      with live lanes x G <= LIST_CTA, so a sparse relist spreads its few
//      live lanes over whole tiles;
//    - the super boxes sit in shared memory, loaded once per CTA, and so
//      do group boxes, each the bounds of GROUP_SUPERS consecutive supers,
//      which the CTA builds there: a level above the supers, so a lane no
//      longer tests every super;
//    - the warp walks the group boxes in chunks of G, then the supers of
//      the groups its tiles need, then their clusters: thread j of a tile
//      tests box base + j, a ballot gives each tile its needed boxes and
//      the warp their union, and the warp walks the union together, thread
//      j of every tile the clusters j, j + G, ... of a super, so each
//      cluster box is one load shared by the warp's tiles and a tile that
//      does not need the box is predicated off;
//    - two culls by the L-th key: a cluster key at or above it is dropped
//      before the chain, and a group or super whose masked entry lies
//      strictly above its masked field is skipped. The bound is the least
//      L-th key of the tile's threads at the chunk's start, then the
//      thread's own: each is the L-th of L keys the tile holds, so no key
//      at or above it can be among the tile's L smallest. A cluster box
//      inside its super box (and a super box inside its group's) enters
//      no earlier than the box around it (the slab arithmetic is monotone
//      in the box, and clearing the id bits is monotone too), so each key
//      under a culled box lies above the bound; an equal masked entry is
//      not culled (a smaller id may still enter);
//    - each thread keeps the L smallest keys of its own clusters; L rounds
//      of a tile minimum then merge them: the L smallest of the union of
//      the per-thread sets are the L smallest keys overall.
//    The key set is that of variant 0 on every lane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC -DCMR_LIST_LEN=L.

#include <cuda_runtime.h>

#include "binned_common.cuh"

#ifndef CMR_LIST_LEN
#error "build with -DCMR_LIST_LEN=<list length>"
#endif

namespace cmr {

constexpr int LIST_THREADS = 128;  // variant 0: one lane a thread
constexpr int LIST_CTA = 256;      // variant 1: threads of a CTA
constexpr int MAX_SUPERS = 1024;   // the super boxes of a CTA: 32 KB of shared memory
constexpr int GROUP_SUPERS = 8;    // variant 1: supers of a group box, the walk's top level

struct ListingParams {
  const float* __restrict__ bounds;        // (C, 8)
  const float* __restrict__ super_bounds;  // (S, 8)
  const float* __restrict__ rays;          // (6, n): ox, oy, oz, dx, dy, dz
  const float* __restrict__ bound;         // (n,) walk bound
  const int* __restrict__ tlo;             // (n,) strict lower key; EMPTY = resolved
  int* keys;                               // (L, n)
  int* tlim;                               // (n,)
  int n, C, S, SF;
  int span;   // variant 1: lanes of a CTA
  int group;  // variant 1: threads per lane; 0 = chosen per CTA from its listing lanes
};

template <int L>
__device__ __forceinline__ void insert_key(int (&slots)[L], int key) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int s = slots[i];
    slots[i] = min(key, s);
    key = max(key, s);
  }
}

// ------------------------------------------------------------ variant 0 --

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
        const int key = (__float_as_int(tn) & ~ID_MASK) | c;
        if (key <= tlo) continue;
        insert_key<L>(slots, key);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) p.keys[(long long)i * n + lane] = slots[i];
  p.tlim[lane] = slots[L - 1];
}

// ------------------------------------------------------------ variant 1 --

// slab_entry (cluster_test.cuh) on a box row held as two float4: (min x,
// min y, min z, max x) and (max y, max z, pad, pad); the same operations in
// the same order.
__device__ __forceinline__ bool box_entry(float4 a, float4 b, float ox, float oy, float oz,
                                          float ix, float iy, float iz, float tmax, float& tn_out) {
  float s0 = (a.x - ox) * ix;
  float s1 = (a.w - ox) * ix;
  float tn = fminf(s0, s1);
  float tf = fmaxf(s0, s1);
  s0 = (a.y - oy) * iy;
  s1 = (b.x - oy) * iy;
  tn = fmaxf(tn, fminf(s0, s1));
  tf = fminf(tf, fmaxf(s0, s1));
  s0 = (a.z - oz) * iz;
  s1 = (b.y - oz) * iz;
  tn = fmaxf(tn, fminf(s0, s1));
  tf = fminf(tf, fmaxf(s0, s1));
  tn = fmaxf(tn, T_MIN);
  tf = fminf(tf, tmax);
  tn_out = tn;
  return tn <= tf;
}

template <int G>
__device__ __forceinline__ int tile_min_key(const cg::thread_block_tile<G>& tile, int v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v = min(v, tile.shfl_xor(v, off));
  return v;
}

// Threads per lane of a CTA holding ``live`` listing lanes of a grid of S
// supers (cluster_test.listing_group).
__device__ __forceinline__ int listing_group(int live, int S) {
  int g = 32;
  while (g > 1 && (live * g > LIST_CTA || g > S)) g >>= 1;
  return g;
}

// A CTA's listing lanes, compacted in lane order: the lane, its t_lo and
// its ray with the slab inverses, in shared memory.
struct LiveLanes {
  int lane[LIST_CTA], tlo[LIST_CTA];
  float ox[LIST_CTA], oy[LIST_CTA], oz[LIST_CTA];
  float ix[LIST_CTA], iy[LIST_CTA], iz[LIST_CTA], bnd[LIST_CTA];
};

struct ListRay {
  float ox, oy, oz, ix, iy, iz, bnd;
};

// One vote of the walk: thread j of each tile tests box ``i`` (two float4
// rows of ``box``) where ``want`` and i < end, and needs it when the ray
// meets it and its masked entry is not above lim's (the cull). ``mine``:
// the tile's G needs; ``uni``: the union of every tile's in the warp.
template <int G>
__device__ __forceinline__ void vote(const float4* box, int i, int end, bool want,
                                     const ListRay& r, int lim, unsigned& mine, unsigned& uni) {
  bool need = false;
  if (want && i < end) {
    float tn;
    need = box_entry(box[2 * i], box[2 * i + 1], r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, r.bnd, tn) &&
           (__float_as_int(tn) & ~ID_MASK) <= (lim & ~ID_MASK);
  }
  const unsigned v = __ballot_sync(0xffffffffu, need);
  const int seg = (threadIdx.x & 31) / G * G;  // the tile's G bits of the ballot
  const unsigned seg_mask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  mine = (v >> seg) & seg_mask;
  uni = v;
#pragma unroll
  for (int s = 16; s >= G; s >>= 1) uni |= uni >> s;
  uni &= seg_mask;
}

// The CTA's ``live`` listing lanes, a tile of G threads each, over the
// ``ng`` group boxes ``grp`` and the super boxes ``sup`` in shared memory;
// the warps whose tiles hold no lane leave at once. Every loop bound below
// is warp-uniform, so the ballots and tile minima meet every thread.
template <int L, int G>
__device__ __forceinline__ void tile_walk(const ListingParams& p, const float4* sup,
                                          const float4* grp, int ng, const LiveLanes& ll,
                                          int live) {
  const int t = threadIdx.x;
  if ((t & ~31) / G >= live) return;  // warp-uniform
  const cg::thread_block_tile<G> tile = cg::tiled_partition<G>(cg::this_thread_block());
  const int j = tile.thread_rank();
  const int me = t / G;
  const bool has = me < live;
  const int q = has ? me : 0;
  const ListRay r{ll.ox[q], ll.oy[q], ll.oz[q], ll.ix[q], ll.iy[q], ll.iz[q], ll.bnd[q]};
  const int tlo = ll.tlo[q];
  int slots[L];
#pragma unroll
  for (int i = 0; i < L; ++i) slots[i] = KEY_EMPTY;
  const float4* boxes = reinterpret_cast<const float4*>(p.bounds);
  for (int gb = 0; gb < ng; gb += G) {
    unsigned gmine, guni;
    vote<G>(grp, gb + j, ng, has, r, tile_min_key<G>(tile, slots[L - 1]), gmine, guni);
    while (guni) {  // the union's groups in order
      const int gbit = __ffs(guni) - 1;
      guni &= guni - 1u;
      const bool gwant = (gmine >> gbit) & 1u;
      const int s0 = (gb + gbit) * GROUP_SUPERS;
      const int s1 = min(s0 + GROUP_SUPERS, p.S);
      for (int base = s0; base < s1; base += G) {
        int lim = tile_min_key<G>(tile, slots[L - 1]);
        unsigned mine, uni;
        vote<G>(sup, base + j, s1, gwant, r, lim, mine, uni);
        while (uni) {  // the union's supers in order
          const int bit = __ffs(uni) - 1;
          uni &= uni - 1u;
          if (!((mine >> bit) & 1u)) continue;
          const int lo = (base + bit) * p.SF;
          const int hi = min(lo + p.SF, p.C);
          for (int c = lo + j; c < hi; c += G) {
            float tn;
            if (!box_entry(__ldg(boxes + 2 * c), __ldg(boxes + 2 * c + 1), r.ox, r.oy, r.oz, r.ix,
                           r.iy, r.iz, r.bnd, tn))
              continue;
            const int key = (__float_as_int(tn) & ~ID_MASK) | c;
            if (key <= tlo || key >= lim) continue;
            insert_key<L>(slots, key);
            lim = min(lim, slots[L - 1]);
          }
        }
      }
    }
  }
  if (!has) return;  // tile-uniform
  const int n = p.n;
  const int lane = ll.lane[q];
  if constexpr (G == 1) {
#pragma unroll
    for (int i = 0; i < L; ++i) p.keys[(long long)i * n + lane] = slots[i];
    p.tlim[lane] = slots[L - 1];
  } else {
    // L rounds: the tile's least head is the next key; its owner pops it
    // (keys are unique; an EMPTY head pops EMPTY on every thread).
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int m = tile_min_key<G>(tile, slots[0]);
      if (j == i % G) p.keys[(long long)i * n + lane] = m;
      if (i == L - 1 && j == 0) p.tlim[lane] = m;
      const bool pop = slots[0] == m;
#pragma unroll
      for (int k = 0; k + 1 < L; ++k) slots[k] = pop ? slots[k + 1] : slots[k];
      slots[L - 1] = pop ? KEY_EMPTY : slots[L - 1];
    }
  }
}

template <int L>
__global__ void __launch_bounds__(LIST_CTA, 4) binned_listing_tile(ListingParams p) {
  extern __shared__ float4 sup[];  // (S, 2) super boxes, then (ng, 2) group boxes
  __shared__ LiveLanes ll;
  __shared__ int warp_live[LIST_CTA / 32];
  const int t = threadIdx.x;
  const int n = p.n;
  // Each of the CTA's lanes reads its t_lo and, when it lists, its ray;
  // the resolved lanes' outputs are written here. The super boxes go to
  // shared memory meanwhile.
  const int lane = blockIdx.x * p.span + t;
  int tlo = KEY_EMPTY;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, ix = 0.0f, iy = 0.0f, iz = 0.0f, bnd = 0.0f;
  if (t < p.span && lane < n) {
    tlo = __ldg(p.tlo + lane);
    if (tlo != KEY_EMPTY) {
      ox = __ldg(p.rays + lane);
      oy = __ldg(p.rays + n + lane);
      oz = __ldg(p.rays + 2 * n + lane);
      ix = slab_inv(__ldg(p.rays + 3 * n + lane));
      iy = slab_inv(__ldg(p.rays + 4 * n + lane));
      iz = slab_inv(__ldg(p.rays + 5 * n + lane));
      bnd = __ldg(p.bound + lane);
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) p.keys[(long long)i * n + lane] = KEY_EMPTY;
      p.tlim[lane] = KEY_EMPTY;
    }
  }
  const float4* src = reinterpret_cast<const float4*>(p.super_bounds);
  for (int i = t; i < 2 * p.S; i += LIST_CTA) sup[i] = __ldg(src + i);
  const bool live = tlo != KEY_EMPTY;
  const unsigned vote_live = __ballot_sync(0xffffffffu, live);
  if ((t & 31) == 0) warp_live[t >> 5] = __popc(vote_live);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < LIST_CTA / 32; ++w) {
    const int c = warp_live[w];
    before += w < (t >> 5) ? c : 0;
    total += c;
  }
  if (total == 0) return;  // CTA-uniform
  if (live) {
    const int at = before + __popc(vote_live & ((1u << (t & 31)) - 1u));
    ll.lane[at] = lane;
    ll.tlo[at] = tlo;
    ll.ox[at] = ox;
    ll.oy[at] = oy;
    ll.oz[at] = oz;
    ll.ix[at] = ix;
    ll.iy[at] = iy;
    ll.iz[at] = iz;
    ll.bnd[at] = bnd;
  }
  // The group boxes: each the bounds of GROUP_SUPERS consecutive supers,
  // so a ray that misses one misses each of its supers, and meets none
  // earlier than the group (the super cull's argument, one level up).
  const int ng = (p.S + GROUP_SUPERS - 1) / GROUP_SUPERS;
  float4* grp = sup + 2 * p.S;
  for (int k = t; k < ng; k += LIST_CTA) {
    float4 a = sup[2 * k * GROUP_SUPERS], b = sup[2 * k * GROUP_SUPERS + 1];
    for (int sp = k * GROUP_SUPERS + 1; sp < min((k + 1) * GROUP_SUPERS, p.S); ++sp) {
      const float4 c = sup[2 * sp], d = sup[2 * sp + 1];
      a.x = fminf(a.x, c.x);
      a.y = fminf(a.y, c.y);
      a.z = fminf(a.z, c.z);
      a.w = fmaxf(a.w, c.w);
      b.x = fmaxf(b.x, d.x);
      b.y = fmaxf(b.y, d.y);
    }
    grp[2 * k] = a;
    grp[2 * k + 1] = b;
  }
  __syncthreads();
  switch (p.group ? p.group : listing_group(total, p.S)) {
    case 1: tile_walk<L, 1>(p, sup, grp, ng, ll, total); break;
    case 2: tile_walk<L, 2>(p, sup, grp, ng, ll, total); break;
    case 4: tile_walk<L, 4>(p, sup, grp, ng, ll, total); break;
    case 8: tile_walk<L, 8>(p, sup, grp, ng, ll, total); break;
    case 16: tile_walk<L, 16>(p, sup, grp, ng, ll, total); break;
    default: tile_walk<L, 32>(p, sup, grp, ng, ll, total); break;
  }
}

// The launch floor: an empty kernel on K4's grid.
__global__ void binned_listing_empty() {}

}  // namespace cmr

extern "C" {

int cmr_list_len() { return CMR_LIST_LEN; }

// Launch ``variant`` on ``stream`` (variant 1: ``span`` lanes a CTA, each
// listing lane a tile of ``group`` threads, 0 = chosen per CTA); returns
// cudaGetLastError() right after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int cmr_binned_listing_launch(const float* bounds, const float* super_bounds, const float* rays,
                              const float* bound, const int* tlo, int* keys, int* tlim, int n,
                              int C, int S, int SF, int variant, int span, int group,
                              void* stream) {
  const cmr::ListingParams p{bounds, super_bounds, rays, bound, tlo, keys, tlim,
                             n, C, S, SF, span, group};
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    const int blocks = (n + cmr::LIST_THREADS - 1) / cmr::LIST_THREADS;
    cmr::binned_listing<CMR_LIST_LEN><<<blocks, cmr::LIST_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  const bool group_ok = group == 0 || group == 1 || group == 2 || group == 4 || group == 8 ||
                        group == 16 || group == 32;
  if (variant != 1 || span < 1 || span > cmr::LIST_CTA || !group_ok ||
      group * span > cmr::LIST_CTA || S < 1 || S > cmr::MAX_SUPERS)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + span - 1) / span;
  const int groups = (S + cmr::GROUP_SUPERS - 1) / cmr::GROUP_SUPERS;
  cmr::binned_listing_tile<CMR_LIST_LEN>
      <<<blocks, cmr::LIST_CTA, (size_t)(S + groups) * 2 * sizeof(float4), s>>>(p);
  return (int)cudaGetLastError();
}

// An empty kernel on the grid of a variant-1 launch over ``n`` lanes.
int cmr_binned_listing_empty(int n, int span, void* stream) {
  if (span < 1 || span > cmr::LIST_CTA) return (int)cudaErrorInvalidValue;
  cmr::binned_listing_empty<<<(n + span - 1) / span, cmr::LIST_CTA, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
