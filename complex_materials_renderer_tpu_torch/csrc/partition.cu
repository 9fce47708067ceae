// The compaction sort of the pass plan as one partition for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package sorts with jnp.argsort, which XLA
// lowers itself (complex_materials_renderer_tpu/render/megarender.py
// ``_partition_live`` :114-146). The port's plain route
// (kernels/partition.py ``partition_plain``) built the coherence key in
// about forty elementwise PyTorch kernels, radix-sorted all 64 bits of it
// with ``torch.argsort(stable=True)`` and moved the state with nine
// gathers and nine copies (and two index_put calls at a phase shrink):
// some seventy launches, 0.2 ms a sort whatever its width.
//
// What it computes: the permutation of the stable argsort of the
// coherence key (render/integrator.py ``_compact``'s key, held in
// kernels/partition.py ``coherence_key``), applied in place to the nine
// per-lane arrays of the state, and at a phase shrink the radiance and RNG
// words of the lanes sorted to positions >= ``keep`` written into the banks
// at their lane ids.
//
// What bounds it on this card: launch latency and the latency of a
// block's dependent steps, not bytes. A lane's 77 bytes (org, dir, thr and
// rad 48, rng and aux 16, lane 8, depth 4, alive 1) have to be read and
// written once: 10 MB at 65,536 lanes, 3 us at 3.35 TB/s (the bound). The
// kernels move them twice (through the scratch copy) and add 16 bytes a
// lane a radix pass for the keys and indices, and take ~30 us (PERF.md).
// A block's work is latency-bound: each kernel loads everything a thread
// moves before it stores anything (a store may alias a later load for all
// the compiler knows, and would otherwise wait on it), and the lanes that
// are gathered or scattered one at a time are spread one a thread over
// the whole card rather than four a thread over a radix pass's tiles (a
// warp's scattered access is served a sector at a time by its SM).
//
// The design: four launches a sort.
//   1. key_hist: one thread a lane computes the key with the plain
//      route's float32 operations in its order (this file is built with
//      --fmad=false), copies the state into the scratch, and counts both
//      radix digits of the keys in shared memory, then adds the block's
//      counts to the global histograms. A live key has 18 bits (octant 3,
//      Morton cell 15); a dead lane's 0xFFFFFFFF becomes 1 << 18, above
//      every live key, so the order is the same with 19 bits. It also
//      clears the look-back words of every tile.
//   2. radix_pass<1024, 0>: key bits 0-9, and
//   3. radix_pass<512, 10>: key bits 10-18, each a stable LSD counting pass
//      over (key, index) in tiles of 1024 lanes: each warp ranks its 128
//      lanes in order with __match_any_sync against its own counts in
//      shared memory, the warps' counts give each digit's offset in the
//      tile, and a decoupled look-back over the tiles (tile ids taken in
//      launch order, so every tile looked at is resident or done; 16 or 32
//      earlier tiles a digit read at once) gives the tile's offset among the
//      earlier tiles; the global histogram's exclusive scan gives the
//      digit's base. The last pass writes the permutation.
//   4. move: one thread a sorted position moves the lane the permutation
//      puts there from the copy into the state's own addresses (a graph
//      reads the state there) and writes its bank rows; block 0 clears the
//      histograms and tile counters for the next sort (the scratch starts
//      zeroed: kernels/partition.py).
// No launch synchronises or allocates: the wrapper hands in the scratch,
// made before any capture.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace cmr {

constexpr int PT_THREADS = 256;
constexpr int PT_WARPS = PT_THREADS / 32;
constexpr int PT_ITEMS = 4;                        // lanes a thread in a pass
constexpr int PT_TILE = PT_THREADS * PT_ITEMS;     // 1024 lanes a block
constexpr int PT_WARP_LANES = 32 * PT_ITEMS;       // a warp's run of lanes in a tile
constexpr int PT_BITS0 = 10;
constexpr int PT_NB0 = 1 << PT_BITS0;              // pass 0 digits: key bits 0-9
constexpr int PT_NB1 = 512;                        // pass 1 digits: key bits 10-18 (0-256)
constexpr uint32_t PT_DEAD = 1u << 18;             // a dead lane's key
constexpr int PT_MAX_LANES = 1 << 24;

// The control words at the head of the scratch (zero between sorts): the
// tile counters of the two passes, then the two global histograms.
constexpr int CTL_TILE0 = 0;
constexpr int CTL_TILE1 = 1;
constexpr int CTL_HIST0 = 32;
constexpr int CTL_HIST1 = CTL_HIST0 + PT_NB0;
constexpr int CTL_WORDS = CTL_HIST1 + PT_NB1;
// A tile's look-back words: pass 0's digits, then pass 1's.
constexpr int ST_STRIDE = PT_NB0 + PT_NB1;
constexpr uint32_t ST_AGG = 1u << 30;   // the tile's own count
constexpr uint32_t ST_INC = 2u << 30;   // the count of this and every earlier tile
constexpr uint32_t ST_VALUE = ST_AGG - 1;

struct Layout {
  size_t ctl, status, keys0, keys1, idx1, perm, org, dir, thr, rad, rng, aux, lane, depth,
      alive, total;
};

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline Layout layout(int cap) {
  const size_t n = (size_t)cap;
  const size_t tiles = (n + PT_TILE - 1) / PT_TILE;
  Layout l;
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    size_t here = at;
    at = align256(at + bytes);
    return here;
  };
  l.ctl = take(CTL_WORDS * 4);
  l.status = take(tiles * ST_STRIDE * 4);
  l.keys0 = take(n * 4);
  l.keys1 = take(n * 4);
  l.idx1 = take(n * 4);
  l.perm = take(n * 4);
  l.org = take(n * 12);
  l.dir = take(n * 12);
  l.thr = take(n * 12);
  l.rad = take(n * 12);
  l.rng = take(n * 8);
  l.aux = take(n * 8);
  l.lane = take(n * 8);
  l.depth = take(n * 4);
  l.alive = take(n);
  l.total = at;
  return l;
}

// The nine per-lane arrays of a state (the sorted one, or its copy in the scratch).
struct Arrays {
  float *org, *dir, *thr, *rad;
  long long *rng, *aux, *lane;
  int* depth;
  unsigned char* alive;
};

struct Sort {
  Arrays state, copy;
  const float *lo, *hi;
  uint32_t *ctl, *status, *keys0, *keys1, *idx1, *perm;
  float* rad_bank;
  long long* rng_bank;
  int bank_rows, keep, n, pos_key;
};

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// integrator's ``_spread3``: a 5-bit value's bits three apart.
__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// The origin's cell along one axis: clamp(((o - lo) / extent) * 32, 0, 31),
// truncated (the plain route's torch.clamp and integer conversion).
__device__ __forceinline__ uint32_t axis_cell(float o, float lo, float extent) {
  const float rel = __fdiv_rn(__fsub_rn(o, lo), extent);
  const float q = fminf(fmaxf(__fmul_rn(rel, 32.0f), 0.0f), 31.0f);
  return (uint32_t)(int)q;
}

// One lane's state in registers. The kernels load every lane they move
// before they store any: a store to the state or its copy may alias a later
// load for all the compiler knows, and would otherwise wait on each load.
struct Lane {
  float org[3], dir[3], thr[3], rad[3];
  long long rng, aux, lane;
  int depth;
  unsigned char alive;
};

__device__ __forceinline__ Lane load_lane(const Arrays& a, size_t i) {
  Lane v;
  for (int c = 0; c < 3; ++c) {
    v.org[c] = a.org[3 * i + c];
    v.dir[c] = a.dir[3 * i + c];
    v.thr[c] = a.thr[3 * i + c];
    v.rad[c] = a.rad[3 * i + c];
  }
  v.rng = a.rng[i];
  v.aux = a.aux[i];
  v.lane = a.lane[i];
  v.depth = a.depth[i];
  v.alive = a.alive[i];
  return v;
}

__device__ __forceinline__ void store_lane(const Arrays& a, size_t i, const Lane& v) {
  for (int c = 0; c < 3; ++c) {
    a.org[3 * i + c] = v.org[c];
    a.dir[3 * i + c] = v.dir[c];
    a.thr[3 * i + c] = v.thr[c];
    a.rad[3 * i + c] = v.rad[c];
  }
  a.rng[i] = v.rng;
  a.aux[i] = v.aux;
  a.lane[i] = v.lane;
  a.depth[i] = v.depth;
  a.alive[i] = v.alive;
}

__device__ __forceinline__ uint32_t lane_key(const Lane& v, const float* lo, const float* extent,
                                             int pos_key) {
  if (!v.alive) return PT_DEAD;
  uint32_t cell = 0;
  for (int a = 0; a < 3; ++a) cell |= spread3(axis_cell(v.org[a], lo[a], extent[a])) << (2 - a);
  const uint32_t octant =
      (v.dir[0] > 0.0f ? 4u : 0u) + (v.dir[1] > 0.0f ? 2u : 0u) + (v.dir[2] > 0.0f ? 1u : 0u);
  return pos_key ? (cell << 3) | octant : (octant << 15) | cell;
}

// One thread a lane: the key, both digits' counts, the state's copy; and
// the look-back words of every tile cleared for the passes that follow.
__global__ void __launch_bounds__(PT_THREADS) key_hist(Sort s) {
  __shared__ uint32_t h0[PT_NB0];
  __shared__ uint32_t h1[PT_NB1];
  const int t = threadIdx.x;
  const int i = blockIdx.x * PT_THREADS + t;
  Lane v;
  if (i < s.n) v = load_lane(s.state, i);
  for (int j = t; j < PT_NB0; j += PT_THREADS) h0[j] = 0;
  for (int j = t; j < PT_NB1; j += PT_THREADS) h1[j] = 0;
  const size_t words = (size_t)((s.n + PT_TILE - 1) / PT_TILE) * ST_STRIDE;
  for (size_t j = i; j < words; j += (size_t)gridDim.x * PT_THREADS) s.status[j] = 0;
  float lo[3], extent[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = s.lo[a];
    extent[a] = fmaxf(__fsub_rn(s.hi[a], s.lo[a]), 1e-6f);
  }
  __syncthreads();
  if (i < s.n) {
    const uint32_t key = lane_key(v, lo, extent, s.pos_key);
    s.keys0[i] = key;
    atomicAdd(&h0[key & (PT_NB0 - 1)], 1u);
    atomicAdd(&h1[key >> PT_BITS0], 1u);
    store_lane(s.copy, i, v);
  }
  __syncthreads();
  for (int j = t; j < PT_NB0; j += PT_THREADS)
    if (h0[j]) atomicAdd(&s.ctl[CTL_HIST0 + j], h0[j]);
  for (int j = t; j < PT_NB1; j += PT_THREADS)
    if (h1[j]) atomicAdd(&s.ctl[CTL_HIST1 + j], h1[j]);
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v, int l) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, d);
    if (l >= d) v += u;
  }
  return v;
}

// One stable counting pass over the digit (key >> SHIFT) & (NB - 1). Pass 0
// (LAST false) reads the keys in lane order, the index being the position,
// and writes (key, index) in digit order; the last pass reads those and
// moves the state.
template <int NB, int SHIFT, bool LAST>
__global__ void __launch_bounds__(PT_THREADS) radix_pass(Sort s) {
  constexpr int K = NB / PT_THREADS;  // digits a thread owns: t + PT_THREADS * k
  constexpr int W = 64 / K;           // earlier tiles a look-back round reads at once
  __shared__ uint32_t whist[PT_WARPS][NB];  // each warp's counts, then its offsets
  __shared__ uint32_t offset[NB];           // a digit's first position for this tile
  __shared__ uint32_t warp_total[PT_WARPS];
  __shared__ int tile_s;
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  uint32_t* counter = s.ctl + (LAST ? CTL_TILE1 : CTL_TILE0);
  const uint32_t* hist = s.ctl + (LAST ? CTL_HIST1 : CTL_HIST0);
  if (t == 0) tile_s = (int)atomicAdd(counter, 1u);
  for (int i = t; i < PT_WARPS * NB; i += PT_THREADS) (&whist[0][0])[i] = 0;

  // The digits' bases: the exclusive scan of the global histogram, over
  // K consecutive digits a thread.
  uint32_t part[K];
  uint32_t mine = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    part[k] = hist[K * t + k];
    mine += part[k];
  }
  const uint32_t inc = warp_inclusive_sum(mine, l);
  if (l == 31) warp_total[w] = inc;
  __syncthreads();
  uint32_t run = inc - mine;
  for (int j = 0; j < w; ++j) run += warp_total[j];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    offset[K * t + k] = run;
    run += part[k];
  }
  const int tile = tile_s;

  // Rank: each warp walks its run of lanes of the tile in order, 32 at a time.
  const uint32_t below = (1u << l) - 1u;
  uint32_t key[PT_ITEMS], idx[PT_ITEMS], rank[PT_ITEMS];
  int digit[PT_ITEMS];
#pragma unroll
  for (int j = 0; j < PT_ITEMS; ++j) {
    const int e = tile * PT_TILE + w * PT_WARP_LANES + j * 32 + l;
    const bool valid = e < s.n;
    key[j] = valid ? (LAST ? s.keys1[e] : s.keys0[e]) : 0u;
    idx[j] = valid ? (LAST ? s.idx1[e] : (uint32_t)e) : 0u;
    digit[j] = valid ? (int)((key[j] >> SHIFT) & (NB - 1)) : NB;
  }
#pragma unroll
  for (int j = 0; j < PT_ITEMS; ++j) {
    const int d = digit[j];
    const bool valid = d != NB;
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const uint32_t before = __popc(peers & below);
    const uint32_t seen = valid ? whist[w][d] : 0u;
    __syncwarp();
    if (valid && before == 0) whist[w][d] = seen + __popc(peers);
    __syncwarp();
    rank[j] = seen + before;
  }
  __syncthreads();

  // Each owned digit: the warps' offsets in the tile and the tile's count,
  // published for the later tiles.
  uint32_t* status = s.status + (LAST ? PT_NB0 : 0);
  uint32_t* mine_st = status + (size_t)tile * ST_STRIDE;
  uint32_t count[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = t + PT_THREADS * k;
    uint32_t c = 0;
    for (int j = 0; j < PT_WARPS; ++j) {
      const uint32_t v = whist[j][d];
      whist[j][d] = c;
      c += v;
    }
    count[k] = c;
    st_relaxed(mine_st + d, (tile == 0 ? ST_INC : ST_AGG) | c);
  }
  // The look-back: the counts of the earlier tiles back to the nearest one
  // that holds an inclusive count, W tiles a digit read at once (all the
  // loads of a round in flight together); a tile not yet published is
  // read again in the next round.
  uint32_t prefix[K];
  int next[K];  // the nearest earlier tile not summed yet; -1: done
#pragma unroll
  for (int k = 0; k < K; ++k) {
    prefix[k] = 0;
    next[k] = tile - 1;
  }
  while (true) {
    bool busy = false;
#pragma unroll
    for (int k = 0; k < K; ++k) busy |= next[k] >= 0;
    if (!busy) break;
    uint32_t v[K][W];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int j = next[k] - i;
        v[k][i] = j >= 0 ? ld_relaxed(status + (size_t)j * ST_STRIDE + t + PT_THREADS * k)
                         : ST_INC;
      }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bool go = next[k] >= 0;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t x = v[k][i];
        if (go) {
          if ((x & ~ST_VALUE) == 0) {
            go = false;
          } else {
            prefix[k] += x & ST_VALUE;
            --next[k];
            if (x & ST_INC) {
              next[k] = -1;
              go = false;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = t + PT_THREADS * k;
    if (tile > 0) st_relaxed(mine_st + d, ST_INC | (prefix[k] + count[k]));
    offset[d] += prefix[k];
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PT_ITEMS; ++j) {
    const int d = digit[j];
    if (d == NB) continue;
    const uint32_t p = offset[d] + whist[w][d] + rank[j];
    if (LAST) {
      s.perm[p] = idx[j];
    } else {
      s.keys1[p] = key[j];
      s.idx1[p] = idx[j];
    }
  }
}

// One thread a sorted position: the lane the permutation puts there, from
// the copy into the state's own addresses (a graph reads the state there),
// and its bank rows past ``keep``. Block 0 clears the control words for the
// next sort: the passes that read them are done.
__global__ void __launch_bounds__(PT_THREADS) move(Sort s) {
  const int p = blockIdx.x * PT_THREADS + threadIdx.x;
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < CTL_WORDS; j += PT_THREADS) s.ctl[j] = 0;
  if (p >= s.n) return;
  const Lane v = load_lane(s.copy, s.perm[p]);
  store_lane(s.state, p, v);
  if (s.rad_bank != nullptr && p >= s.keep && v.lane >= 0 && v.lane < s.bank_rows) {
    for (int c = 0; c < 3; ++c) s.rad_bank[3 * v.lane + c] = v.rad[c];
    s.rng_bank[v.lane] = v.rng;
  }
}

}  // namespace cmr

extern "C" {

// Bytes of the scratch for up to ``cap`` lanes; ``perm_offset`` gets the
// byte offset of the permutation (``cap`` uint32) in it.
long long cmr_partition_scratch_bytes(int cap, long long* perm_offset) {
  const cmr::Layout l = cmr::layout(cap);
  if (perm_offset) *perm_offset = (long long)l.perm;
  return (long long)l.total;
}

// Sort ``n`` lanes in place on ``stream`` (four launches); returns
// cudaGetLastError() after them. The state: org, dir, thr, rad (n x 3
// float32), rng, aux, lane (int64), depth (int32), alive (bytes); ``lo``,
// ``hi``: the world box (3 float32 on the card); ``pos_key``: cell-major
// keys. With ``rad_bank`` (bank_rows x 3 float32) and ``rng_bank``
// (bank_rows int64), the lanes sorted to positions >= ``keep`` write their
// rad and rng rows there at their lane ids (ids outside the bank are
// skipped). ``scratch``: cmr_partition_scratch_bytes(cap), zeroed when made,
// for n <= cap <= 2^24.
int cmr_partition_launch(float* org, float* dir, float* thr, float* rad, long long* rng,
                         int* depth, unsigned char* alive, long long* aux, long long* lane,
                         const float* lo, const float* hi, int n, int pos_key, float* rad_bank,
                         long long* rng_bank, int bank_rows, int keep, void* scratch, int cap,
                         void* stream) {
  if (n < 0 || n > cap || cap > cmr::PT_MAX_LANES) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cmr::Layout l = cmr::layout(cap);
  char* b = (char*)scratch;
  cmr::Sort s;
  s.state = {org, dir, thr, rad, rng, aux, lane, depth, alive};
  s.copy = {(float*)(b + l.org), (float*)(b + l.dir), (float*)(b + l.thr), (float*)(b + l.rad),
            (long long*)(b + l.rng), (long long*)(b + l.aux), (long long*)(b + l.lane),
            (int*)(b + l.depth), (unsigned char*)(b + l.alive)};
  s.lo = lo;
  s.hi = hi;
  s.ctl = (uint32_t*)(b + l.ctl);
  s.status = (uint32_t*)(b + l.status);
  s.keys0 = (uint32_t*)(b + l.keys0);
  s.keys1 = (uint32_t*)(b + l.keys1);
  s.idx1 = (uint32_t*)(b + l.idx1);
  s.perm = (uint32_t*)(b + l.perm);
  s.rad_bank = rad_bank;
  s.rng_bank = rng_bank;
  s.bank_rows = rad_bank ? bank_rows : 0;
  s.keep = keep;
  s.n = n;
  s.pos_key = pos_key;
  const int tiles = (n + cmr::PT_TILE - 1) / cmr::PT_TILE;
  const int blocks = (n + cmr::PT_THREADS - 1) / cmr::PT_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  cmr::key_hist<<<blocks, cmr::PT_THREADS, 0, st>>>(s);
  cmr::radix_pass<cmr::PT_NB0, 0, false><<<tiles, cmr::PT_THREADS, 0, st>>>(s);
  cmr::radix_pass<cmr::PT_NB1, cmr::PT_BITS0, true><<<tiles, cmr::PT_THREADS, 0, st>>>(s);
  cmr::move<<<blocks, cmr::PT_THREADS, 0, st>>>(s);
  return (int)cudaGetLastError();
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
