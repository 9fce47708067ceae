// Pass control for the mega pass, and the CUDA graph conditional nodes that
// the pass plan's loops become.
//
// New glue with no TPU counterpart of its own: it stands for the scalar
// work that the JAX package's jit program does between kernel calls
// (render/megarender.py ``_make_advance`` :213-314: the ``sum(alive)`` of
// ``live_blocks_of`` and of the spill loop's ``while_loop`` condition, the
// ``any(alive)`` of the dynamic modes' ``while_loop`` and ``cond``, and the
// ``dim0 + 8 * cap`` carry). The port's pass plan (render/megarender.py
// ``PassPlan``) runs a pass as a fixed sequence of sorts, scatters, K1
// launches and launches of this kernel; on the card that sequence is one
// CUDA graph and each loop of it a conditional node, so no value goes back
// to the host between a pass's first launch and its last.
//
// The kernel, after a sort or a K1 launch (``flags``, kernels/pass_control.py):
//   AFTER_K1     if the K1 launch just before ran (run flag set and
//                live_blocks > 0): dim0 += ``advance`` (8 * its bounce cap)
//                and, with DEVICE_COUNT and without NOT_K1, one more K1
//                launch in counts[0];
//   INIT         dim0 = ``dim0``, and as SET_FULL;
//   SET_FULL     live_blocks = every block of the ``n`` lanes, run flag 1;
//   SET_LIVE     live_blocks = ceil(alive / 1024), run flag = alive > 0;
//   ITER_RESET   the iteration counter = 0, then
//   ITER_STEP    the iteration counter += 1;
//   COND         the condition alive > ``threshold`` (with ITER_CAP also
//                iteration < ``cap``; with ITER_GRACE alive > 0 while
//                iteration < ``cap``, alive > ``threshold`` after) into the
//                control block and, with SET_HANDLE, into the enclosing
//                conditional node (``cudaGraphSetConditional``);
//   RUNGS        the rung of a launch-shape ladder that holds the count
//                (with EXTENT: the last true byte's index + 1): rung i for
//                edges[i] <= value < edges[i + 1], -1 for none, into the
//                control block and each rung's condition into its IF node;
//   DEVICE_COUNT counts[1] += 1 (the launches of this kernel that ran);
//   SITE_COUNT   the counts of ``site`` in the counter block
//                (pass_control.cuh CNT_*, SITE_*): one more visit; if the
//                K1 launch just before ran, one more K1 launch, the live
//                lanes it was launched on (the CTRL_NALIVE that the launch
//                before left) and the lanes it covered (live_blocks x
//                1024); the walk counts that K1 launches left in the
//                block's accumulator (CNT_WALK: bounces, supers entered,
//                clusters tested), which it clears; and the nanoseconds
//                since the card's last stamp (%globaltimer at this
//                kernel's entry), which becomes the last stamp. Warp 1
//                reads what it needs at the kernel's entry, while the
//                warps count, and adds after the count, beside thread 0's
//                scalar updates.
// It always counts the true bytes of ``alive[0, n)`` (CTRL_NALIVE): the
// alive lanes, or any bool tensor a plan hands in (a round's listed heads,
// a generation's listed pairs, the lanes a march step still runs).
//
// The stamp kernel (``pass_stamp``, one thread) opens and closes a call of a
// captured program (render/megarender.py ``CallGraph``: START before the
// inputs' copies and the replay, END after the outputs' clones): START makes its
// %globaltimer the last stamp and the start of the ring's next call; END
// charges the time since the last stamp to SITE_CALL_END, writes the
// call's end, adds its interval to CNT_CALL_NS and clears the last stamp
// (a host gap before the next call is charged to no site); CALIBRATE
// writes it to CNT_CALIBRATE, which the host reads against its own clock
// (utils/timing.py).

// What bounds it: launch latency. It reads n bytes (65,536 on the main
// path: 20 ns at 3.35 TB/s) and a few words; one block of 1024 threads sums
// the bytes 16 at a time (a bool is 0 or 1, so a word's popcount counts
// its true bytes; the highest set bit of the last nonzero word gives the
// extent) and thread 0 does the scalar updates. Its time on the
// card is that of an empty launch (PERF.md §6).
//
// The graph side (cmr_graph_cond_*): the pass plan captures a pass with
// torch.cuda.graph; at a loop it creates a conditional handle in the graph
// being captured, launches this kernel to set it, adds a conditional node
// (WHILE for the spill loop and the dynamic modes' loop, IF for the hybrid
// mode's guarded bounces, the engines' trace guards and launch-shape
// rungs) after the capture's current dependencies, moves
// the outer capture past that node, and captures the loop body into the
// node's body graph on a second stream. The body ends with this kernel,
// which sets the handle again: the WHILE node runs its body while that
// value is nonzero (CUDA >= 12.4). A body may hold conditional nodes of its
// own (CUDA >= 12.4): each depth is captured on a stream of its own.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "pass_control.cuh"

namespace cmr {

constexpr int PC_INIT = 1;
constexpr int PC_SET_FULL = 2;
constexpr int PC_SET_LIVE = 4;
constexpr int PC_AFTER_K1 = 8;
constexpr int PC_COND = 16;
constexpr int PC_DEVICE_COUNT = 32;
constexpr int PC_SET_HANDLE = 64;
constexpr int PC_ITER_RESET = 128;
constexpr int PC_ITER_STEP = 256;
constexpr int PC_ITER_CAP = 512;
constexpr int PC_ITER_GRACE = 1024;
constexpr int PC_RUNGS = 2048;
constexpr int PC_EXTENT = 4096;
constexpr int PC_NOT_K1 = 8192;
constexpr int PC_SET_RUNG_HANDLES = 16384;
constexpr int PC_SITE_COUNT = 32768;
constexpr int STAMP_START = 0;
constexpr int STAMP_END = 1;
constexpr int STAMP_CALIBRATE = 2;
constexpr int PC_THREADS = 1024;
constexpr int PC_MAX_RUNGS = 8;

// A launch-shape ladder: rung i holds the values in [edges[i], edges[i + 1]).
struct Rungs {
  int n;
  int edges[PC_MAX_RUNGS + 1];
  cudaGraphConditionalHandle handles[PC_MAX_RUNGS];
};

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// The index + 1 of the highest nonzero byte of a little-endian word.
__device__ __forceinline__ int top_byte(unsigned int w) { return ((31 - __clz(w)) >> 3) + 1; }

__global__ void __launch_bounds__(PC_THREADS)
    pass_control(const unsigned char* __restrict__ alive, int n, int* ctrl, long long* counts,
                 int flags, int dim0, int advance, int threshold, int cap, int site,
                 cudaGraphConditionalHandle handle, Rungs rungs) {
  __shared__ int warp_sums[PC_THREADS / 32];
  __shared__ int warp_ext[PC_THREADS / 32];
  // SITE_COUNT: warp 1 reads the clock, the control block and the last
  // stamp at entry, and adds the site's counts (a field a lane) after the
  // __syncthreads below, beside thread 0's scalar updates. Only the control
  // kernel writes the control block, and thread 0 writes it after that
  // barrier, so these are the values the K1 launch before read.
  const bool sites = (flags & PC_SITE_COUNT) && (threadIdx.x >> 5) == 1;
  long long now = 0, last = 0, walk = 0;
  int run = 0, live = 0, nalive = 0;
  // Lane f of warp 1 adds site field f; the walk fields' lanes move one
  // accumulator each.
  const int walk_field = (threadIdx.x & 31) - SITE_BOUNCES;
  const bool walks = sites && walk_field >= 0 && walk_field < WALK_LEN;
  if (sites) {
    if ((threadIdx.x & 31) == 0) now = global_ns();
    run = ctrl[CTRL_RUN];
    live = ctrl[CTRL_LIVE];
    nalive = ctrl[CTRL_NALIVE];
    last = counts[CNT_LAST];
    if (walks) walk = counts[CNT_WALK + walk_field];
  }
  const bool extent = (flags & PC_EXTENT) != 0;  // uniform over the block
  int c = 0;
  int e = 0;  // the extent: index + 1 of the last true byte this thread saw
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(alive) & 15) == 0) {
    const int n16 = n / 16;
    const uint4* v = reinterpret_cast<const uint4*>(alive);
    for (int i = threadIdx.x; i < n16; i += PC_THREADS) {
      const uint4 w = v[i];
      c += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      if (extent) {
        if (w.w) e = i * 16 + 12 + top_byte(w.w);
        else if (w.z) e = i * 16 + 8 + top_byte(w.z);
        else if (w.y) e = i * 16 + 4 + top_byte(w.y);
        else if (w.x) e = i * 16 + top_byte(w.x);
      }
    }
    head = n16 * 16;
  }
  for (int i = head + threadIdx.x; i < n; i += PC_THREADS) {
    if (alive[i] != 0) {
      ++c;
      e = i + 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  if (extent) {
    e = __reduce_max_sync(0xffffffffu, e);
    if ((threadIdx.x & 31) == 0) warp_ext[threadIdx.x >> 5] = e;
  }
  __syncthreads();
  if (sites) {
    now = __shfl_sync(0xffffffffu, now, 0);
    const int f = threadIdx.x & 31;
    if (f < SITE_FIELDS) {
      const bool k1 = (flags & PC_AFTER_K1) && !(flags & PC_NOT_K1) && run != 0 && live > 0;
      long long add = 1;
      if (f == SITE_K1) add = k1 ? 1 : 0;
      if (f == SITE_LIVE) add = k1 ? nalive : 0;
      if (f == SITE_LANES) add = k1 ? (long long)live * CTRL_BLOCK_LANES : 0;
      if (walks) add = walk;
      if (f == SITE_NS) add = last != 0 ? now - last : 0;
      counts[CNT_SITES + site * SITE_FIELDS + f] += add;
      if (f == SITE_NS) counts[CNT_LAST] = now;
      if (walks) counts[CNT_WALK + walk_field] = 0;
    }
    return;
  }
  if (threadIdx.x >= 32) return;
  c = warp_sums[threadIdx.x];
  if (extent) e = __reduce_max_sync(0xffffffffu, warp_ext[threadIdx.x]);
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if (threadIdx.x != 0) return;

  const int n_alive = c;
  if (flags & PC_AFTER_K1) {
    if (ctrl[CTRL_RUN] != 0 && ctrl[CTRL_LIVE] > 0) {
      ctrl[CTRL_DIM0] += advance;
      if ((flags & PC_DEVICE_COUNT) && !(flags & PC_NOT_K1)) counts[0] += 1;
    }
  }
  if (flags & PC_INIT) ctrl[CTRL_DIM0] = dim0;
  if (flags & (PC_INIT | PC_SET_FULL)) {
    ctrl[CTRL_LIVE] = (n + CTRL_BLOCK_LANES - 1) / CTRL_BLOCK_LANES;
    ctrl[CTRL_RUN] = 1;
  }
  if (flags & PC_SET_LIVE) {
    ctrl[CTRL_LIVE] = (n_alive + CTRL_BLOCK_LANES - 1) / CTRL_BLOCK_LANES;
    ctrl[CTRL_RUN] = n_alive > 0 ? 1 : 0;
  }
  ctrl[CTRL_NALIVE] = n_alive;
  if (flags & PC_EXTENT) ctrl[CTRL_EXTENT] = e;
  if (flags & PC_ITER_RESET) ctrl[CTRL_ITER] = 0;
  if (flags & PC_ITER_STEP) ctrl[CTRL_ITER] += 1;
  if (flags & PC_COND) {
    const int it = ctrl[CTRL_ITER];
    bool go = n_alive > threshold;
    if (flags & PC_ITER_CAP) go = go && it < cap;
    if (flags & PC_ITER_GRACE) go = n_alive > (it < cap ? 0 : threshold);
    const unsigned int cond = go ? 1u : 0u;
    ctrl[CTRL_COND] = (int)cond;
    if (flags & PC_SET_HANDLE) cudaGraphSetConditional(handle, cond);
  }
  if (flags & PC_RUNGS) {
    const int value = (flags & PC_EXTENT) ? e : n_alive;
    int rung = -1;
    for (int i = 0; i < rungs.n; ++i) {
      const bool in = rungs.edges[i] <= value && value < rungs.edges[i + 1];
      if (in) rung = i;
      if (flags & PC_SET_RUNG_HANDLES) cudaGraphSetConditional(rungs.handles[i], in ? 1u : 0u);
    }
    ctrl[CTRL_RUNG] = rung;
  }
  if (flags & PC_DEVICE_COUNT) counts[1] += 1;
}

// An empty launch of the control kernel's grid: the floor its time is
// held against.
__global__ void __launch_bounds__(PC_THREADS) pass_control_empty() {}

// A call's START or END stamp, or a CALIBRATE stamp (one thread).
__global__ void pass_stamp(long long* counts, int which) {
  const long long now = global_ns();
  long long* call = counts + CNT_HEAD + 2 * (int)(counts[CNT_CALLS] % CNT_RING);
  if (which == STAMP_START) {
    counts[CNT_LAST] = now;
    call[0] = now;
  } else if (which == STAMP_END) {
    long long* s = counts + CNT_SITES + SITE_CALL_END * SITE_FIELDS;
    s[SITE_VISITS] += 1;
    if (counts[CNT_LAST] != 0) s[SITE_NS] += now - counts[CNT_LAST];
    counts[CNT_LAST] = 0;
    call[1] = now;
    counts[CNT_CALL_NS] += now - call[0];
    counts[CNT_CALLS] += 1;
  } else {
    counts[CNT_CALIBRATE] = now;
  }
}

}  // namespace cmr

// The error for a stream whose capture is not active: invalidated (an
// operation the capture could not record), or none at all.
static int not_capturing(cudaStreamCaptureStatus status) {
  return (int)(status == cudaStreamCaptureStatusInvalidated ? cudaErrorStreamCaptureInvalidated
                                                            : cudaErrorIllegalState);
}

extern "C" {

// Launch on ``stream``; returns cudaGetLastError() right after the launch.
// ``alive``: n bytes; ``ctrl``: CTRL_LEN int32; ``counts``: CNT_LEN int64;
// ``edges``: n_rungs + 1 ints and ``rung_handles``: n_rungs handles (or
// null), host arrays copied into the launch's parameters, for RUNGS; both
// may be null when n_rungs is 0; ``site`` below MAX_SITES.
int cmr_pass_control_launch(const unsigned char* alive, int n, int* ctrl, long long* counts,
                            int flags, int dim0, int advance, int threshold, int cap, int site,
                            unsigned long long handle, int n_rungs, const int* edges,
                            const unsigned long long* rung_handles, void* stream) {
  cmr::Rungs rungs = {};
  if (n_rungs < 0 || n_rungs > cmr::PC_MAX_RUNGS) return (int)cudaErrorInvalidValue;
  if (site < 0 || site >= cmr::MAX_SITES) return (int)cudaErrorInvalidValue;
  rungs.n = n_rungs;
  for (int i = 0; i < n_rungs; ++i) {
    rungs.edges[i] = edges[i];
    rungs.handles[i] = rung_handles ? (cudaGraphConditionalHandle)rung_handles[i] : 0;
  }
  if (n_rungs > 0) rungs.edges[n_rungs] = edges[n_rungs];
  cmr::pass_control<<<1, cmr::PC_THREADS, 0, (cudaStream_t)stream>>>(
      alive, n, ctrl, counts, flags, dim0, advance, threshold, cap, site,
      (cudaGraphConditionalHandle)handle, rungs);
  return (int)cudaGetLastError();
}

// A stamp (``which``: 0 START, 1 END, 2 CALIBRATE) into the counter block.
int cmr_pass_stamp_launch(long long* counts, int which, void* stream) {
  if (which < cmr::STAMP_START || which > cmr::STAMP_CALIBRATE) return (int)cudaErrorInvalidValue;
  cmr::pass_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(counts, which);
  return (int)cudaGetLastError();
}

int cmr_pass_control_empty(void* stream) {
  cmr::pass_control_empty<<<1, cmr::PC_THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// A conditional handle in the graph that ``stream`` is capturing into.
int cmr_graph_cond_handle(void* stream, unsigned long long* handle_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return not_capturing(status);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  *handle_out = (unsigned long long)handle;
  return (int)err;
}

// Add a conditional node (``is_while``: WHILE, else IF) on ``handle`` after
// the current dependencies of ``stream``'s capture, make it the capture's
// only dependency, and start capturing ``body_stream`` into its body graph.
int cmr_graph_cond_begin(void* stream, unsigned long long handle, int is_while,
                         void* body_stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return not_capturing(status);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies((cudaStream_t)stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body, nullptr, nullptr, 0,
                                            cudaStreamCaptureModeRelaxed);
}

// A non-blocking stream on ``device`` for conditional bodies: the port's
// own, since torch hands the streams of its pool out in turn, and in time
// would hand out the stream being captured.
int cmr_graph_body_stream(int device, void** stream_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)stream_out, cudaStreamNonBlocking);
}

// End the capture of a conditional node's body.
int cmr_graph_cond_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

const char* cmr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
