// Live rays packed into full warps, for the trace kernels K1
// (trace_flat.cu) and K5 (trace_bvh.cu); the fused bounces take
// lanes_below from here (bounce_common.cuh).
//
// A launch covers every lane of its ray planes, but after bounce 0 many
// lanes are dead (t_max <= 0) and the live ones are scattered over nearly
// every warp. Both kernels launch a grid over lanes, `claim` lanes a warp
// (a multiple of 32, up to CLAIM_MAX; the host picks it by query kind). A
// warp reads the liveness of all its lanes at once, writes the result of
// every lane it need not trace itself (the caller's `pass`), and keeps the
// live ones in a list in shared memory, from which its threads take rays:
// a warp of 128 lanes with 40 live traces them as 32 and 8, not as four
// warps of about 10, and in K5 a thread whose walk ends takes the next
// live ray (Aila and Laine's "while-while" traversal).
#pragma once

#include <cuda_runtime.h>

namespace pbrs {

constexpr unsigned FULL_MASK = 0xffffffffu;
// The most lanes a warp takes, and so the live lanes its list may hold.
constexpr int CLAIM_MAX = 128;

// A warp's list of live lanes not yet taken. Every field is the same in all
// threads of the warp.
struct WarpQueue {
  int* pending;  // this warp's CLAIM_MAX entries in shared memory
  int n_pending;
  bool read;  // the warp's lanes have been read
};

static __device__ __forceinline__ WarpQueue warp_queue(int* pending) {
  return WarpQueue{pending, 0, false};
}

static __device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Give every idle thread of the warp (busy == false) a live lane, while
// there are live lanes left. On the first call the warp reads its lanes,
// [w * claim, (w + 1) * claim) for warp w of the grid: is_live(i) says
// whether lane i is to be traced, pass(i) writes the result of a lane that
// is not. Called by all threads of the warp together. Returns the lane
// this thread is to trace now, or -1 (a busy thread, or no lane left).
template <class IsLive, class Pass>
static __device__ __forceinline__ int take_rays(WarpQueue& q, int n,
                                                int claim, bool busy,
                                                IsLive is_live, Pass pass) {
  const int lane = threadIdx.x & 31;
  const unsigned idle = __ballot_sync(FULL_MASK, !busy);
  if (!q.read) {
    q.read = true;
    const long long warp =
        (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
    const long long base = warp * claim;
    // Every load first, then the passes and the list.
    bool in[CLAIM_MAX / 32], live[CLAIM_MAX / 32];
#pragma unroll
    for (int j = 0; j < CLAIM_MAX / 32; ++j) {
      const long long i = base + 32 * j + lane;
      in[j] = 32 * j < claim && i < n;
      live[j] = in[j] && is_live((int)i);
    }
#pragma unroll
    for (int j = 0; j < CLAIM_MAX / 32; ++j) {
      const int i = (int)(base + 32 * j + lane);
      if (in[j] && !live[j]) pass(i);
      const unsigned m = __ballot_sync(FULL_MASK, live[j]);
      if (live[j]) q.pending[q.n_pending + __popc(m & lanes_below())] = i;
      q.n_pending += __popc(m);
    }
  }
  __syncwarp();
  const int take = min(__popc(idle), q.n_pending);
  const int rank = __popc(idle & lanes_below());
  const int got =
      (!busy && rank < take) ? q.pending[q.n_pending - take + rank] : -1;
  q.n_pending -= take;
  __syncwarp();
  return got;
}

// Blocks of a grid over n lanes, `claim` lanes a warp.
static int lanes_grid(int n, int block, int claim) {
  const long long per_block = (long long)claim * (block / 32);
  return (int)(((long long)n + per_block - 1) / per_block);
}

}  // namespace pbrs
