// Device code shared by the fused bounces K2 (fused_bounce.cu), K3
// (fused_single_lobe.cu) and the shade pass K4 (fused_wave.cu): constants,
// the PCG and Sobol' draws of core/sampler.py, the Shirley-Chiu disk map
// and the occlusion query over the shared-memory bank. Every expression keeps the evaluation order of
// the plain versions; the library is built with -fmad=false and IEEE
// sqrt/div, so the kernels and their plain versions round alike.
#pragma once

#include "ray_queue.cuh"
#include "trace_flat.cuh"

namespace pbrs {

constexpr float SPAWN_EPS = (float)1e-3;  // geometry/ray.py SPAWN_EPS
constexpr float INV_PI = (float)(1.0 / 3.141592653589793);
constexpr float PI_4 = (float)(3.141592653589793 / 4.0);
constexpr float PI_2 = (float)(3.141592653589793 / 2.0);
constexpr float SHADOW_T = (float)(1.0 - 1e-3);

constexpr int ENV_NONE = 0, ENV_CONST = 1, ENV_GRADIENT = 2, ENV_DUSK = 3;
constexpr int DIM_LIGHT_SELECT = 1, DIM_LIGHT_UV = 2, DIM_SCATTER_UV = 3,
              DIM_BSDF_UV = 4, DIM_RUSSIAN_ROULETTE = 5;

// ---- the counter hash of core/sampler.py (hash_u32), bit for bit ----
static __device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = (k << 15) | (k >> 17);
  k *= 0x1B873593u;
  h ^= k;
  h = (h << 13) | (h >> 19);
  return h * 5u + 0xE6546B64u;
}

static __device__ __forceinline__ uint32_t hash5(uint32_t a, uint32_t b,
                                                 uint32_t c, uint32_t d,
                                                 uint32_t e) {
  uint32_t h = 0x9E3779B9u;
  h = mix(h, a);
  h = mix(h, b);
  h = mix(h, c);
  h = mix(h, d);
  h = mix(h, e);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const uint32_t word = ((h >> ((h >> 28) + 4u)) ^ h) * 277803737u;
  return (word >> 22) ^ word;
}

// ---- Owen-scrambled Sobol' (core/sampler.py sobol_bits) ----
// Laine-Karras nested-uniform scramble on the natural bit order.
static __device__ __forceinline__ uint32_t nested_scramble(uint32_t x,
                                                           uint32_t key) {
  x = __brev(x) + key;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return __brev(x);
}

// Base-2 Sobol' sample `idx` of dimension 0 (bit-reversed index) or 1
// (direction numbers v_0 = 2^31, v_k+1 = v_k ^ v_k >> 1). Dimension 1's
// generator is Pascal's matrix mod 2: v_k holds bit 31 - j where C(k, j) is
// odd, i.e. where j's bits are a subset of k's (Lucas), so output bit
// 31 - j is the parity of idx's bits k over the supersets k of j -- a
// superset-sum transform over the five bit positions of k, then a bit
// reversal. Exact integer arithmetic: the same bits as the 32-step sum
// over the direction numbers.
static __device__ __forceinline__ uint32_t sobol_u32(uint32_t idx,
                                                     uint32_t dim) {
  if (dim == 0) return __brev(idx);
  uint32_t y = idx;
  y ^= (y >> 1) & 0x55555555u;
  y ^= (y >> 2) & 0x33333333u;
  y ^= (y >> 4) & 0x0F0F0F0Fu;
  y ^= (y >> 8) & 0x00FF00FFu;
  y ^= (y >> 16) & 0x0000FFFFu;
  return __brev(y);
}

constexpr int RNG_PCG = 0, RNG_SOBOL = 1;

// A lane's uniform draws (accel/fused_kernel.py:_u1): PCG hashes (seed,
// pixel, sample, bounce*16+dim, lane); Sobol' keys both of its hashes with
// lane 0 and takes Sobol' dimension `lane`. rng is a launch argument, so
// the branch is warp-uniform.
struct Draw {
  int rng;
  uint32_t seed, pix, smp, bounce;

  __device__ __forceinline__ float operator()(uint32_t dim,
                                              uint32_t lane) const {
    const uint32_t dkey = bounce * 16u + dim;
    uint32_t bits;
    if (rng == RNG_SOBOL) {
      const uint32_t shuffle = hash5(seed, pix, dkey, 0u, 0x51633E2Du);
      const uint32_t scramble =
          hash5(seed, pix, dkey, 0u, 0x68BC21EBu + lane);
      bits = nested_scramble(sobol_u32(nested_scramble(smp, shuffle), lane),
                             scramble);
    } else {
      bits = hash5(seed, pix, smp, dkey, lane);
    }
    return (float)(bits >> 8) * (1.0f / 16777216.0f);
  }
};

// Shirley-Chiu concentric map on [-1,1]^2.
static __device__ __forceinline__ void concentric(float x, float y, float& px,
                                                  float& py) {
  const bool big = fabsf(x) > fabsf(y);
  const float r = big ? x : y;
  const float xs = (x == 0.0f) ? 1.0f : x;
  const float ys = (y == 0.0f) ? 1.0f : y;
  const float theta = big ? PI_4 * (y / xs) : PI_2 - PI_4 * (x / ys);
  const bool deg = (x == 0.0f) && (y == 0.0f);
  px = deg ? 0.0f : r * cosf(theta);
  py = deg ? 0.0f : r * sinf(theta);
}

// The primitive bank as the bounces read it (the shared-memory copy).
struct Bank {
  const float* rows;
  int n_sph, n_quad, n_tri, n_disk;
};

static __device__ __forceinline__ bool occluded(const Bank& b, const Ray& r,
                                                float t_max) {
  float t;
  int row;
  sweep<true>(b.rows, b.n_sph, b.n_quad, b.n_tri, b.n_disk, r, t_max, t, row);
  return t < BIG;
}

// ---- shadow rays swept densely (K2, K3) ----
//
// A BSDF-sampled shadow ray is needed by few lanes, yet a warp that holds
// one runs the whole any-hit sweep for it. Instead the lane writes its
// radiance as if the ray were occluded and queues the ray with the
// radiance it takes when the ray is clear; once every lane of the block is
// shaded, the block sweeps the queue one ray a thread (sweep_queue) and
// writes the clear lanes' radiance. A full queue sweeps in place.
constexpr int QUEUE_MAX = 256;
struct ShadowQueue {
  int* count;   // rays pushed (may pass QUEUE_MAX)
  int* lane;    // [QUEUE_MAX]
  float* ray;   // [QUEUE_MAX][7]: origin, direction, t_max
  float* rad;   // [QUEUE_MAX][3]: radiance if clear

  // False when the queue is full: the caller sweeps the ray itself.
  __device__ __forceinline__ bool push(int l, const Ray& r, float t_max,
                                       float r0, float r1, float r2) const {
    const int i = atomicAdd(count, 1);
    if (i >= QUEUE_MAX) return false;
    lane[i] = l;
    float* x = ray + 7 * i;
    x[0] = r.ox;
    x[1] = r.oy;
    x[2] = r.oz;
    x[3] = r.dx;
    x[4] = r.dy;
    x[5] = r.dz;
    x[6] = t_max;
    rad[3 * i] = r0;
    rad[3 * i + 1] = r1;
    rad[3 * i + 2] = r2;
    return true;
  }
};

// The block's queued shadow rays, one a thread, after a __syncthreads:
// a clear ray's lane gets its radiance (planes 0-2 of fout).
static __device__ __forceinline__ void sweep_queue(const ShadowQueue& q,
                                                   const Bank& b, float* fout,
                                                   size_t stride) {
  const int m = *q.count < QUEUE_MAX ? *q.count : QUEUE_MAX;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float* x = q.ray + 7 * i;
    if (!occluded(b, Ray{x[0], x[1], x[2], x[3], x[4], x[5]}, x[6])) {
      for (int c = 0; c < 3; ++c) fout[c * stride + q.lane[i]] = q.rad[3 * i + c];
    }
  }
}

// ---- live lanes packed into full warps (K2, K3) ----
//
// A launch covers every lane of its planes, but after the camera bounce
// many lanes are dead and the live ones are scattered over nearly every
// warp. A block takes a window of PER x blockDim.x consecutive lanes.
// Each thread reads the liveness of PER lanes of it, coalesced, and
// writes the pass-through of its dead ones itself (`pass`); the live lanes'
// indices go, in lane order, to a list in shared memory, from which the
// block's threads then take lanes densely: a window of 512 lanes with 6
// live ones runs them in one warp, not in six.

// A thread's share of the live list: lanes[first], lanes[first + step], ...
// below count.
struct LiveList {
  const int* lanes;
  int count, first, step;
};

// Called by every thread of the block. s_lane holds PER x blockDim.x ints,
// s_cnt 32; PER x blockDim.x / 32 <= 32.
template <int PER, class Pass>
static __device__ __forceinline__ LiveList live_lanes(const int* alive_in,
                                                      int n, int* s_lane,
                                                      int* s_cnt, Pass pass) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = lanes_below();
  const long long base = (long long)blockIdx.x * PER * blockDim.x;
  unsigned ball[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const long long i = base + (long long)j * blockDim.x + threadIdx.x;
    const bool in = i < n;
    const bool live = in && alive_in[i] > 0;
    if (in && !live) pass((int)i);
    ball[j] = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_cnt[j * nw + warp] = __popc(ball[j]);
  }
  __syncthreads();
  // Exclusive scan of the (chunk, warp) counts, in lane order; every warp
  // computes it (PER * nw <= 32 entries).
  const int n_cnt = PER * nw;
  const int v = lane < n_cnt ? s_cnt[lane] : 0;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int excl = incl - v;
  const int total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int off = __shfl_sync(0xffffffffu, excl, j * nw + warp);
    if ((ball[j] >> lane) & 1u)
      s_lane[off + __popc(ball[j] & below)] =
          (int)(base + (long long)j * blockDim.x + threadIdx.x);
  }
  __syncthreads();
  return LiveList{s_lane, total, (int)threadIdx.x, (int)blockDim.x};
}

// Exclusive prefix sum of a[0, len) in place, by the whole block (a in
// shared memory; warp_tot: 32 ints of shared scratch). K3's and K4's class
// sorts scan their class x chunk counts with it.
static __device__ __forceinline__ void scan_block(int* a, int len,
                                                  int* warp_tot) {
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < len ? lo + per : len;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int run = x - sum;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
}

// Exact traced-ray count of a block: warp shuffle, shared-memory sum of
// the warps, one 64-bit atomicAdd. Every thread of the block must call it.
static __device__ __forceinline__ void count_rays(unsigned rays,
                                                  unsigned long long* count) {
  __shared__ unsigned warp_sums[32];
  for (int off = 16; off > 0; off >>= 1)
    rays += __shfl_down_sync(0xffffffffu, rays, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = rays;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    rays = (int)threadIdx.x < n_warps ? warp_sums[threadIdx.x] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      rays += __shfl_down_sync(0xffffffffu, rays, off);
    if (threadIdx.x == 0 && rays) atomicAdd(count, (unsigned long long)rays);
  }
}

// Host side of a K2 / K3 launch with `smem` bytes of staged bank: opts the
// kernel in to that much dynamic shared memory where it and the kernel's
// static arrays pass the 48 KB a block gets by default;
// cudaErrorInvalidValue where the static arrays pass the room
// MAX_BANK_ROWS leaves them or the two pass the SM's 227 KB.
template <class Kernel>
static cudaError_t fit_smem(Kernel kernel, int smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const int fixed = (int)attr.sharedSizeBytes;
  if (fixed > STATIC_SMEM_RESERVE || smem + fixed > MAX_SMEM_BYTES)
    return cudaErrorInvalidValue;
  if (smem + fixed <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace pbrs
