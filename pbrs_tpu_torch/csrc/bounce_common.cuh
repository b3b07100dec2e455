// Device code shared by the fused bounces K2 (fused_bounce.cu) and K3
// (fused_single_lobe.cu): constants, the PCG counter hash of
// core/sampler.py, the Shirley-Chiu disk map and the occlusion query over
// the shared-memory bank. Every expression keeps the evaluation order of
// the plain versions; the library is built with -fmad=false and IEEE
// sqrt/div, so the kernels and their plain versions round alike.
#pragma once

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

// ---- PCG counter hash: core/sampler.py hash_u32, bit for bit ----
static __device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = (k << 15) | (k >> 17);
  k *= 0x1B873593u;
  h ^= k;
  h = (h << 13) | (h >> 19);
  return h * 5u + 0xE6546B64u;
}

static __device__ __forceinline__ float u1(uint32_t seed, uint32_t pix,
                                           uint32_t smp, uint32_t bounce,
                                           uint32_t dim, uint32_t lane) {
  uint32_t h = 0x9E3779B9u;
  h = mix(h, seed);
  h = mix(h, pix);
  h = mix(h, smp);
  h = mix(h, bounce * 16u + dim);
  h = mix(h, lane);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const uint32_t word = ((h >> ((h >> 28) + 4u)) ^ h) * 277803737u;
  const uint32_t bits = (word >> 22) ^ word;
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

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

}  // namespace pbrs
