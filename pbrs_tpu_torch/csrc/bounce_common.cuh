// Device code shared by the fused bounces K2 (fused_bounce.cu), K3
// (fused_single_lobe.cu) and the shade pass K4 (fused_wave.cu): constants,
// the PCG and Sobol' draws of core/sampler.py, the Shirley-Chiu disk map
// and the occlusion query over the shared-memory bank. Every expression keeps the evaluation order of
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
// (direction numbers v_0 = 2^31, v_k+1 = v_k ^ v_k >> 1).
static __device__ __forceinline__ uint32_t sobol_u32(uint32_t idx,
                                                     uint32_t dim) {
  if (dim == 0) return __brev(idx);
  uint32_t out = 0u, v = 1u << 31;
  for (int k = 0; k < 32; ++k) {
    if ((idx >> k) & 1u) out ^= v;
    v ^= v >> 1;
  }
  return out;
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
