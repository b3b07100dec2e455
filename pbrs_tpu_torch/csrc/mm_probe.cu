// The gather-matmul probe for Hopper (sm_90a): `reps` products of a bf16
// [M, 128] table with a bf16 [128, N] mask, each accumulated into an f32
// [M, N] result.
//
// Replaces the Pallas kernel tools/_prof_rounds.py:mm_kernel (launched by
// mm_bench), which times one one-hot gather round of the treelet tracer
// at its kernel shape ([1728, 128] x [128, 1024], Precision.DEFAULT with an
// f32 result) by repeating the product `reps` times inside one launch. The
// port's tracers gather with plain indexing, so no render path runs this
// kernel: it answers the profiling question of what one such product costs
// on this card (pbrs_tpu_torch/tools/prof_rounds.py).
//
// What bounds it on the H100: operations. A product is 2 * M * 128 * N
// flops on 0.26 MB of operands, far above the card's 295 flops a byte.
// The design: one block of four warps owns a 64 x 64 tile of the result;
// it stages its 64 rows of the table and its 64 columns of the mask
// (transposed, so each k-pair is one 32-bit word) in shared memory once,
// then runs every rep from there: a warp computes a fresh 16 x 64 product
// with mma.sync m16n8k16 (bf16 in, f32 accumulate) over the eight k-steps
// and adds it to its running f32 sum, as mm_kernel's fori_loop adds each
// dot_general to its accumulator. A simple kernel, right first: no TMA, no
// wgmma, no pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pbrs {
namespace mm {

constexpr int K = 128;    // the table's width, the mask's height
constexpr int TILE = 64;  // a block's rows and columns of the result
constexpr int PAD = 8;    // bf16s of padding a shared row (fewer conflicts)
constexpr int ROW = K + PAD;
constexpr int THREADS = 128;

static __device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
    mm_probe_kernel(const __nv_bfloat16* __restrict__ tab,
                    const __nv_bfloat16* __restrict__ mask, int n_cols,
                    int reps, float* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 a_s[TILE * ROW];
  __shared__ __align__(16) __nv_bfloat16 b_s[TILE * ROW];  // [col][k]
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  // The table's 64 rows: 16-byte loads, 16 a row.
  for (int e = tid; e < TILE * (K / 8); e += THREADS) {
    const int r = e / (K / 8), c = (e % (K / 8)) * 8;
    *reinterpret_cast<uint4*>(a_s + r * ROW + c) =
        *reinterpret_cast<const uint4*>(tab + (size_t)(row0 + r) * K + c);
  }
  // The mask's 64 columns, transposed into [col][k].
  const unsigned short* mask16 = reinterpret_cast<const unsigned short*>(mask);
  unsigned short* b16 = reinterpret_cast<unsigned short*>(b_s);
  for (int e = tid; e < K * TILE; e += THREADS) {
    const int k = e / TILE, c = e % TILE;
    b16[c * ROW + k] = mask16[(size_t)k * n_cols + col0 + c];
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;  // mma fragment group, thread in it
  const int wr = warp * 16;              // the warp's first row in the tile
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    float prod[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      prod[j][0] = prod[j][1] = prod[j][2] = prod[j][3] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * q;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(a_s + (wr + g) * ROW + ka);
      a[1] = *reinterpret_cast<const uint32_t*>(a_s + (wr + g + 8) * ROW + ka);
      a[2] = *reinterpret_cast<const uint32_t*>(a_s + (wr + g) * ROW + ka + 8);
      a[3] =
          *reinterpret_cast<const uint32_t*>(a_s + (wr + g + 8) * ROW + ka + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* bc = b_s + (j * 8 + g) * ROW + ka;
        mma_bf16(prod[j], a, *reinterpret_cast<const uint32_t*>(bc),
                 *reinterpret_cast<const uint32_t*>(bc + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = acc[j][i] + prod[j][i];
  }
  // Fragment layout of the 16 x 8 f32 result: elements 0-1 on row g,
  // 2-3 on row g + 8, columns 2q and 2q + 1.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col0 + j * 8 + 2 * q;
    float* o0 = out + (size_t)(row0 + wr + g) * n_cols + c;
    float* o1 = out + (size_t)(row0 + wr + g + 8) * n_cols + c;
    *reinterpret_cast<float2*>(o0) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(o1) = make_float2(acc[j][2], acc[j][3]);
  }
}

}  // namespace mm
}  // namespace pbrs

extern "C" {

// tab: [m, 128] bf16; mask: [128, n] bf16; out: [m, n] float32; m and n
// multiples of 64. Returns cudaGetLastError() after the launch.
int pbrs_mm_probe(const void* tab, const void* mask, int m, int n, int reps,
                  float* out, void* stream) {
  namespace mm = pbrs::mm;
  if (m % mm::TILE || n % mm::TILE || reps < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / mm::TILE, m / mm::TILE);
  mm::mm_probe_kernel<<<grid, mm::THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(tab),
      static_cast<const __nv_bfloat16*>(mask), n, reps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
