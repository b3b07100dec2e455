// The gather-matmul probe for Hopper (sm_90a): `reps` products of a bf16
// [M, 128] table with a bf16 [128, N] mask, each added in f32 to a running
// [M, N] sum.
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
// flops on 0.26 MB of operands, far above the card's 295 flops a byte, and
// only wgmma reaches the dense bf16 rate.
// The design: one warpgroup (a block of 128 threads) owns a 64 x 128 tile
// of the result. Its 64 rows of the table (K-major) and its 128 columns of
// the mask (N-major, as the mask lies in memory) are copied into shared
// memory once, with cp.async, in the 128-byte-swizzled layout that
// wgmma's shared-memory descriptors read; every rep then runs from there
// and issues no load. A rep issues the eight k-steps of
// wgmma.m64n128k16 into a fresh product accumulator (scale-d 0 on the
// first step), waits on it and adds the product to the running f32 sum,
// so the sum is taken in mm_kernel's order, acc = acc + a @ b; the sums of
// reps are never folded into wgmma's own accumulator, which would round
// differently. The 1728 x 1024 result is 216 tiles; two blocks fit an SM
// (152 registers a thread, 49 KB of shared memory a block), so all 216 are
// resident at once on the 132 SMs, and one block's adds overlap the other
// block's wgmma. (Two product accumulators in turn inside one warpgroup,
// so that a rep's adds overlap its own next wgmma, make ptxas serialize
// the wgmma pipeline -- its note C7514 -- and ran slower on an H100.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pbrs {
namespace mm {

constexpr int K = 128;        // the table's width, the mask's height
constexpr int BM = 64;        // a block's rows of the result (wgmma's M)
constexpr int BN = 128;       // a block's columns of the result (wgmma's N)
constexpr int THREADS = 128;  // one warpgroup
constexpr int KSTEPS = K / 16;
constexpr int NACC = BN / 2;  // f32 accumulator registers a thread
// Shared memory: the table tile as two K atoms of 64 rows x 128 bytes, the
// mask tile as two N atoms of 128 K-rows x 128 bytes (64 bf16 of N each).
constexpr uint32_t A_ATOM = BM * 128, A_BYTES = 2 * A_ATOM;
constexpr uint32_t B_ATOM = K * 128, B_BYTES = 2 * B_ATOM;
constexpr int SMEM_BYTES = A_BYTES + B_BYTES + 1024;  // + alignment slack

// The descriptors' byte offsets. The table (K-major, 128B swizzle): groups
// of 8 rows 1024 bytes apart (stride); a k-step moves the start 32 bytes
// inside an atom. The mask (N-major, 128B swizzle, CUTLASS's canonical
// ((T,8,m),(8,k)):((1,T,LBO),(8T,SBO)) layout): its two 64-column atoms
// B_ATOM bytes apart (leading), groups of 8 K-rows 1024 bytes apart
// (stride); a k-step moves the start two such groups.
constexpr uint32_t A_SBO = 1024, B_LBO = B_ATOM, B_SBO = 1024;

// The 128-byte swizzle inside 1024-byte-aligned atoms: the 16-byte chunk
// (address bits 4-6) is XORed with the row within the 8-row group (bits
// 7-9), as wgmma's 128B layout reads it.
static __device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

static __device__ __forceinline__ void cp_async16(uint32_t dst,
                                                  const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle.
static __device__ __forceinline__ uint64_t smem_desc(uint32_t addr,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A[64 x 16] * B[16 x 128]: A K-major, B N-major (transposed);
// scale_d 0 writes the product alone.
static __device__ __forceinline__ void wgmma_m64n128k16(float* d,
                                                        uint64_t da,
                                                        uint64_t db,
                                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Pins the accumulator registers at this point of the instruction stream,
// so that no read or write of them moves across a wgmma issue or wait.
static __device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One rep: the eight k-steps into a fresh product.
static __device__ __forceinline__ void product(float* d, uint32_t a_base,
                                               uint32_t b_base) {
  fence_operands(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const uint64_t da =
        smem_desc(a_base + (s / 4) * A_ATOM + (s % 4) * 32, 16, A_SBO);
    const uint64_t db = smem_desc(b_base + s * 2 * B_SBO, B_LBO, B_SBO);
    wgmma_m64n128k16(d, da, db, s > 0);
  }
  wgmma_commit();
  fence_operands(d);
}

static __device__ __forceinline__ void add_to(float* acc, float* p) {
  fence_operands(p);
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = acc[i] + p[i];
}

__global__ void __launch_bounds__(THREADS, 2)
    mm_probe_kernel(const __nv_bfloat16* __restrict__ tab,
                    const __nv_bfloat16* __restrict__ mask, int n_cols,
                    int reps, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t a_base = (raw + 1023u) & ~1023u;
  const uint32_t b_base = a_base + A_BYTES;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  // The table's 64 rows: 16 chunks of 16 bytes a row, K-major.
  for (int e = tid; e < BM * 16; e += THREADS) {
    const int r = e / 16, c = e % 16;
    const uint32_t off = (c / 8) * A_ATOM + r * 128 + (c % 8) * 16;
    cp_async16(a_base + swizzle(off), tab + (size_t)(row0 + r) * K + c * 8);
  }
  // The mask's 128 columns: 16 chunks a K-row, N-major.
  for (int e = tid; e < K * 16; e += THREADS) {
    const int k = e / 16, c = e % 16;
    const uint32_t off = (c / 8) * B_ATOM + k * 128 + (c % 8) * 16;
    cp_async16(b_base + swizzle(off),
               mask + (size_t)k * n_cols + col0 + c * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // Make the copies visible to wgmma's (async-proxy) reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float acc[NACC], prod[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = prod[i] = 0.0f;
  for (int r = 0; r < reps; ++r) {
    product(prod, a_base, b_base);
    wgmma_wait_all();
    add_to(acc, prod);
  }
  // The accumulator's layout: warp w holds rows 16w..16w+15; register
  // 4j + i of lane (g = lane / 4, q = lane % 4) is row g (+ 8 for i >= 2),
  // column 8j + 2q (+ 1 for odd i).
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  float* o0 = out + (size_t)(row0 + 16 * warp + g) * n_cols + col0 + 2 * q;
  float* o1 = o0 + (size_t)8 * n_cols;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(o0 + 8 * j) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(o1 + 8 * j) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace mm
}  // namespace pbrs

extern "C" {

// tab: [m, 128] bf16; mask: [128, n] bf16; out: [m, n] float32; m a
// multiple of 64, n of 128. Returns cudaGetLastError() after the launch.
int pbrs_mm_probe(const void* tab, const void* mask, int m, int n, int reps,
                  float* out, void* stream) {
  namespace mm = pbrs::mm;
  if (m % mm::BM || n % mm::BN || reps < 0) return (int)cudaErrorInvalidValue;
  // A per-device attribute: set on every launch.
  const cudaError_t e = cudaFuncSetAttribute(
      mm::mm_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mm::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n / mm::BN, m / mm::BM);
  mm::mm_probe_kernel<<<grid, mm::THREADS, mm::SMEM_BYTES,
                        (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(tab),
      static_cast<const __nv_bfloat16*>(mask), n, reps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
