// K1: flat-bank closest-hit / occlusion trace for Hopper (sm_90a).
//
// Replaces the Pallas kernel pbrs_tpu/accel/trace_pallas.py:_trace_kernel
// (launched by _trace_padded). Contract: for each ray the closest hit over
// the [P,16] bank -> (t, global prim id from bank column 15), inf / -1 on
// a miss; a ray with t_max <= 0 is dead and writes inf / -1 without a
// sweep. With any_hit the ray stops at its first hit: t is then finite
// exactly where the closest-hit sweep's t is (occlusion = isfinite(t)).
//
// What bounds it on the H100: arithmetic. Each ray does ~30 flops per
// primitive (18 prims for Cornell) against 36 bytes of ray I/O, far above
// the card's bytes-per-flop line, so memory traffic is tiny and the FP32
// pipes and the per-ray branches decide the time.
// What the design does about it: one thread per ray over SoA planes
// (coalesced loads, ragged edge masked in the kernel, no TPU [rows,128]
// padding); the bank is staged once per block into shared memory, where
// every thread of a warp reads the same row (a broadcast, no bank
// conflicts); a dead ray exits before the sweep, the per-thread form of the
// TPU's all-dead-tile early exit. Shared memory caps the bank at
// MAX_BANK_ROWS rows; the wrapper raises above that.
#include "trace_flat.cuh"

namespace pbrs {

template <bool ANY_HIT>
__global__ void trace_flat_kernel(const float* __restrict__ bank, int n_sph,
                                  int n_quad, int n_tri, int n_disk,
                                  const float* __restrict__ planes, int n,
                                  float* __restrict__ t_out,
                                  int* __restrict__ id_out) {
  extern __shared__ float s_bank[];
  stage_bank(s_bank, bank, n_sph + n_quad + n_tri + n_disk);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t stride = (size_t)n;
  const float t_max = planes[6 * stride + lane];
  float t = __int_as_float(0x7f800000);  // +inf
  int id = -1;
  if (t_max > 0.0f) {
    const Ray r{planes[lane], planes[stride + lane], planes[2 * stride + lane],
                planes[3 * stride + lane], planes[4 * stride + lane],
                planes[5 * stride + lane]};
    float t_best;
    int row;
    sweep<ANY_HIT>(s_bank, n_sph, n_quad, n_tri, n_disk, r, t_max, t_best,
                   row);
    if (t_best < BIG) {
      t = t_best;
      id = (int)s_bank[row * BANK_COLS + 15];
    }
  }
  t_out[lane] = t;
  id_out[lane] = id;
}

template <bool ANY_HIT>
static void launch(const float* bank, int n_sph, int n_quad, int n_tri,
                   int n_disk, const float* planes, int n, float* t_out,
                   int* id_out, cudaStream_t stream) {
  const int n_rows = n_sph + n_quad + n_tri + n_disk;
  const int smem = n_rows * BANK_COLS * (int)sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(trace_flat_kernel<ANY_HIT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int block = 256;
  const int grid = (n + block - 1) / block;
  trace_flat_kernel<ANY_HIT><<<grid, block, smem, stream>>>(
      bank, n_sph, n_quad, n_tri, n_disk, planes, n, t_out, id_out);
}

}  // namespace pbrs

extern "C" {

// planes: [7, n] float32 (ox, oy, oz, dx, dy, dz, t_max); t_out [n] float32;
// id_out [n] int32. Returns cudaGetLastError() after the launch.
int pbrs_trace_flat(const float* bank, int n_sph, int n_quad, int n_tri,
                    int n_disk, const float* planes, int n, float* t_out,
                    int* id_out, int any_hit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    pbrs::launch<true>(bank, n_sph, n_quad, n_tri, n_disk, planes, n, t_out,
                       id_out, s);
  else
    pbrs::launch<false>(bank, n_sph, n_quad, n_tri, n_disk, planes, n, t_out,
                        id_out, s);
  return (int)cudaGetLastError();
}

const char* pbrs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pbrs_max_bank_rows() { return pbrs::MAX_BANK_ROWS; }

}  // extern "C"
