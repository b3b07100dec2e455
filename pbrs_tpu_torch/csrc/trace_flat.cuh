// Shared device code of the flat-bank trace (K1) and the fused bounce (K2).
//
// The closest-hit sweep of one ray over the [P,16] primitive bank, in the
// arithmetic of pbrs_tpu/accel/trace_pallas.py:_trace_kernel (and its
// inlined twin fused_kernel.py:_trace_tables): spheres, quads, triangles,
// disks in that order, `t < t_best` so ties keep the lowest row. Every
// expression keeps the reference's evaluation order; the library is built
// with -fmad=false, so each product and sum rounds as PyTorch's one-op
// kernels round it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pbrs {

constexpr int BANK_COLS = 16;
constexpr float T_MIN = (float)1.19209290e-07;  // geometry/ray.py T_MIN
constexpr float BIG = 3.0e38f;

// NaN-propagating min/max/clamp, as torch.minimum / torch.maximum /
// torch.clamp_min.
static __device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
static __device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
static __device__ __forceinline__ float max0(float a, float lo) {
  return (a != a) ? a : fmaxf(a, lo);
}
static __device__ __forceinline__ float minimum(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}
static __device__ __forceinline__ float maximum(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Keep the closer of the held hit and candidate t (if t is valid).
static __device__ __forceinline__ void consider(float t, bool ok, float t_max,
                                                int row, float& t_best,
                                                int& row_best) {
  t = (ok && t >= T_MIN && t < t_max) ? t : BIG;
  if (t < t_best) {
    t_best = t;
    row_best = row;
  }
}

// Closest hit (ANY_HIT=false) or first hit (ANY_HIT=true) of one ray over
// the bank; t_best = BIG and row_best = -1 on a miss.
template <bool ANY_HIT>
static __device__ __forceinline__ void sweep(const float* bank, int n_sph,
                                             int n_quad, int n_tri, int n_disk,
                                             const Ray& r, float t_max,
                                             float& t_best, int& row_best) {
  t_best = BIG;
  row_best = -1;
  const float rox = r.ox, roy = r.oy, roz = r.oz;
  const float rdx = r.dx, rdy = r.dy, rdz = r.dz;
  int row = 0;
  for (int i = 0; i < n_sph; ++i, ++row) {
    const float* p = bank + row * BANK_COLS;
    const float cx = p[0], cy = p[1], cz = p[2], rad = p[3];
    const float fx = rox - cx, fy = roy - cy, fz = roz - cz;
    const float a = rdx * rdx + rdy * rdy + rdz * rdz;
    const float b_pr = -(fx * rdx + fy * rdy + fz * rdz);
    const float inv_a = 1.0f / max0(a, (float)1e-30);
    const float mx = fx + b_pr * inv_a * rdx;
    const float my = fy + b_pr * inv_a * rdy;
    const float mz = fz + b_pr * inv_a * rdz;
    const float delta = rad * rad - (mx * mx + my * my + mz * mz);
    const bool has = delta >= 0.0f;
    const float c = fx * fx + fy * fy + fz * fz - rad * rad;
    const float q =
        b_pr + (b_pr >= 0.0f ? 1.0f : -1.0f) * sqrtf(max0(delta * a, 0.0f));
    const float q_s = (q == 0.0f) ? 1.0f : q;
    const float t0 = c / q_s;
    const float t1 = q * inv_a;
    const float t_lo = minimum(t0, t1);
    const float t_hi = maximum(t0, t1);
    const bool ok = has && (q != 0.0f);
    const bool lo_ok = ok && (t_lo >= T_MIN) && (t_lo < t_max);
    consider(lo_ok ? t_lo : t_hi, ok, t_max, row, t_best, row_best);
    if (ANY_HIT && row_best >= 0) return;
  }
  for (int i = 0; i < n_quad; ++i, ++row) {
    const float* p = bank + row * BANK_COLS;
    const float ox_ = p[0], oy_ = p[1], oz_ = p[2];
    const float ux = p[3], uy = p[4], uz = p[5];
    const float vx = p[6], vy = p[7], vz = p[8];
    const float nx = p[9], ny = p[10], nz = p[11];
    const float inv_n2 = 1.0f / p[12];
    const float denom = rdx * nx + rdy * ny + rdz * nz;
    const float denom_s = (denom == 0.0f) ? 1.0f : denom;
    const float t =
        ((ox_ - rox) * nx + (oy_ - roy) * ny + (oz_ - roz) * nz) / denom_s;
    const float px = rox + t * rdx - ox_;
    const float py = roy + t * rdy - oy_;
    const float pz = roz + t * rdz - oz_;
    float cx = py * vz - pz * vy;
    float cy = pz * vx - px * vz;
    float cz = px * vy - py * vx;
    const float uu = (cx * nx + cy * ny + cz * nz) * inv_n2;
    cx = uy * pz - uz * py;
    cy = uz * px - ux * pz;
    cz = ux * py - uy * px;
    const float vv = (cx * nx + cy * ny + cz * nz) * inv_n2;
    const bool ok = (denom != 0.0f) && (uu >= 0.0f) && (uu <= 1.0f) &&
                    (vv >= 0.0f) && (vv <= 1.0f);
    consider(t, ok, t_max, row, t_best, row_best);
    if (ANY_HIT && row_best >= 0) return;
  }
  for (int i = 0; i < n_tri; ++i, ++row) {
    const float* p = bank + row * BANK_COLS;
    const float p0x = p[0], p0y = p[1], p0z = p[2];
    const float p1x = p[3], p1y = p[4], p1z = p[5];
    const float p2x = p[6], p2y = p[7], p2z = p[8];
    const float nx = p[9], ny = p[10], nz = p[11];
    const float denom = rdx * nx + rdy * ny + rdz * nz;
    const float denom_s = (denom == 0.0f) ? 1.0f : denom;
    const float t =
        ((p0x - rox) * nx + (p0y - roy) * ny + (p0z - roz) * nz) / denom_s;
    const float hx = rox + t * rdx;
    const float hy = roy + t * rdy;
    const float hz = roz + t * rdz;
    auto edge = [&](float ax, float ay, float az, float bx, float by,
                    float bz) {
      const float ex = hx - ax, ey = hy - ay, ez = hz - az;
      const float fx = hx - bx, fy = hy - by, fz = hz - bz;
      return (ey * fz - ez * fy) * nx + (ez * fx - ex * fz) * ny +
             (ex * fy - ey * fx) * nz;
    };
    const float b2 = edge(p0x, p0y, p0z, p1x, p1y, p1z);
    const float b0 = edge(p1x, p1y, p1z, p2x, p2y, p2z);
    const float b1 = edge(p2x, p2y, p2z, p0x, p0y, p0z);
    const bool inside = (b0 > 0.0f && b1 > 0.0f && b2 > 0.0f) ||
                        (b0 < 0.0f && b1 < 0.0f && b2 < 0.0f);
    consider(t, (denom != 0.0f) && inside, t_max, row, t_best, row_best);
    if (ANY_HIT && row_best >= 0) return;
  }
  for (int i = 0; i < n_disk; ++i, ++row) {
    const float* p = bank + row * BANK_COLS;
    const float cx_ = p[0], cy_ = p[1], cz_ = p[2];
    const float nx = p[3], ny = p[4], nz = p[5];
    const float r2 = p[6];
    const float denom = rdx * nx + rdy * ny + rdz * nz;
    const float denom_s = (denom == 0.0f) ? 1.0f : denom;
    const float t =
        ((cx_ - rox) * nx + (cy_ - roy) * ny + (cz_ - roz) * nz) / denom_s;
    const float px = rox + t * rdx - cx_;
    const float py = roy + t * rdy - cy_;
    const float pz = roz + t * rdz - cz_;
    const bool inside = px * px + py * py + pz * pz <= r2;
    consider(t, (denom != 0.0f) && inside, t_max, row, t_best, row_best);
    if (ANY_HIT && row_best >= 0) return;
  }
}

// Copy the bank into shared memory; every thread of the block helps.
static __device__ __forceinline__ void stage_bank(float* s_bank,
                                                  const float* bank,
                                                  int n_rows) {
  for (int i = threadIdx.x; i < n_rows * BANK_COLS; i += blockDim.x)
    s_bank[i] = bank[i];
  __syncthreads();
}

// Dynamic shared memory a block may use on sm_90 (227 KB).
constexpr int MAX_SMEM_BYTES = 232448;
// Room is left for the kernels' small static shared arrays.
constexpr int MAX_BANK_ROWS =
    (MAX_SMEM_BYTES - 1024) / (BANK_COLS * (int)sizeof(float));

}  // namespace pbrs
