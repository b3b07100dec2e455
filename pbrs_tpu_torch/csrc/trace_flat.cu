// K1: flat-bank closest-hit / occlusion trace for Hopper (sm_90a).
//
// Replaces the Pallas kernel pbrs_tpu/accel/trace_pallas.py:_trace_kernel
// (launched by _trace_padded). Contract: for each ray the closest hit over
// the flat bank -> (t, global prim id), inf / -1 on a miss, ties to the
// lowest id; a ray with t_max <= 0 is dead and writes inf / -1 without a
// sweep. With any_hit the ray stops at its first hit: t is then finite
// exactly where the closest-hit sweep's t is (occlusion = isfinite(t)).
//
// The bank comes packed by accel/trace_kernel.py:pack_bank: each family's
// rows (spheres, quads, triangles, disks) in Morton order of their centres,
// cut into chunks of a few rows (trace_kernel.py CHUNK), each with a
// padded box; a family's rows at its own stride (4, 13, 12, 8 floats) and
// the global ids apart. The per-primitive tests are trace_flat.cuh:sweep's,
// expression for expression (the library is built with -fmad=false), so
// every candidate t is the plain version's (trace_kernel.py:
// trace_reference) bit for bit; as the chunks change the visiting order, a
// hit is kept by an explicit (t, global id) comparison, and ids rise with
// bank row, so the lowest id is the plain version's lowest row.
//
// What bounds it on the H100: arithmetic. A ray does ~30-90 flops per
// primitive against 36 bytes of ray I/O, far above the card's
// bytes-per-flop line.
// What the design does about it:
// - Fewer primitive tests: a warp tests each chunk's box against its rays
//   and skips the chunk when no ray of the warp can reach it before its
//   best hit (__any_sync), so a ray sweeps the chunks along its path, not
//   the bank.
// - Live rays in full warps (ray_queue.cuh): a warp takes 32 lanes for a
//   closest hit (neighbouring rays, which cull alike) and 128 for an any
//   hit (sparser), writes dead lanes itself and sweeps its live rays 32 at
//   a time.
// - The bank copied once a block (cp.async), at its packed size: a sphere
//   takes 16 bytes of shared memory instead of a 64-byte row, so more
//   blocks fit on an SM. Every thread of a warp reads the same row (a
//   broadcast). The wrapper raises above the bytes shared memory holds.
#include "ray_queue.cuh"
#include "trace_flat.cuh"

namespace pbrs {

constexpr int FLAT_BLOCK = 256;
// Floats a row of each family takes in the packed bank.
constexpr int SPH_STRIDE = 4, QUAD_STRIDE = 13, TRI_STRIDE = 12,
              DISK_STRIDE = 8;
// Floats of one chunk entry: box lo xyz, hi xyz, then its first row (within
// the family) and row count as int32 bits.
constexpr int CHUNK_FLOATS = 8;
constexpr int FLAT_QUEUE_BYTES =
    (FLAT_BLOCK / 32) * CLAIM_MAX * (int)sizeof(int);
constexpr int MAX_PACKED_BYTES = MAX_SMEM_BYTES - FLAT_QUEUE_BYTES;
// accel/treelet.py SLAB_EPS, rounded from doubles as PyTorch rounds them.
constexpr float FLAT_SLAB_LO = (float)(1.0 - 1e-4);
constexpr float FLAT_SLAB_HI = (float)(1.0 + 1e-4);

// Where each section of the packed bank starts, in floats, and its size.
struct Layout {
  int rows[4];      // spheres, quads, triangles, disks
  int chunks[4];    // chunks of each family, in the chunk table in order
  int offset[4];    // first float of each family's rows
  int ids;          // first float of the global ids (int32 bits)
  int n_floats;     // the whole packed bank, a multiple of 4
};

// The per-primitive tests of trace_flat.cuh:sweep, one row at a time: the
// candidate t, BIG when the row is no hit for this ray.
static __device__ __forceinline__ float sphere_t(const float* p, const Ray& r,
                                                 float t_max) {
  const float rox = r.ox, roy = r.oy, roz = r.oz;
  const float rdx = r.dx, rdy = r.dy, rdz = r.dz;
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
  const float t = lo_ok ? t_lo : t_hi;
  return (ok && t >= T_MIN && t < t_max) ? t : BIG;
}

static __device__ __forceinline__ float quad_t(const float* p, const Ray& r,
                                               float t_max) {
  const float rox = r.ox, roy = r.oy, roz = r.oz;
  const float rdx = r.dx, rdy = r.dy, rdz = r.dz;
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
  return (ok && t >= T_MIN && t < t_max) ? t : BIG;
}

static __device__ __forceinline__ float tri_t(const float* p, const Ray& r,
                                              float t_max) {
  const float rox = r.ox, roy = r.oy, roz = r.oz;
  const float rdx = r.dx, rdy = r.dy, rdz = r.dz;
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
  const bool ok = (denom != 0.0f) && inside;
  return (ok && t >= T_MIN && t < t_max) ? t : BIG;
}

static __device__ __forceinline__ float disk_t(const float* p, const Ray& r,
                                               float t_max) {
  const float rox = r.ox, roy = r.oy, roz = r.oz;
  const float rdx = r.dx, rdy = r.dy, rdz = r.dz;
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
  const bool ok = (denom != 0.0f) && inside;
  return (ok && t >= T_MIN && t < t_max) ? t : BIG;
}

// The conservative slab test of a chunk's box (trace_bvh.cu:box_hit, the
// node test of K5, with plain fminf / fmaxf: it only culls).
static __device__ __forceinline__ bool chunk_hit(const float* c, const Ray& r,
                                                 float ix, float iy, float iz,
                                                 float t_max, float t_best) {
  const float tx0 = (c[0] - r.ox) * ix;
  const float tx1 = (c[3] - r.ox) * ix;
  const float ty0 = (c[1] - r.oy) * iy;
  const float ty1 = (c[4] - r.oy) * iy;
  const float tz0 = (c[2] - r.oz) * iz;
  const float tz1 = (c[5] - r.oz) * iz;
  const float t_enter =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_exit =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  const float te = t_enter * (t_enter > 0.0f ? FLAT_SLAB_LO : FLAT_SLAB_HI);
  const float tx = t_exit * (t_exit > 0.0f ? FLAT_SLAB_HI : FLAT_SLAB_LO);
  return te <= tx && tx >= T_MIN && te < t_max && te <= t_best;
}

template <int FAMILY>
static __device__ __forceinline__ float family_t(const float* p, const Ray& r,
                                                 float t_max) {
  if (FAMILY == 0) return sphere_t(p, r, t_max);
  if (FAMILY == 1) return quad_t(p, r, t_max);
  if (FAMILY == 2) return tri_t(p, r, t_max);
  return disk_t(p, r, t_max);
}

// One family's chunks against the warp's rays. Returns false when every
// ray of the warp is done (any hit only).
template <int FAMILY, int STRIDE, bool ANY_HIT>
static __device__ __forceinline__ bool sweep_family(
    const float* s_bank, const Layout& L, int first_chunk, bool& active,
    const Ray& r, float ix, float iy, float iz, float t_max, float& t_best,
    int& g_best) {
  const int* ids = reinterpret_cast<const int*>(s_bank + L.ids);
  const float* rows = s_bank + L.offset[FAMILY];
  int id_base = 0;
  for (int f = 0; f < FAMILY; ++f) id_base += L.rows[f];
  for (int k = 0; k < L.chunks[FAMILY]; ++k) {
    const float* c = s_bank + (first_chunk + k) * CHUNK_FLOATS;
    const bool in = active && chunk_hit(c, r, ix, iy, iz, t_max, t_best);
    if (!__any_sync(FULL_MASK, in)) continue;
    if (in) {
      const int first = __float_as_int(c[6]);
      const int count = __float_as_int(c[7]);
      for (int j = first; j < first + count; ++j) {
        const float t = family_t<FAMILY>(rows + j * STRIDE, r, t_max);
        if (t < BIG) {
          const int g = ids[id_base + j];
          if (t < t_best || (t == t_best && g < g_best)) {
            t_best = t;
            g_best = g;
          }
          if (ANY_HIT) break;
        }
      }
      if (ANY_HIT && g_best >= 0) active = false;
    }
    if (ANY_HIT && !__any_sync(FULL_MASK, active)) return false;
  }
  return true;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(FLAT_BLOCK)
    trace_flat_kernel(const float* __restrict__ packed, Layout L,
                      const float* __restrict__ planes, int n, int claim,
                      float* __restrict__ t_out, int* __restrict__ id_out) {
  extern __shared__ float4 smem4[];
  float* s_bank = reinterpret_cast<float*>(smem4);
  // The packed bank, once a block, 16 bytes a copy.
  for (int i = threadIdx.x; i < L.n_floats / 4; i += FLAT_BLOCK) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem4 + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(packed + 4 * i));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  WarpQueue q = warp_queue(reinterpret_cast<int*>(s_bank + L.n_floats) +
                           warp * CLAIM_MAX);
  const size_t stride = (size_t)n;
  auto is_live = [&](int i) { return planes[6 * stride + i] > 0.0f; };
  auto pass = [&](int i) {
    t_out[i] = inf_f();
    id_out[i] = -1;
  };
  const int first_chunk[4] = {0, L.chunks[0], L.chunks[0] + L.chunks[1],
                              L.chunks[0] + L.chunks[1] + L.chunks[2]};
  while (true) {
    const int lane = take_rays(q, n, claim, false, is_live, pass);
    if (__ballot_sync(FULL_MASK, lane >= 0) == 0) break;
    bool active = lane >= 0;
    const int i = active ? lane : 0;
    const Ray r{planes[i], planes[stride + i], planes[2 * stride + i],
                planes[3 * stride + i], planes[4 * stride + i],
                planes[5 * stride + i]};
    const float t_max = planes[6 * stride + i];
    const float ix = 1.0f / ((r.dx == 0.0f) ? (float)1e-30 : r.dx);
    const float iy = 1.0f / ((r.dy == 0.0f) ? (float)1e-30 : r.dy);
    const float iz = 1.0f / ((r.dz == 0.0f) ? (float)1e-30 : r.dz);
    float t_best = BIG;
    int g_best = -1;
    // Families in bank order; with any hit, a warp stops when every ray is
    // done.
    bool more = sweep_family<0, SPH_STRIDE, ANY_HIT>(
        s_bank, L, first_chunk[0], active, r, ix, iy, iz, t_max, t_best,
        g_best);
    if (more)
      more = sweep_family<1, QUAD_STRIDE, ANY_HIT>(
          s_bank, L, first_chunk[1], active, r, ix, iy, iz, t_max, t_best,
          g_best);
    if (more)
      more = sweep_family<2, TRI_STRIDE, ANY_HIT>(
          s_bank, L, first_chunk[2], active, r, ix, iy, iz, t_max, t_best,
          g_best);
    if (more)
      sweep_family<3, DISK_STRIDE, ANY_HIT>(s_bank, L, first_chunk[3], active,
                                            r, ix, iy, iz, t_max, t_best,
                                            g_best);
    if (lane >= 0) {
      t_out[lane] = g_best >= 0 ? t_best : inf_f();
      id_out[lane] = g_best;
    }
  }
}

template <bool ANY_HIT>
static int launch(const float* packed, const Layout& L, const float* planes,
                  int n, int claim, float* t_out, int* id_out,
                  cudaStream_t stream) {
  auto kernel = trace_flat_kernel<ANY_HIT>;
  const int smem = L.n_floats * (int)sizeof(float) + FLAT_QUEUE_BYTES;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  kernel<<<lanes_grid(n, FLAT_BLOCK, claim), FLAT_BLOCK, smem, stream>>>(
      packed, L, planes, n, claim, t_out, id_out);
  return (int)cudaGetLastError();
}

}  // namespace pbrs

extern "C" {

// packed: the bank as accel/trace_kernel.py:pack_bank lays it out, 16-byte
// aligned; layout: 14 host int32 (rows of each family, chunks of each
// family, the first float of each family's rows, of the ids, the packed
// size in floats); planes: [7, n] float32 (ox, oy, oz, dx, dy, dz, t_max);
// claim: lanes a warp (a multiple of 32 up to 128); t_out [n] float32;
// id_out [n] int32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without a launch when the bank does not fit or
// the claim is not one of those).
int pbrs_trace_flat(const float* packed, const int* layout,
                    const float* planes, int n, int claim, float* t_out,
                    int* id_out, int any_hit, void* stream) {
  pbrs::Layout L;
  for (int f = 0; f < 4; ++f) {
    L.rows[f] = layout[f];
    L.chunks[f] = layout[4 + f];
    L.offset[f] = layout[8 + f];
  }
  L.ids = layout[12];
  L.n_floats = layout[13];
  if (L.n_floats % 4 ||
      L.n_floats * (int)sizeof(float) > pbrs::MAX_PACKED_BYTES ||
      claim < 32 || claim % 32 || claim > pbrs::CLAIM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return any_hit ? pbrs::launch<true>(packed, L, planes, n, claim, t_out,
                                      id_out, s)
                 : pbrs::launch<false>(packed, L, planes, n, claim, t_out,
                                       id_out, s);
}

const char* pbrs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2 and K3 stage the [P, 16] bank whole (trace_flat.cuh:stage_bank).
int pbrs_max_bank_rows() { return pbrs::MAX_BANK_ROWS; }

int pbrs_flat_max_bytes() { return pbrs::MAX_PACKED_BYTES; }

}  // extern "C"
