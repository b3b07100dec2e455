// K5: per-family BVH closest-hit / any-hit trace for Hopper (sm_90a).
//
// Replaces the Pallas kernels pbrs_tpu/accel/treelet.py:_treelet_kernel
// (per-lane one-hot treelet rounds, launched by _trace_blocks) and
// _rowdense_kernel (row-shared treelet visits, launched by
// _trace_blocks_rowdense). Contract of both: for each ray the closest hit
// (or, with any_hit, a first hit) over one primitive family ->
// (t, global prim id), inf / -1 on a miss; a ray with t_max <= 0 is dead
// and writes inf / -1 without a walk. On equal t the lowest global id wins,
// so the result does not depend on the walk's order and equals the plain
// version's brute-force sweep (accel/treelet.py:trace_reference) bit for
// bit: the per-primitive tests are treelet.py:_test_prims' in its order of
// operations, and the library is built with -fmad=false.
//
// What bounds it on the H100: neither bytes nor FLOPs. A ray reads 28
// bytes and writes 8, and does about ten node tests and a few primitive
// tests whose addresses each depend on the step before, so the bound from
// bytes or operations sits far below the time; the latency of those
// dependent loads and the divergence of the walk's branches take it.
// What the design does about it: the TPU mechanics (64-slot treelets,
// quantised t_enter sort keys, bf16 3-split tables gathered by one-hot MXU
// matmuls, chunk DMA) are gone; one thread walks the binary SAH BVH of
// accel/bvh.py (leaves of at most 8 primitives) with a per-thread stack,
// near child first, and skips a node whose t_enter is above its best hit.
// Node boxes (32 bytes a node, two float4) and primitive fields (padded to
// whole float4s) are read through the read-only cache; at 16384 triangles
// the tables are under 1 MB and stay in the 50 MB L2. Node tests are
// conservative (boxes padded on the host, slab interval widened by
// SLAB_EPS), so rounding never culls a node that holds a hit.
#include "trace_flat.cuh"

namespace pbrs {

constexpr int KIND_TRI = 0, KIND_QUAD = 1, KIND_SPHERE = 2, KIND_DISK = 3;
// Per-thread stack entries: one per tree level at most, and the host
// builder (accel/bvh.py) stops splitting below depth 61.
constexpr int MAX_STACK = 64;
// accel/treelet.py SLAB_EPS, rounded from doubles as PyTorch rounds them.
constexpr float SLAB_LO = (float)(1.0 - 1e-4);
constexpr float SLAB_HI = (float)(1.0 + 1e-4);

template <int KIND>
struct Stride;
template <> struct Stride<KIND_TRI> { static constexpr int value = 12; };
template <> struct Stride<KIND_QUAD> { static constexpr int value = 12; };
template <> struct Stride<KIND_SPHERE> { static constexpr int value = 4; };
template <> struct Stride<KIND_DISK> { static constexpr int value = 8; };

struct Inv {
  float x, y, z;
};

// The conservative slab test of one node (accel/treelet.py:_slab): passes
// when the widened interval is non-empty, ends at or after T_MIN, starts
// before t_max and not after the best hit so far.
static __device__ __forceinline__ bool node_hit(const float4* nodes, int i,
                                                const Ray& r, const Inv& inv,
                                                float t_max, float t_best,
                                                float& te) {
  const float4 a = __ldg(nodes + 2 * i);
  const float4 b = __ldg(nodes + 2 * i + 1);
  const float tx0 = (a.x - r.ox) * inv.x;
  const float tx1 = (a.w - r.ox) * inv.x;
  const float ty0 = (a.y - r.oy) * inv.y;
  const float ty1 = (b.x - r.oy) * inv.y;
  const float tz0 = (a.z - r.oz) * inv.z;
  const float tz1 = (b.y - r.oz) * inv.z;
  const float t_enter = maximum(maximum(minimum(tx0, tx1), minimum(ty0, ty1)),
                                minimum(tz0, tz1));
  const float t_exit = minimum(minimum(maximum(tx0, tx1), maximum(ty0, ty1)),
                               maximum(tz0, tz1));
  te = t_enter * (t_enter > 0.0f ? SLAB_LO : SLAB_HI);
  const float tx = t_exit * (t_exit > 0.0f ? SLAB_HI : SLAB_LO);
  return te <= tx && tx >= T_MIN && te < t_max && te <= t_best;
}

// One primitive of the family (treelet.py:_test_prims; accel/treelet.py
// prim_test): t and whether it is a hit within [T_MIN, t_max).
template <int KIND>
static __device__ __forceinline__ bool prim_hit(const float* fields, int slot,
                                                const Ray& r, float t_max,
                                                float& t) {
  const float4* p =
      reinterpret_cast<const float4*>(fields + slot * Stride<KIND>::value);
  const float rox = r.ox, roy = r.oy, roz = r.oz;
  const float rdx = r.dx, rdy = r.dy, rdz = r.dz;
  if (KIND == KIND_SPHERE) {
    const float4 f0 = __ldg(p);
    const float cx = f0.x, cy = f0.y, cz = f0.z, rad = f0.w;
    const float fx = rox - cx, fy = roy - cy, fz = roz - cz;
    const float a = rdx * rdx + rdy * rdy + rdz * rdz;
    const float b_pr = -(fx * rdx + fy * rdy + fz * rdz);
    const float inv_a = 1.0f / max0(a, (float)1e-30);
    const float mx = fx + b_pr * inv_a * rdx;
    const float my = fy + b_pr * inv_a * rdy;
    const float mz = fz + b_pr * inv_a * rdz;
    const float delta = rad * rad - (mx * mx + my * my + mz * mz);
    const float cc = fx * fx + fy * fy + fz * fz - rad * rad;
    const float q =
        b_pr + (b_pr >= 0.0f ? 1.0f : -1.0f) * sqrtf(max0(delta * a, 0.0f));
    const float q_s = (q == 0.0f) ? 1.0f : q;
    const float t0 = cc / q_s;
    const float t1 = q * inv_a;
    const float t_lo = minimum(t0, t1);
    const float t_hi = maximum(t0, t1);
    const bool ok0 = (delta >= 0.0f) && (q != 0.0f) && (rad > 0.0f);
    const bool lo_ok = ok0 && (t_lo >= T_MIN) && (t_lo < t_max);
    t = lo_ok ? t_lo : t_hi;
    return ok0 && (t >= T_MIN) && (t < t_max);
  } else if (KIND == KIND_QUAD) {
    const float4 f0 = __ldg(p), f1 = __ldg(p + 1), f2 = __ldg(p + 2);
    const float ox_ = f0.x, oy_ = f0.y, oz_ = f0.z;
    const float ux = f0.w, uy = f1.x, uz = f1.y;
    const float vx = f1.z, vy = f1.w, vz = f2.x;
    const float nx = uy * vz - uz * vy;
    const float ny = uz * vx - ux * vz;
    const float nz = ux * vy - uy * vx;
    const float n2 = max0(nx * nx + ny * ny + nz * nz, (float)1e-30);
    const float denom = rdx * nx + rdy * ny + rdz * nz;
    const float denom_s = (denom == 0.0f) ? 1.0f : denom;
    t = ((ox_ - rox) * nx + (oy_ - roy) * ny + (oz_ - roz) * nz) / denom_s;
    const float hx = rox + t * rdx - ox_;
    const float hy = roy + t * rdy - oy_;
    const float hz = roz + t * rdz - oz_;
    float cx = hy * vz - hz * vy;
    float cy = hz * vx - hx * vz;
    float cz = hx * vy - hy * vx;
    const float uu = (cx * nx + cy * ny + cz * nz) / n2;
    cx = uy * hz - uz * hy;
    cy = uz * hx - ux * hz;
    cz = ux * hy - uy * hx;
    const float vv = (cx * nx + cy * ny + cz * nz) / n2;
    return (denom != 0.0f) && (uu >= 0.0f) && (uu <= 1.0f) && (vv >= 0.0f) &&
           (vv <= 1.0f) && (t >= T_MIN) && (t < t_max);
  } else if (KIND == KIND_DISK) {
    const float4 f0 = __ldg(p), f1 = __ldg(p + 1);
    const float cx_ = f0.x, cy_ = f0.y, cz_ = f0.z;
    const float nx = f0.w, ny = f1.x, nz = f1.y;
    const float r2 = f1.z;
    const float denom = rdx * nx + rdy * ny + rdz * nz;
    const float denom_s = (denom == 0.0f) ? 1.0f : denom;
    t = ((cx_ - rox) * nx + (cy_ - roy) * ny + (cz_ - roz) * nz) / denom_s;
    const float hx = rox + t * rdx - cx_;
    const float hy = roy + t * rdy - cy_;
    const float hz = roz + t * rdz - cz_;
    return (denom != 0.0f) && (hx * hx + hy * hy + hz * hz <= r2) &&
           (t >= T_MIN) && (t < t_max);
  } else {
    // Moller-Trumbore with strict u > 0, v > 0, u + v < 1.
    const float4 f0 = __ldg(p), f1 = __ldg(p + 1), f2 = __ldg(p + 2);
    const float p0x = f0.x, p0y = f0.y, p0z = f0.z;
    const float e1x = f0.w - p0x, e1y = f1.x - p0y, e1z = f1.y - p0z;
    const float e2x = f1.z - p0x, e2y = f1.w - p0y, e2z = f2.x - p0z;
    const float pvx = rdy * e2z - rdz * e2y;
    const float pvy = rdz * e2x - rdx * e2z;
    const float pvz = rdx * e2y - rdy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv_det = 1.0f / ((det == 0.0f) ? 1.0f : det);
    const float tvx = rox - p0x, tvy = roy - p0y, tvz = roz - p0z;
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    return (det != 0.0f) && (u > 0.0f) && (v > 0.0f) && (u + v < 1.0f) &&
           (t >= T_MIN) && (t < t_max);
  }
}

// The walk of one live ray: t_best = BIG and gid_best = -1 on a miss.
template <int KIND, bool ANY_HIT>
static __device__ void walk(const float4* __restrict__ nodes,
                            const float* __restrict__ fields,
                            const int* __restrict__ slot_gid, const Ray& r,
                            float t_max, float& t_best, int& gid_best) {
  t_best = BIG;
  gid_best = -1;
  const Inv inv{1.0f / ((r.dx == 0.0f) ? (float)1e-30 : r.dx),
                1.0f / ((r.dy == 0.0f) ? (float)1e-30 : r.dy),
                1.0f / ((r.dz == 0.0f) ? (float)1e-30 : r.dz)};
  int stack_node[MAX_STACK];
  float stack_t[MAX_STACK];
  int sp = 0;
  float te;
  if (!node_hit(nodes, 0, r, inv, t_max, t_best, te)) return;
  int node = 0;
  while (true) {
    const float4 b = __ldg(nodes + 2 * node + 1);
    const int first = __float_as_int(b.z);
    const int count = __float_as_int(b.w);
    if (count > 0) {
      for (int k = 0; k < count; ++k) {
        const int slot = first + k;
        float t;
        if (prim_hit<KIND>(fields, slot, r, t_max, t) && t < BIG) {
          const int g = __ldg(slot_gid + slot);
          if (ANY_HIT) {
            t_best = t;
            gid_best = g;
            return;
          }
          if (t < t_best || (t == t_best && g < gid_best)) {
            t_best = t;
            gid_best = g;
          }
        }
      }
    } else {
      const int left = node + 1, right = first;
      float tl, tr;
      const bool hl = node_hit(nodes, left, r, inv, t_max, t_best, tl);
      const bool hr = node_hit(nodes, right, r, inv, t_max, t_best, tr);
      if (hl && hr) {
        const bool near_l = tl <= tr;
        stack_node[sp] = near_l ? right : left;
        stack_t[sp] = near_l ? tr : tl;
        ++sp;
        node = near_l ? left : right;
        continue;
      }
      if (hl || hr) {
        node = hl ? left : right;
        continue;
      }
    }
    // Pop the nearest pending node that can still beat the best hit.
    bool found = false;
    while (sp > 0) {
      --sp;
      if (stack_t[sp] <= t_best) {
        node = stack_node[sp];
        found = true;
        break;
      }
    }
    if (!found) return;
  }
}

template <int KIND, bool ANY_HIT>
__global__ void trace_bvh_kernel(const float4* __restrict__ nodes,
                                 const float* __restrict__ fields,
                                 const int* __restrict__ slot_gid,
                                 const float* __restrict__ planes, int n,
                                 float* __restrict__ t_out,
                                 int* __restrict__ id_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t stride = (size_t)n;
  const float t_max = planes[6 * stride + lane];
  float t = inf_f();
  int id = -1;
  if (t_max > 0.0f) {
    const Ray r{planes[lane], planes[stride + lane], planes[2 * stride + lane],
                planes[3 * stride + lane], planes[4 * stride + lane],
                planes[5 * stride + lane]};
    float t_best;
    int gid_best;
    walk<KIND, ANY_HIT>(nodes, fields, slot_gid, r, t_max, t_best, gid_best);
    if (gid_best >= 0) {
      t = t_best;
      id = gid_best;
    }
  }
  t_out[lane] = t;
  id_out[lane] = id;
}

template <int KIND, bool ANY_HIT>
static void launch_bvh(const float* nodes, const float* fields,
                       const int* slot_gid, const float* planes, int n,
                       float* t_out, int* id_out, cudaStream_t stream) {
  const int block = 256;
  const int grid = (n + block - 1) / block;
  trace_bvh_kernel<KIND, ANY_HIT><<<grid, block, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes), fields, slot_gid, planes, n,
      t_out, id_out);
}

template <int KIND>
static void launch_kind(const float* nodes, const float* fields,
                        const int* slot_gid, const float* planes, int n,
                        float* t_out, int* id_out, int any_hit,
                        cudaStream_t stream) {
  if (any_hit)
    launch_bvh<KIND, true>(nodes, fields, slot_gid, planes, n, t_out, id_out,
                           stream);
  else
    launch_bvh<KIND, false>(nodes, fields, slot_gid, planes, n, t_out, id_out,
                            stream);
}

}  // namespace pbrs

extern "C" {

// nodes: [n_nodes, 8] float32 (box, then first/right and count as int32
// bits); fields: [P, stride] float32 in leaf order; slot_gid: [P] int32;
// kind: 0 triangle, 1 quad, 2 sphere, 3 disk; planes: [7, n] float32
// (ox, oy, oz, dx, dy, dz, t_max); t_out [n] float32; id_out [n] int32.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown kind, without a launch).
int pbrs_trace_bvh(const float* nodes, const float* fields,
                   const int* slot_gid, int kind, const float* planes, int n,
                   float* t_out, int* id_out, int any_hit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case pbrs::KIND_TRI:
      pbrs::launch_kind<pbrs::KIND_TRI>(nodes, fields, slot_gid, planes, n,
                                        t_out, id_out, any_hit, s);
      break;
    case pbrs::KIND_QUAD:
      pbrs::launch_kind<pbrs::KIND_QUAD>(nodes, fields, slot_gid, planes, n,
                                         t_out, id_out, any_hit, s);
      break;
    case pbrs::KIND_SPHERE:
      pbrs::launch_kind<pbrs::KIND_SPHERE>(nodes, fields, slot_gid, planes,
                                           n, t_out, id_out, any_hit, s);
      break;
    case pbrs::KIND_DISK:
      pbrs::launch_kind<pbrs::KIND_DISK>(nodes, fields, slot_gid, planes, n,
                                         t_out, id_out, any_hit, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int pbrs_bvh_max_stack() { return pbrs::MAX_STACK; }

}  // extern "C"
