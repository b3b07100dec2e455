// K6: single-kind primitive-BVH closest-hit / any-hit walk for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel pbrs_tpu/accel/mesh_pallas.py:_bvh_kernel
// (launched by _traverse_padded, driven by PrimBVHTracer / MeshBVHTracer).
// Contract: for each ray the closest hit (or, with any_hit, a hit) over one
// BVH of triangles, quads, spheres or disks -> (t, global prim id), inf / -1
// on a miss. The tree is accel/bvh.py's DFS order with skip links: a node
// that the ray wants is descended (node + 1) when interior, its primitives
// tested when a leaf; any other node sends the walk to its skip link. The
// slab test and the primitive tests are _bvh_kernel's, in its order of
// operations, and `t < t_best` is strict, so on equal t the primitive
// visited first wins. A step cap of num_nodes + 1 (mesh_pallas.py:238-243)
// ends the walk even on a corrupt or cyclic skip table.
//
// What differs from the TPU kernel: there one node pointer walks a whole
// 32 x 128-lane tile and descends when any lane wants the node. Here one
// thread walks one ray, stackless, and descends on its own slab test, so
// a lane visits a subset of the leaves its TPU packet visited. The two can
// part only where a lane's own slab test culls a leaf holding its hit by
// rounding (a hit at a flat box face). The per-lane step cap is the same.
// Padding slots of the TPU's nine-per-row leaf rows are gone: a leaf tests
// exactly its `count` primitives.
//
// What bounds it on the H100: neither bytes nor FLOPs. A ray reads 28
// bytes and writes 8; its node and primitive loads each depend on the step
// before, so load latency and branch divergence take the time. The design:
// node boxes are two float4 (box, then leaf first/count and the skip link
// as int bits) and primitive fields whole float4s in leaf order, all read
// through the read-only cache; the tables of a 16384-triangle mesh are
// under 1 MB and stay in the 50 MB L2. The library is built with
// -fmad=false, so each lane equals the plain version
// (accel/mesh_bvh.py:walk_reference) bit for bit.
#include "trace_flat.cuh"

namespace pbrs {
namespace k6 {

constexpr int KIND_TRI = 0, KIND_QUAD = 1, KIND_SPHERE = 2, KIND_DISK = 3;
// A leaf's meta word: first slot << LEAF_SHIFT | count; 0 on interior
// nodes (a leaf holds at most 9 primitives).
constexpr int LEAF_SHIFT = 4;

template <int KIND>
struct Stride;
template <> struct Stride<KIND_TRI> { static constexpr int value = 12; };
template <> struct Stride<KIND_QUAD> { static constexpr int value = 12; };
template <> struct Stride<KIND_SPHERE> { static constexpr int value = 4; };
template <> struct Stride<KIND_DISK> { static constexpr int value = 8; };

// Triangle edge function of _bvh_kernel's tri_test: ((h - a) x (h - b)) . n.
static __device__ __forceinline__ float edge(float hx, float hy, float hz,
                                             float ax, float ay, float az,
                                             float bx, float by, float bz,
                                             float nx, float ny, float nz) {
  const float ex = hx - ax, ey = hy - ay, ez = hz - az;
  const float fx = hx - bx, fy = hy - by, fz = hz - bz;
  const float cx = ey * fz - ez * fy;
  const float cy = ez * fx - ex * fz;
  const float cz = ex * fy - ey * fx;
  return cx * nx + cy * ny + cz * nz;
}

// One primitive (mesh_pallas.py:_bvh_kernel tri_test): its t, or BIG where
// it is not a hit within [T_MIN, t_max).
template <int KIND>
static __device__ __forceinline__ float prim_t(const float* fields, int slot,
                                               const Ray& r, float t_max) {
  const float4* p =
      reinterpret_cast<const float4*>(fields + slot * Stride<KIND>::value);
  const float rox = r.ox, roy = r.oy, roz = r.oz;
  const float rdx = r.dx, rdy = r.dy, rdz = r.dz;
  float t;
  bool ok;
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
    const bool ok0 = (delta >= 0.0f) && (q != 0.0f);
    const bool lo_ok = ok0 && (t_lo >= T_MIN) && (t_lo < t_max);
    t = lo_ok ? t_lo : t_hi;
    ok = ok0 && (t >= T_MIN) && (t < t_max);
  } else if (KIND == KIND_QUAD) {
    const float4 f0 = __ldg(p), f1 = __ldg(p + 1), f2 = __ldg(p + 2);
    const float ox_ = f0.x, oy_ = f0.y, oz_ = f0.z;
    const float ux = f0.w, uy = f1.x, uz = f1.y;
    const float vx = f1.z, vy = f1.w, vz = f2.x;
    const float nx = f2.y, ny = f2.z, nz = f2.w;
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
    ok = (denom != 0.0f) && (uu >= 0.0f) && (uu <= 1.0f) && (vv >= 0.0f) &&
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
    ok = (denom != 0.0f) && (hx * hx + hy * hy + hz * hz <= r2) &&
         (t >= T_MIN) && (t < t_max);
  } else {
    const float4 f0 = __ldg(p), f1 = __ldg(p + 1), f2 = __ldg(p + 2);
    const float p0x = f0.x, p0y = f0.y, p0z = f0.z;
    const float p1x = f0.w, p1y = f1.x, p1z = f1.y;
    const float p2x = f1.z, p2y = f1.w, p2z = f2.x;
    const float nx = f2.y, ny = f2.z, nz = f2.w;
    const float denom = rdx * nx + rdy * ny + rdz * nz;
    const float denom_s = (denom == 0.0f) ? 1.0f : denom;
    t = ((p0x - rox) * nx + (p0y - roy) * ny + (p0z - roz) * nz) / denom_s;
    const float hx = rox + t * rdx;
    const float hy = roy + t * rdy;
    const float hz = roz + t * rdz;
    const float b2 = edge(hx, hy, hz, p0x, p0y, p0z, p1x, p1y, p1z, nx, ny, nz);
    const float b0 = edge(hx, hy, hz, p1x, p1y, p1z, p2x, p2y, p2z, nx, ny, nz);
    const float b1 = edge(hx, hy, hz, p2x, p2y, p2z, p0x, p0y, p0z, nx, ny, nz);
    const bool inside = (b0 > 0.0f && b1 > 0.0f && b2 > 0.0f) ||
                        (b0 < 0.0f && b1 < 0.0f && b2 < 0.0f);
    ok = (denom != 0.0f) && inside && (t >= T_MIN) && (t < t_max);
  }
  return ok ? t : BIG;
}

// The stackless walk of one live ray; t_best = BIG and gid_best = -1 on a
// miss.
template <int KIND, bool ANY_HIT>
static __device__ void walk(const float4* __restrict__ nodes, int num_nodes,
                            const float* __restrict__ fields,
                            const int* __restrict__ slot_gid, const Ray& r,
                            float t_max, float& t_best, int& gid_best) {
  t_best = BIG;
  gid_best = -1;
  const float inv_x = 1.0f / ((r.dx == 0.0f) ? (float)1e-30 : r.dx);
  const float inv_y = 1.0f / ((r.dy == 0.0f) ? (float)1e-30 : r.dy);
  const float inv_z = 1.0f / ((r.dz == 0.0f) ? (float)1e-30 : r.dz);
  int node = 0;
  for (int nstep = 0; node < num_nodes && nstep < num_nodes + 1; ++nstep) {
    const float4 a = __ldg(nodes + 2 * node);
    const float4 b = __ldg(nodes + 2 * node + 1);
    const float tx0 = (a.x - r.ox) * inv_x;
    const float tx1 = (a.w - r.ox) * inv_x;
    const float ty0 = (a.y - r.oy) * inv_y;
    const float ty1 = (b.x - r.oy) * inv_y;
    const float tz0 = (a.z - r.oz) * inv_z;
    const float tz1 = (b.y - r.oz) * inv_z;
    const float t_enter = maximum(
        maximum(minimum(tx0, tx1), minimum(ty0, ty1)), minimum(tz0, tz1));
    const float t_exit = minimum(
        minimum(maximum(tx0, tx1), maximum(ty0, ty1)), maximum(tz0, tz1));
    const float limit = minimum(t_best, t_max);
    const bool wanted =
        (t_enter <= t_exit) && (t_exit >= T_MIN) && (t_enter < limit);
    const int meta = __float_as_int(b.z);
    const int skip = __float_as_int(b.w);
    const int count = meta & ((1 << LEAF_SHIFT) - 1);
    if (wanted && count > 0) {
      const int first = meta >> LEAF_SHIFT;
      for (int k = 0; k < count; ++k) {
        const float t = prim_t<KIND>(fields, first + k, r, t_max);
        if (t < t_best) {
          t_best = t;
          gid_best = __ldg(slot_gid + first + k);
          if (ANY_HIT) return;
        }
      }
    }
    node = (wanted && count == 0) ? node + 1 : skip;
  }
}

template <int KIND, bool ANY_HIT>
__global__ void trace_prim_bvh_kernel(const float4* __restrict__ nodes,
                                      int num_nodes,
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
  // A ray with t_max <= 0 (or NaN) can pass no primitive test (t >= T_MIN
  // and t < t_max): skip its walk.
  if (t_max > 0.0f) {
    const Ray r{planes[lane], planes[stride + lane], planes[2 * stride + lane],
                planes[3 * stride + lane], planes[4 * stride + lane],
                planes[5 * stride + lane]};
    float t_best;
    int gid_best;
    walk<KIND, ANY_HIT>(nodes, num_nodes, fields, slot_gid, r, t_max, t_best,
                        gid_best);
    if (t_best < BIG) {
      t = t_best;
      id = gid_best;
    }
  }
  t_out[lane] = t;
  id_out[lane] = id;
}

template <int KIND>
static void launch_kind(const float* nodes, int num_nodes, const float* fields,
                        const int* slot_gid, const float* planes, int n,
                        float* t_out, int* id_out, int any_hit,
                        cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  if (any_hit)
    trace_prim_bvh_kernel<KIND, true><<<grid, block, 0, stream>>>(
        nd, num_nodes, fields, slot_gid, planes, n, t_out, id_out);
  else
    trace_prim_bvh_kernel<KIND, false><<<grid, block, 0, stream>>>(
        nd, num_nodes, fields, slot_gid, planes, n, t_out, id_out);
}

}  // namespace k6
}  // namespace pbrs

extern "C" {

// nodes: [num_nodes, 8] float32 (box lo xyz, hi xyz, then the leaf meta
// word and the skip link as int32 bits); fields: [P, stride] float32 in
// leaf order (stride 12 / 12 / 4 / 8); slot_gid: [P] int32; kind: 0
// triangle, 1 quad, 2 sphere, 3 disk; planes: [7, n] float32 (ox, oy, oz,
// dx, dy, dz, t_max); t_out [n] float32; id_out [n] int32. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown kind, without a launch).
int pbrs_trace_prim_bvh(const float* nodes, int num_nodes, const float* fields,
                        const int* slot_gid, int kind, const float* planes,
                        int n, float* t_out, int* id_out, int any_hit,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  namespace k6 = pbrs::k6;
  switch (kind) {
    case k6::KIND_TRI:
      k6::launch_kind<k6::KIND_TRI>(nodes, num_nodes, fields, slot_gid,
                                    planes, n, t_out, id_out, any_hit, s);
      break;
    case k6::KIND_QUAD:
      k6::launch_kind<k6::KIND_QUAD>(nodes, num_nodes, fields, slot_gid,
                                     planes, n, t_out, id_out, any_hit, s);
      break;
    case k6::KIND_SPHERE:
      k6::launch_kind<k6::KIND_SPHERE>(nodes, num_nodes, fields, slot_gid,
                                       planes, n, t_out, id_out, any_hit, s);
      break;
    case k6::KIND_DISK:
      k6::launch_kind<k6::KIND_DISK>(nodes, num_nodes, fields, slot_gid,
                                     planes, n, t_out, id_out, any_hit, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
