// K6: single-kind primitive-BVH closest-hit / any-hit walk for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel pbrs_tpu/accel/mesh_pallas.py:_bvh_kernel
// (launched by _traverse_padded, driven by PrimBVHTracer / MeshBVHTracer).
// Contract: for each ray the closest hit (or, with any_hit, a hit) over one
// BVH of triangles, quads, spheres or disks -> (t, global prim id), inf / -1
// on a miss, as the reference's walk over accel/bvh.py's DFS order with
// skip links finds it: a node is wanted when its slab test passes with
// `t_enter < min(t_best, t_max)` for the t_best the walk holds on reaching
// it; a wanted interior node is descended, a wanted leaf's primitives are
// tested in order with a strict `t < t_best` (on equal t the primitive
// visited first wins). The slab test and the primitive tests are
// _bvh_kernel's, in its order of operations, and the library is built with
// -fmad=false, so each lane equals the plain version
// (accel/mesh_bvh.py:walk_reference) bit for bit.
//
// What differs from the TPU kernel: there one node pointer walks a whole
// 32 x 128-lane tile and descends when any lane wants the node. Here one
// thread walks one ray and descends on its own slab test, so a lane visits
// a subset of the leaves its TPU packet visited. The two can part only
// where a lane's own slab test culls a leaf holding its hit by rounding (a
// hit at a flat box face). Padding slots of the TPU's nine-per-row leaf
// rows are gone: a leaf tests exactly its `count` primitives.
//
// What bounds it on the H100: neither bytes nor FLOPs. A ray reads 28
// bytes and writes 8; its node and primitive loads each depend on the step
// before, so load latency and idle SIMT lanes take the time. The design:
// - Child-pair nodes (accel/treelet.py:_pair_table, boxes unpadded): one
//   64-byte fetch holds both children's boxes and references (a pair index,
//   or a leaf's first slot and count), so both children are tested at
//   once and a leaf needs no fetch of its own before its primitives.
// - The walk keeps the reference's DFS order: at a pair the left child is
//   taken whenever it is wanted, whatever its t_enter; a wanted right
//   child is pushed with its t_enter and, when popped, taken only if
//   `t_enter < t_best` still holds (its t_enter is below t_max already):
//   the test the skip-link walk makes on reaching that node with the
//   t_best it holds then. So every lane visits the same leaves in the same
//   order as that walk and keeps the same hit. (Nearest child first would
//   cull more, but changes which of two equal-t primitives wins.)
// - The traversal stack in shared memory, 8 bytes an entry and as many
//   entries a thread as the tree is deep (from the host), so ptxas keeps
//   no local-memory stack frame.
// - Live rays packed by ray_queue.cuh: a warp reads the liveness of its 32
//   lanes, passes dead lanes (t_max <= 0, or NaN) as inf / -1 without a
//   walk and hands the live ones to its first threads, and each thread
//   walks its ray to the end (an any hit ends at its first hit), with no
//   warp-wide step between one leaf and the next. A sweep on the card
//   measured the alternatives slower on the 16 ray sets of
//   prof_rounds.k6_sets (PERF.md): Aila and Laine's while-while, idle
//   threads refilled from 128 lanes a warp whenever 8 were idle, took
//   1.8x the time, and warps of 64 or 128 lanes walked in rounds of 32
//   lost 5% and 17%.
// - The slab test's NaN-propagating min / max take one instruction each
//   (min.NaN / max.NaN), and 48 registers leave room for 10 blocks of 128
//   threads an SM.
// A walk ends on any table: at most n_pairs pair fetches (a sound tree
// fetches each pair once, as mesh_pallas.py:238-243 caps a cyclic skip
// table at num_nodes + 1 steps), a pair index outside the table ends it,
// and a push beyond the stack depth is dropped.
#include "ray_queue.cuh"
#include "trace_flat.cuh"

namespace pbrs {
namespace k6 {

constexpr int KIND_TRI = 0, KIND_QUAD = 1, KIND_SPHERE = 2, KIND_DISK = 3;
constexpr int K6_BLOCK = 128;
// Lanes a warp takes: its own 32.
constexpr int K6_CLAIM = 32;
// Blocks an SM the register allocation must leave room for.
constexpr int K6_MIN_BLOCKS = 10;
// Shared memory a block needs beside its stack: each warp's live lanes.
constexpr int QUEUE_BYTES = (K6_BLOCK / 32) * K6_CLAIM * (int)sizeof(int);
// A stack entry of one thread: a node reference and its t_enter, 8 bytes.
// The reference is a pair index (>= 0) or a leaf, ~(first slot * 16 +
// count): a leaf holds at most 9 primitives.
constexpr int STACK_ENTRY_BYTES = 8;
constexpr int MAX_STACK_DEPTH =
    (MAX_SMEM_BYTES - QUEUE_BYTES) / (STACK_ENTRY_BYTES * K6_BLOCK);

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

// NaN-propagating min / max in one instruction each (min.NaN / max.NaN,
// sm_80 and later): trace_flat.cuh's minimum / maximum, whose NaN is
// another bit pattern; a slab value that is NaN only ever fails the test.
static __device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return minimum(a, b);
#endif
}
static __device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return maximum(a, b);
#endif
}

// _bvh_kernel's slab test of one box: wanted, and its t_enter.
static __device__ __forceinline__ bool slab(float lx, float ly, float lz,
                                            float hx, float hy, float hz,
                                            const Ray& r, float ix, float iy,
                                            float iz, float limit,
                                            float& t_enter) {
  const float tx0 = (lx - r.ox) * ix;
  const float tx1 = (hx - r.ox) * ix;
  const float ty0 = (ly - r.oy) * iy;
  const float ty1 = (hy - r.oy) * iy;
  const float tz0 = (lz - r.oz) * iz;
  const float tz1 = (hz - r.oz) * iz;
  t_enter = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                    min_nan(tz0, tz1));
  const float t_exit = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                               max_nan(tz0, tz1));
  return (t_enter <= t_exit) && (t_exit >= T_MIN) && (t_enter < limit);
}

// One thread's walk; its stack lives in shared memory, entry k of thread
// tid at [k * K6_BLOCK + tid].
struct Walk {
  Ray r;
  float ix, iy, iz;
  float t_max, t_best;
  int g_best;
  int ref, cnt;  // the node in hand: a pair index (cnt 0) or a leaf
  int sp;
  int fetches;
};

static __device__ __forceinline__ void push(Walk& w, int2* stack, int depth,
                                            int ref, int cnt, float t) {
  if (w.sp == depth) return;
  stack[w.sp * K6_BLOCK] =
      make_int2(cnt > 0 ? ~(ref * 16 + cnt) : ref, __float_as_int(t));
  ++w.sp;
}

// Pop the last pending node whose t_enter is below the best t (a pushed
// t_enter is below t_max, so this is the slab test's `t_enter <
// min(t_best, t_max)` at that node); false when none is left.
static __device__ __forceinline__ bool pop(Walk& w, const int2* stack) {
  while (w.sp > 0) {
    --w.sp;
    const int2 e = stack[w.sp * K6_BLOCK];
    if (__int_as_float(e.y) < w.t_best) {
      w.ref = e.x >= 0 ? e.x : (~e.x) >> 4;
      w.cnt = e.x >= 0 ? 0 : (~e.x) & 15;
      return true;
    }
  }
  return false;
}

// A walk of the ray in planes' lane `lane` from pair 0, which holds the
// root beside a NaN box.
static __device__ __forceinline__ void start(Walk& w, const float* planes,
                                             size_t stride, int lane) {
  w.r = Ray{planes[lane], planes[stride + lane], planes[2 * stride + lane],
            planes[3 * stride + lane], planes[4 * stride + lane],
            planes[5 * stride + lane]};
  w.ix = 1.0f / ((w.r.dx == 0.0f) ? (float)1e-30 : w.r.dx);
  w.iy = 1.0f / ((w.r.dy == 0.0f) ? (float)1e-30 : w.r.dy);
  w.iz = 1.0f / ((w.r.dz == 0.0f) ? (float)1e-30 : w.r.dz);
  w.t_max = planes[6 * stride + lane];
  w.t_best = BIG;
  w.g_best = -1;
  w.ref = 0;
  w.cnt = 0;
  w.sp = 0;
  w.fetches = 0;
}

// Interior pairs until w holds a leaf (a count above 0); false when the
// walk is done.
static __device__ __forceinline__ bool descend(Walk& w,
                                               const float4* __restrict__ pairs,
                                               int n_pairs, int depth,
                                               int2* stack) {
  while (w.cnt <= 0) {
    if (w.fetches == n_pairs || (unsigned)w.ref >= (unsigned)n_pairs)
      return false;
    ++w.fetches;
    const float4* p = pairs + 4 * w.ref;
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    const int4 d = __ldg(reinterpret_cast<const int4*>(p + 3));
    const float limit = min_nan(w.t_best, w.t_max);
    float tl, tr;
    const bool wl =
        slab(a.x, a.y, a.z, a.w, b.x, b.y, w.r, w.ix, w.iy, w.iz, limit, tl);
    const bool wr =
        slab(b.z, b.w, c.x, c.y, c.z, c.w, w.r, w.ix, w.iy, w.iz, limit, tr);
    if (wl) {
      if (wr) push(w, stack, depth, d.z, d.w, tr);
      w.ref = d.x;
      w.cnt = d.y;
    } else if (wr) {
      w.ref = d.z;
      w.cnt = d.w;
    } else if (!pop(w, stack)) {
      return false;
    }
  }
  return true;
}

// The primitives of w's leaf in order, then the next pending node; false
// when the walk is done (an any hit at its first hit).
template <int KIND, bool ANY_HIT>
static __device__ __forceinline__ bool visit_leaf(
    Walk& w, const float* __restrict__ fields,
    const int* __restrict__ slot_gid, const int2* stack) {
  bool hit = false;
  for (int k = 0; k < w.cnt && !hit; ++k) {
    const float t = prim_t<KIND>(fields, w.ref + k, w.r, w.t_max);
    if (t < w.t_best) {
      w.t_best = t;
      w.g_best = __ldg(slot_gid + w.ref + k);
      hit = ANY_HIT;
    }
  }
  return !hit && pop(w, stack);
}

template <int KIND, bool ANY_HIT>
__global__ void __launch_bounds__(K6_BLOCK, K6_MIN_BLOCKS)
    trace_prim_bvh_kernel(const float4* __restrict__ pairs, int n_pairs,
                          int depth, const float* __restrict__ fields,
                          const int* __restrict__ slot_gid,
                          const float* __restrict__ planes, int n,
                          float* __restrict__ t_out,
                          int* __restrict__ id_out) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  WarpQueue q = warp_queue(smem + warp * K6_CLAIM);
  int2* stack = reinterpret_cast<int2*>(smem + (K6_BLOCK / 32) * K6_CLAIM) +
                threadIdx.x;
  const size_t stride = (size_t)n;
  auto pass = [&](int i) {
    t_out[i] = inf_f();
    id_out[i] = -1;
  };
  // A ray with t_max <= 0 (or NaN) can pass no primitive test (t >= T_MIN
  // and t < t_max): it is not walked.
  auto is_live = [&](int i) { return planes[6 * stride + i] > 0.0f; };
  const int lane = take_rays(q, n, K6_CLAIM, false, is_live, pass);
  if (lane < 0) return;
  Walk w;
  start(w, planes, stride, lane);
  while (descend(w, pairs, n_pairs, depth, stack) &&
         visit_leaf<KIND, ANY_HIT>(w, fields, slot_gid, stack)) {
  }
  const bool hit = w.t_best < BIG;
  t_out[lane] = hit ? w.t_best : inf_f();
  id_out[lane] = hit ? w.g_best : -1;
}

using Kernel = void (*)(const float4*, int, int, const float*, const int*,
                        const float*, int, float*, int*);

// The instance for (kind, any_hit), or null for an unknown kind.
static Kernel kernel_of(int kind, int any_hit) {
  const bool ah = any_hit != 0;
  switch (kind) {
    case KIND_TRI:
      return ah ? trace_prim_bvh_kernel<KIND_TRI, true>
                : trace_prim_bvh_kernel<KIND_TRI, false>;
    case KIND_QUAD:
      return ah ? trace_prim_bvh_kernel<KIND_QUAD, true>
                : trace_prim_bvh_kernel<KIND_QUAD, false>;
    case KIND_SPHERE:
      return ah ? trace_prim_bvh_kernel<KIND_SPHERE, true>
                : trace_prim_bvh_kernel<KIND_SPHERE, false>;
    case KIND_DISK:
      return ah ? trace_prim_bvh_kernel<KIND_DISK, true>
                : trace_prim_bvh_kernel<KIND_DISK, false>;
    default:
      return nullptr;
  }
}

// Dynamic shared bytes of a block at this stack depth, opted in above the
// default 48 KB.
static cudaError_t fit(Kernel kernel, int depth, int& smem) {
  smem = QUEUE_BYTES + STACK_ENTRY_BYTES * depth * K6_BLOCK;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace k6
}  // namespace pbrs

extern "C" {

// pairs: [n_pairs, 16] float32 child-pair nodes: the left child's box (lo
// xyz, hi xyz), the right child's, then int32 bits (left ref, left count,
// right ref, right count); a count of 0 marks an interior child whose ref
// is its pair index, else ref is the leaf's first slot and the count is 1
// to 9. Pair 0 holds the root beside a NaN box. depth: stack entries a
// thread, at least the tree's depth and at most
// pbrs_prim_bvh_max_stack_depth(). fields: [P, stride] float32 in leaf
// order (stride 12 / 12 / 4 / 8); slot_gid: [P] int32; kind: 0 triangle, 1
// quad, 2 sphere, 3 disk; planes: [7, n] float32 (ox, oy, oz, dx, dy, dz,
// t_max); t_out [n] float32; id_out [n] int32. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown kind or depth,
// without a launch).
int pbrs_trace_prim_bvh(const float* pairs, int n_pairs, int depth,
                        const float* fields, const int* slot_gid, int kind,
                        const float* planes, int n, float* t_out,
                        int* id_out, int any_hit, void* stream) {
  namespace k6 = pbrs::k6;
  const k6::Kernel kernel = k6::kernel_of(kind, any_hit);
  if (!kernel || depth < 1 || depth > k6::MAX_STACK_DEPTH)
    return (int)cudaErrorInvalidValue;
  int smem;
  const cudaError_t e = k6::fit(kernel, depth, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<pbrs::lanes_grid(n, k6::K6_BLOCK, k6::K6_CLAIM), k6::K6_BLOCK,
           smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(pairs), n_pairs, depth, fields,
      slot_gid, planes, n, t_out, id_out);
  return (int)cudaGetLastError();
}

// The (kind, any_hit) instance as built and as it fits an SM at this stack
// depth: info[0] registers a thread, [1] local (stack and spill) bytes a
// thread, [2] resident warps an SM, [3] threads a block, [4] static and [5]
// dynamic shared bytes a block.
int pbrs_trace_prim_bvh_info(int kind, int any_hit, int depth, int* info) {
  namespace k6 = pbrs::k6;
  const k6::Kernel kernel = k6::kernel_of(kind, any_hit);
  if (!kernel || depth < 1 || depth > k6::MAX_STACK_DEPTH)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  int smem;
  e = k6::fit(kernel, depth, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    k6::K6_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks * k6::K6_BLOCK / 32;
  info[3] = k6::K6_BLOCK;
  info[4] = (int)attr.sharedSizeBytes;
  info[5] = smem;
  return 0;
}

int pbrs_prim_bvh_max_stack_depth() { return pbrs::k6::MAX_STACK_DEPTH; }

}  // extern "C"
