// K5: per-family BVH closest-hit / any-hit trace for Hopper (sm_90a).
//
// Replaces the Pallas kernels pbrs_tpu/accel/treelet.py:_treelet_kernel
// (per-lane one-hot treelet rounds, launched by _trace_blocks) and
// _rowdense_kernel (row-shared treelet visits, launched by
// _trace_blocks_rowdense). Contract of both: for each ray the closest hit
// (or, with any_hit, a first hit) over one primitive family ->
// (t, global prim id), inf / -1 on a miss; a ray with t_max <= 0 is dead
// and is not walked. Here the walk also takes the query's running hit
// (t_in, id_in: the flat bank's, or the previous family's) and writes the
// merged result: the family's hit where it is closer than the running one,
// else the running one (on equal t the running hit stays; among the
// family's own primitives the lowest global id wins). A dead lane, and with
// any_hit a lane whose running hit is already finite, passes its running
// hit through without a walk. Given the running hit's own buffers as its
// output, it merges in place and writes only the lanes the family wins.
// So the result does not depend on the walk's order and equals the plain
// version (accel/treelet.py:trace_reference, a brute-force sweep merged
// the same way) bit for bit: the per-primitive
// tests are treelet.py:_test_prims' in its order of operations, and the
// library is built with -fmad=false.
//
// What bounds it on the H100: neither bytes nor FLOPs. A ray reads 36
// bytes and writes 8, and does about ten node tests and a few primitive
// tests whose addresses each depend on the step before, so the bound from
// bytes or operations sits far below the time; the latency of those
// dependent loads and idle SIMT lanes take it.
// What the design does about it:
// - Live rays in full warps (ray_queue.cuh): a warp takes 32 lanes for a
//   closest hit (neighbouring rays, which walk alike) and 128 for an any
//   hit (sparser), passes dead ones through, and its idle threads take the
//   next live rays whenever REFILL of them are idle.
// - Child-pair nodes: one 64-byte node holds both children's boxes and
//   their references (a node index, or a leaf's first slot and count), so
//   one contiguous fetch tests both children and a leaf needs no fetch of
//   its own before its primitives.
// - The traversal stack in shared memory, 8 bytes an entry and as many
//   entries a thread as the family's tree is deep (from the host), so
//   ptxas keeps no local-memory stack frame.
// - The running hit seeds t_best, so every node beyond it is culled, and
//   the merge with the flat bank's hit costs no launch of its own.
// The walk is Aila and Laine's while-while: interior nodes until every
// thread of the warp holds a leaf or is done, then one leaf each.
// Node tests are conservative (boxes padded on the host, slab interval
// widened by SLAB_EPS), so rounding never culls a node that holds a hit.
#include "ray_queue.cuh"
#include "trace_flat.cuh"

namespace pbrs {

constexpr int KIND_TRI = 0, KIND_QUAD = 1, KIND_SPHERE = 2, KIND_DISK = 3;
constexpr int BVH_BLOCK = 128;
// A warp takes new rays when this many of its threads are idle.
constexpr int REFILL = 8;
// accel/treelet.py SLAB_EPS, rounded from doubles as PyTorch rounds them.
constexpr float SLAB_LO = (float)(1.0 - 1e-4);
constexpr float SLAB_HI = (float)(1.0 + 1e-4);
// Shared memory a block needs beside its stack: each warp's pending lanes.
constexpr int BVH_QUEUE_BYTES =
    (BVH_BLOCK / 32) * CLAIM_MAX * (int)sizeof(int);
// A stack entry of one thread: a node reference and its t_enter, 8 bytes.
// The reference is a pair index (>= 0) or a leaf, ~(first slot * 16 +
// count): a leaf of the pair table holds at most LEAF_MAX primitives.
constexpr int LEAF_MAX = 15;
constexpr int STACK_ENTRY_BYTES = 8;
constexpr int MAX_STACK_DEPTH =
    (MAX_SMEM_BYTES - BVH_QUEUE_BYTES) / (STACK_ENTRY_BYTES * BVH_BLOCK);

template <int KIND>
struct Stride;
template <> struct Stride<KIND_TRI> { static constexpr int value = 12; };
template <> struct Stride<KIND_QUAD> { static constexpr int value = 12; };
template <> struct Stride<KIND_SPHERE> { static constexpr int value = 4; };
template <> struct Stride<KIND_DISK> { static constexpr int value = 8; };

struct Inv {
  float x, y, z;
};

// The conservative slab test of one box (accel/treelet.py:_slab): passes
// when the widened interval is non-empty, ends at or after T_MIN, starts
// before t_max and not after the best hit so far. It culls and never
// decides a hit's t, so plain fminf / fmaxf do (a NaN box, whose six slab
// values are all NaN, still never passes).
static __device__ __forceinline__ bool box_hit(float lx, float ly, float lz,
                                               float hx, float hy, float hz,
                                               const Ray& r, const Inv& inv,
                                               float t_max, float t_best,
                                               float& te) {
  const float tx0 = (lx - r.ox) * inv.x;
  const float tx1 = (hx - r.ox) * inv.x;
  const float ty0 = (ly - r.oy) * inv.y;
  const float ty1 = (hy - r.oy) * inv.y;
  const float tz0 = (lz - r.oz) * inv.z;
  const float tz1 = (hz - r.oz) * inv.z;
  const float t_enter =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_exit =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
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

// One thread's traversal state; its stack lives in shared memory, entry k
// of thread tid at [k * BVH_BLOCK + tid].
struct Walk {
  Ray r;
  Inv inv;
  float t_max, t_best;
  int g_best;    // the family's best global id, -1 while the running hit holds
  int ref, cnt;  // the node in hand: a pair index (cnt 0) or a leaf
  int sp;
};

static __device__ __forceinline__ void push(Walk& w, int2* stack, int ref,
                                            int cnt, float t) {
  stack[w.sp * BVH_BLOCK] =
      make_int2(cnt ? ~(ref * 16 + cnt) : ref, __float_as_int(t));
  ++w.sp;
}

// Pop the nearest pending node that can still beat the best hit; false
// when none is left.
static __device__ __forceinline__ bool pop(Walk& w, const int2* stack) {
  while (w.sp > 0) {
    --w.sp;
    const int2 e = stack[w.sp * BVH_BLOCK];
    if (__int_as_float(e.y) <= w.t_best) {
      w.ref = e.x >= 0 ? e.x : (~e.x) >> 4;
      w.cnt = e.x >= 0 ? 0 : (~e.x) & 15;
      return true;
    }
  }
  return false;
}

template <int KIND, bool ANY_HIT>
__global__ void __launch_bounds__(BVH_BLOCK, 4)
    trace_bvh_kernel(const float4* __restrict__ pairs,
                     const float* __restrict__ fields,
                     const int* __restrict__ slot_gid,
                     const float* __restrict__ planes,
                     const float* t_in, const int* id_in, int n, int claim,
                     float* t_out, int* id_out) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  WarpQueue q = warp_queue(smem + warp * CLAIM_MAX);
  int2* stack = reinterpret_cast<int2*>(smem + (BVH_BLOCK / 32) * CLAIM_MAX) +
                threadIdx.x;
  const size_t stride = (size_t)n;
  // The running hit of lane i, passed through unchanged (in place there is
  // nothing to write; t_in and t_out may then alias, so neither is
  // __restrict__: a lane is read before it is written, by one warp).
  const bool in_place = t_out == t_in;
  auto pass = [&](int i) {
    if (in_place) return;
    t_out[i] = t_in ? t_in[i] : inf_f();
    id_out[i] = id_in ? id_in[i] : -1;
  };
  auto is_live = [&](int i) {
    return planes[6 * stride + i] > 0.0f &&
           !(ANY_HIT && t_in && t_in[i] < BIG);
  };
  int lane = -1;  // the ray lane this thread walks, -1 when idle
  Walk w;
  while (true) {
    const unsigned idle = __ballot_sync(FULL_MASK, lane < 0);
    if (__popc(idle) >= REFILL && (q.n_pending > 0 || !q.read)) {
      const int got = take_rays(q, n, claim, lane >= 0, is_live, pass);
      if (got >= 0) {
        lane = got;
        w.r = Ray{planes[lane], planes[stride + lane],
                  planes[2 * stride + lane], planes[3 * stride + lane],
                  planes[4 * stride + lane], planes[5 * stride + lane]};
        w.inv = Inv{1.0f / ((w.r.dx == 0.0f) ? (float)1e-30 : w.r.dx),
                    1.0f / ((w.r.dy == 0.0f) ? (float)1e-30 : w.r.dy),
                    1.0f / ((w.r.dz == 0.0f) ? (float)1e-30 : w.r.dz)};
        w.t_max = planes[6 * stride + lane];
        const float seed = t_in ? t_in[lane] : inf_f();
        w.t_best = seed < BIG ? seed : BIG;
        w.g_best = -1;
        w.ref = 0;  // pair 0: the root beside an empty (NaN) box
        w.cnt = 0;
        w.sp = 0;
      }
    }
    if (__ballot_sync(FULL_MASK, lane >= 0) == 0) {
      if (q.n_pending == 0 && q.read) break;
      continue;
    }
    if (lane < 0) continue;
    bool done = false;
    // Interior nodes until this thread holds a leaf or is done.
    while (w.cnt == 0) {
      const float4* p = pairs + 4 * w.ref;
      const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
      const int4 d = __ldg(reinterpret_cast<const int4*>(p + 3));
      float tl, tr;
      const bool hl = box_hit(a.x, a.y, a.z, a.w, b.x, b.y, w.r, w.inv,
                              w.t_max, w.t_best, tl);
      const bool hr = box_hit(b.z, b.w, c.x, c.y, c.z, c.w, w.r, w.inv,
                              w.t_max, w.t_best, tr);
      if (hl && hr) {
        const bool near_l = tl <= tr;
        push(w, stack, near_l ? d.z : d.x, near_l ? d.w : d.y,
             near_l ? tr : tl);
        w.ref = near_l ? d.x : d.z;
        w.cnt = near_l ? d.y : d.w;
      } else if (hl || hr) {
        w.ref = hl ? d.x : d.z;
        w.cnt = hl ? d.y : d.w;
      } else if (!pop(w, stack)) {
        done = true;
        break;
      }
    }
    if (!done) {
      for (int k = 0; k < w.cnt; ++k) {
        const int slot = w.ref + k;
        float t;
        if (prim_hit<KIND>(fields, slot, w.r, w.t_max, t) && t < BIG) {
          const int g = __ldg(slot_gid + slot);
          if (ANY_HIT) {
            w.t_best = t;
            w.g_best = g;
            break;
          }
          if (t < w.t_best || (t == w.t_best && g < w.g_best)) {
            w.t_best = t;
            w.g_best = g;
          }
        }
      }
      done = (ANY_HIT && w.g_best >= 0) || !pop(w, stack);
    }
    if (done) {
      if (w.g_best >= 0) {
        t_out[lane] = w.t_best;
        id_out[lane] = w.g_best;
      } else {
        pass(lane);
      }
      lane = -1;
    }
  }
}

template <int KIND, bool ANY_HIT>
static int launch_bvh(const float* pairs, const float* fields,
                      const int* slot_gid, const float* planes,
                      const float* t_in, const int* id_in, int n,
                      int stack_depth, int claim, float* t_out, int* id_out,
                      cudaStream_t stream) {
  auto kernel = trace_bvh_kernel<KIND, ANY_HIT>;
  const int smem =
      BVH_QUEUE_BYTES + STACK_ENTRY_BYTES * stack_depth * BVH_BLOCK;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  kernel<<<lanes_grid(n, BVH_BLOCK, claim), BVH_BLOCK, smem, stream>>>(
      reinterpret_cast<const float4*>(pairs), fields, slot_gid, planes, t_in,
      id_in, n, claim, t_out, id_out);
  return (int)cudaGetLastError();
}

template <int KIND>
static int launch_kind(const float* pairs, const float* fields,
                       const int* slot_gid, const float* planes,
                       const float* t_in, const int* id_in, int n,
                       int stack_depth, int claim, float* t_out, int* id_out,
                       int any_hit, cudaStream_t stream) {
  return any_hit ? launch_bvh<KIND, true>(pairs, fields, slot_gid, planes,
                                          t_in, id_in, n, stack_depth, claim,
                                          t_out, id_out, stream)
                 : launch_bvh<KIND, false>(pairs, fields, slot_gid, planes,
                                           t_in, id_in, n, stack_depth, claim,
                                           t_out, id_out, stream);
}

}  // namespace pbrs

extern "C" {

// pairs: [n_pairs, 16] float32 child-pair nodes: the left child's box (lo
// xyz, hi xyz), the right child's, then int32 bits (left ref, left count,
// right ref, right count); a count of 0 marks an interior child whose ref
// is its pair index, else ref is the leaf's first slot and the count is at
// most LEAF_MAX. Pair 0 holds the root beside a NaN box. fields: [P,
// stride] float32 in leaf order; slot_gid: [P] int32; kind: 0 triangle,
// 1 quad, 2 sphere, 3 disk; planes: [7, n] float32 (ox, oy, oz, dx, dy,
// dz, t_max); t_in [n] float32 and id_in [n] int32, the running hit (both
// null: a miss on every lane); stack_depth: stack entries a thread, at
// least the family's depth and at most pbrs_bvh_max_stack_depth(); claim:
// lanes a warp (a multiple of 32 up to 128); t_out [n] float32 and id_out
// [n] int32, either new buffers or t_in / id_in themselves (a merge in
// place). Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unknown kind, stack depth or
// claim, without a launch).
int pbrs_trace_bvh(const float* pairs, const float* fields,
                   const int* slot_gid, int kind, const float* planes,
                   const float* t_in, const int* id_in, int n,
                   int stack_depth, int claim, float* t_out, int* id_out,
                   int any_hit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stack_depth < 1 || stack_depth > pbrs::MAX_STACK_DEPTH ||
      claim < 32 || claim % 32 || claim > pbrs::CLAIM_MAX)
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case pbrs::KIND_TRI:
      return pbrs::launch_kind<pbrs::KIND_TRI>(
          pairs, fields, slot_gid, planes, t_in, id_in, n, stack_depth,
          claim, t_out, id_out, any_hit, s);
    case pbrs::KIND_QUAD:
      return pbrs::launch_kind<pbrs::KIND_QUAD>(
          pairs, fields, slot_gid, planes, t_in, id_in, n, stack_depth,
          claim, t_out, id_out, any_hit, s);
    case pbrs::KIND_SPHERE:
      return pbrs::launch_kind<pbrs::KIND_SPHERE>(
          pairs, fields, slot_gid, planes, t_in, id_in, n, stack_depth,
          claim, t_out, id_out, any_hit, s);
    case pbrs::KIND_DISK:
      return pbrs::launch_kind<pbrs::KIND_DISK>(
          pairs, fields, slot_gid, planes, t_in, id_in, n, stack_depth,
          claim, t_out, id_out, any_hit, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int pbrs_bvh_max_stack_depth() { return pbrs::MAX_STACK_DEPTH; }

}  // extern "C"
