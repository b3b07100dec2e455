// K2: fused diffuse bounce for Hopper (sm_90a).
//
// Replaces the Pallas kernel pbrs_tpu/accel/fused_kernel.py:_bounce_kernel
// (launched by _bounce_call). One launch runs a whole wavefront bounce per
// lane: closest hit over the [P,16] bank, sphere/quad hit detail, shading
// frame, albedo/emission fetch, none/const/gradient environment, one-light
// quad NEE with MIS and both shadow sweeps, cosine BSDF sample, Russian
// roulette and the next-ray spawn. Random numbers are the PCG counter hash
// or the Owen-scrambled Sobol' draw of core/sampler.py (the `rng` launch
// argument), in native uint32. The plain version is
// pbrs_tpu_torch/accel/fused_kernel.py:bounce_reference; every expression
// here keeps its evaluation order, and the library is built with
// -fmad=false and IEEE sqrt/div, so the two round alike.
//
// What bounds it on the H100: bytes at the main path's shape. One Cornell
// 1024^2 depth-8 sample's eight launches must move 0.243 ms of bytes at
// 3.35 TB/s (every lane's planes in and out; the camera bounce's
// closest-hit and shadow sweeps are 0.035 ms of FP32 operations); they
// take 1.345 ms (chip_smoke.py phase 3 and profiling.py on an NVIDIA H100
// 80GB HBM3 at 700 W; the kernel before this design took 1.91-1.96 ms).
// The time goes to latency in the dense bounces 0-4 (0.18-0.25 ms each,
// 6-8x their bound): a lane's three sweeps of IEEE divisions and square
// roots. The sparse bounces 5-7 (0.7-2.4% of lanes live) take
// 0.074-0.083 ms, most of it the dead lanes' pass-through (0.029 ms of
// bytes).
// What the design does about it (each piece reverted alone in a copy of
// the tree, one sample's launches timed by profiling.py, same card):
// - Live lanes in full warps (bounce_common.cuh:live_lanes): a block of
//   128 threads takes a window of 512 lanes, passes its dead lanes through
//   as it reads them, and runs the live ones from a list in shared memory
//   (at 1, 2 or 8 lanes a thread a sample takes 27%, 8% or 4% longer).
// - The BSDF-sampled shadow ray, needed by 0.6% of the lanes, queued in
//   shared memory and swept by the block, one ray a thread, once its
//   lanes are shaded (without the queue: +7%).
// - A quad's 1 / |n|^2 staged once a block in the shared bank and a
//   sphere test's 1 / |d|^2 once a ray (trace_flat.cuh): about half the
//   IEEE divisions of a sweep, the same bits (unstaged: +6%); Sobol'
//   dimension 1 by a bit transform (bounce_common.cuh; the 32-step sum:
//   +5% on the Sobol' path).
// - 96 registers a thread, 20 warps an SM, no spill (built for 16 warps:
//   +4%; for 24: +6%).
// - The bank staged once a block in shared memory (broadcast reads; up to
//   MAX_BANK_ROWS rows, opted in past 48 KB), the scene's switches as
//   launch arguments, and an exact traced-ray count: a warp-shuffle and
//   shared-memory block reduction and one 64-bit atomicAdd a block, in
//   place of the TPU's per-lane-average encoding.
#include "bounce_common.cuh"

namespace pbrs {

struct Tables {
  const float* bank;  // shared-memory copy
  int n_sph, n_quad, n_tri, n_disk;
  const float* mats;  // [n_mats, 6]
  int n_mats;
  const float* lights;  // [max(n_area,1), 12]
  int n_area;
  const float* env;  // [6]
  int env_kind;
  __device__ Bank prims() const { return Bank{bank, n_sph, n_quad, n_tri, n_disk}; }
};

static __device__ __forceinline__ void env_along(const Tables& tb, float x,
                                                 float y, float z, float& er,
                                                 float& eg, float& eb) {
  const float* e = tb.env;
  if (tb.env_kind == ENV_GRADIENT) {
    const float dl = rsqrtf(max0(x * x + y * y + z * z, (float)1e-30));
    const float yy = (y * dl + 1.0f) * 0.5f;
    er = e[0] * yy + e[3] * (1.0f - yy);
    eg = e[1] * yy + e[4] * (1.0f - yy);
    eb = e[2] * yy + e[5] * (1.0f - yy);
  } else if (tb.env_kind == ENV_CONST) {
    er = e[0];
    eg = e[1];
    eb = e[2];
  } else {
    er = eg = eb = 0.0f;
  }
}

// The bounce of one live lane. in[9]: origin, dir, beta; out[12]: radiance,
// next origin, next dir, next beta. Returns the lane's traced-ray count.
// The BSDF-sampled shadow ray goes to the block's queue (out's radiance is
// then the occluded one until the block sweeps it), or, the queue full, is
// swept here.
static __device__ unsigned bounce_lane(const Tables& tb, const float* in,
                                       const Draw& u1, bool first,
                                       bool rr_active, int lane,
                                       const ShadowQueue& queue, float* out,
                                       int& alive_out) {
  const float rox = in[0], roy = in[1], roz = in[2];
  const float rdx = in[3], rdy = in[4], rdz = in[5];
  const float br = in[6], bg = in[7], bb = in[8];
  unsigned n_rays = 1;

  // ---- closest hit + sphere/quad detail ----
  float t;
  int pid;
  sweep<false>(tb.bank, tb.n_sph, tb.n_quad, tb.n_tri, tb.n_disk,
               Ray{rox, roy, roz, rdx, rdy, rdz}, inf_f(), t, pid);
  const bool hit = t < BIG;
  const float t_safe = hit ? t : 1.0f;
  float px = rox + t_safe * rdx;
  float py = roy + t_safe * rdy;
  float pz = roz + t_safe * rdz;
  float nx = 0.0f, ny = 0.0f, nz = 1.0f;
  float tx = 1.0f, ty = 0.0f, tz = 0.0f;
  int mat_id = -1;
  if (pid >= 0 && pid < tb.n_sph) {
    const float* p = tb.bank + pid * BANK_COLS;
    const float cx = p[0], cy = p[1], cz = p[2], r = p[3];
    const float gx = px - cx, gy = py - cy, gz = pz - cz;
    const float inv = rsqrtf(max0(gx * gx + gy * gy + gz * gz, (float)1e-30));
    const float ux = gx * inv, uy = gy * inv, uz = gz * inv;
    const float h2 = ux * ux + uy * uy;
    const float hinv = rsqrtf(max0(h2, (float)1e-30));
    tx = (h2 < (float)1e-12) ? 1.0f : -uy * hinv;
    ty = (h2 < (float)1e-12) ? 0.0f : ux * hinv;
    tz = 0.0f;
    const float s = (ux * rdx + uy * rdy + uz * rdz > 0.0f) ? -1.0f : 1.0f;
    nx = s * ux;
    ny = s * uy;
    nz = s * uz;
    const float r_out = r * (float)1.00001;
    px = cx + ux * r_out;
    py = cy + uy * r_out;
    pz = cz + uz * r_out;
    mat_id = (int)p[13];
  } else if (pid >= tb.n_sph && pid < tb.n_sph + tb.n_quad) {
    const float* p = tb.bank + pid * BANK_COLS;
    const float qnx = p[9], qny = p[10], qnz = p[11];
    const float inv = rsqrtf(max0(qnx * qnx + qny * qny + qnz * qnz, (float)1e-30));
    const float ux = qnx * inv, uy = qny * inv, uz = qnz * inv;
    const float s = (ux * rdx + uy * rdy + uz * rdz > 0.0f) ? -1.0f : 1.0f;
    nx = s * ux;
    ny = s * uy;
    nz = s * uz;
    tx = p[3];
    ty = p[4];
    tz = p[5];
    mat_id = (int)p[13];
  }

  // ---- shading frame (orthonormal_frame with the Duff fallback) ----
  float bx = ny * tz - nz * ty;
  float by = nz * tx - nx * tz;
  float bz = nx * ty - ny * tx;
  if (!(bx * bx + by * by + bz * bz > (float)1e-12)) {
    const float sD = (nz >= 0.0f) ? 1.0f : -1.0f;
    const float aD = -1.0f / (sD + nz);
    const float bD = nx * ny * aD;
    const float atx = 1.0f + sD * nx * nx * aD;
    const float aty = sD * bD;
    const float atz = -sD * nx;
    bx = ny * atz - nz * aty;
    by = nz * atx - nx * atz;
    bz = nx * aty - ny * atx;
  }
  const float binv = rsqrtf(max0(bx * bx + by * by + bz * bz, (float)1e-30));
  bx = bx * binv;
  by = by * binv;
  bz = bz * binv;
  const float fx_ = by * nz - bz * ny;
  const float fy_ = bz * nx - bx * nz;
  const float fz_ = bx * ny - by * nx;

  // ---- material fetch ----
  float alb_r = 0.0f, alb_g = 0.0f, alb_b = 0.0f;
  float emi_r = 0.0f, emi_g = 0.0f, emi_b = 0.0f;
  if (mat_id >= 0 && mat_id < tb.n_mats) {
    const float* m = tb.mats + mat_id * 6;
    alb_r = m[0];
    alb_g = m[1];
    alb_b = m[2];
    emi_r = m[3];
    emi_g = m[4];
    emi_b = m[5];
  }

  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  if (first) {
    float er, eg, eb;
    env_along(tb, rdx, rdy, rdz, er, eg, eb);
    rad_r = rad_r + br * (hit ? emi_r : er);
    rad_g = rad_g + bg * (hit ? emi_g : eg);
    rad_b = rad_b + bb * (hit ? emi_b : eb);
  }
  bool alive = hit;

  // ---- NEE: one light among n_area (+ env) ----
  const int n_lights = tb.n_area + (tb.env_kind != ENV_NONE ? 1 : 0);
  if (n_lights > 0) {
    const float fn = (float)n_lights;
    const float u_sel = u1(DIM_LIGHT_SELECT, 0);
    const float u_l0 = u1(DIM_LIGHT_UV, 0);
    const float u_l1 = u1(DIM_LIGHT_UV, 1);
    const float u_s0 = u1(DIM_SCATTER_UV, 0);
    const float u_s1 = u1(DIM_SCATTER_UV, 1);
    int chosen = (int)(u_sel * fn);
    chosen = chosen < n_lights - 1 ? chosen : n_lights - 1;
    const bool arm_area = chosen < tb.n_area;
    const bool arm_env = !arm_area;
    float L[12];
    for (int j = 0; j < 12; ++j)
      L[j] = arm_area ? tb.lights[chosen * 12 + j] : 0.0f;
    const float lqx = L[0], lqy = L[1], lqz = L[2];
    const float lux = L[3], luy = L[4], luz = L[5];
    const float lvx = L[6], lvy = L[7], lvz = L[8];
    const float ler = L[9], leg = L[10], leb = L[11];

    const float lnx = luy * lvz - luz * lvy;
    const float lny = luz * lvx - lux * lvz;
    const float lnz = lux * lvy - luy * lvx;
    const float ln2 = max0(lnx * lnx + lny * lny + lnz * lnz, (float)1e-30);
    const float area = sqrtf(ln2);
    const float inv_ln = rsqrtf(ln2);
    const float lnx_u = lnx * inv_ln, lny_u = lny * inv_ln,
                lnz_u = lnz * inv_ln;

    // ---- light-sampled arm ----
    const float ptx = lqx + u_l0 * lux + u_l1 * lvx;
    const float pty = lqy + u_l0 * luy + u_l1 * lvy;
    const float ptz = lqz + u_l0 * luz + u_l1 * lvz;
    const float wlx = ptx - px, wly = pty - py, wlz = ptz - pz;
    const float d2 = max0(wlx * wlx + wly * wly + wlz * wlz, (float)1e-20);
    const float inv_d = rsqrtf(d2);
    const float wix = wlx * inv_d, wiy = wly * inv_d, wiz = wlz * inv_d;
    const float cos_l = -(lnx_u * wix + lny_u * wiy + lnz_u * wiz);
    const bool facing = cos_l > 0.0f;
    const float pdf_l = d2 / max0(fabsf(cos_l) * area, (float)1e-20);
    const float cos_s = nx * wix + ny * wiy + nz * wiz;
    const float fl = max0(cos_s, 0.0f) * INV_PI;
    const float pdf_scatter = max0(cos_s, 0.0f) * INV_PI;
    const float side = (cos_s >= 0.0f) ? 1.0f : -1.0f;
    const float sox = px + side * nx * SPAWN_EPS;
    const float soy = py + side * ny * SPAWN_EPS;
    const float soz = pz + side * nz * SPAWN_EPS;
    bool valid_l = arm_area && facing && (pdf_l > 0.0f);
    // The shadow sweep only decides lanes that could still contribute; a
    // lane with valid_l false adds zero either way.
    if (valid_l && alive)
      valid_l = !occluded(
          tb.prims(), Ray{sox, soy, soz, ptx - sox, pty - soy, ptz - soz}, SHADOW_T);
    const float w_l = pdf_l * pdf_l /
                      max0(pdf_l * pdf_l + pdf_scatter * pdf_scatter, (float)1e-30);
    const float contrib = valid_l ? fl * w_l / pdf_l : 0.0f;
    if (alive) {
      rad_r = rad_r + br * alb_r * contrib * ler * fn;
      rad_g = rad_g + bg * alb_g * contrib * leg * fn;
      rad_b = rad_b + bb * alb_b * contrib * leb * fn;
    }

    // ---- BSDF-sampled arm (area MIS + env) ----
    float ddx, ddy;
    concentric(u_s1 * 2.0f - 1.0f, u_s0 * 2.0f - 1.0f, ddx, ddy);
    const float ddz = sqrtf(max0(1.0f - ddx * ddx - ddy * ddy, 0.0f));
    const float w2x = ddx * fx_ + ddy * bx + ddz * nx;
    const float w2y = ddx * fy_ + ddy * by + ddz * ny;
    const float w2z = ddx * fz_ + ddy * bz + ddz * nz;
    const float cos2 = max0(ddz, 0.0f);
    const float pdf2 = cos2 * INV_PI;
    const float f2 = cos2 * INV_PI;

    const float denom = w2x * lnx_u + w2y * lny_u + w2z * lnz_u;
    const float denom_s = (denom == 0.0f) ? 1.0f : denom;
    const float sgn = (cos2 >= 0.0f) ? 1.0f : -1.0f;
    const float s2ox = px + sgn * nx * SPAWN_EPS;
    const float s2oy = py + sgn * ny * SPAWN_EPS;
    const float s2oz = pz + sgn * nz * SPAWN_EPS;
    const float t_hit = ((lqx - s2ox) * lnx_u + (lqy - s2oy) * lny_u +
                         (lqz - s2oz) * lnz_u) / denom_s;
    const float hxq = s2ox + t_hit * w2x - lqx;
    const float hyq = s2oy + t_hit * w2y - lqy;
    const float hzq = s2oz + t_hit * w2z - lqz;
    float cqx = hyq * lvz - hzq * lvy;
    float cqy = hzq * lvx - hxq * lvz;
    float cqz = hxq * lvy - hyq * lvx;
    const float uu = (cqx * lnx + cqy * lny + cqz * lnz) / ln2;
    cqx = luy * hzq - luz * hyq;
    cqy = luz * hxq - lux * hzq;
    cqz = lux * hyq - luy * hxq;
    const float vv = (cqx * lnx + cqy * lny + cqz * lnz) / ln2;
    const bool hit_l = (denom != 0.0f) && (t_hit >= T_MIN) && (uu >= 0.0f) &&
                       (uu <= 1.0f) && (vv >= 0.0f) && (vv <= 1.0f);
    const float pdf_l2 =
        (t_hit * t_hit) * (w2x * w2x + w2y * w2y + w2z * w2z) /
        max0(fabsf(lnx_u * w2x + lny_u * w2y + lnz_u * w2z) * area, (float)1e-20);
    // Bounded to the light point on the area arm, unbounded for env.
    const float tmax2 = (arm_area && hit_l) ? t_hit * SHADOW_T : inf_f();
    const bool env_on = tb.env_kind != ENV_NONE;
    bool valid_b = arm_area && hit_l && (pdf2 > 0.0f) && (pdf_l2 > 0.0f);
    bool valid_e = env_on && arm_env && (pdf2 > 0.0f);
    // The arm's radiance onto (r, g, b), the shadow ray decided.
    auto arm = [&](bool vb, bool ve, float& r, float& g, float& b) {
      const float w_b =
          pdf2 * pdf2 / max0(pdf2 * pdf2 + pdf_l2 * pdf_l2, (float)1e-30);
      const float contrib_b = vb ? f2 * w_b / max0(pdf2, (float)1e-20) : 0.0f;
      if (alive) {
        r = r + br * alb_r * contrib_b * ler * fn;
        g = g + bg * alb_g * contrib_b * leg * fn;
        b = b + bb * alb_b * contrib_b * leb * fn;
      }
      if (env_on) {
        float er2, eg2, eb2;
        env_along(tb, w2x, w2y, w2z, er2, eg2, eb2);
        const float contrib_e = ve ? f2 / max0(pdf2, (float)1e-20) : 0.0f;
        if (alive) {
          r = r + br * alb_r * contrib_e * er2 * fn;
          g = g + bg * alb_g * contrib_e * eg2 * fn;
          b = b + bb * alb_b * contrib_e * eb2 * fn;
        }
      }
    };
    if (alive && (valid_b || valid_e)) {
      const Ray r2{s2ox, s2oy, s2oz, w2x, w2y, w2z};
      float vr = rad_r, vg = rad_g, vb = rad_b;
      arm(valid_b, valid_e, vr, vg, vb);
      if (queue.push(lane, r2, tmax2, vr, vg, vb)) {
        valid_b = valid_e = false;  // written as occluded until swept
      } else {
        const bool occ2 = occluded(tb.prims(), r2, tmax2);
        valid_b = valid_b && !occ2;
        valid_e = valid_e && !occ2;
      }
    }
    arm(valid_b, valid_e, rad_r, rad_g, rad_b);
    if (alive) n_rays += 2;
  }

  // ---- BSDF sample for the next direction (cosine hemisphere) ----
  const float u_b0 = u1(DIM_BSDF_UV, 0);
  const float u_b1 = u1(DIM_BSDF_UV, 1);
  float ddx, ddy;
  concentric(u_b1 * 2.0f - 1.0f, u_b0 * 2.0f - 1.0f, ddx, ddy);
  const float ddz = sqrtf(max0(1.0f - ddx * ddx - ddy * ddy, 0.0f));
  const float wnx = ddx * fx_ + ddy * bx + ddz * nx;
  const float wny = ddx * fy_ + ddy * by + ddz * ny;
  const float wnz = ddx * fz_ + ddy * bz + ddz * nz;
  // Throughput f*cos/pdf = albedo; zero-albedo or emissive-only lanes die.
  const bool nonzero = (alb_r > 0.0f) || (alb_g > 0.0f) || (alb_b > 0.0f);
  alive = alive && nonzero && (mat_id >= 0) && (ddz > 0.0f);
  float nbr = alive ? br * alb_r : br;
  float nbg = alive ? bg * alb_g : bg;
  float nbb = alive ? bb * alb_b : bb;
  if (rr_active) {
    const float lum = (float)0.21267127 * nbr + (float)0.71515972 * nbg +
                      (float)0.07216883 * nbb;
    const float q = max0(1.0f - lum, (float)0.05);
    alive = alive &&
            !(u1(DIM_RUSSIAN_ROULETTE, 0) < q);
    const float scale = alive ? 1.0f / max0(1.0f - q, (float)1e-6) : 1.0f;
    nbr = nbr * scale;
    nbg = nbg * scale;
    nbb = nbb * scale;
  }
  const float side = (wnx * nx + wny * ny + wnz * nz >= 0.0f) ? 1.0f : -1.0f;
  out[0] = rad_r;
  out[1] = rad_g;
  out[2] = rad_b;
  out[3] = px + side * nx * SPAWN_EPS;
  out[4] = py + side * ny * SPAWN_EPS;
  out[5] = pz + side * nz * SPAWN_EPS;
  out[6] = wnx;
  out[7] = wny;
  out[8] = wnz;
  out[9] = nbr;
  out[10] = nbg;
  out[11] = nbb;
  alive_out = alive ? 1 : 0;
  return n_rays;
}

// Threads a block and the blocks an SM must hold (so registers a thread:
// 96, 20 warps an SM, no spill), and the lanes a thread reads: a block's
// window is BOUNCE_PER x BOUNCE_BLOCK = 512 lanes.
constexpr int BOUNCE_BLOCK = 128, BOUNCE_MIN_BLOCKS = 5, BOUNCE_PER = 4;
constexpr int BOUNCE_WINDOW = BOUNCE_PER * BOUNCE_BLOCK;

__global__ void __launch_bounds__(BOUNCE_BLOCK, BOUNCE_MIN_BLOCKS)
    fused_bounce_kernel(
        const float* __restrict__ bank, int n_sph, int n_quad, int n_tri,
        int n_disk, const float* __restrict__ mats, int n_mats,
        const float* __restrict__ lights, int n_area,
        const float* __restrict__ env, int env_kind, int rng, uint32_t seed,
        uint32_t bounce, int first, int rr_active,
        const float* __restrict__ fin, const int* __restrict__ alive_in,
        const int* __restrict__ pix, const int* __restrict__ samp, int n,
        float* __restrict__ fout,
        int* __restrict__ alive_out, unsigned long long* __restrict__ count) {
  extern __shared__ float s_bank[];
  __shared__ int s_lane[BOUNCE_WINDOW];
  __shared__ int s_cnt[32];
  __shared__ int s_qn, s_qlane[QUEUE_MAX];
  __shared__ float s_qray[QUEUE_MAX * 7], s_qrad[QUEUE_MAX * 3];
  if (threadIdx.x == 0) s_qn = 0;
  const ShadowQueue sq{&s_qn, s_qlane, s_qray, s_qrad};
  stage_bank(s_bank, bank, n_sph + n_quad + n_tri + n_disk, n_sph,
             n_sph + n_quad);
  const Tables tb{s_bank, n_sph, n_quad, n_tri,  n_disk,
                  mats,   n_mats, lights, n_area, env, env_kind};
  const size_t stride = (size_t)n;
  // Dead lane: zero radiance, origin/dir/beta passed through.
  const LiveList live = live_lanes<BOUNCE_PER>(
      alive_in, n, s_lane, s_cnt, [&](int i) {
        for (int j = 0; j < 3; ++j) fout[j * stride + i] = 0.0f;
        for (int j = 0; j < 9; ++j) fout[(3 + j) * stride + i] = fin[j * stride + i];
        alive_out[i] = 0;
      });
  unsigned rays = 0;
#pragma unroll 1
  for (int pos = live.first; pos < live.count; pos += live.step) {
    const int lane = live.lanes[pos];
    float in[9], out[12];
    for (int j = 0; j < 9; ++j) in[j] = fin[j * stride + lane];
    int alive = 0;
    const Draw u1{rng, seed, (uint32_t)pix[lane], (uint32_t)samp[lane],
                  bounce};
    rays += bounce_lane(tb, in, u1, first != 0, rr_active != 0, lane,
                        sq, out, alive);
    for (int j = 0; j < 12; ++j) fout[j * stride + lane] = out[j];
    alive_out[lane] = alive;
  }
  __syncthreads();
  sweep_queue(sq, tb.prims(), fout, stride);
  count_rays(rays, count);
}

}  // namespace pbrs

extern "C" {

// fin [9, n] float32 (origin, dir, beta); alive_in, pix, samp [n] int32;
// fout [12, n] float32 (radiance, next origin, next dir, next beta);
// alive_out [n] int32; count: one uint64 the bounce's traced rays are added
// to; rng 0 draws PCG, 1 Sobol'. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue without one for a bank that does not fit
// shared memory beside the kernel's static arrays).
int pbrs_fused_bounce(const float* bank, int n_sph, int n_quad, int n_tri,
                      int n_disk, const float* mats, int n_mats,
                      const float* lights, int n_area, const float* env,
                      int env_kind, int rng, int seed, int bounce, int first,
                      int rr_active, const float* fin, const int* alive_in,
                      const int* pix, const int* samp, int n, float* fout,
                      int* alive_out, void* count, void* stream) {
  const int n_rows = n_sph + n_quad + n_tri + n_disk;
  const int smem = n_rows * pbrs::BANK_COLS * (int)sizeof(float);
  const cudaError_t e = pbrs::fit_smem(pbrs::fused_bounce_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + pbrs::BOUNCE_WINDOW - 1) / pbrs::BOUNCE_WINDOW;
  pbrs::fused_bounce_kernel<<<grid, pbrs::BOUNCE_BLOCK, smem,
                              (cudaStream_t)stream>>>(
      bank, n_sph, n_quad, n_tri, n_disk, mats, n_mats, lights, n_area, env,
      env_kind, rng, (uint32_t)seed, (uint32_t)bounce, first, rr_active, fin,
      alive_in, pix, samp, n, fout, alive_out,
      (unsigned long long*)count);
  return (int)cudaGetLastError();
}

// K2 as ptxas built it and as it launches on one SM with an n_rows bank:
// info[0] registers a thread, info[1] local memory bytes a thread (spills
// and stack), info[2] resident warps an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[3] threads a block,
// info[4] lanes a block's window, info[5] static shared bytes a block.
int pbrs_fused_bounce_info(int n_rows, int* info) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, pbrs::fused_bounce_kernel);
  if (e != cudaSuccess) return (int)e;
  const int smem = n_rows * pbrs::BANK_COLS * (int)sizeof(float);
  e = pbrs::fit_smem(pbrs::fused_bounce_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pbrs::fused_bounce_kernel, pbrs::BOUNCE_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks * pbrs::BOUNCE_BLOCK / 32;
  info[3] = pbrs::BOUNCE_BLOCK;
  info[4] = pbrs::BOUNCE_WINDOW;
  info[5] = (int)attr.sharedSizeBytes;
  return 0;
}

}  // extern "C"
