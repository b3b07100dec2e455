// K4: the shade-only bounce for Hopper (sm_90a).
//
// Replaces the Pallas kernel pbrs_tpu/accel/fused_wave.py:_shade_kernel
// (launched by _shade_call): two-arm or folded NEE, PCG or Sobol' draws
// (the `folded` and `rng` launch arguments). The trace stays
// outside: one launch shades every lane of a wavefront bounce from its
// hit detail -- the shading frame, the material row with up to five lobe
// slots (Lambert, Oren-Nayar, isotropic microfacet, mirror, dielectric,
// transmit, FresnelBlend) and the texture values evaluated outside,
// emission / environment on camera and post-delta segments, the mixture's
// BSDF sample, NEE over one light among delta + area (quad, sphere cone,
// disk, triangle) + env (its importance-sampled draw evaluated outside)
// with both MIS arms, and Russian roulette -- and writes two shadow queries
// with their pending contributions, the env coefficient and BSDF pdf, the
// next direction and throughput. Folded, the BSDF arm takes the
// continuation sample (no second sample_mix) and only the light-sampled
// shadow query is written; s2t carries the distance to the chosen area
// light along the continuation ray, for the next bounce's closest hit to
// resolve. The plain version is
// pbrs_tpu_torch/accel/fused_wave.py:shade_reference; every expression here
// keeps its evaluation order (shade_common.cuh, built with -fmad=false).
//
// What bounds it on the H100: neither bytes nor operations at the port's
// sizes -- 34 input and 32 output planes of 4 B a lane (277 MB at 2^20
// lanes, 0.083 ms at 3.35 TB/s) and a few thousand float operations a lane
// (0.03-0.07 ms at 67 TFLOP/s) -- but latency and divergence: lanes of one
// warp take other lobe kinds, light arms and shapes, and a lane's state
// (up to five lobe records of 20 values) takes 115-209 registers, so few
// warps fit an SM.
// What the design does about it: one thread per lane with its slots in
// registers (the slot count a template parameter, so every loop over slots
// unrolls and no record is indexed at run time: no spills); SoA planes for
// coalesced loads; the material, light and delta rows read through the
// read-only cache, one indexed load per lane in place of the TPU's one-hot
// MXU gathers and bf16 3-split banks; a lane branching on its own kind,
// arm and shape where the TPU kernel masked every model the scene holds;
// the scene's static switches as uniform launch arguments; and the traced
// shadow-ray count summed exactly on the device (block reduction, one
// 64-bit atomicAdd per block).
//
// The TPU kernel runs a 64 x 128-lane block only when one of its lanes is
// alive and then shades every lane of it, writing zeros, the incoming
// direction and beta through on an all-dead block. K4 keeps that rule per
// group of GROUP lanes (group_live holds one flag a group), so every
// output plane equals the TPU kernel's on every lane.
#include "shade_common.cuh"

namespace pbrs {

constexpr int SLOT_COLS_W = 20;
constexpr int GROUP = 64 * 128;
constexpr int N_BASE = 15, N_OUT = 30;

struct WParams {
  const float* mats;
  int n_mats, mat_cols;
  const float* lights;
  int n_area;
  const float* delta;
  int n_delta;
  float world_radius;
  int has_env, env_is, tex_mask, n_in, rng, folded;
  uint32_t seed, bounce;
  int first, rr_on;
};

// A slot's 20 columns of the material row (zeros for no row).
static __device__ __forceinline__ Lobe load_slot(const float* row) {
  float c[SLOT_COLS_W];
#pragma unroll
  for (int j = 0; j < SLOT_COLS_W; ++j) c[j] = row ? __ldg(row + j) : 0.0f;
  Lobe l;
  for (int i = 0; i < 3; ++i) {
    l.alb[i] = c[i];
    l.spc[i] = c[3 + i];
    l.et[i] = c[13 + i];
    l.k[i] = c[16 + i];
  }
  l.kind = (int)c[6];
  l.alpha = c[7];
  l.alpha2 = c[8];
  l.distrib = (int)c[9];
  l.fr_kind = (int)c[10];
  l.eta0 = c[11];
  l.eta1 = c[12];
  l.tex = (int)c[19];
  return l;
}

// The L-slot mixture of one lane (bsdf.eval_bsdf / pdf_bsdf /
// sample_bsdf).
template <int NS>
struct WMixture {
  Lobe sl[NS];
  int n_active;
  float n_active_f;
  float wolx, woly, wolz;

  // Sum of f over the slots; pdf = sum of pdfs / n_active.
  __device__ void eval(float wilx, float wily, float wilz, float* f,
                       float& pdf) const {
    eval_lobe(sl[0], wolx, woly, wolz, wilx, wily, wilz, f, pdf);
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      float f2[3], p2;
      eval_lobe(sl[s], wolx, woly, wolz, wilx, wily, wilz, f2, p2);
      for (int c = 0; c < 3; ++c) f[c] = f[c] + f2[c];
      pdf = pdf + p2;
    }
    if (NS > 1) pdf = pdf / n_active_f;
  }

  // A uniform slot pick on u0, remapped; the chosen slot samples with
  // (u1, remapped u0), the other active slots are tallied at its
  // direction; a delta pick keeps its own f / pmf.
  __device__ Sample sample(float u0, float u1_) const {
    if (NS == 1) return sample_lobe(sl[0], wolx, woly, wolz, u1_, u0);
    int chosen = (int)(u0 * n_active_f);
    const int hi = (n_active - 1 > 0) ? n_active - 1 : 0;
    chosen = chosen < hi ? chosen : hi;
    float u_remap = fmodf(u0 * n_active_f, 1.0f);
    if (u_remap != 0.0f && u_remap < 0.0f) u_remap = u_remap + 1.0f;
    Lobe lc = sl[0];
#pragma unroll
    for (int s = 1; s < NS; ++s)
      if (chosen == s) lc = sl[s];
    Sample smp = sample_lobe(lc, wolx, woly, wolz, u1_, u_remap);
    float f_sum[3] = {0.0f, 0.0f, 0.0f}, p_sum = 0.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const bool mask = (chosen != s) && (sl[s].kind != K_NONE);
      float f2[3] = {0.0f, 0.0f, 0.0f}, p2 = 0.0f;
      if (mask)
        eval_lobe(sl[s], wolx, woly, wolz, smp.wi[0], smp.wi[1], smp.wi[2],
                  f2, p2);
      for (int c = 0; c < 3; ++c) f_sum[c] = f_sum[c] + (mask ? f2[c] : 0.0f);
      p_sum = p_sum + (mask ? p2 : 0.0f);
    }
    if (!smp.delta)
      for (int c = 0; c < 3; ++c) smp.f[c] = smp.f[c] + f_sum[c];
    smp.pdf = (smp.delta ? smp.pdf : smp.pdf + p_sum) / n_active_f;
    if (n_active == 0) {
      smp.f[0] = smp.f[1] = smp.f[2] = 0.0f;
      smp.pdf = 0.0f;
    }
    return smp;
  }
};

// Reads plane j of lane `lane`.
#define IN(j) fin[(size_t)(j) * n + lane]
#define OUT(j) fout[(size_t)(j) * n + lane]

// The shade pass of one lane of a live group. Returns the lane's traced
// shadow-ray count.
template <int NS>
static __device__ unsigned shade_lane(const WParams& P,
                                      const float* __restrict__ fin,
                                      const int* __restrict__ iin, int n,
                                      int lane, float* __restrict__ fout,
                                      int* __restrict__ iout) {
  const float rd[3] = {IN(0), IN(1), IN(2)};
  const float p[3] = {IN(3), IN(4), IN(5)};
  const float nx = IN(6), ny = IN(7), nz = IN(8);
  const float tg[3] = {IN(9), IN(10), IN(11)};
  const float beta[3] = {IN(P.n_in - 3), IN(P.n_in - 2), IN(P.n_in - 1)};
  const int mat_id = iin[lane];
  const bool hit = iin[(size_t)n + lane] > 0;
  bool alive = iin[2 * (size_t)n + lane] > 0;
  const bool prev_spec = iin[3 * (size_t)n + lane] > 0;
  const uint32_t pixu = (uint32_t)iin[4 * (size_t)n + lane];
  const uint32_t smpu = (uint32_t)iin[5 * (size_t)n + lane];
  const Draw u1{P.rng, P.seed, pixu, smpu, P.bounce};

  // ---- shading frame: vecmath.orthonormal_frame(normal, dpdu) ----
  Frame fr;
  float wol[3];
  make_frame(nx, ny, nz, tg, rd, fr, wol);

  // ---- material row (one read-only load per column), texture values ----
  const int safe_mat = hit ? mat_id : -1;
  const bool m_ok = safe_mat >= 0 && safe_mat < P.n_mats;
  const float* mrow = m_ok ? P.mats + (size_t)safe_mat * P.mat_cols : nullptr;
  float emi[3];
  for (int i = 0; i < 3; ++i) emi[i] = m_ok ? __ldg(mrow + i) : 0.0f;
  WMixture<NS> mix;
  int tex_plane = N_BASE;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    mix.sl[s] = load_slot(m_ok ? mrow + 3 + s * SLOT_COLS_W : nullptr);
    if (P.tex_mask & (1 << s)) {
      if (mix.sl[s].tex >= 0)
        for (int c = 0; c < 3; ++c) mix.sl[s].alb[c] = IN(tex_plane + c);
      tex_plane += 3;
    }
  }
  mix.n_active = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) mix.n_active += (int)(mix.sl[s].kind != K_NONE);
  mix.n_active_f = (float)(mix.n_active > 1 ? mix.n_active : 1);
  mix.wolx = wol[0];
  mix.woly = wol[1];
  mix.wolz = wol[2];

  // ---- emission / env on camera and post-delta segments ----
  float rad[3] = {0.0f, 0.0f, 0.0f};
  if (alive && (prev_spec || P.first))
    for (int i = 0; i < 3; ++i)
      rad[i] = beta[i] * (hit ? emi[i] : IN(12 + i));
  alive = alive && hit;
  const int n_lights = P.n_delta + P.n_area + (P.has_env ? 1 : 0);
  const unsigned n_rays =
      (alive && n_lights > 0) ? (P.folded ? 1u : 2u) : 0u;

  // ---- BSDF sample for the next direction ----
  const Sample bs = mix.sample(u1(DIM_BSDF_UV, 0), u1(DIM_BSDF_UV, 1));
  float wn[3];
  fr.to_world(bs.wi, wn);

  // ---- NEE: one light among delta + area + env ----
  float o1[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float o2[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                  0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (n_lights > 0) {
    const float fn = (float)n_lights;
    const float u_sel = u1(DIM_LIGHT_SELECT, 0);
    const float u_l0 = u1(DIM_LIGHT_UV, 0);
    const float u_l1 = u1(DIM_LIGHT_UV, 1);
    int chosen = (int)(u_sel * fn);
    chosen = chosen < n_lights - 1 ? chosen : n_lights - 1;
    const bool arm_delta = chosen < P.n_delta;
    const bool arm_area = !arm_delta && chosen < P.n_delta + P.n_area;
    const bool arm_env = chosen >= P.n_delta + P.n_area;
    // The area light of the lane's (clipped) index: the BSDF arm queries
    // it on every lane.
    AreaLight L;
    if (P.n_area > 0) {
      int a_idx = chosen - P.n_delta;
      a_idx = a_idx < 0 ? 0 : (a_idx > P.n_area - 1 ? P.n_area - 1 : a_idx);
      area_init(P.lights, a_idx, p, u_l0, u_l1, L);
    }
    float li[3] = {0.0f, 0.0f, 0.0f}, wl[3] = {0.0f, 0.0f, 1.0f};
    float tgt[3] = {0.0f, 0.0f, 0.0f}, pdf_l = 1.0f;
    if (arm_delta) {
      const float* r = P.delta + chosen * DELTA_COLS;
      const bool is_point = __ldg(r) < 0.5f;  // POINT = 0
      const float dp[3] = {__ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
      const float tl[3] = {dp[0] - p[0], dp[1] - p[1], dp[2] - p[2]};
      const float d2p =
          max0(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], (float)1e-30);
      const float ipd = rsqrtf(d2p);
      const float dinv = rsqrtf(
          max0(dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2], (float)1e-30));
      for (int i = 0; i < 3; ++i) {
        const float c = __ldg(r + 4 + i);
        li[i] = is_point ? c / d2p : c;
        wl[i] = is_point ? tl[i] * ipd : -dp[i] * dinv;
        tgt[i] = is_point ? dp[i] : p[i] - 2.0f * P.world_radius * dp[i];
      }
    } else if (arm_area) {
      const float tl[3] = {L.pt[0] - p[0], L.pt[1] - p[1], L.pt[2] - p[2]};
      const float d2a =
          max0(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], (float)1e-20);
      const float ia = rsqrtf(d2a);
      for (int i = 0; i < 3; ++i) wl[i] = tl[i] * ia;
      // One-sided emission.
      const float cos_la =
          -(L.ln[0] * wl[0] + L.ln[1] * wl[1] + L.ln[2] * wl[2]);
      const bool facing = cos_la > 0.0f;
      bool ok_;
      float t_;
      area_query(L, p, wl[0], wl[1], wl[2], ok_, t_, pdf_l);
      for (int i = 0; i < 3; ++i) {
        li[i] = facing ? L.le[i] : 0.0f;
        tgt[i] = L.pt[i];
      }
    } else if (P.env_is) {
      // The importance-sampled env arm, drawn outside from the same
      // DIM_LIGHT_UV stream: direction, radiance, solid-angle pdf.
      const int e = tex_plane;
      for (int i = 0; i < 3; ++i) {
        wl[i] = IN(e + i);
        li[i] = IN(e + 3 + i);
      }
      pdf_l = IN(e + 6);
    }

    // -------- light-sampled arm: shadow query 1 --------
    if (P.n_delta + P.n_area > 0 || P.env_is) {
      float wil[3], fe[3], pdf_sc;
      fr.to_local(wl[0], wl[1], wl[2], wil);
      mix.eval(wil[0], wil[1], wil[2], fe, pdf_sc);
      if (wol[2] == 0.0f) fe[0] = fe[1] = fe[2] = 0.0f;
      const float cos_s = fabsf(nx * wl[0] + ny * wl[1] + nz * wl[2]);
      float sd[3];
      for (int i = 0; i < 3; ++i)
        sd[i] = (P.env_is && arm_env) ? wl[i] : tgt[i] - p[i];
      const float side =
          (sd[0] * nx + sd[1] * ny + sd[2] * nz >= 0.0f) ? 1.0f : -1.0f;
      const float weight =
          arm_delta ? 1.0f
                    : pdf_l * pdf_l /
                          max0(pdf_l * pdf_l + pdf_sc * pdf_sc, (float)1e-30);
      const bool li_any = (li[0] > 0.0f) || (li[1] > 0.0f) || (li[2] > 0.0f);
      const bool sampled = arm_delta || arm_area || (P.env_is && arm_env);
      const bool valid = sampled && (pdf_l > 0.0f) && li_any && alive;
      const float c = valid ? cos_s * weight * weak_recip(pdf_l) : 0.0f;
      for (int i = 0; i < 3; ++i) o1[i] = sd[i];
      o1[3] = valid ? ((P.env_is && arm_env) ? inf_f() : SHADOW_T) : 0.0f;
      o1[4] = side;
      for (int i = 0; i < 3; ++i)
        o1[5 + i] = alive ? beta[i] * fe[i] * li[i] * c * fn : 0.0f;
    }

    // -------- BSDF-sampled arm (area MIS + env): shadow query 2 --------
    // Folded, the continuation sample is the arm's and the next bounce's
    // closest hit resolves its visibility.
    if (P.n_area > 0 || P.has_env) {
      Sample ss = bs;
      float w2[3] = {wn[0], wn[1], wn[2]};
      if (!P.folded) {
        ss = mix.sample(u1(DIM_SCATTER_UV, 0), u1(DIM_SCATTER_UV, 1));
        fr.to_world(ss.wi, w2);
      }
      const float cos2a = fabsf(w2[0] * nx + w2[1] * ny + w2[2] * nz);
      const float f2[3] = {ss.f[0] * cos2a, ss.f[1] * cos2a, ss.f[2] * cos2a};
      bool hit_l = false;
      float t_hit = 0.0f, pdf_l2 = 0.0f;
      if (P.n_area > 0) area_query(L, p, w2[0], w2[1], w2[2], hit_l, t_hit,
                                   pdf_l2);
      const bool f_any = (f2[0] > 0.0f) || (f2[1] > 0.0f) || (f2[2] > 0.0f);
      bool valid_b = false, valid_e = false;
      if (P.n_area > 0) {
        const float w_b =
            ss.pdf * ss.pdf / max0(ss.pdf * ss.pdf + pdf_l2 * pdf_l2,
                                   (float)1e-30);
        // Delta-sampled directions are left to the emission-after-specular
        // rule.
        valid_b = arm_area && hit_l && !ss.delta && (ss.pdf > 0.0f) &&
                  (pdf_l2 > 0.0f) && f_any && alive;
        const float cb_ = valid_b ? w_b * weak_recip(ss.pdf) : 0.0f;
        for (int i = 0; i < 3; ++i)
          o2[5 + i] = alive ? beta[i] * f2[i] * L.le[i] * cb_ * fn : 0.0f;
      }
      if (P.has_env) {
        // The env radiance (and its MIS weight under env-IS) applies
        // outside: emit beta * f2 / s_pdf * n_lights and the BSDF pdf.
        valid_e = arm_env && !ss.delta && (ss.pdf > 0.0f) && alive;
        const float ce_ = valid_e ? weak_recip(ss.pdf) : 0.0f;
        for (int i = 0; i < 3; ++i)
          o2[8 + i] = alive ? beta[i] * f2[i] * ce_ * fn : 0.0f;
        o2[11] = valid_e ? ss.pdf : 0.0f;
      }
      if (P.folded) {
        o2[3] = valid_b ? t_hit : 0.0f;
      } else {
        float dir2[3];
        for (int i = 0; i < 3; ++i) dir2[i] = arm_env ? w2[i] : t_hit * w2[i];
        for (int i = 0; i < 3; ++i) o2[i] = dir2[i];
        o2[3] = valid_e ? inf_f() : (valid_b ? SHADOW_T : 0.0f);
        o2[4] = (dir2[0] * nx + dir2[1] * ny + dir2[2] * nz >= 0.0f) ? 1.0f
                                                                      : -1.0f;
      }
    }
  }

  // ---- continuation: throughput update, Russian roulette ----
  const float cosn = fabsf(wn[0] * nx + wn[1] * ny + wn[2] * nz);
  const bool f_any = (bs.f[0] > 0.0f) || (bs.f[1] > 0.0f) || (bs.f[2] > 0.0f);
  alive = alive && (bs.pdf > 0.0f) && f_any;
  const float mult = cosn * weak_recip(bs.pdf);
  float nb[3];
  for (int i = 0; i < 3; ++i) nb[i] = alive ? beta[i] * bs.f[i] * mult : beta[i];
  if (P.rr_on) {
    const float lum = (float)0.21267127 * nb[0] + (float)0.71515972 * nb[1] +
                      (float)0.07216883 * nb[2];
    const float q = max0(1.0f - lum, (float)0.05);
    alive = alive &&
            !(u1(DIM_RUSSIAN_ROULETTE, 0) < q);
    const float scale = alive ? 1.0f / max0(1.0f - q, (float)1e-6) : 1.0f;
    for (int i = 0; i < 3; ++i) nb[i] = nb[i] * scale;
  }
  const float nside =
      (wn[0] * nx + wn[1] * ny + wn[2] * nz >= 0.0f) ? 1.0f : -1.0f;
  for (int i = 0; i < 3; ++i) OUT(i) = rad[i];
  for (int j = 0; j < 8; ++j) OUT(3 + j) = o1[j];
  for (int j = 0; j < 12; ++j) OUT(11 + j) = o2[j];
  for (int i = 0; i < 3; ++i) {
    OUT(23 + i) = wn[i];
    OUT(27 + i) = nb[i];
  }
  OUT(26) = nside;
  iout[lane] = alive ? 1 : 0;
  iout[(size_t)n + lane] = (alive && bs.delta) ? 1 : 0;
  return n_rays;
}

template <int NS>
__global__ void fused_wave_kernel(WParams P, const float* __restrict__ fin,
                                  const int* __restrict__ iin,
                                  const int* __restrict__ group_live, int n,
                                  float* __restrict__ fout,
                                  int* __restrict__ iout,
                                  unsigned long long* __restrict__ count) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned rays = 0;
  if (lane < n) {
    if (group_live[lane / GROUP]) {
      rays = shade_lane<NS>(P, fin, iin, n, lane, fout, iout);
    } else {
      // All-dead group: zeros, the incoming direction and beta.
      for (int j = 0; j < N_OUT; ++j) OUT(j) = 0.0f;
      for (int i = 0; i < 3; ++i) {
        OUT(23 + i) = IN(i);
        OUT(27 + i) = IN(P.n_in - 3 + i);
      }
      iout[lane] = 0;
      iout[(size_t)n + lane] = 0;
    }
  }
  count_rays(rays, count);
}

#undef IN
#undef OUT

}  // namespace pbrs

extern "C" {

// mats [n_mats, mat_cols] (emission, 20 columns per slot); lights [*, 14];
// delta [*, 8]; fin [n_in, n] float32 planes (dir, position, normal, dpdu,
// env radiance, 3 per textured slot, 7 for an importance-sampled env,
// beta); iin [6, n] int32 (mat_id, hit, alive, spec, pixel, sample);
// group_live [ceil(n / 8192)] int32; fout [30, n] float32; iout [2, n]
// int32 (alive, spec); count: one uint64 the pass's shadow rays are added
// to. tex_mask has bit s set for a textured slot s; rng 0 draws PCG, 1
// Sobol'; folded 1 takes the folded NEE. Returns cudaGetLastError() after
// the launch.
int pbrs_fused_wave(const float* mats, int n_mats, int mat_cols, int n_slots,
                    const float* lights, int n_area, const float* delta,
                    int n_delta, float world_radius, int has_env, int env_is,
                    int tex_mask, int rng, int folded, int seed, int bounce,
                    int first, int rr_on, const float* fin, int n_in,
                    const int* iin, const int* group_live, int n, float* fout,
                    int* iout, void* count, void* stream) {
  pbrs::WParams P;
  P.mats = mats;
  P.n_mats = n_mats;
  P.mat_cols = mat_cols;
  P.lights = lights;
  P.n_area = n_area;
  P.delta = delta;
  P.n_delta = n_delta;
  P.world_radius = world_radius;
  P.has_env = has_env;
  P.env_is = env_is;
  P.tex_mask = tex_mask;
  P.n_in = n_in;
  P.rng = rng;
  P.folded = folded;
  P.seed = (uint32_t)seed;
  P.bounce = (uint32_t)bounce;
  P.first = first;
  P.rr_on = rr_on;
  const int block = 256;
  const int grid = (n + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* cnt = (unsigned long long*)count;
  switch (n_slots) {
    case 1:
      pbrs::fused_wave_kernel<1><<<grid, block, 0, st>>>(
          P, fin, iin, group_live, n, fout, iout, cnt);
      break;
    case 2:
      pbrs::fused_wave_kernel<2><<<grid, block, 0, st>>>(
          P, fin, iin, group_live, n, fout, iout, cnt);
      break;
    case 3:
      pbrs::fused_wave_kernel<3><<<grid, block, 0, st>>>(
          P, fin, iin, group_live, n, fout, iout, cnt);
      break;
    case 4:
      pbrs::fused_wave_kernel<4><<<grid, block, 0, st>>>(
          P, fin, iin, group_live, n, fout, iout, cnt);
      break;
    case 5:
      pbrs::fused_wave_kernel<5><<<grid, block, 0, st>>>(
          P, fin, iin, group_live, n, fout, iout, cnt);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
