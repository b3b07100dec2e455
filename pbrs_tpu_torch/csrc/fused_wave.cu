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
// (0.03-0.07 ms at 67 TFLOP/s) -- but divergence and memory transactions:
// after the camera bounce the lanes of a warp hold other materials, so a
// warp runs the eval / sample branch of every lobe kind its lanes hold;
// once lanes are regrouped, a warp's lanes are scattered over its window,
// and 4-byte stores to scattered lanes of 32 planes cost more than the
// loads.
// What the design does about it:
// - Lanes regrouped by material inside the block. A block of 512 threads
//   takes a window of 2048 lanes, reads their shading keys coalesced (the
//   material row's class -- rows with equal lobe kinds share one, numbered
//   on the host -- or "dead"), and a stable counting sort in shared memory
//   (warp match for ranks inside 32-lane chunks, a block scan over class x
//   chunk) gives each thread the lanes at its sorted positions. Warps then
//   hold one class each, apart from the class boundaries. No extra launch,
//   no host op. (Windows of 256-1024 lanes left more warps mixed: slower.)
// - Outputs staged: as many of the 32 output planes as fit in shared
//   memory beside the table (26 for the interior's) are written there at
//   the lane's offset in the window and copied out coalesced when the
//   window is done; the rest are stored at the lane's index directly.
// - Occupancy: the material table is copied into shared memory once a
//   block, and a slot's columns are read from there where eval_lobe /
//   sample_lobe need them (through an opaque row offset, so they are not
//   held in registers across the lane), as are the area light's shape for
//   the BSDF arm and each phase's input planes; outputs are written as soon
//   as they are final. __launch_bounds__(512, 1) caps a thread at 128
//   registers: 16 warps an SM (pbrs_fused_wave_info reports registers,
//   local memory, resident warps and staged planes).
// - A lane that enters dead writes its pass-through on its own: zeros, its
//   incoming direction and beta. The apply step reads nothing else of it.
// - The scene's static switches as uniform launch arguments, the traced
//   shadow-ray count summed exactly on the device (block reduction, one
//   64-bit atomicAdd per block).
#include "shade_common.cuh"

namespace pbrs {

constexpr int SLOT_COLS_W = 20;
constexpr int N_BASE = 15, N_OUT = 30;
constexpr int BLOCK = 512;            // threads a block, 16 warps
constexpr int WINDOW = 2048;          // lanes a block regroups
constexpr int CHUNKS = WINDOW / 32;   // 32-lane chunks of a window
constexpr int MIN_BLOCKS = 1;         // resident blocks an SM
constexpr int MAX_CLASSES = 32;       // shading classes, "dead" excluded

struct WParams {
  const float* mats;
  int n_mats, mat_cols;
  const int* mat_class;  // [n_mats + 1]: the rows' classes, then the zero row's
  int n_classes;
  const float* lights;
  int n_area;
  const float* delta;
  int n_delta;
  float world_radius;
  int has_env, env_is, tex_mask, n_in, rng, folded;
  uint32_t seed, bounce;
  int first, rr_on;
  int n_stage;  // output planes staged in shared memory
};

// An opaque copy of an offset: what is loaded through it is loaded again at
// each use instead of being kept in registers across the lane's shading.
static __device__ __forceinline__ int opaque(int i) {
  asm volatile("" : "+r"(i));
  return i;
}

// A slot's 20 columns of a material row in shared memory.
static __device__ __forceinline__ Lobe slot_at(const float* c) {
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

// Where a lane's outputs go: output plane j < n_stage to the block's
// shared copy of the window's planes (at the lane's offset `local` in the
// window), the rest straight to fout / iout at the lane's index. Planes
// N_OUT and N_OUT + 1 are iout's two.
struct LaneOut {
  float* fout;
  int* iout;
  float* s_out;
  int n, lane, local, n_stage;
  __device__ __forceinline__ void put(int j, float v) const {
    if (j < n_stage)
      s_out[j * WINDOW + local] = v;
    else
      fout[(size_t)j * n + lane] = v;
  }
  __device__ __forceinline__ void put_int(int j, int v) const {
    if (N_OUT + j < n_stage)
      s_out[(N_OUT + j) * WINDOW + local] = __int_as_float(v);
    else
      iout[(size_t)j * n + lane] = v;
  }
};
struct OutRef {
  const LaneOut& o;
  int j;
  __device__ __forceinline__ void operator=(float v) const { o.put(j, v); }
};

// Reads plane j of lane `lane`; OUT(j) = v writes output plane j of it.
#define IN(j) fin[(size_t)(j) * n + lane]
#define OUT(j) (OutRef{out, (j)})

// The L-slot mixture of one lane (bsdf.eval_bsdf / pdf_bsdf /
// sample_bsdf), its slots read from the block's copy of the material
// table where they are used.
template <int NS>
struct WMixture {
  const float* mats;  // shared copy; row n_mats is all zeros
  int row_off;        // the lane's row * mat_cols
  const float* fin;
  int n, lane, tex_mask;
  int n_active;
  float n_active_f;
  float wolx, woly, wolz;

  __device__ __forceinline__ int kind(int s) const {
    return (int)mats[opaque(row_off) + 3 + s * SLOT_COLS_W + 6];
  }

  // Slot s, its albedo from the texture planes where the slot is textured.
  __device__ __forceinline__ Lobe slot(int s) const {
    Lobe l = slot_at(mats + opaque(row_off) + 3 + s * SLOT_COLS_W);
    if ((tex_mask >> s) & 1) {
      if (l.tex >= 0) {
        const int t = N_BASE + 3 * __popc(tex_mask & ((1 << s) - 1));
        for (int c = 0; c < 3; ++c) l.alb[c] = IN(t + c);
      }
    }
    return l;
  }

  // Sum of f over the slots; pdf = sum of pdfs / n_active.
  __device__ void eval(float wilx, float wily, float wilz, float* f,
                       float& pdf) const {
    eval_lobe(slot(0), wolx, woly, wolz, wilx, wily, wilz, f, pdf);
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      float f2[3], p2;
      eval_lobe(slot(s), wolx, woly, wolz, wilx, wily, wilz, f2, p2);
      for (int c = 0; c < 3; ++c) f[c] = f[c] + f2[c];
      pdf = pdf + p2;
    }
    if (NS > 1) pdf = pdf / n_active_f;
  }

  // A uniform slot pick on u0, remapped; the chosen slot samples with
  // (u1, remapped u0), the other active slots are tallied at its
  // direction; a delta pick keeps its own f / pmf.
  __device__ Sample sample(float u0, float u1_) const {
    if (NS == 1) return sample_lobe(slot(0), wolx, woly, wolz, u1_, u0);
    int chosen = (int)(u0 * n_active_f);
    const int hi = (n_active - 1 > 0) ? n_active - 1 : 0;
    chosen = chosen < hi ? chosen : hi;
    float u_remap = fmodf(u0 * n_active_f, 1.0f);
    if (u_remap != 0.0f && u_remap < 0.0f) u_remap = u_remap + 1.0f;
    Sample smp = sample_lobe(slot(chosen < NS ? chosen : 0), wolx, woly,
                             wolz, u1_, u_remap);
    float f_sum[3] = {0.0f, 0.0f, 0.0f}, p_sum = 0.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const bool mask = (chosen != s) && (kind(s) != K_NONE);
      float f2[3] = {0.0f, 0.0f, 0.0f}, p2 = 0.0f;
      if (mask)
        eval_lobe(slot(s), wolx, woly, wolz, smp.wi[0], smp.wi[1], smp.wi[2],
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

// A lane that enters dead: zeros, the incoming direction and beta.
static __device__ __forceinline__ void pass_through(
    const WParams& P, const float* __restrict__ fin, int n, int lane,
    const LaneOut& out) {
  for (int j = 0; j < N_OUT; ++j) OUT(j) = 0.0f;
  for (int i = 0; i < 3; ++i) {
    OUT(23 + i) = IN(i);
    OUT(27 + i) = IN(P.n_in - 3 + i);
  }
  out.put_int(0, 0);
  out.put_int(1, 0);
}

// One lane's input planes, read at `lane`. Each phase of the shading takes
// its own reader with an opaque copy of the lane index, so a value the
// phase needs is read again there instead of being held in a register
// from an earlier phase.
struct LaneIn {
  const float* fin;
  int n, lane;
  __device__ __forceinline__ float operator()(int j) const {
    return fin[(size_t)j * n + lane];
  }
};

// The shading frame (vecmath.orthonormal_frame(normal, dpdu)) and the
// local outgoing direction, from the lane's planes.
static __device__ __forceinline__ void lane_frame(const LaneIn& in,
                                                  Frame& fr, float* wol) {
  const float rd[3] = {in(0), in(1), in(2)};
  const float tg[3] = {in(9), in(10), in(11)};
  make_frame(in(6), in(7), in(8), tg, rd, fr, wol);
}

// The shade pass of one lane that enters alive, its material row `row`
// (n_mats for a miss or a row out of range). Returns the lane's traced
// shadow-ray count.
template <int NS>
static __device__ unsigned shade_lane(const WParams& P, const float* s_mats,
                                      const float* __restrict__ fin,
                                      const int* __restrict__ iin, int n,
                                      int lane, int row,
                                      const LaneOut& out) {
  const bool hit = iin[(size_t)n + lane] > 0;
  const bool prev_spec = iin[3 * (size_t)n + lane] > 0;
  const uint32_t pixu = (uint32_t)iin[4 * (size_t)n + lane];
  const uint32_t smpu = (uint32_t)iin[5 * (size_t)n + lane];
  const Draw u1{P.rng, P.seed, pixu, smpu, P.bounce};

  // ---- material row (the block's shared copy), texture values ----
  WMixture<NS> mix;
  mix.mats = s_mats;
  mix.row_off = row * P.mat_cols;
  mix.fin = fin;
  mix.n = n;
  mix.lane = lane;
  mix.tex_mask = P.tex_mask;
  mix.n_active = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) mix.n_active += (int)(mix.kind(s) != K_NONE);
  mix.n_active_f = (float)(mix.n_active > 1 ? mix.n_active : 1);

  // ---- emission / env on camera and post-delta segments ----
  Sample bs;
  float wn[3];
  {
    const LaneIn in{fin, n, opaque(lane)};
    if (prev_spec || P.first) {
      const float* emi = s_mats + opaque(mix.row_off);
      for (int i = 0; i < 3; ++i)
        OUT(i) = in(P.n_in - 3 + i) * (hit ? emi[i] : in(12 + i));
    } else {
      for (int i = 0; i < 3; ++i) OUT(i) = 0.0f;
    }
    // ---- BSDF sample for the next direction ----
    Frame fr;
    float wol[3];
    lane_frame(in, fr, wol);
    mix.wolx = wol[0];
    mix.woly = wol[1];
    mix.wolz = wol[2];
    bs = mix.sample(u1(DIM_BSDF_UV, 0), u1(DIM_BSDF_UV, 1));
    fr.to_world(bs.wi, wn);
  }
  bool alive = hit;
  const int n_lights = P.n_delta + P.n_area + (P.has_env ? 1 : 0);

  // ---- NEE: one light among delta + area + env ----
  bool light_arm = false, bsdf_arm = false;
  if (n_lights > 0) {
    const float fn = (float)n_lights;
    int chosen = (int)(u1(DIM_LIGHT_SELECT, 0) * fn);
    chosen = chosen < n_lights - 1 ? chosen : n_lights - 1;
    const bool arm_delta = chosen < P.n_delta;
    const bool arm_area = !arm_delta && chosen < P.n_delta + P.n_area;
    const bool arm_env = chosen >= P.n_delta + P.n_area;
    int a_idx = chosen - P.n_delta;
    a_idx = a_idx < 0 ? 0 : (a_idx > P.n_area - 1 ? P.n_area - 1 : a_idx);

    // -------- light-sampled arm: shadow query 1 --------
    if (P.n_delta + P.n_area > 0 || P.env_is) {
      light_arm = true;
      const LaneIn in{fin, n, opaque(lane)};
      const float p[3] = {in(3), in(4), in(5)};
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
        AreaLight L;
        area_init(P.lights, a_idx, p, u1(DIM_LIGHT_UV, 0),
                  u1(DIM_LIGHT_UV, 1), L);
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
        const int e = N_BASE + 3 * __popc(P.tex_mask);
        for (int i = 0; i < 3; ++i) {
          wl[i] = in(e + i);
          li[i] = in(e + 3 + i);
        }
        pdf_l = in(e + 6);
      }
      float sd[3];
      for (int i = 0; i < 3; ++i)
        sd[i] = (P.env_is && arm_env) ? wl[i] : tgt[i] - p[i];
      Frame fr;
      float wol[3];
      lane_frame(in, fr, wol);
      mix.wolx = wol[0];
      mix.woly = wol[1];
      mix.wolz = wol[2];
      const float nx = fr.n[0], ny = fr.n[1], nz = fr.n[2];
      float wil[3], fe[3], pdf_sc;
      fr.to_local(wl[0], wl[1], wl[2], wil);
      mix.eval(wil[0], wil[1], wil[2], fe, pdf_sc);
      if (wol[2] == 0.0f) fe[0] = fe[1] = fe[2] = 0.0f;
      const float cos_s = fabsf(nx * wl[0] + ny * wl[1] + nz * wl[2]);
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
      for (int i = 0; i < 3; ++i) OUT(3 + i) = sd[i];
      OUT(6) = valid ? ((P.env_is && arm_env) ? inf_f() : SHADOW_T) : 0.0f;
      OUT(7) = side;
      for (int i = 0; i < 3; ++i)
        OUT(8 + i) = alive ? in(P.n_in - 3 + i) * fe[i] * li[i] * c * fn : 0.0f;
    }

    // -------- BSDF-sampled arm (area MIS + env): shadow query 2 --------
    // Folded, the continuation sample is the arm's and the next bounce's
    // closest hit resolves its visibility.
    if (P.n_area > 0 || P.has_env) {
      bsdf_arm = true;
      const LaneIn in{fin, n, opaque(lane)};
      float o2[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                      0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      Sample ss = bs;
      float w2[3] = {wn[0], wn[1], wn[2]};
      if (!P.folded) {
        Frame fr;
        float wol[3];
        lane_frame(in, fr, wol);
        mix.wolx = wol[0];
        mix.woly = wol[1];
        mix.wolz = wol[2];
        ss = mix.sample(u1(DIM_SCATTER_UV, 0), u1(DIM_SCATTER_UV, 1));
        fr.to_world(ss.wi, w2);
      }
      const float p[3] = {in(3), in(4), in(5)};
      const float nx = in(6), ny = in(7), nz = in(8);
      const float cos2a = fabsf(w2[0] * nx + w2[1] * ny + w2[2] * nz);
      const float f2[3] = {ss.f[0] * cos2a, ss.f[1] * cos2a, ss.f[2] * cos2a};
      // The area light of the lane's (clipped) index, its shape read again.
      AreaLight L;
      bool hit_l = false;
      float t_hit = 0.0f, pdf_l2 = 0.0f;
      if (P.n_area > 0) {
        area_shape(P.lights, opaque(a_idx), L);
        area_query(L, p, w2[0], w2[1], w2[2], hit_l, t_hit, pdf_l2);
      }
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
          o2[5 + i] =
              alive ? in(P.n_in - 3 + i) * f2[i] * L.le[i] * cb_ * fn : 0.0f;
      }
      if (P.has_env) {
        // The env radiance (and its MIS weight under env-IS) applies
        // outside: emit beta * f2 / s_pdf * n_lights and the BSDF pdf.
        valid_e = arm_env && !ss.delta && (ss.pdf > 0.0f) && alive;
        const float ce_ = valid_e ? weak_recip(ss.pdf) : 0.0f;
        for (int i = 0; i < 3; ++i)
          o2[8 + i] = alive ? in(P.n_in - 3 + i) * f2[i] * ce_ * fn : 0.0f;
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
      for (int j = 0; j < 12; ++j) OUT(11 + j) = o2[j];
    }
  }
  if (!light_arm)
    for (int j = 0; j < 8; ++j) OUT(3 + j) = 0.0f;
  if (!bsdf_arm)
    for (int j = 0; j < 12; ++j) OUT(11 + j) = 0.0f;

  // ---- continuation: throughput update, Russian roulette ----
  const LaneIn in{fin, n, opaque(lane)};
  const float nx = in(6), ny = in(7), nz = in(8);
  const float cosn = fabsf(wn[0] * nx + wn[1] * ny + wn[2] * nz);
  const bool f_any = (bs.f[0] > 0.0f) || (bs.f[1] > 0.0f) || (bs.f[2] > 0.0f);
  alive = alive && (bs.pdf > 0.0f) && f_any;
  const float mult = cosn * weak_recip(bs.pdf);
  float nb[3];
  for (int i = 0; i < 3; ++i) {
    const float beta = in(P.n_in - 3 + i);
    nb[i] = alive ? beta * bs.f[i] * mult : beta;
  }
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
  for (int i = 0; i < 3; ++i) {
    OUT(23 + i) = wn[i];
    OUT(27 + i) = nb[i];
  }
  OUT(26) = nside;
  out.put_int(0, alive ? 1 : 0);
  out.put_int(1, (alive && bs.delta) ? 1 : 0);
  return (hit && n_lights > 0) ? (P.folded ? 1u : 2u) : 0u;
}

// Dynamic shared memory of a block: the material table with a zero row,
// the row classes, the class x chunk counts, the sorted lane offsets, then
// n_stage output planes of the window.
static __host__ __device__ __forceinline__ size_t wave_smem_bytes(
    int n_mats, int mat_cols, int n_stage) {
  return sizeof(float) * (size_t)((n_mats + 1) * mat_cols + (n_mats + 1)) +
         sizeof(int) * (size_t)(MAX_CLASSES + 1) * CHUNKS +
         sizeof(unsigned short) * (size_t)WINDOW +
         sizeof(float) * (size_t)n_stage * WINDOW;
}

template <int NS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    fused_wave_kernel(WParams P, const float* __restrict__ fin,
                      const int* __restrict__ iin, int n,
                      float* __restrict__ fout, int* __restrict__ iout,
                      unsigned long long* __restrict__ count) {
  extern __shared__ float smem[];
  __shared__ int warp_tot[32];
  float* s_mats = smem;
  const int n_rows = P.n_mats + 1;
  int* s_class = reinterpret_cast<int*>(smem + n_rows * P.mat_cols);
  int* s_cnt = s_class + n_rows;  // [n_keys][CHUNKS]
  const int n_keys = P.n_classes + 1;  // the classes, then "dead"
  unsigned short* s_lane =
      reinterpret_cast<unsigned short*>(s_cnt + (MAX_CLASSES + 1) * CHUNKS);
  float* s_out = reinterpret_cast<float*>(s_lane + WINDOW);  // [n_stage][W]
  const int tid = threadIdx.x;
  for (int i = tid; i < n_rows * P.mat_cols; i += BLOCK)
    s_mats[i] = i < P.n_mats * P.mat_cols ? __ldg(P.mats + i) : 0.0f;
  for (int i = tid; i < n_rows; i += BLOCK) s_class[i] = __ldg(P.mat_class + i);
  for (int i = tid; i < n_keys * CHUNKS; i += BLOCK) s_cnt[i] = 0;
  __syncthreads();

  // Keys of the window, read coalesced: the row's class, or dead. Ranks
  // inside each 32-lane chunk come from a warp match, so the sort is
  // stable and a class's lanes keep their order.
  const int base = blockIdx.x * WINDOW;
  const int lane_id = tid & 31, warp = tid >> 5;
  constexpr int PER_WARP = CHUNKS / (BLOCK / 32);
  int key[PER_WARP], rank[PER_WARP];
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int chunk = warp + k * (BLOCK / 32);
    const int lane = base + chunk * 32 + lane_id;
    int kk = n_keys;  // past the end of the frame: no key
    if (lane < n) {
      if (iin[2 * (size_t)n + lane] > 0) {
        const int mat = iin[lane];
        const bool m_ok =
            iin[(size_t)n + lane] > 0 && mat >= 0 && mat < P.n_mats;
        kk = s_class[m_ok ? mat : P.n_mats];
      } else {
        kk = n_keys - 1;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, kk);
    rank[k] = __popc(peers & ((1u << lane_id) - 1u));
    key[k] = kk;
    if (kk < n_keys && rank[k] == 0) s_cnt[kk * CHUNKS + chunk] = __popc(peers);
  }
  __syncthreads();
  scan_block(s_cnt, n_keys * CHUNKS, warp_tot);
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int chunk = warp + k * (BLOCK / 32);
    if (key[k] < n_keys)
      s_lane[s_cnt[key[k] * CHUNKS + chunk] + rank[k]] =
          (unsigned short)(chunk * 32 + lane_id);
  }
  __syncthreads();

  // Each thread shades the lanes at its sorted positions ...
  const int count_in = n - base < WINDOW ? n - base : WINDOW;
  unsigned rays = 0;
#pragma unroll 1
  for (int pos = tid; pos < count_in; pos += BLOCK) {
    const int local = s_lane[pos];
    const int lane = base + local;
    const LaneOut out{fout, iout, s_out, n, lane, local, P.n_stage};
    if (iin[2 * (size_t)n + lane] > 0) {
      const int mat = iin[lane];
      const bool m_ok =
          iin[(size_t)n + lane] > 0 && mat >= 0 && mat < P.n_mats;
      rays += shade_lane<NS>(P, s_mats, fin, iin, n, lane,
                             m_ok ? mat : P.n_mats, out);
    } else {
      pass_through(P, fin, n, lane, out);
    }
  }
  count_rays(rays, count);  // (its barrier also ends the shading)
  // ... and the block writes the staged output planes out, coalesced.
  for (int j = 0; j < P.n_stage; ++j) {
    const float* src = s_out + j * WINDOW;
    if (j < N_OUT) {
      for (int i = tid; i < count_in; i += BLOCK)
        fout[(size_t)j * n + base + i] = src[i];
    } else {
      for (int i = tid; i < count_in; i += BLOCK)
        iout[(size_t)(j - N_OUT) * n + base + i] = __float_as_int(src[i]);
    }
  }
}

#undef IN
#undef OUT

template <int NS>
static const void* wave_kernel_ptr() {
  return reinterpret_cast<const void*>(&fused_wave_kernel<NS>);
}

static const void* wave_kernel(int n_slots) {
  switch (n_slots) {
    case 1: return wave_kernel_ptr<1>();
    case 2: return wave_kernel_ptr<2>();
    case 3: return wave_kernel_ptr<3>();
    case 4: return wave_kernel_ptr<4>();
    case 5: return wave_kernel_ptr<5>();
    default: return nullptr;
  }
}

// The launch shape of the n_slots kernel for an n_mats x mat_cols table on
// the current device: as many output planes staged in shared memory as fit
// beside the table and the sort (at most all 32), and the dynamic shared
// memory that takes. Raises the kernel's dynamic shared memory limit to it.
// Both the limit and what is read here belong to one device, so nothing is
// cached between calls.
static cudaError_t wave_shape(int n_slots, int n_mats, int mat_cols,
                              int* n_stage, size_t* smem) {
  const void* fn = wave_kernel(n_slots);
  if (!fn) return cudaErrorInvalidValue;
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  const size_t used =
      attr.sharedSizeBytes + wave_smem_bytes(n_mats, mat_cols, 0);
  const size_t room = (size_t)optin > used ? (size_t)optin - used : 0;
  size_t k = room / (sizeof(float) * WINDOW);
  if (k > (size_t)N_OUT + 2) k = N_OUT + 2;
  *n_stage = (int)k;
  *smem = wave_smem_bytes(n_mats, mat_cols, (int)k);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace pbrs

extern "C" {

// mats [n_mats, mat_cols] (emission, 20 columns per slot); mat_class
// [n_mats + 1] int32 (each row's shading class in [0, n_classes), then a
// missed lane's); lights [*, 14]; delta [*, 8]; fin [n_in, n] float32
// planes (dir, position, normal, dpdu, env radiance, 3 per textured slot, 7
// for an importance-sampled env, beta); iin [6, n] int32 (mat_id, hit,
// alive, spec, pixel, sample); fout [30, n] float32; iout [2, n] int32
// (alive, spec); count: one uint64 the pass's shadow rays are added to.
// tex_mask has bit s set for a textured slot s; rng 0 draws PCG, 1
// Sobol'; folded 1 takes the folded NEE. Returns cudaGetLastError() after
// the launch.
int pbrs_fused_wave(const float* mats, int n_mats, int mat_cols, int n_slots,
                    const int* mat_class, int n_classes, const float* lights,
                    int n_area, const float* delta, int n_delta,
                    float world_radius, int has_env, int env_is, int tex_mask,
                    int rng, int folded, int seed, int bounce, int first,
                    int rr_on, const float* fin, int n_in, const int* iin,
                    int n, float* fout, int* iout, void* count,
                    void* stream) {
  const void* fn = pbrs::wave_kernel(n_slots);
  if (!fn || n_classes < 1 || n_classes > pbrs::MAX_CLASSES)
    return (int)cudaErrorInvalidValue;
  pbrs::WParams P;
  P.mats = mats;
  P.n_mats = n_mats;
  P.mat_cols = mat_cols;
  P.mat_class = mat_class;
  P.n_classes = n_classes;
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
  size_t smem;
  const cudaError_t es =
      pbrs::wave_shape(n_slots, n_mats, mat_cols, &P.n_stage, &smem);
  if (es != cudaSuccess) return (int)es;
  const int grid = (n + pbrs::WINDOW - 1) / pbrs::WINDOW;
  unsigned long long* cnt = (unsigned long long*)count;
  void* args[] = {&P, &fin, &iin, &n, &fout, &iout, &cnt};
  const cudaError_t e = cudaLaunchKernel(fn, dim3(grid), dim3(pbrs::BLOCK),
                                         args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The n_slots kernel as ptxas built it and as it launches on one SM for a
// table of n_mats x mat_cols: info[0] registers a thread, info[1] local
// memory bytes a thread (spills and stack), info[2] resident warps an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[3] dynamic shared
// memory bytes a block, info[4] threads a block, info[5] lanes a block
// regroups, info[6] output planes staged in shared memory.
int pbrs_fused_wave_info(int n_slots, int n_mats, int mat_cols, int* info) {
  const void* fn = pbrs::wave_kernel(n_slots);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int n_stage;
  size_t smem;
  e = pbrs::wave_shape(n_slots, n_mats, mat_cols, &n_stage, &smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, pbrs::BLOCK,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks * pbrs::BLOCK / 32;
  info[3] = (int)smem;
  info[4] = pbrs::BLOCK;
  info[5] = pbrs::WINDOW;
  info[6] = n_stage;
  return 0;
}

}  // extern "C"
