// K3: fused single-lobe bounce for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// pbrs_tpu/accel/fused_single_lobe.py:_bounce2_kernel (launched by
// _bounce2_call), PCG or Sobol' (the `rng` launch argument). One launch runs a whole wavefront bounce
// per lane: closest hit over the [P,16] bank, sphere/quad/triangle/disk hit
// detail, shading frame, the material row, solid/checker/Perlin-marble
// textures, per-lobe eval/pdf and the two-lobe mixture sample (Lambert,
// isotropic Beckmann/Trowbridge-Reitz microfacet with nop/dielectric/
// conductor Fresnel, mirror, hybrid dielectric, transmit), emission and
// the none/const/gradient/dusk environment on camera and post-delta
// segments, NEE over one light among delta, area (quad, sphere cone, disk,
// triangle) and env with both MIS arms and their shadow sweeps, the BSDF
// continuation, Russian roulette and the next-ray spawn. The plain version
// is pbrs_tpu_torch/accel/fused_single_lobe.py:bounce2_reference; every
// expression here keeps its evaluation order (see bounce_common.cuh).
//
// What bounds it on the H100: arithmetic and divergence. A lane runs three
// bank sweeps (~30 flops per primitive each) and ~1-3k flops of shading
// (the Perlin marble alone is 7 octaves x 8 lattice hashes) against ~100
// bytes of lane state in and out, far above the card's bytes-per-flop
// line; lanes of one warp that take other materials, lights or die idle
// their slots.
// What the design does about it: one thread per lane with the bounce in
// registers; SoA planes for coalesced loads; the primitive bank staged once
// per block in shared memory (a broadcast read per primitive); the material
// (up to 512 x 35 floats), texture, light and delta rows read through the
// read-only cache with __ldg -- one indexed load per lane in place of the
// TPU's one-hot MXU gather, leaving shared memory to the bank so that
// occupancy stays that of K2; a lane branching on its own lobe kind and
// light shape, so it computes one material model and one shape where the
// TPU kernel masked every model the scene holds; the scene's static
// switches (two slots, texture kinds, env kind, first bounce, roulette) as
// warp-uniform launch arguments, not template parameters, so one build
// serves every scene; a dead lane exiting early with its pass-through
// outputs; and an exact traced-ray count (block reduction, one 64-bit
// atomicAdd per block) in place of the TPU's per-lane average.
#include "shade_common.cuh"

namespace pbrs {

constexpr float INV_PI_4 = (float)(1.0 / (3.141592653589793 * 0.25));
constexpr float INV_SQRT2 = (float)0.7071067811865475;  // 1/np.sqrt(2.0)

// Texture kinds and table widths of K3's banks.
constexpr int TEX_CHECKER = 1, TEX_PERLIN = 2;
constexpr int SLOT_COLS = 16, TEX_COLS = 8;

struct Params {
  Bank bank;  // shared-memory copy, set in the kernel
  const float* bank_g;
  const float* mats;
  int n_mats, mat_cols;
  const float* texs;
  int n_texs, tex_kinds;  // tex_kinds: bit mask
  const float* lights;
  int n_area;
  const float* delta;
  int n_delta;
  const float* env;  // [7]: color a, color b, world radius
  int env_kind;
  int two_slots;
  int rng;
  uint32_t seed, bounce;
  int first, rr_active;
};

// A slot's 16 columns of the material row (zeros for no row); K3's kinds
// read no FresnelBlend Rs and no Oren-Nayar B.
static __device__ __forceinline__ Lobe load_lobe(const float* row) {
  Lobe l;
  l.spc[0] = l.spc[1] = l.spc[2] = 0.0f;
  l.alpha2 = 0.0f;
  float c[SLOT_COLS];
  for (int j = 0; j < SLOT_COLS; ++j) c[j] = row ? __ldg(row + j) : 0.0f;
  l.alb[0] = c[0];
  l.alb[1] = c[1];
  l.alb[2] = c[2];
  l.kind = (int)c[3];
  l.alpha = c[4];
  l.distrib = (int)c[5];
  l.fr_kind = (int)c[6];
  l.eta0 = c[7];
  l.eta1 = c[8];
  for (int i = 0; i < 3; ++i) {
    l.et[i] = c[9 + i];
    l.k[i] = c[12 + i];
  }
  l.tex = (int)c[15];
  return l;
}

// ---------------------------- the two-slot mixture --------------------------

struct Mixture {
  Lobe l0, l1;
  bool two;
  int n_active;
  float n_active_f;
  float wolx, woly, wolz;

  // Sum of f over the slots, pdf = sum of pdfs / n_active.
  __device__ void eval(float wilx, float wily, float wilz, float* f,
                       float& pdf) const {
    eval_lobe(l0, wolx, woly, wolz, wilx, wily, wilz, f, pdf);
    if (two) {
      float f1[3], p1;
      eval_lobe(l1, wolx, woly, wolz, wilx, wily, wilz, f1, p1);
      for (int c = 0; c < 3; ++c) f[c] = f[c] + f1[c];
      pdf = (pdf + p1) / n_active_f;
    }
  }

  // bsdf.sample_bsdf: a uniform slot pick on u0, remapped; the chosen slot
  // samples with (u1, remapped u0) and the other slot is tallied.
  __device__ Sample sample(float u0, float u1_) const {
    if (!two) return sample_lobe(l0, wolx, woly, wolz, u1_, u0);
    int chosen = (int)(u0 * n_active_f);
    const int hi = (n_active - 1 > 0) ? n_active - 1 : 0;
    chosen = chosen < hi ? chosen : hi;
    float u_remap = fmodf(u0 * n_active_f, 1.0f);
    if (u_remap != 0.0f && u_remap < 0.0f) u_remap = u_remap + 1.0f;
    const bool pick0 = chosen == 0;
    Sample s = sample_lobe(pick0 ? l0 : l1, wolx, woly, wolz, u1_, u_remap);
    float fo[3], po;
    eval_lobe(pick0 ? l1 : l0, wolx, woly, wolz, s.wi[0], s.wi[1], s.wi[2],
              fo, po);
    for (int c = 0; c < 3; ++c) s.f[c] = s.f[c] + fo[c];
    s.pdf = (s.pdf + po) / n_active_f;
    if (n_active == 0) {
      s.f[0] = s.f[1] = s.f[2] = 0.0f;
      s.pdf = 0.0f;
    }
    return s;
  }
};

// ------------------------------ environment --------------------------------

static __device__ void env_eval(const Params& P, float wx, float wy,
                                float wz, float* e) {
  const float* E = P.env;
  if (P.env_kind == ENV_NONE) {
    e[0] = e[1] = e[2] = 0.0f;
    return;
  }
  if (P.env_kind == ENV_CONST) {
    for (int i = 0; i < 3; ++i) e[i] = __ldg(E + i);
    return;
  }
  const float dlen = rsqrtf(max0(wx * wx + wy * wy + wz * wz, (float)1e-30));
  const float yy = wy * dlen;
  if (P.env_kind == ENV_GRADIENT) {
    const float t = (yy + 1.0f) * 0.5f;
    for (int i = 0; i < 3; ++i)
      e[i] = __ldg(E + i) * t + __ldg(E + i + 3) * (1.0f - t);
    return;
  }
  // ENV_DUSK (acos in place of the TPU kernel's polynomial _acos).
  const float tilt = acosf(clamp11(yy));
  const float t = tilt * INV_PI_4;
  const bool above = tilt > PI_4;
  const bool ground = tilt <= 0.0f;
  for (int i = 0; i < 3; ++i)
    e[i] = ground ? (float)0.2
                  : (above ? __ldg(E + i)
                           : __ldg(E + i) * t + __ldg(E + i + 3) * (1.0f - t));
}

// ------------------------------- textures ----------------------------------

static __device__ __forceinline__ uint32_t hash3(int ix, int iy, int iz) {
  uint32_t h = (uint32_t)ix * 0x8DA6B343u;
  h = h + (uint32_t)iy * 0xD8163841u;
  h = h + (uint32_t)iz * 0xCB1AB31Fu;
  h ^= h >> 13;
  h *= 0x85EBCA6Bu;
  return h ^ (h >> 16);
}

static __device__ __forceinline__ float grad_dot(uint32_t h, float x, float y,
                                                 float z) {
  const uint32_t hi = h & 15u;
  const float u = hi < 8u ? x : y;
  const float v = hi < 4u ? y : ((hi == 12u || hi == 14u) ? x : z);
  const float su = (hi & 1u) == 0u ? u : -u;
  const float sv = (hi & 2u) == 0u ? v : -v;
  return su + sv;
}

static __device__ float perlin_noise(float sx, float sy, float sz) {
  const float flx = floorf(sx), fly = floorf(sy), flz = floorf(sz);
  const int ix = (int)flx, iy = (int)fly, iz = (int)flz;
  const float fx = sx - flx, fy = sy - fly, fz = sz - flz;
  const float smx = fx * fx * (3.0f - 2.0f * fx);
  const float smy = fy * fy * (3.0f - 2.0f * fy);
  const float smz = fz * fz * (3.0f - 2.0f * fz);
  float acc = 0.0f;
  for (int di = 0; di < 2; ++di) {
    const float wu = smx * (float)di + (1.0f - smx) * (float)(1 - di);
    for (int dj = 0; dj < 2; ++dj) {
      const float wj = smy * (float)dj + (1.0f - smy) * (float)(1 - dj);
      for (int dk = 0; dk < 2; ++dk) {
        const float wk = smz * (float)dk + (1.0f - smz) * (float)(1 - dk);
        const uint32_t h = hash3(ix + di, iy + dj, iz + dk);
        acc = acc + wu * wj * wk *
                        grad_dot(h, fx - (float)di, fy - (float)dj,
                                 fz - (float)dk);
      }
    }
  }
  return acc * INV_SQRT2;
}

// Perlin marble: sin(freq z + 10 turbulence(p)) / 2 + 1/2, 7 octaves.
static __device__ float marble(float px, float py, float pz, float freq) {
  float acc = 0.0f;
  float scale = 1.0f, weight = 1.0f;  // 2^i and 0.5^i, exact
  for (int i = 0; i < 7; ++i) {
    const float sc = freq * scale;
    acc = acc + weight * perlin_noise(px * sc, py * sc, pz * sc);
    scale = scale * 2.0f;
    weight = weight * 0.5f;
  }
  return sinf(freq * pz + 10.0f * fabsf(acc)) * 0.5f + 0.5f;
}

// textures.eval_texture on the hit position, over the slot's albedo.
static __device__ void overlay_texture(const Params& P, Lobe& l, float px,
                                       float py, float pz) {
  const int tid = l.tex;
  float gt[TEX_COLS];
  const bool ok = tid >= 0 && tid < P.n_texs;
  for (int j = 0; j < TEX_COLS; ++j)
    gt[j] = ok ? __ldg(P.texs + tid * TEX_COLS + j) : 0.0f;
  const int tkind = (int)gt[0];
  float c[3] = {gt[1], gt[2], gt[3]};
  if (P.tex_kinds & (1 << TEX_CHECKER)) {
    const float sines =
        sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
    if (tkind == TEX_CHECKER && sines < 0.0f)
      for (int i = 0; i < 3; ++i) c[i] = gt[4 + i];
  }
  if ((P.tex_kinds & (1 << TEX_PERLIN)) && tkind == TEX_PERLIN) {
    const float m = marble(px, py, pz, gt[7]);
    c[0] = c[1] = c[2] = m;
  }
  if (tid >= 0)
    for (int i = 0; i < 3; ++i) l.alb[i] = c[i];
}

// Closest hit and hit detail (sphere/quad/triangle/disk) -> position p,
// normal n (facing the ray), tangent t; returns the material id (-1 on a
// miss).
static __device__ int hit_detail(const Bank& bk, const float* o,
                                 const float* d, bool& hit, float* p,
                                 float* n, float* t) {
  float tb;
  int pid;
  sweep<false>(bk.rows, bk.n_sph, bk.n_quad, bk.n_tri, bk.n_disk,
               Ray{o[0], o[1], o[2], d[0], d[1], d[2]}, inf_f(), tb, pid);
  hit = tb < BIG;
  const float t_safe = hit ? tb : 1.0f;
  for (int i = 0; i < 3; ++i) {
    p[i] = o[i] + t_safe * d[i];
    n[i] = i == 2 ? 1.0f : 0.0f;
    t[i] = i == 0 ? 1.0f : 0.0f;
  }
  if (!hit) return -1;
  const float* g = bk.rows + pid * BANK_COLS;
  const float rdx = d[0], rdy = d[1], rdz = d[2];
  const int q0 = bk.n_sph, t0 = q0 + bk.n_quad, d0 = t0 + bk.n_tri;
  if (pid < q0) {
    const float cx = g[0], cy = g[1], cz = g[2], r = g[3];
    const float gx = p[0] - cx, gy = p[1] - cy, gz = p[2] - cz;
    const float inv = rsqrtf(max0(gx * gx + gy * gy + gz * gz, (float)1e-30));
    const float ux = gx * inv, uy = gy * inv, uz = gz * inv;
    const float h2 = ux * ux + uy * uy;
    const float hinv = rsqrtf(max0(h2, (float)1e-30));
    t[0] = (h2 < (float)1e-12) ? 1.0f : -uy * hinv;
    t[1] = (h2 < (float)1e-12) ? 0.0f : ux * hinv;
    t[2] = 0.0f;
    const float s = (ux * rdx + uy * rdy + uz * rdz > 0.0f) ? -1.0f : 1.0f;
    n[0] = s * ux;
    n[1] = s * uy;
    n[2] = s * uz;
    const float r_out = r * (float)1.00001;
    p[0] = cx + ux * r_out;
    p[1] = cy + uy * r_out;
    p[2] = cz + uz * r_out;
  } else if (pid < t0) {
    const float qo[3] = {g[0], g[1], g[2]};
    const float eu[3] = {g[3], g[4], g[5]};
    const float ev[3] = {g[6], g[7], g[8]};
    const float qnx = g[9], qny = g[10], qnz = g[11];
    const float inv_n2 = 1.0f / max0(g[12], (float)1e-30);
    const float hx = p[0] - qo[0], hy = p[1] - qo[1], hz = p[2] - qo[2];
    float cx_ = hy * ev[2] - hz * ev[1];
    float cy_ = hz * ev[0] - hx * ev[2];
    float cz_ = hx * ev[1] - hy * ev[0];
    const float uu = (cx_ * qnx + cy_ * qny + cz_ * qnz) * inv_n2;
    cx_ = eu[1] * hz - eu[2] * hy;
    cy_ = eu[2] * hx - eu[0] * hz;
    cz_ = eu[0] * hy - eu[1] * hx;
    const float vv = (cx_ * qnx + cy_ * qny + cz_ * qnz) * inv_n2;
    const float inv =
        rsqrtf(max0(qnx * qnx + qny * qny + qnz * qnz, (float)1e-30));
    const float ux = qnx * inv, uy = qny * inv, uz = qnz * inv;
    const float s = (ux * rdx + uy * rdy + uz * rdz > 0.0f) ? -1.0f : 1.0f;
    n[0] = s * ux;
    n[1] = s * uy;
    n[2] = s * uz;
    for (int i = 0; i < 3; ++i) {
      t[i] = eu[i];
      p[i] = qo[i] + uu * eu[i] + vv * ev[i];
    }
  } else if (pid < d0) {
    const float* p0 = g;
    const float* p1 = g + 3;
    const float* p2 = g + 6;
    const float gnx = g[9], gny = g[10], gnz = g[11];
    const float px = p[0], py = p[1], pz = p[2];
    auto edge = [&](const float* a, const float* b) {
      const float ex = px - a[0], ey = py - a[1], ez = pz - a[2];
      const float fx = px - b[0], fy = py - b[1], fz = pz - b[2];
      return (ey * fz - ez * fy) * gnx + (ez * fx - ex * fz) * gny +
             (ex * fy - ey * fx) * gnz;
    };
    float b2 = edge(p0, p1);
    float b0 = edge(p1, p2);
    float b1 = edge(p2, p0);
    float total = b0 + b1 + b2;
    total = (total == 0.0f) ? 1.0f : total;
    b0 = b0 / total;
    b1 = b1 / total;
    b2 = b2 / total;
    const float s = (gnx * rdx + gny * rdy + gnz * rdz > 0.0f) ? -1.0f : 1.0f;
    n[0] = s * gnx;
    n[1] = s * gny;
    n[2] = s * gnz;
    for (int i = 0; i < 3; ++i) {
      t[i] = p1[i] - p0[i];
      p[i] = b0 * p0[i] + b1 * p1[i] + b2 * p2[i];
    }
  } else {
    const float dc[3] = {g[0], g[1], g[2]};
    const float dn[3] = {g[3], g[4], g[5]};
    float cp[3] = {p[0] - dc[0], p[1] - dc[1], p[2] - dc[2]};
    const float proj = cp[0] * dn[0] + cp[1] * dn[1] + cp[2] * dn[2];
    for (int i = 0; i < 3; ++i) cp[i] = cp[i] - proj * dn[i];
    const float s =
        (dn[0] * rdx + dn[1] * rdy + dn[2] * rdz > 0.0f) ? -1.0f : 1.0f;
    const float fn[3] = {s * dn[0], s * dn[1], s * dn[2]};
    const float tgx = fn[1] * cp[2] - fn[2] * cp[1];
    const float tgy = fn[2] * cp[0] - fn[0] * cp[2];
    const float tgz = fn[0] * cp[1] - fn[1] * cp[0];
    const float tinv =
        rsqrtf(max0(tgx * tgx + tgy * tgy + tgz * tgz, (float)1e-30));
    t[0] = tgx * tinv;
    t[1] = tgy * tinv;
    t[2] = tgz * tinv;
    for (int i = 0; i < 3; ++i) {
      n[i] = fn[i];
      p[i] = dc[i] + cp[i];
    }
  }
  return (int)g[13];
}

// The bounce of one live lane. in[9]: origin, dir, beta; out[12]:
// radiance, next origin, next dir, next beta. Returns the lane's traced-ray
// count.
static __device__ unsigned bounce_lane(const Params& P, const float* in,
                                       bool prev_spec, uint32_t pixu,
                                       uint32_t smpu, float* out,
                                       int& alive_out, int& spec_out) {
  const float* o = in;
  const float* d = in + 3;
  const float* beta = in + 6;
  const Draw u1{P.rng, P.seed, pixu, smpu, P.bounce};
  unsigned n_rays = 1;

  bool hit;
  float p[3], n[3], tg[3];
  const int mat_id = hit_detail(P.bank, o, d, hit, p, n, tg);
  const float nx = n[0], ny = n[1], nz = n[2];

  // ---- shading frame: vecmath.orthonormal_frame(normal, dpdu) ----
  Frame fr;
  float wol[3];
  make_frame(nx, ny, nz, tg, d, fr, wol);

  // ---- material row (one read-only load per column) + textures ----
  const bool m_ok = mat_id >= 0 && mat_id < P.n_mats;
  const float* mrow = m_ok ? P.mats + mat_id * P.mat_cols : nullptr;
  float emi[3];
  for (int i = 0; i < 3; ++i) emi[i] = m_ok ? __ldg(mrow + i) : 0.0f;
  Mixture mix;
  mix.two = P.two_slots != 0;
  mix.l0 = load_lobe(m_ok ? mrow + 3 : nullptr);
  if (mix.two) mix.l1 = load_lobe(m_ok ? mrow + 3 + SLOT_COLS : nullptr);
  if (P.n_texs > 0) {
    overlay_texture(P, mix.l0, p[0], p[1], p[2]);
    if (mix.two) overlay_texture(P, mix.l1, p[0], p[1], p[2]);
  }
  mix.n_active = mix.two ? (int)(mix.l0.kind != K_NONE) +
                               (int)(mix.l1.kind != K_NONE)
                         : 1;
  mix.n_active_f = (float)(mix.n_active > 1 ? mix.n_active : 1);
  mix.wolx = wol[0];
  mix.woly = wol[1];
  mix.wolz = wol[2];

  // ---- emission / env on camera and post-delta segments ----
  float rad[3] = {0.0f, 0.0f, 0.0f};
  if (P.first || prev_spec) {
    float env[3];
    env_eval(P, d[0], d[1], d[2], env);
    for (int i = 0; i < 3; ++i) rad[i] = beta[i] * (hit ? emi[i] : env[i]);
  }
  bool alive = hit;

  // ---- NEE: one light among delta + area + env ----
  const bool has_env = P.env_kind != ENV_NONE;
  const int n_lights = P.n_delta + P.n_area + (has_env ? 1 : 0);
  const float fn = (float)n_lights;
  if (n_lights > 0 && alive) {
    const float u_sel = u1(DIM_LIGHT_SELECT, 0);
    const float u_l0 = u1(DIM_LIGHT_UV, 0);
    const float u_l1 = u1(DIM_LIGHT_UV, 1);
    const float u_s0 = u1(DIM_SCATTER_UV, 0);
    const float u_s1 = u1(DIM_SCATTER_UV, 1);
    int chosen = (int)(u_sel * fn);
    chosen = chosen < n_lights - 1 ? chosen : n_lights - 1;
    const bool arm_delta = chosen < P.n_delta;
    const bool arm_area = !arm_delta && chosen < P.n_delta + P.n_area;
    const bool arm_env = chosen >= P.n_delta + P.n_area;
    AreaLight L;
    if (arm_area) area_init(P.lights, chosen - P.n_delta, p, u_l0, u_l1, L);

    // -------- light-sampled arm (delta + area) --------
    if (arm_delta || arm_area) {
      float li[3], wl[3], tgt[3], pdf_l = 1.0f;
      if (arm_delta) {
        const float* r = P.delta + chosen * DELTA_COLS;
        const bool is_point = __ldg(r) < 0.5f;  // POINT = 0
        const float dp[3] = {__ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
        const float tl[3] = {dp[0] - p[0], dp[1] - p[1], dp[2] - p[2]};
        const float d2p =
            max0(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], (float)1e-30);
        const float ipd = rsqrtf(d2p);
        const float w_rad = __ldg(P.env + 6);
        const float dinv = rsqrtf(
            max0(dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2], (float)1e-30));
        for (int i = 0; i < 3; ++i) {
          const float c = __ldg(r + 4 + i);
          li[i] = is_point ? c / d2p : c;
          wl[i] = is_point ? tl[i] * ipd : -dp[i] * dinv;
          tgt[i] = is_point ? dp[i] : p[i] - 2.0f * w_rad * dp[i];
        }
      } else {
        const float tl[3] = {L.pt[0] - p[0], L.pt[1] - p[1], L.pt[2] - p[2]};
        const float d2a =
            max0(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], (float)1e-20);
        const float ia = rsqrtf(d2a);
        for (int i = 0; i < 3; ++i) wl[i] = tl[i] * ia;
        // One-sided emission on the sampled arm.
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
      }
      const bool li_any = (li[0] > 0.0f) || (li[1] > 0.0f) || (li[2] > 0.0f);
      if (pdf_l > 0.0f && li_any) {
        const float sd[3] = {tgt[0] - p[0], tgt[1] - p[1], tgt[2] - p[2]};
        const float side =
            (sd[0] * nx + sd[1] * ny + sd[2] * nz >= 0.0f) ? 1.0f : -1.0f;
        const bool occ1 = occluded(
            P.bank,
            Ray{p[0] + side * nx * SPAWN_EPS, p[1] + side * ny * SPAWN_EPS,
                p[2] + side * nz * SPAWN_EPS, sd[0], sd[1], sd[2]},
            SHADOW_T);
        if (!occ1) {
          float wil[3], fe[3], pdf_sc;
          fr.to_local(wl[0], wl[1], wl[2], wil);
          mix.eval(wil[0], wil[1], wil[2], fe, pdf_sc);
          // eval_bsdf zeroes f when wo is tangent.
          if (wol[2] == 0.0f) fe[0] = fe[1] = fe[2] = 0.0f;
          const float cos_s = fabsf(nx * wl[0] + ny * wl[1] + nz * wl[2]);
          const float weight =
              arm_delta ? 1.0f
                        : pdf_l * pdf_l /
                              max0(pdf_l * pdf_l + pdf_sc * pdf_sc,
                                   (float)1e-30);
          const float c = cos_s * weight * weak_recip(pdf_l);
          for (int i = 0; i < 3; ++i)
            rad[i] = rad[i] + beta[i] * fe[i] * li[i] * c * fn;
        }
      }
    }

    // -------- BSDF-sampled arm (area MIS + env) --------
    if (P.n_area > 0 || has_env) {
      const Sample s = mix.sample(u_s0, u_s1);
      float w2[3];
      fr.to_world(s.wi, w2);
      const float cos2a = fabsf(w2[0] * nx + w2[1] * ny + w2[2] * nz);
      const float f2[3] = {s.f[0] * cos2a, s.f[1] * cos2a, s.f[2] * cos2a};
      bool hit_l = false;
      float t_hit = 0.0f, pdf_l2 = 0.0f;
      if (arm_area) area_query(L, p, w2[0], w2[1], w2[2], hit_l, t_hit, pdf_l2);
      const bool f_any = (f2[0] > 0.0f) || (f2[1] > 0.0f) || (f2[2] > 0.0f);
      bool valid_b = arm_area && hit_l && !s.delta && (s.pdf > 0.0f) &&
                     (pdf_l2 > 0.0f) && f_any;
      bool valid_e = has_env && arm_env && !s.delta && (s.pdf > 0.0f);
      if (valid_b || valid_e) {
        // Shared shadow ray: to the light point on the area arm (t_max
        // 1 - 1e-3), unbounded along wi on the env arm.
        float dir2[3];
        for (int i = 0; i < 3; ++i) dir2[i] = arm_env ? w2[i] : t_hit * w2[i];
        const float tmax2 = arm_env ? inf_f() : SHADOW_T;
        const float side2 =
            (dir2[0] * nx + dir2[1] * ny + dir2[2] * nz >= 0.0f) ? 1.0f
                                                                 : -1.0f;
        const bool occ2 = occluded(
            P.bank,
            Ray{p[0] + side2 * nx * SPAWN_EPS, p[1] + side2 * ny * SPAWN_EPS,
                p[2] + side2 * nz * SPAWN_EPS, dir2[0], dir2[1], dir2[2]},
            tmax2);
        valid_b = valid_b && !occ2;
        valid_e = valid_e && !occ2;
      }
      if (valid_b) {
        const float w_b =
            s.pdf * s.pdf / max0(s.pdf * s.pdf + pdf_l2 * pdf_l2, (float)1e-30);
        const float cb_ = w_b * weak_recip(s.pdf);
        for (int i = 0; i < 3; ++i)
          rad[i] = rad[i] + beta[i] * f2[i] * L.le[i] * cb_ * fn;
      }
      if (valid_e) {
        float er2[3];
        env_eval(P, w2[0], w2[1], w2[2], er2);
        const float ce_ = weak_recip(s.pdf);
        for (int i = 0; i < 3; ++i)
          rad[i] = rad[i] + beta[i] * f2[i] * er2[i] * ce_ * fn;
      }
    }
    n_rays += 2;
  }

  // ---- BSDF sample for the next direction ----
  const float u_b0 = u1(DIM_BSDF_UV, 0);
  const float u_b1 = u1(DIM_BSDF_UV, 1);
  const Sample s = mix.sample(u_b0, u_b1);
  float wn[3];
  fr.to_world(s.wi, wn);
  const float cosn = fabsf(wn[0] * nx + wn[1] * ny + wn[2] * nz);
  const bool f_any = (s.f[0] > 0.0f) || (s.f[1] > 0.0f) || (s.f[2] > 0.0f);
  alive = alive && (s.pdf > 0.0f) && f_any;
  const float mult = cosn * weak_recip(s.pdf);
  float nb[3];
  for (int i = 0; i < 3; ++i) nb[i] = alive ? beta[i] * s.f[i] * mult : beta[i];
  if (P.rr_active) {
    const float lum = (float)0.21267127 * nb[0] + (float)0.71515972 * nb[1] +
                      (float)0.07216883 * nb[2];
    const float q = max0(1.0f - lum, (float)0.05);
    alive = alive &&
            !(u1(DIM_RUSSIAN_ROULETTE, 0) < q);
    const float scale = alive ? 1.0f / max0(1.0f - q, (float)1e-6) : 1.0f;
    for (int i = 0; i < 3; ++i) nb[i] = nb[i] * scale;
  }
  const float side = (wn[0] * nx + wn[1] * ny + wn[2] * nz >= 0.0f) ? 1.0f
                                                                     : -1.0f;
  for (int i = 0; i < 3; ++i) {
    out[i] = rad[i];
    out[3 + i] = p[i] + side * n[i] * SPAWN_EPS;
    out[6 + i] = wn[i];
    out[9 + i] = nb[i];
  }
  alive_out = alive ? 1 : 0;
  spec_out = (alive && s.delta) ? 1 : 0;
  return n_rays;
}

__global__ void fused_single_lobe_kernel(
    Params P, const float* __restrict__ fin, const int* __restrict__ alive_in,
    const int* __restrict__ spec_in, const int* __restrict__ pix,
    const int* __restrict__ samp, int n, float* __restrict__ fout,
    int* __restrict__ alive_out, int* __restrict__ spec_out,
    unsigned long long* __restrict__ count) {
  extern __shared__ float s_bank[];
  stage_bank(s_bank, P.bank_g,
             P.bank.n_sph + P.bank.n_quad + P.bank.n_tri + P.bank.n_disk);
  P.bank.rows = s_bank;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)n;
  unsigned rays = 0;
  if (lane < n) {
    float in[9], out[12];
    for (int j = 0; j < 9; ++j) in[j] = fin[j * stride + lane];
    int alive = 0, spec = 0;
    if (alive_in[lane] > 0) {
      rays = bounce_lane(P, in, spec_in[lane] > 0, (uint32_t)pix[lane],
                         (uint32_t)samp[lane], out, alive, spec);
    } else {
      // Dead lane: zero radiance, origin/dir/beta passed through.
      out[0] = out[1] = out[2] = 0.0f;
      for (int j = 0; j < 9; ++j) out[3 + j] = in[j];
    }
    for (int j = 0; j < 12; ++j) fout[j * stride + lane] = out[j];
    alive_out[lane] = alive;
    spec_out[lane] = spec;
  }
  count_rays(rays, count);
}

}  // namespace pbrs

extern "C" {

// fin [9, n] float32 (origin, dir, beta); alive_in, spec_in, pix, samp [n]
// int32; fout [12, n] float32 (radiance, next origin, next dir, next beta);
// alive_out, spec_out [n] int32; count: one uint64 the bounce's traced rays
// are added to. tex_kinds_mask is the bit set of the texture kinds the
// textured slots use; rng 0 draws PCG, 1 Sobol'. Returns cudaGetLastError() after the launch.
int pbrs_fused_single_lobe(
    const float* bank, int n_sph, int n_quad, int n_tri, int n_disk,
    const float* mats, int n_mats, int mat_cols, const float* texs,
    int n_texs, int tex_kinds_mask, const float* lights, int n_area,
    const float* delta, int n_delta, const float* env, int env_kind,
    int two_slots, int rng, int seed, int bounce,
    int first, int rr_active, const float* fin, const int* alive_in,
    const int* spec_in, const int* pix, const int* samp, int n, float* fout,
    int* alive_out, int* spec_out, void* count, void* stream) {
  pbrs::Params P;
  P.bank = pbrs::Bank{nullptr, n_sph, n_quad, n_tri, n_disk};
  P.bank_g = bank;
  P.mats = mats;
  P.n_mats = n_mats;
  P.mat_cols = mat_cols;
  P.texs = texs;
  P.n_texs = n_texs;
  P.tex_kinds = tex_kinds_mask;
  P.lights = lights;
  P.n_area = n_area;
  P.delta = delta;
  P.n_delta = n_delta;
  P.env = env;
  P.env_kind = env_kind;
  P.two_slots = two_slots;
  P.rng = rng;
  P.seed = (uint32_t)seed;
  P.bounce = (uint32_t)bounce;
  P.first = first;
  P.rr_active = rr_active;
  const int n_rows = n_sph + n_quad + n_tri + n_disk;
  const int smem = n_rows * pbrs::BANK_COLS * (int)sizeof(float);
  if (smem > 48 * 1024 - 128)
    cudaFuncSetAttribute(pbrs::fused_single_lobe_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int block = 256;
  const int grid = (n + block - 1) / block;
  pbrs::fused_single_lobe_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      P, fin, alive_in, spec_in, pix, samp, n, fout, alive_out, spec_out,
      (unsigned long long*)count);
  return (int)cudaGetLastError();
}

}  // extern "C"
