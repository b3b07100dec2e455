// Device code shared by the fused single-lobe bounce K3
// (fused_single_lobe.cu) and the shade kernel K4 (fused_wave.cu), as the
// JAX package's fused_wave.py imports its helpers from fused_single_lobe.py
// (_weak_recip, _fr_dielectric, _fresnel_rgb, _d_ndf, _lambda_iso,
// _sample_lobe): Fresnel terms, the isotropic NDF and masking, per-slot lobe
// eval/pdf (Lambert, Oren-Nayar, microfacet, FresnelBlend) and sampling
// (plus the specular kinds), the chosen area light's sampled point and its
// pdf / intersection query, and the shading frame. Each function keeps the
// evaluation order of its plain version (accel/fused_single_lobe.py:
// _make_eval, _sample_lobe, _AreaLight); the library is built with
// -fmad=false.
#pragma once

#include "bounce_common.cuh"

namespace pbrs {

constexpr float PI_F = (float)3.141592653589793;
constexpr float TWO_PI_F = (float)(2.0 * 3.141592653589793);
constexpr float FOUR_PI_F = (float)(4.0 * 3.141592653589793);
// FresnelBlend's diffuse constant 28/(23 pi), rounded from double.
constexpr float FB_DIFFUSE = (float)(28.0 / 23.0 * (1.0 / 3.141592653589793));

// Lobe kinds (bxdf/lobes.py), Fresnel kinds, distributions, light shapes.
constexpr int K_NONE = 0, K_LAMBERT = 1, K_OREN_NAYAR = 2, K_MICROFACET = 3,
              K_MIRROR = 4, K_DIELECTRIC = 5, K_TRANSMIT = 6,
              K_FRESNEL_BLEND = 7;
constexpr int FR_DIELECTRIC = 1, FR_CONDUCTOR = 2;
constexpr int BECKMANN = 0;
constexpr int S_QUAD = 0, S_SPHERE = 1, S_DISK = 2, S_TRIANGLE = 3;
constexpr int LIGHT_COLS = 14, DELTA_COLS = 8;

static __device__ __forceinline__ float clamp11(float x) {
  return (x != x) ? x : fminf(fmaxf(x, -1.0f), 1.0f);
}

static __device__ __forceinline__ float weak_recip(float x) {
  return (x != 0.0f) ? 1.0f / x : 0.0f;
}

// ---------------------------- Fresnel, NDF --------------------------------

static __device__ float fr_dielectric(float cos_i, float e0, float e1) {
  cos_i = clamp11(cos_i);
  const bool entering = cos_i > 0.0f;
  const float ei = entering ? e0 : e1;
  const float et = entering ? e1 : e0;
  const float ci = fabsf(cos_i);
  const float si = sqrtf(max0(1.0f - ci * ci, 0.0f));
  const float st = ei / et * si;
  const bool tir = st >= 1.0f;
  const float ct = sqrtf(max0(1.0f - st * st, 0.0f));
  const float r_perp =
      (ei * ci - et * ct) / max0(ei * ci + et * ct, (float)1e-30);
  const float r_par =
      (et * ci - ei * ct) / max0(et * ci + ei * ct, (float)1e-30);
  return tir ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
}

static __device__ float fr_conductor_ch(float cos_i, float eta, float k) {
  float c2 = clamp11(cos_i);
  c2 = c2 * c2;
  const float s2 = 1.0f - c2;
  const float e2 = eta * eta;
  const float k2 = k * k;
  const float t0 = e2 - k2 - s2;
  const float a2b2 = sqrtf(max0(t0 * t0 + 4.0f * e2 * k2, 0.0f));
  const float t1 = a2b2 + c2;
  const float a = sqrtf(max0(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * a * sqrtf(max0(c2, 0.0f));
  const float rs = (t1 - t2) / max0(t1 + t2, (float)1e-30);
  const float t3 = c2 * a2b2 + s2 * s2;
  const float t4 = t2 * s2;
  const float rp = rs * (t3 - t4) / max0(t3 + t4, (float)1e-30);
  return max0(0.5f * (rs + rp), 0.0f);
}

// One lobe slot: albedo, FresnelBlend Rs (spc), kind, alpha (Oren-Nayar
// A), alpha2 (Oren-Nayar B), distribution, Fresnel kind and constants,
// texture id.
struct Lobe {
  float alb[3], spc[3];
  int kind;
  float alpha, alpha2;
  int distrib, fr_kind;
  float eta0, eta1, et[3], k[3];
  int tex;
};

static __device__ void fresnel_rgb(const Lobe& l, float cos_i, float* f) {
  const float fr =
      (l.fr_kind == FR_DIELECTRIC) ? fr_dielectric(cos_i, l.eta0, l.eta1)
                                   : 1.0f;
  for (int c = 0; c < 3; ++c)
    f[c] = (l.fr_kind == FR_CONDUCTOR) ? fr_conductor_ch(cos_i, l.et[c], l.k[c])
                                       : fr;
}

static __device__ float d_ndf(int distrib, float alpha, float whz) {
  const float c2 = whz * whz;
  const float t2 = max0(1.0f - c2, 0.0f) / max0(c2, (float)1e-30);
  const float c4 = c2 * c2;
  const float a2 = alpha * alpha;
  const float denom = max0(PI_F * a2 * c4, (float)1e-30);
  const float et2 = t2 / a2;
  const float d_beck = expf(-et2) / denom;
  const float e1 = 1.0f + et2;
  const float d_tr = 1.0f / max0(e1 * e1 * denom, (float)1e-30);
  const float d = (distrib == BECKMANN) ? d_beck : d_tr;
  return (c4 < (float)1e-32) ? 0.0f : d;
}

static __device__ float lambda_iso(int distrib, float alpha, float wz) {
  const float c2 = wz * wz;
  const float t2 = max0(1.0f - c2, 0.0f) / max0(c2, (float)1e-30);
  const float abs_tan = sqrtf(max0(t2, 0.0f));
  const float a = 1.0f / max0(alpha * abs_tan, (float)1e-30);
  const float lam_b =
      (a >= (float)1.6)
          ? 0.0f
          : (1.0f - (float)1.259 * a + (float)0.396 * a * a) /
                max0((float)3.535 * a + (float)2.181 * a * a, (float)1e-30);
  const float lam_t = 0.5f * (-1.0f + sqrtf(1.0f + alpha * alpha * t2));
  return (distrib == BECKMANN) ? lam_b : lam_t;
}

static __device__ __forceinline__ float pow5(float x) {
  return (x * x) * (x * x) * x;
}

// lobes.eval_lobe + pdf_lobe of one slot: Lambert, Oren-Nayar, isotropic
// microfacet and FresnelBlend; the specular kinds and the empty slot give 0.
static __device__ void eval_lobe(const Lobe& l, float wolx, float woly,
                                 float wolz, float wilx, float wily,
                                 float wilz, float* f, float& pdf) {
  f[0] = f[1] = f[2] = 0.0f;
  pdf = 0.0f;
  const bool same = wolz * wilz >= 0.0f;
  const float cos_pdf = fabsf(wilz) * INV_PI;
  if (l.kind == K_LAMBERT) {
    if (same) {
      for (int c = 0; c < 3; ++c) f[c] = l.alb[c] * INV_PI;
      pdf = cos_pdf;
    }
  } else if (l.kind == K_OREN_NAYAR) {
    const float sin_i = sqrtf(max0(1.0f - wilz * wilz, 0.0f));
    const float sin_o = sqrtf(max0(1.0f - wolz * wolz, 0.0f));
    const float hyp_i = max0(sqrtf(wilx * wilx + wily * wily), (float)1e-20);
    const float hyp_o = max0(sqrtf(wolx * wolx + woly * woly), (float)1e-20);
    const float cos_dphi = (wilx * wolx + wily * woly) / (hyp_i * hyp_o);
    const float d_cos = max0(cos_dphi, 0.0f);
    const float aci = fabsf(wilz), aco = fabsf(wolz);
    const bool steeper = aci > aco;
    const float sin_a = steeper ? sin_o : sin_i;
    const float tan_b = steeper ? sin_i / max0(aci, (float)1e-20)
                                : sin_o / max0(aco, (float)1e-20);
    const float factor = l.alpha + l.alpha2 * d_cos * sin_a * tan_b;
    if (same) {
      for (int c = 0; c < 3; ++c) f[c] = l.alb[c] * INV_PI * factor;
      pdf = cos_pdf;
    }
  } else if (l.kind == K_MICROFACET || l.kind == K_FRESNEL_BLEND) {
    const float mx = wolx + wilx, my = woly + wily, mz = wolz + wilz;
    const float m2 = mx * mx + my * my + mz * mz;
    const bool okm = m2 > (float)1e-16;
    const float minv = rsqrtf(max0(m2, (float)1e-30));
    const float whx = mx * minv, why = my * minv, whz = mz * minv;
    const float dval = d_ndf(l.distrib, l.alpha, whz);
    // pdf: D(wh) |cos theta_h| / (4 wo.wh) with the raw wh.
    const float dot_oh = wolx * whx + woly * why + wolz * whz;
    float p_mf = dval * fabsf(whz) * weak_recip(4.0f * dot_oh);
    p_mf = (same && okm) ? p_mf : 0.0f;
    if (l.kind == K_MICROFACET) {
      const float g = 1.0f / (1.0f + lambda_iso(l.distrib, l.alpha, wolz) +
                              lambda_iso(l.distrib, l.alpha, wilz));
      const float zsgn = (whz < 0.0f) ? -1.0f : 1.0f;
      const float cos_ih = (wilx * whx + wily * why + wilz * whz) * zsgn;
      float frc[3];
      fresnel_rgb(l, cos_ih, frc);
      const float inv_den = weak_recip(4.0f * fabsf(wolz) * fabsf(wilz));
      const float scale = (okm && same) ? dval * g * inv_den : 0.0f;
      for (int c = 0; c < 3; ++c) f[c] = l.alb[c] * scale * frc[c];
      pdf = max0(p_mf, 0.0f);
    } else {
      // Ashikhmin-Shirley FresnelBlend.
      const float aci = fabsf(wilz), aco = fabsf(wolz);
      const float dterm = FB_DIFFUSE * (1.0f - pow5(1.0f - 0.5f * aci)) *
                          (1.0f - pow5(1.0f - 0.5f * aco));
      const float iw = wilx * whx + wily * why + wilz * whz;
      const float sch = pow5(1.0f - iw);
      const float dfac =
          dval * weak_recip(4.0f * fabsf(iw) * maximum(aci, aco));
      if (okm && same)
        for (int c = 0; c < 3; ++c)
          f[c] = dterm * l.alb[c] * (1.0f - l.spc[c]) +
                 dfac * (l.spc[c] + sch * (1.0f - l.spc[c]));
      pdf = (same && okm) ? 0.5f * (cos_pdf + max0(p_mf, 0.0f)) : 0.0f;
    }
  }
}

struct Sample {
  float f[3], wi[3], pdf;
  bool delta;
};

// lobes.sample_lobe on the remapped pair (su0, su1) for every kind of K3
// and K4; f is without the cosine, pdf is the mass for delta kinds.
static __device__ Sample sample_lobe(const Lobe& l, float wolx, float woly,
                                     float wolz, float su0, float su1) {
  Sample s;
  float ddx, ddy;
  concentric(su0 * 2.0f - 1.0f, su1 * 2.0f - 1.0f, ddx, ddy);
  const float ddz = sqrtf(max0(1.0f - ddx * ddx - ddy * ddy, 0.0f));
  const float flip = (wolz < 0.0f) ? -1.0f : 1.0f;
  float wix = ddx * flip, wiy = ddy * flip, wiz = ddz * flip;
  bool tir = false, refl = false;
  float r_coeff = 0.0f;
  const int kind = l.kind;
  // Isotropic microfacet.sample_wh, face-forwarded to wo, reflected.
  auto reflect_wh = [&](float u, float v, float& rx, float& ry, float& rz) {
    const float phi = TWO_PI_F * v;
    const float a2 = max0(l.alpha * l.alpha, (float)1e-30);
    const float log_s = logf(max0(1.0f - u, (float)1e-30));
    const float tan2_b = -log_s * a2;
    const float tan2_t = u / max0(1.0f - u, (float)1e-30) * a2;
    const float tan2 = (l.distrib == BECKMANN) ? tan2_b : tan2_t;
    const float cos_t = 1.0f / sqrtf(1.0f + tan2);
    const float sin_t = cos_t * sqrtf(max0(tan2, 0.0f));
    float whx = sin_t * cosf(phi);
    float why = sin_t * sinf(phi);
    float whz = cos_t;
    const float sgn =
        (whx * wolx + why * woly + whz * wolz < 0.0f) ? -1.0f : 1.0f;
    whx = whx * sgn;
    why = why * sgn;
    whz = whz * sgn;
    const float doh = wolx * whx + woly * why + wolz * whz;
    rx = 2.0f * doh * whx - wolx;
    ry = 2.0f * doh * why - woly;
    rz = 2.0f * doh * whz - wolz;
  };
  bool fb_diffuse = false;
  if (kind == K_MICROFACET) {
    reflect_wh(su0, su1, wix, wiy, wiz);
  } else if (kind == K_FRESNEL_BLEND) {
    // Two strategies split on su0: cosine hemisphere below 0.5, a
    // reflected microfacet normal above.
    fb_diffuse = su0 < 0.5f;
    if (fb_diffuse) {
      const float u_lo = minimum(su0 * 2.0f, (float)(1.0 - 1e-7));
      float cdx, cdy;
      concentric(u_lo * 2.0f - 1.0f, su1 * 2.0f - 1.0f, cdx, cdy);
      const float cdz = sqrtf(max0(1.0f - cdx * cdx - cdy * cdy, 0.0f));
      wix = cdx * flip;
      wiy = cdy * flip;
      wiz = cdz * flip;
    } else {
      reflect_wh(fmodf(su0 * 2.0f, 1.0f), su1, wix, wiy, wiz);
    }
  } else if (kind == K_MIRROR) {
    wix = -wolx;
    wiy = -woly;
    wiz = wolz;
  } else if (kind == K_TRANSMIT || kind == K_DIELECTRIC) {
    // Refract across local z; total internal reflection -> mirror.
    const bool entering = wolz > 0.0f;
    const float ei = entering ? l.eta0 : l.eta1;
    const float et = entering ? l.eta1 : l.eta0;
    const float nzs = entering ? 1.0f : -1.0f;
    const float ratio = ei / et;
    const float cos_i = wolz * nzs;
    const float sin2_i = max0(1.0f - cos_i * cos_i, 0.0f);
    const float sin2_o = sin2_i * ratio * ratio;
    tir = sin2_o >= 1.0f;
    const float cos_o = sqrtf(max0(1.0f - sin2_o, 0.0f));
    const float tx_ = tir ? -wolx : -ratio * wolx;
    const float ty_ = tir ? -woly : -ratio * woly;
    const float tz_ =
        tir ? wolz : -ratio * wolz + (ratio * cos_i - cos_o) * nzs;
    wix = tx_;
    wiy = ty_;
    wiz = tz_;
    if (kind == K_DIELECTRIC) {
      // Reflect with probability R(wo), else refract; chosen on su1.
      r_coeff = fr_dielectric(wolz, l.eta0, l.eta1);
      refl = su1 < r_coeff;
      if (refl) {
        wix = -wolx;
        wiy = -woly;
        wiz = wolz;
      }
    }
  }
  eval_lobe(l, wolx, woly, wolz, wix, wiy, wiz, s.f, s.pdf);
  if ((kind == K_MICROFACET || (kind == K_FRESNEL_BLEND && !fb_diffuse)) &&
      wolz * wiz < 0.0f) {
    // Below-horizon microfacet / FresnelBlend-specular samples are
    // rejected.
    s.f[0] = s.f[1] = s.f[2] = 0.0f;
    s.pdf = 0.0f;
  }
  s.delta = kind == K_MIRROR || kind == K_DIELECTRIC || kind == K_TRANSMIT;
  if (s.delta) {
    const float inv_ci = weak_recip(fabsf(wiz));
    float pmf = 1.0f;
    if (kind == K_MIRROR) {
      float frc[3];
      fresnel_rgb(l, wiz, frc);
      for (int c = 0; c < 3; ++c) s.f[c] = frc[c] * l.alb[c] * inv_ci;
    } else {
      const float r_wi = fr_dielectric(wiz, l.eta0, l.eta1);
      for (int c = 0; c < 3; ++c) {
        const float ftr = tir ? 0.0f : (1.0f - r_wi) * l.alb[c] * inv_ci;
        s.f[c] = (kind == K_DIELECTRIC && refl)
                     ? r_coeff * l.alb[c] * inv_ci
                     : ftr;
      }
      if (kind == K_DIELECTRIC) pmf = refl ? r_coeff : 1.0f - r_coeff;
    }
    s.pdf = pmf;
  }
  if (kind == K_NONE) {
    s.f[0] = s.f[1] = s.f[2] = 0.0f;
    s.pdf = 0.0f;
  }
  s.wi[0] = wix;
  s.wi[1] = wiy;
  s.wi[2] = wiz;
  return s;
}

// ------------------------------- area lights --------------------------------

// The chosen area light of a lane: its shape constants and a sampled point
// with the (raw) light normal there.
struct AreaLight {
  int kind;
  float l0[3], l1[3], l2[3], lsc, le[3];
  float c12[3], ln2, area, tn[3], tn2;
  float pt[3], ln[3];
};

static __device__ void area_init(const float* lights, int idx, const float* p,
                                 float u_l0, float u_l1, AreaLight& L) {
  const float* r = lights + idx * LIGHT_COLS;
  L.kind = (int)__ldg(r);
  for (int i = 0; i < 3; ++i) {
    L.l0[i] = __ldg(r + 1 + i);
    L.l1[i] = __ldg(r + 4 + i);
    L.l2[i] = __ldg(r + 7 + i);
    L.le[i] = __ldg(r + 11 + i);
  }
  L.lsc = __ldg(r + 10);
  const float* l0 = L.l0;
  const float* l1 = L.l1;
  const float* l2 = L.l2;
  L.c12[0] = l1[1] * l2[2] - l1[2] * l2[1];
  L.c12[1] = l1[2] * l2[0] - l1[0] * l2[2];
  L.c12[2] = l1[0] * l2[1] - l1[1] * l2[0];
  L.ln2 = max0(L.c12[0] * L.c12[0] + L.c12[1] * L.c12[1] +
                   L.c12[2] * L.c12[2],
               (float)1e-30);
  const float tax = l0[0] - l1[0], tay = l0[1] - l1[1], taz = l0[2] - l1[2];
  const float tbx = l2[0] - l1[0], tby = l2[1] - l1[1], tbz = l2[2] - l1[2];
  L.tn[0] = tay * tbz - taz * tby;
  L.tn[1] = taz * tbx - tax * tbz;
  L.tn[2] = tax * tby - tay * tbx;
  L.tn2 = max0(L.tn[0] * L.tn[0] + L.tn[1] * L.tn[1] + L.tn[2] * L.tn[2],
               (float)1e-30);
  L.area = 1.0f;
  for (int i = 0; i < 3; ++i) {
    L.pt[i] = 0.0f;
    L.ln[i] = i == 2 ? 1.0f : 0.0f;
  }
  if (L.kind == S_QUAD) {
    L.area = sqrtf(L.ln2);
    const float ilq = rsqrtf(L.ln2);
    for (int i = 0; i < 3; ++i) {
      L.pt[i] = l0[i] + u_l0 * l1[i] + u_l1 * l2[i];
      L.ln[i] = L.c12[i] * ilq;
    }
  } else if (L.kind == S_SPHERE) {
    const float lsc = L.lsc;
    L.area = FOUR_PI_F * lsc * lsc;
    // Cone sampling from outside, uniform from inside.
    const float wcx = l0[0] - p[0], wcy = l0[1] - p[1], wcz = l0[2] - p[2];
    const float dc2 = wcx * wcx + wcy * wcy + wcz * wcz;
    const float r2l = lsc * lsc;
    const bool inside_s = dc2 < r2l;
    const float zc = 2.0f * u_l1 - 1.0f;
    const float szc = sqrtf(max0(1.0f - zc * zc, 0.0f));
    const float th = TWO_PI_F * u_l0;
    const float iu[3] = {szc * cosf(th), szc * sinf(th), zc};
    const float sin2_tm = r2l / max0(dc2, (float)1e-30);
    const float cos_tm = sqrtf(max0(1.0f - sin2_tm, 0.0f));
    const float cos_tc = (1.0f - u_l0) + u_l0 * cos_tm;
    const float sin2_tc = max0(1.0f - cos_tc * cos_tc, 0.0f);
    const float phi_c = u_l1 * 2.0f * PI_F;
    const float dcl = sqrtf(max0(dc2, (float)1e-30));
    const float ds_ = dcl * cos_tc - sqrtf(max0(r2l - dc2 * sin2_tc, 0.0f));
    const float cos_al =
        (dc2 + r2l - ds_ * ds_) / max0(2.0f * dcl * lsc, (float)1e-30);
    const float sin_al = sqrtf(max0(1.0f - cos_al * cos_al, 0.0f));
    // Frame around unit -wc (Duff basis of vecmath.make_coord_system).
    const float idc = rsqrtf(max0(dc2, (float)1e-30));
    const float tt[3] = {-wcx * idc, -wcy * idc, -wcz * idc};
    const float sgn_ = (tt[2] >= 0.0f) ? 1.0f : -1.0f;
    const float aD_ = -1.0f / (sgn_ + tt[2]);
    const float bD_ = tt[0] * tt[1] * aD_;
    const float b1[3] = {1.0f + sgn_ * tt[0] * tt[0] * aD_, sgn_ * bD_,
                         -sgn_ * tt[0]};
    const float b2[3] = {bD_, sgn_ + tt[1] * tt[1] * aD_, -tt[1]};
    const float nax = sin_al * cosf(phi_c);
    const float nay = sin_al * sinf(phi_c);
    for (int i = 0; i < 3; ++i) {
      const float on = nax * b1[i] + nay * b2[i] + cos_al * tt[i];
      const float ns = inside_s ? iu[i] : on;
      L.pt[i] = l0[i] + ns * lsc;
      L.ln[i] = ns;
    }
  } else if (L.kind == S_DISK) {
    L.area = PI_F * (l2[0] * l2[0] + l2[1] * l2[1] + l2[2] * l2[2]);
    float cdx, cdy;
    concentric(u_l0 * 2.0f - 1.0f, u_l1 * 2.0f - 1.0f, cdx, cdy);
    for (int i = 0; i < 3; ++i) {
      L.pt[i] = l0[i] + cdx * l2[i] + cdy * L.c12[i];
      L.ln[i] = l1[i];
    }
  } else if (L.kind == S_TRIANGLE) {
    L.area = 0.5f * sqrtf(L.tn2);
    const bool over = (u_l0 + u_l1) > 1.0f;
    const float tu = over ? 1.0f - u_l1 : u_l0;
    const float tv = over ? 1.0f - u_l0 : u_l1;
    const float itq = rsqrtf(L.tn2);
    for (int i = 0; i < 3; ++i) {
      L.pt[i] = l0[i] + tu * (l1[i] - l0[i]) + tv * (l2[i] - l0[i]);
      L.ln[i] = L.tn[i] * itq;
    }
  }
}

// (hit, t, solid-angle pdf) of the light's shape along unit w from p; the
// pdf is zero when the re-intersection misses, even for a sampled point.
static __device__ void area_query(const AreaLight& L, const float* p,
                                  float wx_, float wy_, float wz_, bool& okq,
                                  float& tq, float& pdfq) {
  const float px = p[0], py = p[1], pz = p[2];
  const float* l0 = L.l0;
  const float* l1 = L.l1;
  const float* l2 = L.l2;
  okq = false;
  tq = 0.0f;
  float cosq = 1.0f;
  auto plane_hit = [&](float nx_, float ny_, float nz_, float& den,
                       float& tt) {
    den = wx_ * nx_ + wy_ * ny_ + wz_ * nz_;
    const float den_s = (den == 0.0f) ? 1.0f : den;
    tt = ((l0[0] - px) * nx_ + (l0[1] - py) * ny_ + (l0[2] - pz) * nz_) /
         den_s;
  };
  if (L.kind == S_QUAD) {
    const float ilq = rsqrtf(L.ln2);
    const float c12x = L.c12[0], c12y = L.c12[1], c12z = L.c12[2];
    float den, tt;
    plane_hit(c12x * ilq, c12y * ilq, c12z * ilq, den, tt);
    const float hxq = px + tt * wx_ - l0[0];
    const float hyq = py + tt * wy_ - l0[1];
    const float hzq = pz + tt * wz_ - l0[2];
    float cqx = hyq * l2[2] - hzq * l2[1];
    float cqy = hzq * l2[0] - hxq * l2[2];
    float cqz = hxq * l2[1] - hyq * l2[0];
    const float uu = (cqx * c12x + cqy * c12y + cqz * c12z) / L.ln2;
    cqx = l1[1] * hzq - l1[2] * hyq;
    cqy = l1[2] * hxq - l1[0] * hzq;
    cqz = l1[0] * hyq - l1[1] * hxq;
    const float vv = (cqx * c12x + cqy * c12y + cqz * c12z) / L.ln2;
    okq = (den != 0.0f) && (tt >= T_MIN) && (uu >= 0.0f) && (uu <= 1.0f) &&
          (vv >= 0.0f) && (vv <= 1.0f);
    tq = tt;
    cosq = fabsf(den);
  } else if (L.kind == S_TRIANGLE) {
    const float itq = rsqrtf(L.tn2);
    const float unx = L.tn[0] * itq, uny = L.tn[1] * itq, unz = L.tn[2] * itq;
    float den, tt;
    plane_hit(unx, uny, unz, den, tt);
    const float hx_ = px + tt * wx_, hy_ = py + tt * wy_, hz_ = pz + tt * wz_;
    auto tedge = [&](const float* a, const float* b) {
      const float ex = hx_ - a[0], ey = hy_ - a[1], ez = hz_ - a[2];
      const float gx = hx_ - b[0], gy = hy_ - b[1], gz = hz_ - b[2];
      return (ey * gz - ez * gy) * unx + (ez * gx - ex * gz) * uny +
             (ex * gy - ey * gx) * unz;
    };
    const float tb2 = tedge(l0, l1);
    const float tb0 = tedge(l1, l2);
    const float tb1 = tedge(l2, l0);
    const bool ins = (tb0 > 0.0f && tb1 > 0.0f && tb2 > 0.0f) ||
                     (tb0 < 0.0f && tb1 < 0.0f && tb2 < 0.0f);
    okq = (den != 0.0f) && (tt >= T_MIN) && ins;
    tq = tt;
    cosq = fabsf(den);
  } else if (L.kind == S_DISK) {
    // Raw normal p1, radius^2 = |p2|^2.
    float den, tt;
    plane_hit(l1[0], l1[1], l1[2], den, tt);
    const float hx_ = px + tt * wx_ - l0[0];
    const float hy_ = py + tt * wy_ - l0[1];
    const float hz_ = pz + tt * wz_ - l0[2];
    const float r2d = l2[0] * l2[0] + l2[1] * l2[1] + l2[2] * l2[2];
    const bool ins = hx_ * hx_ + hy_ * hy_ + hz_ * hz_ <= r2d;
    okq = (den != 0.0f) && (tt >= T_MIN) && ins;
    tq = tt;
    cosq = fabsf(den);
  }
  pdfq = okq ? (tq * tq) / max0(cosq * L.area, (float)1e-30) : 0.0f;
  if (L.kind == S_SPHERE) {
    // Any-root hit; cone / uniform pdf (independent of the hit).
    const float lsc = L.lsc;
    const float fx_s = px - l0[0], fy_s = py - l0[1], fz_s = pz - l0[2];
    const float a_s = wx_ * wx_ + wy_ * wy_ + wz_ * wz_;
    const float bp = -(fx_s * wx_ + fy_s * wy_ + fz_s * wz_);
    const float inv_a = 1.0f / max0(a_s, (float)1e-30);
    const float mx_ = fx_s + bp * inv_a * wx_;
    const float my_ = fy_s + bp * inv_a * wy_;
    const float mz_ = fz_s + bp * inv_a * wz_;
    const float r2l = lsc * lsc;
    const float dlt = r2l - (mx_ * mx_ + my_ * my_ + mz_ * mz_);
    const float c_s = fx_s * fx_s + fy_s * fy_s + fz_s * fz_s - r2l;
    const float q_s =
        bp + ((bp >= 0.0f) ? 1.0f : -1.0f) * sqrtf(max0(dlt * a_s, 0.0f));
    const float q_sf = (q_s == 0.0f) ? 1.0f : q_s;
    const float t0_ = c_s / q_sf;
    const float t1_ = q_s * inv_a;
    const float tlo = minimum(t0_, t1_);
    const float thi = maximum(t0_, t1_);
    const bool ok_lo = tlo >= T_MIN;
    okq = (dlt >= 0.0f) && (q_s != 0.0f) && (ok_lo || (thi >= T_MIN));
    tq = ok_lo ? tlo : thi;
    const float wcx_ = l0[0] - px, wcy_ = l0[1] - py, wcz_ = l0[2] - pz;
    const float dc2_ = wcx_ * wcx_ + wcy_ * wcy_ + wcz_ * wcz_;
    const bool ins_s = dc2_ < r2l;
    const float s2tm = r2l / max0(dc2_, (float)1e-30);
    const float ctm = sqrtf(max0(1.0f - s2tm, 0.0f));
    const float idc_ = rsqrtf(max0(dc2_, (float)1e-30));
    const float cone = 1.0f / max0(TWO_PI_F * (1.0f - ctm), (float)1e-30);
    const float cdir = (wcx_ * wx_ + wcy_ * wy_ + wcz_ * wz_) * idc_;
    pdfq = ins_s ? 1.0f / max0(L.area, (float)1e-30)
                 : ((cdir > ctm) ? cone : 0.0f);
  }
}

// The shading frame (vecmath.orthonormal_frame of the normal and dpdu).
struct Frame {
  float n[3], b[3], f[3];
  __device__ void to_local(float wx, float wy, float wz, float* l) const {
    const float lx = wx * f[0] + wy * f[1] + wz * f[2];
    const float ly = wx * b[0] + wy * b[1] + wz * b[2];
    const float lz = wx * n[0] + wy * n[1] + wz * n[2];
    const float inv = rsqrtf(max0(lx * lx + ly * ly + lz * lz, (float)1e-30));
    l[0] = lx * inv;
    l[1] = ly * inv;
    l[2] = lz * inv;
  }
  __device__ void to_world(const float* l, float* w) const {
    for (int i = 0; i < 3; ++i) w[i] = l[0] * f[i] + l[1] * b[i] + l[2] * n[i];
  }
};

// vecmath.orthonormal_frame of normal n and tangent hint t, and -d (the
// ray direction, normalized) in that frame.
static __device__ __forceinline__ void make_frame(float nx, float ny,
                                                  float nz, const float* t,
                                                  const float* d, Frame& fr,
                                                  float* wol) {
  float bx = ny * t[2] - nz * t[1];
  float by = nz * t[0] - nx * t[2];
  float bz = nx * t[1] - ny * t[0];
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
  fr.b[0] = bx * binv;
  fr.b[1] = by * binv;
  fr.b[2] = bz * binv;
  fr.n[0] = nx;
  fr.n[1] = ny;
  fr.n[2] = nz;
  fr.f[0] = fr.b[1] * nz - fr.b[2] * ny;
  fr.f[1] = fr.b[2] * nx - fr.b[0] * nz;
  fr.f[2] = fr.b[0] * ny - fr.b[1] * nx;
  const float winv =
      rsqrtf(max0(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], (float)1e-30));
  fr.to_local(-d[0] * winv, -d[1] * winv, -d[2] * winv, wol);
}

}  // namespace pbrs
