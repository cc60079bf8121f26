// Per-pair EAM forms shared by the hand-written EAM kernels
// (csrc/eam_half.cu, csrc/eam_half_col.cu): the device counterpart of
// _pair_eval (ddcmd_tpu/potentials/eam.py:444), which the TPU kernels
// (ddcmd_tpu/ops/pallas_eam.py:_typed_pair_sums) bake in as constants.
//
// Here the parameters of every ordered species pair (t_p, t_q) come as
// one row of a (T*T, npar) f32 table (ops/eam_half.py:PARAM_KEYS gives
// the column order):
//   FS        [a b c m n ro x]
//   SC        [eps a n m]
//   EXP       [f_e phi_e beta gamma r_e_inv]
//   AT        [B b0 alpha c c0 c1 c2 d]
//   RATIONAL  [phi_cut rho_cut phiP(D) phiQ(D) rhoP(D) rhoQ(D)]
//             (rationals of r^2, Horner over degree D, the shorter fit
//             zero-padded at the top, which leaves the Horner sums exact)
//   RATIONAL_SHIFTED (the tabularFit=rational refit of a TABULAR deck,
//             ddcmd_tpu/potentials/eam.py:fit_tabular_rational)
//             the RATIONAL row, then [phiX0 phiS rhoX0 rhoS]: each fit a
//             rational of u = (r2 - X0) * S, whose monomials stay f32-safe
//             at the refit's degree (up to ~19); d/d(r2) = S d/du.  A
//             form of its own, so the unshifted RATIONAL decks keep their
//             instruction stream
//
// pair_eval<kForm, false> gives the pair energy phi and the density term
// rho; pair_eval<kForm, true> gives their (d/dr)/r.  Each expression keeps
// the JAX package's order of operations; the transcendentals are the IEEE
// expf / logf / powf (the kernels are built without --use_fast_math, and
// with --fmad=false so nothing is contracted), and RATIONAL divides by its
// denominator exactly.

#pragma once

namespace eam {

enum Form : int {
  kFS = 0,
  kSC = 1,
  kEXP = 2,
  kAT = 3,
  kRational = 4,
  kRationalShifted = 5
};

// P(x)/Q(x) and its derivative d/dx (_rational_eval, eam.py:421)
__device__ __forceinline__ void rational(const float* P, const float* Q,
                                         int D, float x, float& val,
                                         float& der) {
  float p = P[D - 1], q = Q[D - 1], dp = 0.f, dq = 0.f;
  for (int k = D - 2; k >= 0; --k) {
    dp = dp * x + p;
    dq = dq * x + q;
    p = p * x + P[k];
    q = q * x + Q[k];
  }
  const float qinv = 1.0f / q;
  val = p * qinv;
  der = qinv * (dp - val * dq);
}

template <int kForm, bool kDeriv>
__device__ __forceinline__ void pair_eval(const float* row, int D, float r2,
                                          float ir, float ir2, float& e,
                                          float& p) {
  if constexpr (kForm == kRational || kForm == kRationalShifted) {
    const float phi_cut = row[0], rho_cut = row[1];
    float ev, ed, pv, pd;
    if constexpr (kForm == kRationalShifted) {
      // _pair_eval's order (eam.py:453-467): u = (r2 - X0) * S, the
      // Horner sums in u, then the derivative times S
      const float* sh = row + 2 + 4 * D;   // [phiX0 phiS rhoX0 rhoS]
      rational(row + 2, row + 2 + D, D, (r2 - sh[0]) * sh[1], ev, ed);
      rational(row + 2 + 2 * D, row + 2 + 3 * D, D, (r2 - sh[2]) * sh[3],
               pv, pd);
      ed = ed * sh[1];
      pd = pd * sh[3];
    } else {
      rational(row + 2, row + 2 + D, D, r2, ev, ed);
      rational(row + 2 + 2 * D, row + 2 + 3 * D, D, r2, pv, pd);
    }
    if constexpr (kDeriv) {
      e = r2 < phi_cut ? 2.0f * ed : 0.f;
      p = r2 < rho_cut ? 2.0f * pd : 0.f;
    } else {
      e = r2 < phi_cut ? ev : 0.f;
      p = r2 < rho_cut ? pv : 0.f;
    }
  } else if constexpr (kForm == kFS) {
    const float a = row[0], b = row[1], c = row[2], m = row[3], n = row[4],
                ro = row[5], x = row[6];
    const float r = r2 * ir;
    const float dri = 1.0f / (r - x);
    const float lr = logf(r / ro);
    const float ev = a * expf(c * dri - m * lr);
    const float pv = b * expf(c * dri - n * lr);
    if constexpr (kDeriv) {
      e = -(m / r + c * dri * dri) * ir * ev;
      p = -(n / r + c * dri * dri) * ir * pv;
    } else {
      e = ev;
      p = pv;
    }
  } else if constexpr (kForm == kSC) {
    const float eps = row[0], a = row[1], n = row[2], m = row[3];
    const float arg2 = a * a * ir2;
    const float ev = eps * powf(arg2, 0.5f * n);
    const float pv = powf(arg2, 0.5f * m);
    if constexpr (kDeriv) {
      e = -n * ev * ir2;
      p = -m * pv * ir2;
    } else {
      e = ev;
      p = pv;
    }
  } else if constexpr (kForm == kEXP) {
    const float f_e = row[0], phi_e = row[1], beta = row[2], gamma = row[3],
                r_e_inv = row[4];
    const float r = r2 * ir;
    const float pv = f_e * expf(-beta * (r * r_e_inv - 1.0f));
    const float ev = phi_e * expf(-gamma * (r * r_e_inv - 1.0f));
    if constexpr (kDeriv) {
      e = -gamma * r_e_inv * ev * ir;
      p = -beta * r_e_inv * pv * ir;
    } else {
      e = ev;
      p = pv;
    }
  } else {  // kAT
    const float B = row[0], b0 = row[1], alpha = row[2], c = row[3],
                c0 = row[4], c1 = row[5], c2 = row[6], d = row[7];
    const float r = r2 * ir;
    const float poly = c0 + c1 * r + c2 * r2;
    const float rc = r - c, bm = b0 - r, rd = r - d;
    if constexpr (kDeriv) {
      float de = r < c ? 2.0f * rc * poly + rc * rc * (c1 + 2.0f * c2 * r)
                       : 0.f;
      de = de + (r < b0 ? -B * (bm * bm) * expf(-alpha * r) *
                              (alpha * bm + 3.0f)
                        : 0.f);
      e = de * ir;
      p = (r < d ? 2.0f * rd : 0.f) * ir;
    } else {
      const float core = B * (bm * bm * bm) * expf(-alpha * r);
      e = (r < c ? rc * rc * poly : 0.f) + (r < b0 ? core : 0.f);
      p = r < d ? rd * rd : 0.f;
    }
  }
}

}  // namespace eam
