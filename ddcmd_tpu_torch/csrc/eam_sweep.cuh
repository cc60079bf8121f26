// The EAM hit evaluator of the two-pass EAM kernels (csrc/eam_half.cu,
// csrc/eam_half_col.cu) for the shared two-phase sweep of csrc/sweep.cuh,
// which holds the design and what bounds it.  Replaces the tile math of
// the TPU kernels ddcmd_tpu/ops/pallas_eam.py: _rho_kernel /
// _force_kernel and their column variants (_geometry, _pair_tile,
// _typed_pair_sums, _force_virial); the .cu files keep their work
// decomposition and epilogues.
//
// A staged EAM slot carries its species in w (p side: the float; q side:
// slot << 2 | species, as bits) and, in pass B, its dF(rho) as the one
// extra row.  A pair counts when both slots are valid and 0 < d2 < rcut2.

#pragma once

#include "eam_forms.cuh"
#include "sweep.cuh"

namespace eam {

using sweep::kDirsN;
using sweep::kMaxCap;
using sweep::kMaxDirs;
using sweep::kRec;
using sweep::kSmemMax;

// The sweep layout of an EAM pass: dF rows (pass B) as the extra row,
// [rho pe] or [fx fy fz] accumulators.  ops/eam_half.py mirrors the total
// (eam_cell_smem_bytes, eam_col_smem_bytes).
__host__ __device__ inline sweep::Layout make_layout(int cap, int nd,
                                                     int nblk, int ntab,
                                                     bool force, int nwarps) {
  return sweep::make_layout(cap, nd, nblk, ntab, force ? 1 : 0,
                            force ? 3 : 2, nwarps);
}

template <int kForm, bool kForce>
struct Hit {
  static constexpr int kX = kForce ? 1 : 0;      // dF
  static constexpr int kAcc = kForce ? 3 : 2;    // [fx fy fz] or [rho pe]
  static constexpr int kSums = 6;                // the virial (pass B)
  static constexpr bool kNonzeroD2 = true;
  int T, npar, D;

  // the species index, 0 when T == 1 whatever the type row says
  __device__ __forceinline__ float p_w(const float* P, int cap, int i) const {
    return T == 1 ? 0.f : P[4 * cap + i];
  }
  __device__ __forceinline__ unsigned q_bits(const float* Q, int cap,
                                             int j) const {
    return (static_cast<unsigned>(j) << 2) |
           (T == 1 ? 0u : static_cast<unsigned>(Q[4 * cap + j]));
  }
  template <int N>
  __device__ __forceinline__ void load_px(const float* P, int cap, int i,
                                          float (&x)[N]) const {
    if (kForce) x[0] = P[6 * cap + i];
  }
  template <int N>
  __device__ __forceinline__ void load_qx(const float* Q, int cap, int j,
                                          float (&x)[N]) const {
    if (kForce) x[0] = Q[6 * cap + j];
  }

  // Phase 2 for one hit: entry = d << 20 | p slot << 10 | q position.
  __device__ __forceinline__ void eval(const sweep::View& v, unsigned entry,
                                       int cap, float (&vir)[6]) const {
    const int d = entry >> 20;
    const int i = (entry >> 10) & 1023;
    const int pos = entry & 1023;
    const float4 P = v.p4[i];
    const float4 Q = v.q4[d * cap + pos];
    const unsigned bits = __float_as_uint(Q.w);
    const int j = bits >> 2;             // the q atom's slot
    const float dx = P.x - Q.x;
    const float dy = P.y - Q.y;
    const float dz = P.z - Q.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float ir = 1.0f / sqrtf(d2);
    const float ir2 = 1.0f / d2;
    const int tp = static_cast<int>(P.w);
    const int tq = bits & 3u;
    float e, p;
    pair_eval<kForm, kForce>(v.tab + (tp * T + tq) * npar, D, d2, ir, ir2, e,
                             p);
    float pT = p;                        // density term on the q side
    if (tq != tp) {
      float eT;
      pair_eval<kForm, kForce>(v.tab + (tq * T + tp) * npar, D, d2, ir, ir2,
                               eT, pT);
    }
    float* A = v.aq + v.dblk[d] * kAcc * cap;
    if (!kForce) {
      sweep::shared_add(&v.ap[i], p);
      sweep::shared_add(&v.ap[cap + i], 0.5f * e);
      sweep::shared_add(&A[j], pT);
      sweep::shared_add(&A[cap + j], 0.5f * e);
    } else {
      const float coef = e + v.px[i] * p + v.qx[d * cap + pos] * pT;
      const float fdx = coef * dx;
      const float fdy = coef * dy;
      const float fdz = coef * dz;
      sweep::shared_add(&v.ap[i], -fdx);
      sweep::shared_add(&v.ap[cap + i], -fdy);
      sweep::shared_add(&v.ap[2 * cap + i], -fdz);
      sweep::shared_add(&A[j], fdx);
      sweep::shared_add(&A[cap + j], fdy);
      sweep::shared_add(&A[2 * cap + j], fdz);
      vir[0] -= fdx * dx;
      vir[1] -= fdy * dy;
      vir[2] -= fdz * dz;
      vir[3] -= fdx * dy;
      vir[4] -= fdx * dz;
      vir[5] -= fdy * dz;
    }
  }
};

}  // namespace eam
