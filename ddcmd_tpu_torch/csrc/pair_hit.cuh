// The pair hit evaluator of the half-stencil LJ + reaction-field kernels
// (csrc/cellpair_half.cu: per cell, extended grid, column) for the shared
// two-phase sweep of csrc/sweep.cuh, which holds the design and what
// bounds it.  Replaces the tile math of the TPU kernels
// ddcmd_tpu/ops/pallas_cellpair.py:_kernel_half / _kernel_half_col
// (_pair_tile, bcast variant, with in-kernel exclusions).
//
// A staged slot carries its LJ type in w (p side: the float, an exact
// small integer; q side: slot | type << 10, as bits) and kX extra rows:
// the charge (reserved, and left unread, without kCoulomb), and with
// kExcl the exclusion component id and, on the p side, B = floor(ex7),
// on the q side the fraction ex7 - B = 2^-(intra+1).
//
// A pair (p, q) counts when both validity rows are positive (they hold 0
// or 1, ops/cellpair_half.py:pack_slots, the twin's pv * qv > 0), d2 <
// rcut2 (there is no d2 > 0 test: the plain version has none), j > i in
// the self block, and it is not excluded: masked -- no LJ, no RF,
// nothing -- when the component ids match and bit intra_q of B_p is set,
// decoded as parity(floor(B_p * 2^-intra_q)) from the f32 channels
// (_pair_tile:205-222).  B < 2^12 and 2^-intra >= 2^-11, so every step of
// that test is exact in f32.  The distance is recomputed from the staged
// records with the plain version's operations (px - (qx + sx), the sum
// rounded at staging), and the LJ and RF terms keep its order too.

#pragma once

#include "sweep.cuh"

namespace ljpair {

// extra rows per staged slot: the charge, with exclusions also the
// component id and B_p (p side) or 2^-(intra+1) (q side)
__host__ __device__ constexpr int extra_rows(bool excl) {
  return excl ? 3 : 1;
}

// The sweep layout of a pair kernel: 4 accumulator rows [fx fy fz pe],
// the (T, T) sigma / eps / shift tables.  ops/cellpair_half.py mirrors
// the total (sweep_smem_bytes).
__host__ __device__ inline sweep::Layout make_layout(int cap, int nd,
                                                     int nblk, int T,
                                                     bool excl, int nwarps) {
  return sweep::make_layout(cap, nd, nblk, 3 * T * T, extra_rows(excl), 4,
                            nwarps);
}

template <bool kCoulomb, bool kExcl>
struct Hit {
  static constexpr int kX = extra_rows(kExcl);
  static constexpr int kAcc = 4;                 // [fx fy fz pe]
  static constexpr int kSums = 7;                // [e vxx vyy vzz vxy vxz vyz]
  static constexpr bool kNonzeroD2 = false;
  int T, TT;
  float krf, crf, keR;

  // the slot of a kept q entry, from its w
  static __device__ __forceinline__ int slot_of(float w) {
    return static_cast<int>(__float_as_uint(w) & 1023u);
  }
  // the LJ type, 0 when T == 1 whatever the type row says
  __device__ __forceinline__ float p_w(const float* P, int cap, int i) const {
    return T == 1 ? 0.f : P[4 * cap + i];
  }
  __device__ __forceinline__ unsigned q_bits(const float* Q, int cap,
                                             int j) const {
    return static_cast<unsigned>(j) |
           (T == 1 ? 0u : static_cast<unsigned>(Q[4 * cap + j]) << 10);
  }
  template <int N>
  __device__ __forceinline__ void load_px(const float* P, int cap, int i,
                                          float (&x)[N]) const {
    if (kCoulomb) x[0] = P[3 * cap + i];
    if (kExcl) {
      x[1] = P[6 * cap + i];
      x[2] = floorf(P[7 * cap + i]);             // B_p
    }
  }
  template <int N>
  __device__ __forceinline__ void load_qx(const float* Q, int cap, int j,
                                          float (&x)[N]) const {
    if (kCoulomb) x[0] = Q[3 * cap + j];
    if (kExcl) {
      x[1] = Q[6 * cap + j];
      const float w7 = Q[7 * cap + j];
      x[2] = w7 - floorf(w7);                    // 2^-(intra+1)
    }
  }

  // Phase 2 for one hit: entry = d << 20 | p slot << 10 | q position.
  __device__ __forceinline__ void eval(const sweep::View& v, unsigned entry,
                                       int cap, float (&sums)[7]) const {
    const int d = entry >> 20;
    const int i = (entry >> 10) & 1023;
    const int pos = entry & 1023;
    const float* qx = v.qx + d * kX * cap;
    if (kExcl && v.px[cap + i] == qx[cap + pos]) {
      const float qw = qx[2 * cap + pos];
      const float t_bit = floorf(v.px[2 * cap + i] * (qw + qw));  // B_p / 2^intra_q
      if (t_bit - 2.0f * floorf(t_bit * 0.5f) > 0.5f) return;
    }
    const float4 P = v.p4[i];
    const float4 Q = v.q4[d * cap + pos];
    const unsigned bits = __float_as_uint(Q.w);
    const int j = bits & 1023u;          // the q slot
    const float dx = P.x - Q.x;
    const float dy = P.y - Q.y;
    const float dz = P.z - Q.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const int pt = T == 1 ? 0 : static_cast<int>(P.w) * T + (bits >> 10);
    const float sg = v.tab[pt];
    const float ep = v.tab[TT + pt];
    const float sh = v.tab[2 * TT + pt];
    const float ir2 = 1.0f / d2;
    const float s2 = sg * sg * ir2;
    const float s6 = s2 * s2 * s2;
    const float s12 = s6 * s6;
    float epair = 4.0f * ep * (s12 - s6) + sh;
    float dvdr = 24.0f * ep * (s6 - 2.0f * s12) * ir2;
    if (kCoulomb) {
      const float ir = 1.0f / sqrtf(d2);
      const float kqq = keR * v.px[i] * qx[pos];
      epair += kqq * (ir + krf * d2 - crf);
      dvdr += kqq * (2.0f * krf - ir2 * ir);
    }
    const float fdx = dvdr * dx;
    const float fdy = dvdr * dy;
    const float fdz = dvdr * dz;
    const float half = 0.5f * epair;
    float* A = v.aq + v.dblk[d] * kAcc * cap;
    sweep::shared_add(&v.ap[i], -fdx);
    sweep::shared_add(&v.ap[cap + i], -fdy);
    sweep::shared_add(&v.ap[2 * cap + i], -fdz);
    sweep::shared_add(&v.ap[3 * cap + i], half);
    sweep::shared_add(&A[j], fdx);
    sweep::shared_add(&A[cap + j], fdy);
    sweep::shared_add(&A[2 * cap + j], fdz);
    sweep::shared_add(&A[3 * cap + j], half);
    sums[0] += epair;
    sums[1] -= fdx * dx;
    sums[2] -= fdy * dy;
    sums[3] -= fdz * dz;
    sums[4] -= fdx * dy;
    sums[5] -= fdx * dz;
    sums[6] -= fdy * dz;
  }
};

}  // namespace ljpair
