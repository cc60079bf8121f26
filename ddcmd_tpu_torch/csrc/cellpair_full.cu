// Full-stencil cell-pair kernel: shifted LJ plus optional reaction-field
// Coulomb over all 27 neighbour blocks of every cell, no Newton's third
// law -- each thread sums the force on its own particle only.
//
// Replaces the TPU kernel ddcmd_tpu/ops/pallas_cellpair.py:_kernel (built
// by make_pallas_cellpair).  Same record contract as the half kernel:
//   slots    (ncell, 8, cap) f32, rows [x y z q type valid ex6 ex7],
//            cell-centred coordinates, cells filled rank-contiguously
//            (rows 6-7 are not read: the full kernel has no exclusions)
//   stencil  (ncell, S*4) int32 [cell dx dy dz]*S, the 27 directions
//   L8       8 f32 [L/n (3), rcut^2, 0...]
//   counts   (ncell,) int32 per-cell occupancy
//   sigma/eps/shift (T, T) f32
//   s_self   the stencil index of the (0,0,0) direction: the self pair
//            j == i is masked there only.  On a 2-cell axis the -1 and
//            +1 directions reach one cell through two images and both
//            count; on a 1-cell axis the wrapped self images are real
//            pairs -- neither is masked.
// Outputs (written here, every element):
//   out_p    (ncell*cap, 4)  [fx fy fz pe] per slot, pe = 1/2 sum e
//   out_cell (ncell, 8)      [e vxx vyy vzz vxy vxz vyz 0] per cell, every
//            ordered pair at half weight (so each unordered pair once)
//
// Launch shape: one CTA per cell, cap threads, thread i owns p slot i.
// The CTA walks the S stencil blocks in order; for each it stages the q
// block's six live rows, shifted into the home cell's frame, in shared
// memory, and every thread sweeps j < counts[tgt].  Forces, pe and the
// virial stay in registers; the CTA reduces e and the virial for its
// cell at the end.  No atomics and a fixed summation order: the output
// is deterministic, unlike the half kernel's.
//
// What bounds it on an H100: as for the half kernel, the distance test
// of every candidate pair out of shared memory (~2-10% of the candidates
// lie inside the cutoff), not device memory (the slots stay in L2) and
// not the pair arithmetic; the full stencil tests every pair twice,
// once from each side, which is its price for writing no q side.  The
// design answers that with occupancy trimming of both loops (exact:
// cells fill rank-contiguously) and conflict-free shared loads: each
// candidate costs three broadcast reads.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false: the division is IEEE and the distance arithmetic rounds
// exactly as the plain PyTorch version's, so both take the same cutoff
// decision for every pair.

#include <cuda_runtime.h>

namespace {

constexpr int kRec = 8;        // record rows per slot
constexpr int kMaxWarps = 32;  // cap <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool kCoulomb>
__global__ void __launch_bounds__(1024)
cellpair_full_kernel(const float* __restrict__ slots,
                     const int* __restrict__ stencil,
                     const float* __restrict__ L8,
                     const int* __restrict__ counts,
                     const float* __restrict__ sigma,
                     const float* __restrict__ eps,
                     const float* __restrict__ shift,
                     float* __restrict__ out_p,
                     float* __restrict__ out_cell,
                     int cap, int n_stencil, int s_self, int T,
                     float krf, float crf, float keR) {
  extern __shared__ float smem[];
  float* qx = smem;              // q block, shifted into the p frame
  float* qy = qx + cap;
  float* qz = qy + cap;
  float* qq = qz + cap;          // charge
  float* qt = qq + cap;          // LJ type (exact small integer in f32)
  float* qv = qt + cap;          // valid
  float* tab = qv + cap;         // 3*T*T [sigma eps shift]
  __shared__ float red[kMaxWarps][7];

  const int c = blockIdx.x;      // home cell
  const int i = threadIdx.x;     // p slot
  const int TT = T * T;
  const float rcut2 = L8[3];
  // counts come from the caller: never let them index past the tile
  const int np = min(counts[c], cap);

  for (int k = i; k < TT; k += blockDim.x) {
    tab[k] = sigma[k];
    tab[TT + k] = eps[k];
    tab[2 * TT + k] = shift[k];
  }

  const float* P = slots + static_cast<size_t>(c) * kRec * cap;
  const bool live = i < np;
  const float px = live ? P[i] : 0.f;
  const float py = live ? P[cap + i] : 0.f;
  const float pz = live ? P[2 * cap + i] : 0.f;
  const float pq = live ? P[3 * cap + i] : 0.f;
  // T == 1 (uniform type): one parameter set whatever the type rows say
  const int prow = (T == 1 || !live) ? 0 : static_cast<int>(P[4 * cap + i]) * T;
  const float pv = live ? P[5 * cap + i] : 0.f;

  float fx = 0.f, fy = 0.f, fz = 0.f, pe = 0.f;
  float vxx = 0.f, vyy = 0.f, vzz = 0.f, vxy = 0.f, vxz = 0.f, vyz = 0.f;
  const int* st = stencil + static_cast<size_t>(c) * n_stencil * 4;
  // an empty home cell has nothing to sum: its outputs are zeros
  for (int s = 0; np > 0 && s < n_stencil; ++s) {
    const int tgt = st[4 * s];
    const int nq = min(counts[tgt], cap);
    if (nq == 0) continue;       // uniform over the block
    __syncthreads();             // the previous block's readers are done
    if (i < nq) {
      const float* Q = slots + static_cast<size_t>(tgt) * kRec * cap;
      qx[i] = Q[i] + static_cast<float>(st[4 * s + 1]) * L8[0];
      qy[i] = Q[cap + i] + static_cast<float>(st[4 * s + 2]) * L8[1];
      qz[i] = Q[2 * cap + i] + static_cast<float>(st[4 * s + 3]) * L8[2];
      qq[i] = Q[3 * cap + i];
      qt[i] = Q[4 * cap + i];
      qv[i] = Q[5 * cap + i];
    }
    __syncthreads();
    if (!live) continue;
    const int skip = s == s_self ? i : -1;
    for (int j = 0; j < nq; ++j) {
      if (j == skip) continue;
      const float dx = px - qx[j];
      const float dy = py - qy[j];
      const float dz = pz - qz[j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (!(pv * qv[j] > 0.f) || !(d2 < rcut2)) continue;
      const int pt = T == 1 ? 0 : prow + static_cast<int>(qt[j]);
      const float sg = tab[pt];
      const float ep = tab[TT + pt];
      const float sh = tab[2 * TT + pt];
      const float ir2 = 1.0f / d2;
      const float s2 = sg * sg * ir2;
      const float s6 = s2 * s2 * s2;
      const float s12 = s6 * s6;
      float epair = 4.0f * ep * (s12 - s6) + sh;
      float dvdr = 24.0f * ep * (s6 - 2.0f * s12) * ir2;
      if (kCoulomb) {
        const float ir = 1.0f / sqrtf(d2);
        const float kqq = keR * pq * qq[j];
        epair += kqq * (ir + krf * d2 - crf);
        dvdr += kqq * (2.0f * krf - ir2 * ir);
      }
      const float fdx = dvdr * dx;
      const float fdy = dvdr * dy;
      const float fdz = dvdr * dz;
      fx -= fdx;
      fy -= fdy;
      fz -= fdz;
      pe += 0.5f * epair;
      vxx -= 0.5f * fdx * dx;
      vyy -= 0.5f * fdy * dy;
      vzz -= 0.5f * fdz * dz;
      vxy -= 0.5f * fdx * dy;
      vxz -= 0.5f * fdx * dz;
      vyz -= 0.5f * fdy * dz;
    }
  }

  float* op = out_p + (static_cast<size_t>(c) * cap + i) * 4;
  op[0] = fx;
  op[1] = fy;
  op[2] = fz;
  op[3] = pe;

  float vals[7] = {pe, vxx, vyy, vzz, vxy, vxz, vyz};
  const int lane = i & 31;
  const int warp = i >> 5;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const float v = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (i < 8) {
    float t = 0.f;
    if (i < 7)
      for (int w = 0; w < (blockDim.x >> 5); ++w) t += red[w][i];
    out_cell[static_cast<size_t>(c) * 8 + i] = t;
  }
}

template <bool kCoulomb>
cudaError_t launch(const float* slots, const int* stencil, const float* L8,
                   const int* counts, const float* sigma, const float* eps,
                   const float* shift, float* out_p, float* out_cell,
                   int ncell, int cap, int n_stencil, int s_self, int T,
                   float krf, float crf, float keR, cudaStream_t stream) {
  const size_t smem =
      (6 * static_cast<size_t>(cap) + 3 * static_cast<size_t>(T) * T) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cellpair_full_kernel<kCoulomb>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cellpair_full_kernel<kCoulomb><<<ncell, cap, smem, stream>>>(
      slots, stencil, L8, counts, sigma, eps, shift, out_p, out_cell, cap,
      n_stencil, s_self, T, krf, crf, keR);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Returns the cudaError_t of the launch
// (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int ddcmd_cellpair_full(const float* slots, const int* stencil,
                                   const float* L8, const int* counts,
                                   const float* sigma, const float* eps,
                                   const float* shift, float* out_p,
                                   float* out_cell, int ncell, int cap,
                                   int n_stencil, int s_self, int T,
                                   float krf, float crf, float keR,
                                   int coulomb, void* stream) {
  if (s_self < 0 || s_self >= n_stencil)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      coulomb ? launch<true>(slots, stencil, L8, counts, sigma, eps, shift,
                             out_p, out_cell, ncell, cap, n_stencil, s_self,
                             T, krf, crf, keR, st)
              : launch<false>(slots, stencil, L8, counts, sigma, eps, shift,
                              out_p, out_cell, ncell, cap, n_stencil, s_self,
                              T, krf, crf, keR, st);
  return static_cast<int>(err);
}
