// Column variant of the two-pass half-stencil EAM kernels: pass A
// (density) and pass B (force) for G z-contiguous cells per CTA, the
// analytic forms FS / SC / EXP / AT / RATIONAL and the shifted RATIONAL of
// a tabularFit=rational refit, alloys of 1-4 species.
//
// Replaces the TPU kernels ddcmd_tpu/ops/pallas_eam.py:_rho_kernel_col
// (pass A) and _force_kernel_col (pass B), with their union geometry
// (_geometry_col, _member_tile).  The physics is csrc/eam_half.cu's
// (pair forms in csrc/eam_forms.cuh); the column tables are the pair
// kernel's (csrc/cellpair_half.cu:ddcmd_cellpair_half_col).  Contract:
//   slots       (ncell, 8, cap) f32, rows [x y z q type valid dF 0]
//   stencil_col (ncol, U) int32: the U union blocks of column c (cells
//               pairwise distinct within a column; ops/cellpair_half.py:
//               pack_stencil_col); the members of column c are the cells
//               c*G .. c*G+G-1
//   member_u    (G, 14) int32: union index of member g's s-th half-stencil
//               block, shifted by the static direction kHalfDirs[s] * L/ncells
//   L8          8 f32 [L/n (3), rcut^2, 0...]
//   counts      (ncell,) int32 per-cell occupancy
//   params      (T*T, npar) f32, row t_p*T + t_q (csrc/eam_forms.cuh)
// Outputs (zeroed by the caller):
//   pass A: out_p (ncell*cap, 2) p-side [rho pe] (stored: each slot
//           belongs to one column); out_q (ncell, 8, cap) q-side rows
//           [rho pe 0...] (atomics: columns share target cells)
//   pass B: out_p (ncell*cap, 3) p-side force; out_q (ncell, 8, cap)
//           q-side rows [fx fy fz 0...]; out_col (ncol, 8)
//           [vxx vyy vzz vxy vxz vyz 0 0], each pair once
//
// Launch shape: one CTA of kThreads threads per column, three an SM.  What the
// column keeps from the TPU kernels' union is the q side: one accumulator
// block per union block (2 rows of cap in pass A, 3 in pass B) stays in
// shared memory for the whole column, so a target cell that several
// members reach gets one atomicAdd per live slot and column, not one per
// member and direction; and each member's p side is stored, not added
// (a slot belongs to one column).  The records are not kept: the slots
// of the 131,072-atom crystal are 6.5 MB in a 50 MB L2, so each member
// stages its own q blocks from there, kColDirs directions a round,
// shifted into its frame and pruned to the atoms that can have a partner
// (csrc/sweep.cuh), and the CTA's warps sweep the round's
// (direction, p tile, q chunk) items with the two-phase body of
// csrc/sweep.cuh and the EAM hit evaluator of csrc/eam_sweep.cuh.  Periodic aliasing (nz == G) needs nothing more:
// the union is deduplicated on the host, two directions of a member that
// reach one block through different images are staged apart with their
// own shifts, and every contribution is an atomic add.
//
// Shared memory (eam::make_layout with kColDirs staged blocks and U
// accumulator blocks): at U = 29, cap 128, one species, RATIONAL, pass A
// with 14 staged directions takes 70 KB and pass B with 7 takes 71 KB, so
// three CTAs share an SM and the crystal's 396 columns are one wave.
// ops/eam_half.py:eam_col_smem_bytes mirrors the count, and the plan
// (ops/cellpair_half.py:fit_col_group) lowers G until it fits.
//
// What bounds it on an H100, and what the design does about it: see
// csrc/sweep.cuh (operations, not bytes).  Beside the per-cell kernel
// on the same slots it saves global atomics and loses on latency: three
// CTAs of 8 warps an SM, with a barrier before and after each round's
// staging, hide phase 2's compare-and-swap loops less well than the
// per-cell grid's many small CTAs.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false.  Sums are accumulated with atomics and are therefore not
// deterministic; every comparison states a tolerance.

#include <cuda_runtime.h>

#include "eam_sweep.cuh"

namespace {

using eam::kDirsN;
using eam::kRec;

// directions a member stages per round: all 14 in pass A, 7 in pass B,
// whose dF rows and third accumulator row would otherwise leave an SM
// room for two CTAs, not three
template <bool kForce>
constexpr int kColDirs = kForce ? 7 : 14;
// CTA size: 12 warps on pass A's 14 directions, 8 on pass B's 7
template <bool kForce>
constexpr int kThreads = kForce ? 256 : 384;

using sweep::kHalfDirs;

template <int kForm, bool kForce>
__global__ void __launch_bounds__(kThreads<kForce>, 3)
eam_half_col_kernel(const float* __restrict__ slots,
                    const int* __restrict__ stencil_col,
                    const int* __restrict__ member_u,
                    const float* __restrict__ L8,
                    const int* __restrict__ counts,
                    const float* __restrict__ params,
                    float* __restrict__ out_p,
                    float* __restrict__ out_q,
                    float* __restrict__ out_col,
                    int cap, int G, int U, int T, int npar, int D) {
  constexpr int kAcc = kForce ? 3 : 2;    // [fx fy fz] or [rho pe]
  constexpr int kNt = kThreads<kForce>;   // threads of this CTA
  extern __shared__ __align__(16) unsigned char smem[];

  const int c = blockIdx.x;               // column
  const int t = threadIdx.x;
  const int* ucell = stencil_col + static_cast<size_t>(c) * U;
  const int ntab = T * T * npar;
  const sweep::Layout lay = eam::make_layout(cap, kColDirs<kForce>, U, ntab,
                                             kForce, kNt / 32);
  const sweep::View v = sweep::make_view(smem, lay, kColDirs<kForce>, U);
  const eam::Hit<kForm, kForce> f{T, npar, D};

  __shared__ float pbox[kNt / 32][6];
  // counts come from the caller: never let them index past the tile
  for (int u = t; u < U; u += kNt) v.bnq[u] = min(counts[ucell[u]], cap);
  for (int k = t; k < U * kAcc * cap; k += kNt) v.aq[k] = 0.f;
  for (int k = t; k < ntab; k += kNt) v.tab[k] = params[k];
  __syncthreads();

  const float rcut2 = L8[3];
  const float rc = sqrtf(rcut2) * sweep::kBoxSlack;
  float vir[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int g = 0; g < G; ++g) {
    const int cell = c * G + g;
    const int* mu = member_u + g * kDirsN;
    const int np = v.bnq[mu[0]];
    if (np == 0) continue;                // uniform over the CTA
    for (int s0 = 0; s0 < kDirsN; s0 += kColDirs<kForce>) {
      const int nd = min(kColDirs<kForce>, kDirsN - s0);
      const int dself = s0 == 0 ? 0 : -1; // the self block is direction 0
      __syncthreads();                    // the sweep before is done
      if (t < nd) {
        const int s = s0 + t;
        const int u = mu[s];
        v.dtgt[t] = ucell[u];
        v.dcnt[t] = v.bnq[u];
        v.dblk[t] = u;
        v.dsh[3 * t] = static_cast<float>(kHalfDirs[s][0]) * L8[0];
        v.dsh[3 * t + 1] = static_cast<float>(kHalfDirs[s][1]) * L8[1];
        v.dsh[3 * t + 2] = static_cast<float>(kHalfDirs[s][2]) * L8[2];
      }
      if (t == 0) *v.next = 0;
      // the home cell once a member (its box too: pbox stays)
      if (s0 == 0)
        sweep::stage_home(v, f, slots + static_cast<size_t>(cell) * kRec * cap,
                          cap, np, pbox);
      __syncthreads();
      sweep::stage_dirs(v, f, slots, cap, np, nd, dself, rc, pbox);
      __syncthreads();
      sweep::sweep(v, f, cap, nd, dself, rcut2, vir);
    }
    __syncthreads();
    // the member's p side: this column owns the slots, so a plain store
    for (int idx = t; idx < np * kAcc; idx += kNt) {
      const int i = idx / kAcc;
      const int k = idx - i * kAcc;
      out_p[(static_cast<size_t>(cell) * cap + i) * kAcc + k] =
          v.ap[k * cap + i];
    }
  }
  __syncthreads();

  // --- q side: one atomic add per live slot of every union block --------
  for (int k = t; k < U * cap; k += kNt) {
    const int u = k / cap;
    const int j = k - u * cap;
    if (j >= v.bnq[u]) continue;
    float* oq = out_q + static_cast<size_t>(ucell[u]) * kRec * cap + j;
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
      atomicAdd(&oq[a * cap], v.aq[(u * kAcc + a) * cap + j]);
  }

  // --- per-column virial (pass B) ----------------------------------------
  if (kForce)
    sweep::reduce_sums<true>(vir, out_col + static_cast<size_t>(c) * 8);
}

template <int kForm, bool kForce>
cudaError_t launch(const float* slots, const int* stencil_col,
                   const int* member_u, const float* L8, const int* counts,
                   const float* params, float* out_p, float* out_q,
                   float* out_col, int ncol, int cap, int G, int U, int T,
                   int npar, int D, cudaStream_t stream) {
  if (ncol < 1 || G < 1 || U < 1 || cap < 32 || cap > eam::kMaxCap ||
      cap % 32)
    return cudaErrorInvalidValue;
  const int smem =
      eam::make_layout(cap, kColDirs<kForce>, U, T * T * npar, kForce,
                       kThreads<kForce> / 32)
          .bytes;
  if (smem > eam::kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        eam_half_col_kernel<kForm, kForce>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  eam_half_col_kernel<kForm, kForce><<<ncol, kThreads<kForce>, smem, stream>>>(
      slots, stencil_col, member_u, L8, counts, params, out_p, out_q, out_col,
      cap, G, U, T, npar, D);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const int*, const int*,
                                 const float*, const int*, const float*,
                                 float*, float*, float*, int, int, int, int,
                                 int, int, int, cudaStream_t);

// [form][pass]: eam::Form order, pass 0 = density, 1 = force
constexpr LaunchFn kLaunch[6][2] = {
    {launch<eam::kFS, false>, launch<eam::kFS, true>},
    {launch<eam::kSC, false>, launch<eam::kSC, true>},
    {launch<eam::kEXP, false>, launch<eam::kEXP, true>},
    {launch<eam::kAT, false>, launch<eam::kAT, true>},
    {launch<eam::kRational, false>, launch<eam::kRational, true>},
    {launch<eam::kRationalShifted, false>,
     launch<eam::kRationalShifted, true>}};

}  // namespace

// Plain C entry point for ctypes: form is an eam::Form, force selects
// pass B (out_col is unused in pass A).  Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int ddcmd_eam_half_col(
    const float* slots, const int* stencil_col, const int* member_u,
    const float* L8, const int* counts, const float* params, float* out_p,
    float* out_q, float* out_col, int ncol, int cap, int G, int U, int T,
    int npar, int degree, int form, int force, void* stream) {
  if (form < 0 || form > 5) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunch[form][force ? 1 : 0](
      slots, stencil_col, member_u, L8, counts, params, out_p, out_q, out_col,
      ncol, cap, G, U, T, npar, degree, static_cast<cudaStream_t>(stream)));
}
