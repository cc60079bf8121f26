// Column variant of the two-pass half-stencil EAM kernels: pass A
// (density) and pass B (force) for G z-contiguous cells per CTA, the
// analytic forms FS / SC / EXP / AT / RATIONAL, alloys of 1-4 species.
//
// Replaces the TPU kernels ddcmd_tpu/ops/pallas_eam.py:_rho_kernel_col
// (pass A) and _force_kernel_col (pass B), with their union geometry
// (_geometry_col, _member_tile).  The physics is csrc/eam_half.cu's
// (pair forms in csrc/eam_forms.cuh); the column layout is
// csrc/cellpair_half_col.cu's.  Contract:
//   slots       (ncell, 8, cap) f32, rows [x y z q type valid dF 0]
//   stencil_col (ncol, U) int32: the U union blocks of column c (cells
//               pairwise distinct within a column; ops/cellpair_half.py:
//               pack_stencil_col); the members of column c are the cells
//               c*G .. c*G+G-1
//   member_u    (G, 14) int32: union index of member g's s-th half-stencil
//               block, shifted by the static direction kDirs[s] * L/ncells
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
// Launch shape: one CTA per column, NG * cap threads (NG = 512 / cap, at
// most 4).  The CTA stages the column's U union blocks once in shared
// memory (x y z type valid, plus dF in pass B) -- the Hopper counterpart
// of the TPU kernels' union DMA -- with one q-side accumulator per union
// block (2 rows in pass A, 3 in pass B), then sweeps each member cell
// against its 14 direction blocks: thread (k, i) owns p-slot i and the
// directions s = k, k + NG, ...  p-side sums go to a shared per-member
// accumulator, q-side sums to the union block's accumulator (shared
// atomics), then to global memory with one atomicAdd per live slot.
// Periodic aliasing (nz == G) needs nothing more: the union is
// deduplicated on the host and every contribution is an atomic add.
//
// Shared memory: U * (kRows + kAcc) * cap + kAcc * cap + T*T*npar floats
// plus U ints -- pass B at U = 29, cap 128: 134 KB, so one CTA per SM.
// ops/eam_half.py:eam_col_smem_bytes mirrors this count, and the plan
// (ops/cellpair_half.py:fit_col_group) lowers G until the union fits.
//
// What bounds it on an H100: as the per-cell EAM kernel, the distance
// test over ~970 candidates per p atom (~3% inside the 5.5 A cutoff at
// the copper crystal's cap 128 cells), now with 16 warps per SM instead
// of many small CTAs; the staging saves device-memory reads that the L2
// would mostly serve anyway (the 131,072-atom crystal's slots are 6.5 MB).
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false.  Sums are accumulated with atomics and are therefore not
// deterministic; every comparison states a tolerance.

#include <cuda_runtime.h>

#include "eam_forms.cuh"

namespace {

constexpr int kRec = 8;        // record rows per slot
constexpr int kDirsN = 14;     // half stencil: self + 13 positive offsets
// at most 512 threads a CTA and one CTA per SM (the staged union takes
// most of the shared memory): a budget of 128 registers a thread
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// _half_dirs(): self first, then the lexicographically positive offsets
__constant__ int kDirs[kDirsN][3] = {
    {0, 0, 0},   {0, 0, 1},  {0, 1, -1}, {0, 1, 0},  {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1},   {1, 1, -1}, {1, 1, 0},  {1, 1, 1}};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int kForm, bool kForce>
__global__ void __launch_bounds__(kMaxThreads, 1)
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
  constexpr int kRows = kForce ? 6 : 5;   // staged: x y z type valid [dF]
  constexpr int kAcc = kForce ? 3 : 2;    // [fx fy fz] or [rho pe]
  extern __shared__ float smem[];
  float* rec = smem;                        // U * kRows * cap
  float* aq = rec + U * kRows * cap;        // U * kAcc * cap q-side sums
  float* ap = aq + U * kAcc * cap;          // kAcc * cap p-side (member)
  float* tab = ap + kAcc * cap;             // T*T*npar parameter rows
  int* nu = reinterpret_cast<int*>(tab + T * T * npar);   // U occupancies
  __shared__ float red[kMaxWarps][6];

  const int c = blockIdx.x;                 // column
  const int t = threadIdx.x;
  const int nthr = blockDim.x;
  const int ng = nthr / cap;                // direction groups
  const int grp = t / cap;
  const int i = t - grp * cap;              // p slot
  const int* ucell = stencil_col + static_cast<size_t>(c) * U;

  // --- stage the union once -------------------------------------------
  for (int k = t; k < U * cap; k += nthr) {
    const int u = k / cap;
    const int j = k - u * cap;
    const float* Q = slots + static_cast<size_t>(ucell[u]) * kRec * cap;
    float* R = rec + u * kRows * cap;
    R[j] = Q[j];
    R[cap + j] = Q[cap + j];
    R[2 * cap + j] = Q[2 * cap + j];
    R[3 * cap + j] = Q[4 * cap + j];        // species index
    R[4 * cap + j] = Q[5 * cap + j];        // valid
    if (kForce) R[5 * cap + j] = Q[6 * cap + j];   // dF
    float* A = aq + u * kAcc * cap;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) A[a * cap + j] = 0.f;
  }
  for (int k = t; k < T * T * npar; k += nthr) tab[k] = params[k];
  // counts come from the caller: never let them index past the tile
  for (int u = t; u < U; u += nthr) nu[u] = min(counts[ucell[u]], cap);

  const float Lx = L8[0], Ly = L8[1], Lz = L8[2];
  const float rcut2 = L8[3];
  float vxx = 0.f, vyy = 0.f, vzz = 0.f, vxy = 0.f, vxz = 0.f, vyz = 0.f;

  for (int g = 0; g < G; ++g) {
    const int cell = c * G + g;
    for (int k = t; k < kAcc * cap; k += nthr) ap[k] = 0.f;
    __syncthreads();   // union staged (first member) and ap cleared

    const int* mu = member_u + g * kDirsN;
    const int uself = mu[0];
    const int np = nu[uself];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    if (i < np) {
      const float* P = rec + uself * kRows * cap;
      const float px = P[i];
      const float py = P[cap + i];
      const float pz = P[2 * cap + i];
      const int tp = T == 1 ? 0 : static_cast<int>(P[3 * cap + i]);
      const float pv = P[4 * cap + i];
      const float dFp = kForce ? P[5 * cap + i] : 0.f;
      const float* prow = tab + tp * T * npar;   // rows (t_p, *)
      for (int s = grp; s < kDirsN; s += ng) {
        const int u = mu[s];
        const int nq = nu[u];
        if (nq == 0) continue;
        const float sx = static_cast<float>(kDirs[s][0]) * Lx;
        const float sy = static_cast<float>(kDirs[s][1]) * Ly;
        const float sz = static_cast<float>(kDirs[s][2]) * Lz;
        const float* Q = rec + u * kRows * cap;
        float* A = aq + u * kAcc * cap;
        int j = i % nq;
        for (int k = 0; k < nq; ++k, j = (j + 1 == nq) ? 0 : j + 1) {
          if (s == 0 && j <= i) continue;   // self block: each pair once
          const float dx = px - (Q[j] + sx);
          const float dy = py - (Q[cap + j] + sy);
          const float dz = pz - (Q[2 * cap + j] + sz);
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (!(pv * Q[4 * cap + j] > 0.f) || !(d2 < rcut2) || !(d2 > 0.f))
            continue;
          const float ir = 1.0f / sqrtf(d2);
          const float ir2 = 1.0f / d2;
          const int tq = T == 1 ? 0 : static_cast<int>(Q[3 * cap + j]);
          float e, p;
          eam::pair_eval<kForm, kForce>(prow + tq * npar, D, d2, ir, ir2, e,
                                        p);
          float pT = p;                     // density term on the q side
          if (tq != tp) {
            float eT;
            eam::pair_eval<kForm, kForce>(tab + (tq * T + tp) * npar, D, d2,
                                          ir, ir2, eT, pT);
          }
          if (!kForce) {
            a0 += p;
            a1 += 0.5f * e;
            atomicAdd(&A[j], pT);
            atomicAdd(&A[cap + j], 0.5f * e);
          } else {
            const float coef = e + dFp * p + Q[5 * cap + j] * pT;
            const float fdx = coef * dx;
            const float fdy = coef * dy;
            const float fdz = coef * dz;
            a0 -= fdx;
            a1 -= fdy;
            a2 -= fdz;
            vxx -= fdx * dx;
            vyy -= fdy * dy;
            vzz -= fdz * dz;
            vxy -= fdx * dy;
            vxz -= fdx * dz;
            vyz -= fdy * dz;
            atomicAdd(&A[j], fdx);
            atomicAdd(&A[cap + j], fdy);
            atomicAdd(&A[2 * cap + j], fdz);
          }
        }
      }
      if (ng == 1) {
        ap[i] = a0;
        ap[cap + i] = a1;
        if (kForce) ap[2 * cap + i] = a2;
      } else {
        atomicAdd(&ap[i], a0);
        atomicAdd(&ap[cap + i], a1);
        if (kForce) atomicAdd(&ap[2 * cap + i], a2);
      }
    }
    __syncthreads();
    if (t < cap && t < np) {
      float* op = out_p + (static_cast<size_t>(cell) * cap + t) * kAcc;
#pragma unroll
      for (int a = 0; a < kAcc; ++a) op[a] = ap[a * cap + t];
    }
    __syncthreads();   // ap read out before the next member clears it
  }

  // --- q side: one atomic add per live slot of every union block --------
  for (int k = t; k < U * cap; k += nthr) {
    const int u = k / cap;
    const int j = k - u * cap;
    if (j >= nu[u]) continue;
    const float* A = aq + u * kAcc * cap;
    float* oq = out_q + static_cast<size_t>(ucell[u]) * kRec * cap;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) atomicAdd(&oq[a * cap + j], A[a * cap + j]);
  }

  // --- per-column virial (pass B) ----------------------------------------
  if (kForce) {
    float vals[6] = {vxx, vyy, vzz, vxy, vxz, vyz};
    const int lane = t & 31;
    const int warp = t >> 5;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float v = warp_sum(vals[k]);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (t < 6) {
      float sum = 0.f;
      for (int w = 0; w < (nthr >> 5); ++w) sum += red[w][t];
      out_col[static_cast<size_t>(c) * 8 + t] = sum;
    }
  }
}

template <int kForm, bool kForce>
cudaError_t launch(const float* slots, const int* stencil_col,
                   const int* member_u, const float* L8, const int* counts,
                   const float* params, float* out_p, float* out_q,
                   float* out_col, int ncol, int cap, int G, int U, int T,
                   int npar, int D, cudaStream_t stream) {
  const int rows = kForce ? 9 : 7;          // staged + accumulator rows
  const int acc = kForce ? 3 : 2;
  const size_t smem =
      (static_cast<size_t>(U) * rows * cap + static_cast<size_t>(acc) * cap +
       static_cast<size_t>(T) * T * npar + U) *
      sizeof(float);
  if (cap % 32 != 0 || cap < 32 || cap > kMaxThreads)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        eam_half_col_kernel<kForm, kForce>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int ng = kMaxThreads / cap < 4 ? kMaxThreads / cap : 4;
  eam_half_col_kernel<kForm, kForce><<<ncol, ng * cap, smem, stream>>>(
      slots, stencil_col, member_u, L8, counts, params, out_p, out_q, out_col,
      cap, G, U, T, npar, D);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const int*, const int*,
                                 const float*, const int*, const float*,
                                 float*, float*, float*, int, int, int, int,
                                 int, int, int, cudaStream_t);

// [form][pass]: eam::Form order, pass 0 = density, 1 = force
constexpr LaunchFn kLaunch[5][2] = {
    {launch<eam::kFS, false>, launch<eam::kFS, true>},
    {launch<eam::kSC, false>, launch<eam::kSC, true>},
    {launch<eam::kEXP, false>, launch<eam::kEXP, true>},
    {launch<eam::kAT, false>, launch<eam::kAT, true>},
    {launch<eam::kRational, false>, launch<eam::kRational, true>}};

}  // namespace

// Plain C entry point for ctypes: form is an eam::Form, force selects
// pass B (out_col is unused in pass A).  Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int ddcmd_eam_half_col(
    const float* slots, const int* stencil_col, const int* member_u,
    const float* L8, const int* counts, const float* params, float* out_p,
    float* out_q, float* out_col, int ncol, int cap, int G, int U, int T,
    int npar, int degree, int form, int force, void* stream) {
  if (form < 0 || form > 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunch[form][force ? 1 : 0](
      slots, stencil_col, member_u, L8, counts, params, out_p, out_q, out_col,
      ncol, cap, G, U, T, npar, degree, static_cast<cudaStream_t>(stream)));
}
