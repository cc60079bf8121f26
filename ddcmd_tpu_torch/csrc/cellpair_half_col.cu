// Column variant of the half-stencil (Newton's third law) cell-pair
// kernel: shifted LJ plus optional reaction-field Coulomb, optionally with
// in-kernel bonded-pair exclusions, for G z-contiguous cells per CTA.
//
// Replaces the TPU kernel ddcmd_tpu/ops/pallas_cellpair.py:
// _kernel_half_col (tile math in _pair_tile, bcast variant).  Contract:
//   slots       (ncell, 8, cap) f32, rows [x y z q type valid ex6 ex7],
//               cell-centred coordinates, cells filled rank-contiguously
//   stencil_col (ncol, U) int32: the U union blocks of column c (cells
//               pairwise distinct within a column; ops/cellpair_half.py:
//               pack_stencil_col); the members of column c are the cells
//               c*G .. c*G+G-1
//   member_u    (G, 14) int32: union index of member g's s-th half-stencil
//               block; block s is shifted by the static direction
//               kDirs[s] * L/ncells (col_plan_grid)
//   L8          8 f32 [L/n (3), rcut^2, 0...]
//   counts      (ncell,) int32 per-cell occupancy
//   sigma/eps/shift (T, T) f32
// Outputs (zeroed by the caller):
//   out_p    (ncell*cap, 4)  p-side [fx fy fz pe] per slot (stored: each
//            slot belongs to exactly one column)
//   out_q    (ncell, 8, cap) q-side reaction [fx fy fz pe 0 0 0 0]
//            (accumulated with atomics: columns share target cells)
//   out_col  (ncol, 8)       [e vxx vyy vzz vxy vxz vyz 0], each pair once
//
// Launch shape: one CTA per column, NG * cap threads (NG = 512 / cap, at
// most 4).  The CTA stages the column's U union blocks once in shared
// memory -- the Hopper counterpart of the TPU kernel's union DMA -- then
// sweeps each member cell against its 14 direction blocks: thread (k, i)
// owns p-slot i and the directions s = k, k + NG, ...  The shift is added
// to the q position per pair, in the twin's order (px - (qx + sx)), so
// kernel and twin take the same cutoff decisions.  p-side sums go to a
// shared per-member accumulator, q-side sums to one shared 4-row
// accumulator per union block (shared atomics), then to global memory
// with atomicAdd once per column.  Periodic aliasing (nz == G: several
// union directions reach one cell) needs nothing more: the union is
// deduplicated on the host and every contribution is an atomic add.
//
// What bounds it on an H100: at the bilayer shapes (~1280 cells of ~78
// beads, cap 128, G = 5) a member evaluates 14 x ~78^2 candidate pairs of
// which ~2% lie inside the cutoff, so, as for the per-cell kernel, the
// shared-memory reads and the distance test bound the sweep, not device
// memory.  The staged union (up to 34 blocks x 12 rows x cap floats at
// cap 128: 211 KB) leaves one CTA per SM; NG thread groups per CTA keep
// 16 warps resident instead of 4.  Measured on an H100 it is slower than
// the per-cell kernel on the same slots (PERF.md): the slots fit in L2,
// so the union staging saves little, and one CTA per SM hides less
// latency than the per-cell kernel's many small CTAs.  Loop bounds come from `counts`
// (occupancy trimming, exact because cells fill rank-contiguously).
//
// Exclusions (kExcl): as csrc/cellpair_half.cu, a pair is masked --
// nothing is computed for it -- when the component ids match and bit
// intra_q of B_p is set, decoded exactly in f32.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false.  Sums are accumulated with atomics and are therefore not
// deterministic; every comparison states a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kRec = 8;        // record rows per slot
constexpr int kDirsN = 14;     // half stencil: self + 13 positive offsets
// at most 512 threads a CTA and one CTA per SM (the staged union takes
// most of the shared memory): the register budget is then 128 a thread
// (at 1024 threads the kernel was held to 64 and spilled)
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

template <bool kCoulomb, bool kExcl>
__global__ void __launch_bounds__(kMaxThreads, 1)
cellpair_half_col_kernel(const float* __restrict__ slots,
                         const int* __restrict__ stencil_col,
                         const int* __restrict__ member_u,
                         const float* __restrict__ L8,
                         const int* __restrict__ counts,
                         const float* __restrict__ sigma,
                         const float* __restrict__ eps,
                         const float* __restrict__ shift,
                         float* __restrict__ out_p,
                         float* __restrict__ out_q,
                         float* __restrict__ out_col,
                         int cap, int G, int U, int T,
                         float krf, float crf, float keR) {
  // staged rows per union block: x y z q type valid [comp frac]
  constexpr int kRows = kExcl ? 8 : 6;
  extern __shared__ float smem[];
  float* rec = smem;                        // U * kRows * cap
  float* aq = rec + U * kRows * cap;        // U * 4 * cap q-side sums
  float* ap = aq + U * 4 * cap;             // 4 * cap p-side sums (member)
  float* tab = ap + 4 * cap;                // 3*T*T [sigma eps shift]
  int* nu = reinterpret_cast<int*>(tab + 3 * T * T);   // U occupancies
  __shared__ float red[kMaxWarps][7];

  const int c = blockIdx.x;                 // column
  const int t = threadIdx.x;
  const int nthr = blockDim.x;
  const int ng = nthr / cap;                // direction groups
  const int grp = t / cap;
  const int i = t - grp * cap;              // p slot
  const int TT = T * T;
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
    R[3 * cap + j] = Q[3 * cap + j];
    R[4 * cap + j] = Q[4 * cap + j];
    R[5 * cap + j] = Q[5 * cap + j];
    if (kExcl) {
      R[6 * cap + j] = Q[6 * cap + j];
      const float w7 = Q[7 * cap + j];
      R[7 * cap + j] = w7 - floorf(w7);     // 2^-(intra+1)
    }
    float* A = aq + u * 4 * cap;
    A[j] = 0.f;
    A[cap + j] = 0.f;
    A[2 * cap + j] = 0.f;
    A[3 * cap + j] = 0.f;
  }
  for (int k = t; k < TT; k += nthr) {
    tab[k] = sigma[k];
    tab[TT + k] = eps[k];
    tab[2 * TT + k] = shift[k];
  }
  // counts come from the caller: never let them index past the tile
  for (int u = t; u < U; u += nthr) nu[u] = min(counts[ucell[u]], cap);

  const float Lx = L8[0], Ly = L8[1], Lz = L8[2];
  const float rcut2 = L8[3];
  float e = 0.f;
  float vxx = 0.f, vyy = 0.f, vzz = 0.f, vxy = 0.f, vxz = 0.f, vyz = 0.f;

  for (int g = 0; g < G; ++g) {
    const int cell = c * G + g;
    for (int k = t; k < 4 * cap; k += nthr) ap[k] = 0.f;
    __syncthreads();   // union staged (first member) and ap cleared

    const int* mu = member_u + g * kDirsN;
    const int uself = mu[0];
    const int np = nu[uself];
    float fx = 0.f, fy = 0.f, fz = 0.f, pe = 0.f;
    if (i < np) {
      const float* P = rec + uself * kRows * cap;
      const float px = P[i];
      const float py = P[cap + i];
      const float pz = P[2 * cap + i];
      const float pq = P[3 * cap + i];
      // T == 1 (uniform type): one parameter set whatever the type rows say
      const int prow = T == 1 ? 0 : static_cast<int>(P[4 * cap + i]) * T;
      const float pv = P[5 * cap + i];
      const float pm = kExcl ? P[6 * cap + i] : 0.f;
      // B_p = floor(ex7); the staged row holds the fraction, so B_p is
      // read from the record itself
      const float pb =
          kExcl ? floorf(slots[(static_cast<size_t>(cell) * kRec + 7) * cap +
                               i])
                : 0.f;
      for (int s = grp; s < kDirsN; s += ng) {
        const int u = mu[s];
        const int nq = nu[u];
        if (nq == 0) continue;
        const float sx = static_cast<float>(kDirs[s][0]) * Lx;
        const float sy = static_cast<float>(kDirs[s][1]) * Ly;
        const float sz = static_cast<float>(kDirs[s][2]) * Lz;
        const float* Q = rec + u * kRows * cap;
        float* A = aq + u * 4 * cap;
        int j = i % nq;
        for (int k = 0; k < nq; ++k, j = (j + 1 == nq) ? 0 : j + 1) {
          if (s == 0 && j <= i) continue;   // self block: each pair once
          const float dx = px - (Q[j] + sx);
          const float dy = py - (Q[cap + j] + sy);
          const float dz = pz - (Q[2 * cap + j] + sz);
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (!(pv * Q[5 * cap + j] > 0.f) || !(d2 < rcut2)) continue;
          if (kExcl && pm == Q[6 * cap + j]) {
            const float qw = Q[7 * cap + j];
            const float t_bit = floorf(pb * (qw + qw));  // B_p / 2^intra_q
            if (t_bit - 2.0f * floorf(t_bit * 0.5f) > 0.5f) continue;
          }
          const int pt =
              T == 1 ? 0 : prow + static_cast<int>(Q[4 * cap + j]);
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
            const float kqq = keR * pq * Q[3 * cap + j];
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
          e += epair;
          vxx -= fdx * dx;
          vyy -= fdy * dy;
          vzz -= fdz * dz;
          vxy -= fdx * dy;
          vxz -= fdx * dz;
          vyz -= fdy * dz;
          atomicAdd(&A[j], fdx);
          atomicAdd(&A[cap + j], fdy);
          atomicAdd(&A[2 * cap + j], fdz);
          atomicAdd(&A[3 * cap + j], 0.5f * epair);
        }
      }
      if (ng == 1) {
        ap[i] = fx;
        ap[cap + i] = fy;
        ap[2 * cap + i] = fz;
        ap[3 * cap + i] = pe;
      } else {
        atomicAdd(&ap[i], fx);
        atomicAdd(&ap[cap + i], fy);
        atomicAdd(&ap[2 * cap + i], fz);
        atomicAdd(&ap[3 * cap + i], pe);
      }
    }
    __syncthreads();
    if (t < cap && t < np) {
      float* op = out_p + (static_cast<size_t>(cell) * cap + t) * 4;
      op[0] = ap[t];
      op[1] = ap[cap + t];
      op[2] = ap[2 * cap + t];
      op[3] = ap[3 * cap + t];
    }
    __syncthreads();   // ap read out before the next member clears it
  }

  // --- q side: one atomic add per live slot of every union block --------
  for (int k = t; k < U * cap; k += nthr) {
    const int u = k / cap;
    const int j = k - u * cap;
    if (j >= nu[u]) continue;
    const float* A = aq + u * 4 * cap;
    float* oq = out_q + static_cast<size_t>(ucell[u]) * kRec * cap;
    atomicAdd(&oq[j], A[j]);
    atomicAdd(&oq[cap + j], A[cap + j]);
    atomicAdd(&oq[2 * cap + j], A[2 * cap + j]);
    atomicAdd(&oq[3 * cap + j], A[3 * cap + j]);
  }

  // --- per-column energy and virial --------------------------------------
  float vals[7] = {e, vxx, vyy, vzz, vxy, vxz, vyz};
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const float v = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (t < 7) {
    float sum = 0.f;
    for (int w = 0; w < (nthr >> 5); ++w) sum += red[w][t];
    out_col[static_cast<size_t>(c) * 8 + t] = sum;
  }
}

template <bool kCoulomb, bool kExcl>
cudaError_t launch(const float* slots, const int* stencil_col,
                   const int* member_u, const float* L8, const int* counts,
                   const float* sigma, const float* eps, const float* shift,
                   float* out_p, float* out_q, float* out_col, int ncol,
                   int cap, int G, int U, int T, float krf, float crf,
                   float keR, cudaStream_t stream) {
  const int rows = kExcl ? 8 : 6;
  const size_t smem =
      (static_cast<size_t>(U) * (rows + 4) * cap + 4 * static_cast<size_t>(cap) +
       3 * static_cast<size_t>(T) * T + U) *
      sizeof(float);
  if (cap % 32 != 0 || cap < 32 || cap > kMaxThreads)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cellpair_half_col_kernel<kCoulomb, kExcl>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int ng = kMaxThreads / cap < 4 ? kMaxThreads / cap : 4;
  cellpair_half_col_kernel<kCoulomb, kExcl><<<ncol, ng * cap, smem, stream>>>(
      slots, stencil_col, member_u, L8, counts, sigma, eps, shift, out_p,
      out_q, out_col, cap, G, U, T, krf, crf, keR);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Returns the cudaError_t of the launch
// (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int ddcmd_cellpair_half_col(
    const float* slots, const int* stencil_col, const int* member_u,
    const float* L8, const int* counts, const float* sigma, const float* eps,
    const float* shift, float* out_p, float* out_q, float* out_col, int ncol,
    int cap, int G, int U, int T, float krf, float crf, float keR,
    int coulomb, int excl, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return fn(slots, stencil_col, member_u, L8, counts, sigma, eps, shift,
              out_p, out_q, out_col, ncol, cap, G, U, T, krf, crf, keR, st);
  };
  cudaError_t err;
  if (coulomb)
    err = excl ? go(launch<true, true>) : go(launch<true, false>);
  else
    err = excl ? go(launch<false, true>) : go(launch<false, false>);
  return static_cast<int>(err);
}
