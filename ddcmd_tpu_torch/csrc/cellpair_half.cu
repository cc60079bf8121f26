// Half-stencil (Newton's third law) cell-pair kernel: shifted LJ plus
// optional reaction-field Coulomb, for the Martini/PAIR nonbond term,
// optionally with in-kernel bonded-pair exclusions.
//
// Replaces the TPU kernel ddcmd_tpu/ops/pallas_cellpair.py:_kernel_half
// (tile math in _pair_tile, bcast variant).  Same record contract:
//   slots    (ncell, 8, cap) f32, rows [x y z q type valid ex6 ex7],
//            cell-centred coordinates, cells filled rank-contiguously;
//            ex6 = exclusion component id, ex7 = B + 2^-(intra+1) with B
//            the particle's exclusion bitmask over its component
//            (run/forces.py:_excl_channels; zero rows without exclusions)
//   stencil  (ncell, S*4) int32 [cell dx dy dz]*S, self block first
//   L8       8 f32 [L/n (3), rcut^2, 0...]
//   counts   (ncell,) int32 per-cell occupancy
//   sigma/eps/shift (T, T) f32
// Outputs (zeroed by the caller, accumulated here):
//   out_p    (ncell*cap, 4)  p-side [fx fy fz pe] per slot
//   out_q    (ncell, 8, cap) q-side reaction [fx fy fz pe 0 0 0 0]
//   out_cell (ncell, 8)      [e vxx vyy vzz vxy vxz vyz 0], each pair once
//
// Launch shape: one CTA per (home cell, stencil direction), the cell on
// blockIdx.x, cap threads, thread i owns p-slot i.  The CTA stages its q
// block (shifted into the home cell's frame) in shared memory, sweeps
// j < counts[tgt] (j > i in the self block), keeps the p side in
// registers and accumulates the q side in shared memory; both then go to
// global memory with atomicAdd.
//
// What bounds it on an H100: at the waterbox shapes (80 cells, cap 128,
// ~77 beads a cell) a CTA evaluates ~6k candidate pairs of which ~2% lie
// inside the cutoff, so the sweep is bound by the shared-memory reads
// and compare of the distance test, not by device memory (the whole slot
// array is 330 KB and stays in L2) and not by the LJ arithmetic.  The
// design answers that by
//   - trimming both loops to live occupancy (exact: cells fill
//     rank-contiguously), which removes ~64% of the padded cap^2 tile;
//   - starting each thread's sweep at a different j (j = i + k mod nq),
//     so the rare q-side shared atomics of one warp hit distinct words;
//   - staging every q record once per CTA, so each pair costs three
//     conflict-free shared loads.
// The TPU kernel's in-order read-modify-write of the q side (race-free
// only because the TPU grid runs in sequence) and its merge of aliased
// periodic images become atomics; sums are therefore not deterministic
// and every comparison states a tolerance.
//
// Exclusions (kExcl): pair (p, q) is masked -- no LJ, no RF, nothing --
// when the component ids match and bit intra_q of B_p is set, decoded as
// parity(floor(B_p * 2^-intra_q)) from the f32 channels (_pair_tile:
// 205-222).  B < 2^12 and 2^-intra >= 2^-11, so every step of that test
// is exact in f32.  The bonded rf_add term adds back the RF part the
// reference keeps for excluded pairs; nothing is computed and subtracted.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false: the division is IEEE and the distance arithmetic rounds
// exactly as the plain PyTorch twin's, so both take the same cutoff
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

template <bool kCoulomb, bool kExcl>
__global__ void __launch_bounds__(1024)
cellpair_half_kernel(const float* __restrict__ slots,
                     const int* __restrict__ stencil,
                     const float* __restrict__ L8,
                     const int* __restrict__ counts,
                     const float* __restrict__ sigma,
                     const float* __restrict__ eps,
                     const float* __restrict__ shift,
                     float* __restrict__ out_p,
                     float* __restrict__ out_q,
                     float* __restrict__ out_cell,
                     int cap, int n_stencil, int T,
                     float krf, float crf, float keR) {
  extern __shared__ float smem[];
  float* qx = smem;              // q block, shifted into the p frame
  float* qy = qx + cap;
  float* qz = qy + cap;
  float* qq = qz + cap;          // charge
  float* qt = qq + cap;          // LJ type (exact small integer in f32)
  float* qv = qt + cap;          // valid
  float* qm = qv + cap;          // exclusion component id
  float* qw = qm + cap;          // 2^-(intra+1): the fraction of ex7
  float* aq = qw + cap;          // 4*cap q-side sums [fx fy fz pe]
  float* tab = aq + 4 * cap;     // 3*T*T [sigma eps shift]
  __shared__ float red[kMaxWarps][7];

  const int c = blockIdx.x;      // home cell (x: no 65,535 bound on a plan)
  const int s = blockIdx.y;      // stencil direction (0 = self block)
  const int i = threadIdx.x;     // p slot
  const int TT = T * T;

  const int* st = stencil + (static_cast<size_t>(c) * n_stencil + s) * 4;
  const int tgt = st[0];
  const float sx = static_cast<float>(st[1]) * L8[0];
  const float sy = static_cast<float>(st[2]) * L8[1];
  const float sz = static_cast<float>(st[3]) * L8[2];
  const float rcut2 = L8[3];
  // counts come from the caller: never let them index past the tile
  const int np = min(counts[c], cap);
  const int nq = min(counts[tgt], cap);
  // a block with no p or no q particle (an empty cell, or on an extended
  // grid a direction that reaches the sentinel) adds nothing, so the
  // whole CTA leaves before staging (np and nq are uniform over the block)
  if (np == 0 || nq == 0) return;

  const float* Q = slots + static_cast<size_t>(tgt) * kRec * cap;
  qx[i] = Q[i] + sx;
  qy[i] = Q[cap + i] + sy;
  qz[i] = Q[2 * cap + i] + sz;
  qq[i] = Q[3 * cap + i];
  qt[i] = Q[4 * cap + i];
  qv[i] = Q[5 * cap + i];
  if (kExcl) {
    qm[i] = Q[6 * cap + i];
    const float w7 = Q[7 * cap + i];
    qw[i] = w7 - floorf(w7);
  }
  aq[i] = 0.f;
  aq[cap + i] = 0.f;
  aq[2 * cap + i] = 0.f;
  aq[3 * cap + i] = 0.f;
  for (int k = i; k < TT; k += blockDim.x) {
    tab[k] = sigma[k];
    tab[TT + k] = eps[k];
    tab[2 * TT + k] = shift[k];
  }
  __syncthreads();

  float fx = 0.f, fy = 0.f, fz = 0.f, pe = 0.f, e = 0.f;
  float vxx = 0.f, vyy = 0.f, vzz = 0.f, vxy = 0.f, vxz = 0.f, vyz = 0.f;
  if (i < np && nq > 0) {
    const float* P = slots + static_cast<size_t>(c) * kRec * cap;
    const float px = P[i];
    const float py = P[cap + i];
    const float pz = P[2 * cap + i];
    const float pq = P[3 * cap + i];
    // T == 1 (uniform type): one parameter set whatever the type rows say
    const int prow = T == 1 ? 0 : static_cast<int>(P[4 * cap + i]) * T;
    const float pv = P[5 * cap + i];
    const float pm = kExcl ? P[6 * cap + i] : 0.f;
    const float pb = kExcl ? floorf(P[7 * cap + i]) : 0.f;   // B_p
    int j = i % nq;
    for (int k = 0; k < nq; ++k, j = (j + 1 == nq) ? 0 : j + 1) {
      if (s == 0 && j <= i) continue;   // self block: each pair once
      const float dx = px - qx[j];
      const float dy = py - qy[j];
      const float dz = pz - qz[j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (!(pv * qv[j] > 0.f) || !(d2 < rcut2)) continue;
      if (kExcl && pm == qm[j]) {
        const float t_bit = floorf(pb * (qw[j] + qw[j]));  // B_p / 2^intra_q
        if (t_bit - 2.0f * floorf(t_bit * 0.5f) > 0.5f) continue;
      }
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
      e += epair;
      vxx -= fdx * dx;
      vyy -= fdy * dy;
      vzz -= fdz * dz;
      vxy -= fdx * dy;
      vxz -= fdx * dz;
      vyz -= fdy * dz;
      atomicAdd(&aq[j], fdx);
      atomicAdd(&aq[cap + j], fdy);
      atomicAdd(&aq[2 * cap + j], fdz);
      atomicAdd(&aq[3 * cap + j], 0.5f * epair);
    }
    float* op = out_p + (static_cast<size_t>(c) * cap + i) * 4;
    atomicAdd(op, fx);
    atomicAdd(op + 1, fy);
    atomicAdd(op + 2, fz);
    atomicAdd(op + 3, pe);
  }
  __syncthreads();

  if (i < nq) {
    float* oq = out_q + static_cast<size_t>(tgt) * kRec * cap;
    atomicAdd(&oq[i], aq[i]);
    atomicAdd(&oq[cap + i], aq[cap + i]);
    atomicAdd(&oq[2 * cap + i], aq[2 * cap + i]);
    atomicAdd(&oq[3 * cap + i], aq[3 * cap + i]);
  }

  float vals[7] = {e, vxx, vyy, vzz, vxy, vxz, vyz};
  const int lane = i & 31;
  const int warp = i >> 5;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const float v = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (i < 7) {
    float t = 0.f;
    for (int w = 0; w < (blockDim.x >> 5); ++w) t += red[w][i];
    atomicAdd(&out_cell[static_cast<size_t>(c) * 8 + i], t);
  }
}

template <bool kCoulomb, bool kExcl>
cudaError_t launch(const float* slots, const int* stencil, const float* L8,
                   const int* counts, const float* sigma, const float* eps,
                   const float* shift, float* out_p, float* out_q,
                   float* out_cell, int ncell, int cap, int n_stencil, int T,
                   float krf, float crf, float keR, cudaStream_t stream) {
  const size_t smem =
      (12 * static_cast<size_t>(cap) + 3 * static_cast<size_t>(T) * T) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cellpair_half_kernel<kCoulomb, kExcl>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ncell, n_stencil);
  cellpair_half_kernel<kCoulomb, kExcl><<<grid, cap, smem, stream>>>(
      slots, stencil, L8, counts, sigma, eps, shift, out_p, out_q, out_cell,
      cap, n_stencil, T, krf, crf, keR);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Returns the cudaError_t of the launch
// (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int ddcmd_cellpair_half(const float* slots, const int* stencil,
                                   const float* L8, const int* counts,
                                   const float* sigma, const float* eps,
                                   const float* shift, float* out_p,
                                   float* out_q, float* out_cell, int ncell,
                                   int cap, int n_stencil, int T, float krf,
                                   float crf, float keR, int coulomb,
                                   int excl, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return fn(slots, stencil, L8, counts, sigma, eps, shift, out_p, out_q,
              out_cell, ncell, cap, n_stencil, T, krf, crf, keR, st);
  };
  cudaError_t err;
  if (coulomb)
    err = excl ? go(launch<true, true>) : go(launch<true, false>);
  else
    err = excl ? go(launch<false, true>) : go(launch<false, false>);
  return static_cast<int>(err);
}

// The sweep on a brick's EXTENDED cell grid (replaces the TPU kernel
// ddcmd_tpu/parallel/pallas_shard.py:make_shard_pallas_kernel, which runs
// _kernel_half verbatim over the core cells): programs over the n_prog
// core cells only, slot space over n_slot = n_prog + halo shell + 1
// sentinel cells.  Contract as above except
//   slots    (n_slot, 8, cap); core cells first, halo shell, sentinel last
//   stencil  (n_prog, S*4); a direction that leaves the grid on an open
//            axis points at the sentinel, whose count is 0
//   counts   (n_slot,) -- every slot cell's occupancy, halo cells
//            included, since the q sweep is trimmed with counts[tgt]
//   out_p    (n_prog*cap, 4); out_q (n_slot, 8, cap); out_cell (n_prog, 8)
// The device code indexes p by its program cell and q by the stencil
// target, so this is the per-cell launch with n_prog rows of programs;
// what is new is the contract that the q side spans n_slot cells.  The
// CTAs whose direction reaches the sentinel (count 0) leave at once, so
// the sentinel's out_q rows stay exactly 0.  What bounds it is the
// per-cell kernel's: the shared-memory distance test over every
// candidate pair of a live block.
extern "C" int ddcmd_cellpair_half_ext(const float* slots, const int* stencil,
                                       const float* L8, const int* counts,
                                       const float* sigma, const float* eps,
                                       const float* shift, float* out_p,
                                       float* out_q, float* out_cell,
                                       int n_prog, int n_slot, int cap,
                                       int n_stencil, int T, float krf,
                                       float crf, float keR, int coulomb,
                                       int excl, void* stream) {
  if (n_prog > n_slot) return static_cast<int>(cudaErrorInvalidValue);
  return ddcmd_cellpair_half(slots, stencil, L8, counts, sigma, eps, shift,
                             out_p, out_q, out_cell, n_prog, cap, n_stencil,
                             T, krf, crf, keR, coulomb, excl, stream);
}
