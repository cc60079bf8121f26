// Two-pass EAM on the half stencil (Newton's third law), one cell per
// CTA row: pass A (density) and pass B (force) for the analytic forms
// FS / SC / EXP / AT / RATIONAL, alloys of 1-4 species.
//
// Replaces the TPU kernels ddcmd_tpu/ops/pallas_eam.py:_rho_kernel (pass
// A) and _force_kernel (pass B), with their tile math (_geometry,
// _pair_tile bcast variant, _force_virial, _typed_pair_sums).  Contract:
//   slots    (ncell, 8, cap) f32, rows [x y z q type valid dF 0],
//            cell-centred coordinates, cells filled rank-contiguously;
//            type = species index, valid carries the particle mask, and
//            row 6 holds dF(rho) for pass B (ops/eam_half.py:eam_eval_half)
//   stencil  (ncell, S*4) int32 [cell dx dy dz]*S, self block first
//   L8       8 f32 [L/n (3), rcut^2, 0...]
//   counts   (ncell,) int32 per-cell occupancy
//   params   (T*T, npar) f32, row t_p*T + t_q (csrc/eam_forms.cuh)
// Outputs (zeroed by the caller, accumulated here):
//   pass A: out_p (ncell*cap, 2) p-side [rho pe]; out_q (ncell, 8, cap)
//           q-side rows [rho pe 0...]
//   pass B: out_p (ncell*cap, 3) p-side force; out_q (ncell, 8, cap)
//           q-side reaction rows [fx fy fz 0...]; out_cell (ncell, 8)
//           [vxx vyy vzz vxy vxz vyz 0 0], each pair once
// A pair (p, q) is valid when both slots are valid and 0 < d2 < rcut^2
// (RATIONAL adds its per-fit r^2 cutoffs); the self block takes j > i
// only.  Pass A adds rho(t_p, t_q)(r) to p and the transposed
// rho(t_q, t_p)(r) to q, and half the pair energy to each side; pass B
// uses coef = dphi + dF_p drho(t_p, t_q) + dF_q drho(t_q, t_p), the
// asymmetric-alloy combine (eam.c:166-190), with force -coef*d on p and
// +coef*d on q.
//
// Launch shape: as csrc/cellpair_half.cu, one CTA per (stencil direction,
// home cell), cap threads, thread i owns p-slot i.  The CTA stages its q
// block (shifted into the home cell's frame, plus dF in pass B) and the
// parameter table in shared memory, sweeps j < counts[tgt] from a
// per-thread start (j = i + k mod nq), keeps the p side in registers and
// accumulates the q side in shared memory with atomics; both then go to
// global memory with atomicAdd.  The TPU kernels' in-order q-side
// read-modify-write (race-free only because the TPU grid is sequential)
// and their alias groups become these atomics, so sums are not
// deterministic and every comparison states a tolerance.
//
// What bounds it on an H100: at the copper crystal's shapes (fcc at
// a = 3.615 A, rcut 5.5 A, 100 cells of ~69 atoms at cap 128) a p atom
// meets ~970 candidates in its 14 blocks and ~27 of them lie inside the
// cutoff, so, as for the LJ kernel, the shared-memory reads and compare
// of the distance test over every candidate bound the sweep; the form
// arithmetic (exp/log/pow, or two rational Horner sums; twice for the
// transposed density of an alloy) and the q-side shared atomics run for
// the ~3% inside.  The slots (100 cells x 4 KB) stay in L2.  Occupancy
// trimming (loop bounds from counts) removes the padded part of the
// cap^2 tile exactly.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false, so the distance arithmetic and the cutoff decisions
// match the plain PyTorch twin.

#include <cuda_runtime.h>

#include "eam_forms.cuh"

namespace {

constexpr int kRec = 8;        // record rows per slot
constexpr int kMaxWarps = 32;  // cap <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int kForm, bool kForce>
__global__ void __launch_bounds__(1024)
eam_half_kernel(const float* __restrict__ slots,
                const int* __restrict__ stencil,
                const float* __restrict__ L8,
                const int* __restrict__ counts,
                const float* __restrict__ params,
                float* __restrict__ out_p,
                float* __restrict__ out_q,
                float* __restrict__ out_cell,
                int cap, int n_stencil, int T, int npar, int D) {
  constexpr int kRows = kForce ? 6 : 5;   // staged: x y z type valid [dF]
  constexpr int kAcc = kForce ? 3 : 2;    // q side: [fx fy fz] or [rho pe]
  extern __shared__ float smem[];
  float* qx = smem;              // q block, shifted into the p frame
  float* qy = qx + cap;
  float* qz = qy + cap;
  float* qt = qz + cap;          // species index (exact small integer)
  float* qv = qt + cap;          // valid
  float* qf = qv + cap;          // dF (pass B)
  float* aq = smem + kRows * cap;
  float* tab = aq + kAcc * cap;  // T*T*npar parameter rows
  __shared__ float red[kMaxWarps][6];

  const int s = blockIdx.x;      // stencil direction (0 = self block)
  const int c = blockIdx.y;      // home cell
  const int i = threadIdx.x;     // p slot

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
  // grid a direction that reaches the sentinel) adds nothing; the CTA
  // leaves before staging (np and nq are uniform over the block)
  if (np == 0 || nq == 0) return;

  const float* Q = slots + static_cast<size_t>(tgt) * kRec * cap;
  qx[i] = Q[i] + sx;
  qy[i] = Q[cap + i] + sy;
  qz[i] = Q[2 * cap + i] + sz;
  qt[i] = Q[4 * cap + i];
  qv[i] = Q[5 * cap + i];
  if (kForce) qf[i] = Q[6 * cap + i];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) aq[k * cap + i] = 0.f;
  for (int k = i; k < T * T * npar; k += blockDim.x) tab[k] = params[k];
  __syncthreads();

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;   // p side: [rho pe] or [fx fy fz]
  float vxx = 0.f, vyy = 0.f, vzz = 0.f, vxy = 0.f, vxz = 0.f, vyz = 0.f;
  if (i < np && nq > 0) {
    const float* P = slots + static_cast<size_t>(c) * kRec * cap;
    const float px = P[i];
    const float py = P[cap + i];
    const float pz = P[2 * cap + i];
    const int tp = T == 1 ? 0 : static_cast<int>(P[4 * cap + i]);
    const float pv = P[5 * cap + i];
    const float dFp = kForce ? P[6 * cap + i] : 0.f;
    const float* prow = tab + tp * T * npar;   // rows (t_p, *)
    int j = i % nq;
    for (int k = 0; k < nq; ++k, j = (j + 1 == nq) ? 0 : j + 1) {
      if (s == 0 && j <= i) continue;   // self block: each pair once
      const float dx = px - qx[j];
      const float dy = py - qy[j];
      const float dz = pz - qz[j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (!(pv * qv[j] > 0.f) || !(d2 < rcut2) || !(d2 > 0.f)) continue;
      const float ir = 1.0f / sqrtf(d2);
      const float ir2 = 1.0f / d2;
      const int tq = T == 1 ? 0 : static_cast<int>(qt[j]);
      float e, p;
      eam::pair_eval<kForm, kForce>(prow + tq * npar, D, d2, ir, ir2, e, p);
      float pT = p;                     // density term on the q side
      if (tq != tp) {
        float eT;
        eam::pair_eval<kForm, kForce>(tab + (tq * T + tp) * npar, D, d2, ir,
                                      ir2, eT, pT);
      }
      if (!kForce) {
        a0 += p;
        a1 += 0.5f * e;
        atomicAdd(&aq[j], pT);
        atomicAdd(&aq[cap + j], 0.5f * e);
      } else {
        const float coef = e + dFp * p + qf[j] * pT;
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
        atomicAdd(&aq[j], fdx);
        atomicAdd(&aq[cap + j], fdy);
        atomicAdd(&aq[2 * cap + j], fdz);
      }
    }
    float* op = out_p + (static_cast<size_t>(c) * cap + i) * kAcc;
    atomicAdd(op, a0);
    atomicAdd(op + 1, a1);
    if (kForce) atomicAdd(op + 2, a2);
  }
  __syncthreads();

  if (i < nq) {
    float* oq = out_q + static_cast<size_t>(tgt) * kRec * cap;
#pragma unroll
    for (int k = 0; k < kAcc; ++k) atomicAdd(&oq[k * cap + i], aq[k * cap + i]);
  }

  if (kForce) {
    float vals[6] = {vxx, vyy, vzz, vxy, vxz, vyz};
    const int lane = i & 31;
    const int warp = i >> 5;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float v = warp_sum(vals[k]);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (i < 6) {
      float t = 0.f;
      for (int w = 0; w < (blockDim.x >> 5); ++w) t += red[w][i];
      atomicAdd(&out_cell[static_cast<size_t>(c) * 8 + i], t);
    }
  }
}

template <int kForm, bool kForce>
cudaError_t launch(const float* slots, const int* stencil, const float* L8,
                   const int* counts, const float* params, float* out_p,
                   float* out_q, float* out_cell, int ncell, int cap,
                   int n_stencil, int T, int npar, int D,
                   cudaStream_t stream) {
  const size_t smem = ((kForce ? 9 : 7) * static_cast<size_t>(cap) +
                       static_cast<size_t>(T) * T * npar) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        eam_half_kernel<kForm, kForce>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_stencil, ncell);
  eam_half_kernel<kForm, kForce><<<grid, cap, smem, stream>>>(
      slots, stencil, L8, counts, params, out_p, out_q, out_cell, cap,
      n_stencil, T, npar, D);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const int*, const float*,
                                 const int*, const float*, float*, float*,
                                 float*, int, int, int, int, int, int,
                                 cudaStream_t);

// [form][pass]: eam::Form order, pass 0 = density, 1 = force
constexpr LaunchFn kLaunch[5][2] = {
    {launch<eam::kFS, false>, launch<eam::kFS, true>},
    {launch<eam::kSC, false>, launch<eam::kSC, true>},
    {launch<eam::kEXP, false>, launch<eam::kEXP, true>},
    {launch<eam::kAT, false>, launch<eam::kAT, true>},
    {launch<eam::kRational, false>, launch<eam::kRational, true>}};

}  // namespace

// Plain C entry point for ctypes: form is an eam::Form, force selects
// pass B (out_cell is unused in pass A).  Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int ddcmd_eam_half(const float* slots, const int* stencil,
                              const float* L8, const int* counts,
                              const float* params, float* out_p, float* out_q,
                              float* out_cell, int ncell, int cap,
                              int n_stencil, int T, int npar, int degree,
                              int form, int force, void* stream) {
  if (form < 0 || form > 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunch[form][force ? 1 : 0](
      slots, stencil, L8, counts, params, out_p, out_q, out_cell, ncell, cap,
      n_stencil, T, npar, degree, static_cast<cudaStream_t>(stream)));
}

// The two passes on a brick's EXTENDED cell grid (replace the TPU kernels
// ddcmd_tpu/parallel/pallas_shard.py:make_shard_eam_kernels, which run
// _rho_kernel / _force_kernel verbatim over the core cells): programs
// over the n_prog core cells only, slot space over n_slot = n_prog + halo
// shell + 1 sentinel cells.  Contract as ddcmd_eam_half except
//   slots    (n_slot, 8, cap); core cells first, halo shell, sentinel last
//   stencil  (n_prog, S*4); out-of-grid directions point at the sentinel
//   counts   (n_slot,) -- every slot cell's occupancy (sentinel 0)
//   out_p    (n_prog*cap, 2|3); out_q (n_slot, 8, cap); out_cell (n_prog, 8)
// p is indexed by the program cell and q by the stencil target, so these
// are the per-cell launches with n_prog rows of programs; the CTAs whose
// direction reaches the sentinel (count 0) leave at once, so its out_q
// rows stay exactly 0.
// The q-side shares that land in halo cells are the caller's to reduce
// home (parallel/brick.halo_reduce_3d).  Bound as the per-cell passes: the
// shared-memory distance test over every candidate pair.
extern "C" int ddcmd_eam_rho_half_ext(const float* slots, const int* stencil,
                                      const float* L8, const int* counts,
                                      const float* params, float* out_p,
                                      float* out_q, int n_prog, int n_slot,
                                      int cap, int n_stencil, int T, int npar,
                                      int degree, int form, void* stream) {
  if (n_prog > n_slot) return static_cast<int>(cudaErrorInvalidValue);
  return ddcmd_eam_half(slots, stencil, L8, counts, params, out_p, out_q,
                        nullptr, n_prog, cap, n_stencil, T, npar, degree,
                        form, 0, stream);
}

extern "C" int ddcmd_eam_force_half_ext(const float* slots,
                                        const int* stencil, const float* L8,
                                        const int* counts,
                                        const float* params, float* out_p,
                                        float* out_q, float* out_cell,
                                        int n_prog, int n_slot, int cap,
                                        int n_stencil, int T, int npar,
                                        int degree, int form, void* stream) {
  if (n_prog > n_slot) return static_cast<int>(cudaErrorInvalidValue);
  return ddcmd_eam_half(slots, stencil, L8, counts, params, out_p, out_q,
                        out_cell, n_prog, cap, n_stencil, T, npar, degree,
                        form, 1, stream);
}
