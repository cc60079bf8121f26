// Two-pass EAM on the half stencil (Newton's third law), per cell: pass A
// (density) and pass B (force) for the analytic forms FS / SC / EXP / AT /
// RATIONAL and the shifted RATIONAL of a tabularFit=rational refit,
// alloys of 1-4 species.
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
// Launch shape: one CTA of kThreads threads per (home cell, group of
// stencil directions), the cell on blockIdx.x (so a plan may hold more
// than 65,535 cells) and the group on blockIdx.y.  The CTA stages the
// home cell and its group's q blocks once, pruned to the atoms that can
// have a partner, its warps sweep (direction, p tile, q chunk) items
// with the two-phase body of csrc/sweep.cuh (the EAM hit evaluator in
// csrc/eam_sweep.cuh), and the sums leave
// shared memory once: the p side with a plain store when the CTA holds
// all directions of its cell (one group), else with atomicAdd; the q
// side with one atomicAdd per live slot of each target cell (other cells
// add to the same rows).  The host picks the group size: as many
// directions as fit in kSmemBudget bytes of shared memory (4 at cap 128,
// so ~9 CTAs share an SM), fewer when the grid has too few cells to give
// each SM of the card kFillCtasPerSm CTAs.  A CTA whose home cell is
// empty leaves at once and a direction whose target is empty (on an
// extended grid: the sentinel) stages and adds nothing, so such out_q rows
// stay exactly 0.
// The TPU kernels' in-order q-side read-modify-write (race-free only
// because the TPU grid is sequential) and their alias groups become
// atomics, so sums are not deterministic and every comparison states a
// tolerance.
//
// What bounds it on an H100, and what the design does about it: see
// csrc/sweep.cuh.  Operations, not bytes (the crystal's slots stay in
// L2): of the ~970 candidates a p atom has in its 14 blocks the box
// pruning leaves about a quarter to the distance test, and what then
// weighs most is phase 2's shared-memory float atomics (compare-and-swap
// loops on this card) and the staging, both a matter of latency that the
// many small CTAs an SM hide.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false, so the distance arithmetic and the cutoff decisions
// match the plain PyTorch twin.

#include <cuda_runtime.h>

#include "eam_sweep.cuh"

namespace {

using eam::kRec;

constexpr int kThreads = 128;   // CTA size: 4 warps

// shared memory a CTA aims to stay under, so that several share an SM
constexpr int kSmemBudget = 24 * 1024;
// CTAs the grid should hold at least for each SM of the card, else the
// directions of a cell are spread over more CTAs
constexpr int kFillCtasPerSm = 4;

template <int kForm, bool kForce>
__global__ void __launch_bounds__(kThreads)
eam_half_kernel(const float* __restrict__ slots,
                const int* __restrict__ stencil,
                const float* __restrict__ L8,
                const int* __restrict__ counts,
                const float* __restrict__ params,
                float* __restrict__ out_p,
                float* __restrict__ out_q,
                float* __restrict__ out_cell,
                int cap, int n_stencil, int T, int npar, int D, int dg) {
  constexpr int kAcc = kForce ? 3 : 2;    // [fx fy fz] or [rho pe]
  extern __shared__ __align__(16) unsigned char smem[];

  const int c = blockIdx.x;               // home cell
  const int s0 = blockIdx.y * dg;         // first stencil direction
  const int nd = min(dg, n_stencil - s0);
  const int t = threadIdx.x;
  // counts come from the caller: never let them index past the tile
  const int np = min(counts[c], cap);
  // an empty home cell adds nothing: the CTA leaves before staging
  if (np == 0) return;

  const int ntab = T * T * npar;
  const sweep::Layout lay =
      eam::make_layout(cap, dg, dg, ntab, kForce, kThreads / 32);
  const sweep::View v = sweep::make_view(smem, lay, dg, dg);
  const eam::Hit<kForm, kForce> f{T, npar, D};
  __shared__ float pbox[kThreads / 32][6];
  if (t < nd) {
    const int* st = stencil + (static_cast<size_t>(c) * n_stencil + s0 + t) * 4;
    v.dtgt[t] = st[0];
    v.dcnt[t] = min(counts[st[0]], cap);
    v.dblk[t] = t;
    v.dsh[3 * t] = static_cast<float>(st[1]) * L8[0];
    v.dsh[3 * t + 1] = static_cast<float>(st[2]) * L8[1];
    v.dsh[3 * t + 2] = static_cast<float>(st[3]) * L8[2];
  }
  if (t == 0) *v.next = 0;
  for (int k = t; k < ntab; k += kThreads) v.tab[k] = params[k];
  sweep::stage_home(v, f, slots + static_cast<size_t>(c) * kRec * cap, cap,
                    np, pbox);
  __syncthreads();
  for (int idx = t; idx < nd * cap; idx += kThreads) {
    const int d = idx / cap;
    const int j = idx - d * cap;
    if (j >= v.dcnt[d]) continue;
#pragma unroll
    for (int k = 0; k < kAcc; ++k) v.aq[(d * kAcc + k) * cap + j] = 0.f;
  }
  const float rcut2 = L8[3];
  // the self block is stencil direction 0
  const int dself = s0 == 0 ? 0 : -1;
  sweep::stage_dirs(v, f, slots, cap, np, nd, dself,
                    sqrtf(rcut2) * sweep::kBoxSlack, pbox);
  __syncthreads();

  float vir[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  sweep::sweep(v, f, cap, nd, dself, rcut2, vir);
  __syncthreads();

  const bool whole = gridDim.y == 1;      // this CTA holds the whole cell
  for (int idx = t; idx < np * kAcc; idx += kThreads) {
    const int i = idx / kAcc;
    const int k = idx - i * kAcc;
    float* o = out_p + (static_cast<size_t>(c) * cap + i) * kAcc + k;
    if (whole)
      *o = v.ap[k * cap + i];
    else
      atomicAdd(o, v.ap[k * cap + i]);
  }
  for (int idx = t; idx < nd * cap; idx += kThreads) {
    const int d = idx / cap;
    const int j = idx - d * cap;
    if (j >= v.dcnt[d]) continue;
    float* oq = out_q + static_cast<size_t>(v.dtgt[d]) * kRec * cap + j;
#pragma unroll
    for (int k = 0; k < kAcc; ++k)
      atomicAdd(&oq[k * cap], v.aq[(d * kAcc + k) * cap + j]);
  }
  if (kForce)
    sweep::reduce_sums<false>(vir, out_cell + static_cast<size_t>(c) * 8);
}

template <int kForm, bool kForce>
cudaError_t launch(const float* slots, const int* stencil, const float* L8,
                   const int* counts, const float* params, float* out_p,
                   float* out_q, float* out_cell, int ncell, int cap,
                   int n_stencil, int T, int npar, int D,
                   cudaStream_t stream) {
  if (ncell < 1 || n_stencil < 1 || cap < 32 || cap > eam::kMaxCap ||
      cap % 32)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int ntab = T * T * npar;
  auto bytes = [&](int nd) {
    return eam::make_layout(cap, nd, nd, ntab, kForce, kThreads / 32).bytes;
  };
  // directions a CTA: all that fit in the budget (at least one) ...
  int fit = n_stencil < eam::kMaxDirs ? n_stencil : eam::kMaxDirs;
  while (fit > 1 && bytes(fit) > kSmemBudget) --fit;
  if (bytes(fit) > eam::kSmemMax) return cudaErrorInvalidValue;
  // ... spread over more CTAs when the grid has few cells
  const int want = (kFillCtasPerSm * sms + ncell - 1) / ncell;
  int groups = (n_stencil + fit - 1) / fit;
  if (groups < want) groups = want < n_stencil ? want : n_stencil;
  const int dg = (n_stencil + groups - 1) / groups;
  groups = (n_stencil + dg - 1) / dg;
  const int smem = bytes(dg);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(eam_half_kernel<kForm, kForce>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ncell, groups);
  eam_half_kernel<kForm, kForce><<<grid, kThreads, smem, stream>>>(
      slots, stencil, L8, counts, params, out_p, out_q, out_cell, cap,
      n_stencil, T, npar, D, dg);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const int*, const float*,
                                 const int*, const float*, float*, float*,
                                 float*, int, int, int, int, int, int,
                                 cudaStream_t);

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
// pass B (out_cell is unused in pass A).  Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int ddcmd_eam_half(const float* slots, const int* stencil,
                              const float* L8, const int* counts,
                              const float* params, float* out_p, float* out_q,
                              float* out_cell, int ncell, int cap,
                              int n_stencil, int T, int npar, int degree,
                              int form, int force, void* stream) {
  if (form < 0 || form > 5) return static_cast<int>(cudaErrorInvalidValue);
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
// are the per-cell launches with n_prog cells of programs; a direction
// that reaches the sentinel (count 0) stages and adds nothing, so its out_q
// rows stay exactly 0.
// The q-side shares that land in halo cells are the caller's to reduce
// home (parallel/brick.halo_reduce_3d).  Bound as the per-cell passes: the
// distance test over every candidate pair (csrc/sweep.cuh).
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
