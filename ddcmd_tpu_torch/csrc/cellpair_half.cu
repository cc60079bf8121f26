// Half-stencil (Newton's third law) cell-pair kernels: shifted LJ plus
// optional reaction-field Coulomb, for the Martini/PAIR nonbond term,
// optionally with in-kernel bonded-pair exclusions.  One device body, three
// entry points: per cell (ddcmd_cellpair_half), on a brick's extended grid
// (ddcmd_cellpair_half_ext) and over column tables
// (ddcmd_cellpair_half_col).
//
// ddcmd_cellpair_half replaces the TPU kernel
// ddcmd_tpu/ops/pallas_cellpair.py:_kernel_half (tile math in _pair_tile,
// bcast variant).  Record contract:
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
// Which pairs count, and the exact in-kernel exclusion test: see
// csrc/pair_hit.cuh.  The bonded rf_add term adds back the RF part the
// reference keeps for excluded pairs; nothing is computed and subtracted.
//
// Launch shape: one CTA of kThreads threads per (home cell, group of
// stencil directions), the cell on blockIdx.x (so a plan may hold more
// than 65,535 cells) and the group on blockIdx.y.  The CTA stages the
// home cell and its group's q blocks once, pruned to the particles that
// can have a partner, its warps sweep (direction, p tile, q chunk) items
// with the two-phase body of csrc/sweep.cuh and the pair hit evaluator of
// csrc/pair_hit.cuh, and the sums leave shared memory once: the p side
// with a plain store when the CTA holds all directions of its cell (one
// group), else with one atomicAdd per live slot and value; the q side
// with one atomicAdd per kept q slot and value (the self block: every
// live slot), since other CTAs add to the same rows.  The host picks the
// group size: as many directions as fit in kSmemBudget bytes of shared
// memory, fewer when the grid has too few cells to give each SM of the
// card kFillCtasPerSm CTAs (the water box's 80 cells take 14 CTAs a
// cell, a direction each; the bilayer's 1,200 four).  A CTA whose home cell is empty leaves at
// once and a direction whose target is empty (on an extended grid: the
// sentinel) stages and adds nothing, so such out_q rows stay exactly 0.
// The TPU kernel's in-order q-side read-modify-write (race-free only
// because the TPU grid runs in sequence) and its merge of aliased
// periodic images become atomics, so sums are not deterministic and every
// comparison states a tolerance.
//
// What bounds it on an H100, and what the design does about it: see
// csrc/sweep.cuh.  Operations, not bytes (the slots stay in L2): of the
// ~1,100 candidates a p bead has in its 14 blocks the box pruning leaves
// about a quarter to the distance test, and what then weighs most is
// phase 2's eight shared-memory float atomics a hit and the staging, both
// a matter of latency that the many small CTAs an SM hide.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// --fmad=false: the division is IEEE and the distance arithmetic rounds
// exactly as the plain PyTorch twin's, so both take the same cutoff
// decision for every pair.

#include <cuda_runtime.h>

#include "pair_hit.cuh"

namespace {

using sweep::kDirsN;
using sweep::kHalfDirs;
using sweep::kRec;

constexpr int kThreads = 128;   // CTA size: 4 warps

// shared memory a CTA aims to stay under, so that several share an SM
constexpr int kSmemBudget = 32 * 1024;
// CTAs the grid should hold at least for each SM of the card, else the
// directions of a cell are spread over more CTAs (8: the water box's
// kernel took 35.2 us of device time, against 40.0 at 4, on an H100 80GB
// HBM3 at 700 W; PERF.md)
constexpr int kFillCtasPerSm = 8;

// Where a CTA's directions come from: the per-cell stencil rows [cell dx
// dy dz]*S, the image shift d * L/n ...
struct StencilDirs {
  const int* stencil;
  int n_stencil;
  __device__ __forceinline__ int sums_row(int c) const { return c; }
  __device__ __forceinline__ void get(int c, int s, const float* L8,
                                      int& tgt, float (&sh)[3]) const {
    const int* st = stencil + (static_cast<size_t>(c) * n_stencil + s) * 4;
    tgt = st[0];
#pragma unroll
    for (int a = 0; a < 3; ++a) sh[a] = static_cast<float>(st[1 + a]) * L8[a];
  }
};

// ... or the column tables: cell c is member g = c % G of column c / G,
// its s-th block the union block member_u[g][s] of that column, shifted
// by the static direction kHalfDirs[s] * L/n; the column's [e, virial6]
// is one row
struct ColumnDirs {
  const int* stencil_col;
  const int* member_u;
  int G, U;
  __device__ __forceinline__ int sums_row(int c) const { return c / G; }
  __device__ __forceinline__ void get(int c, int s, const float* L8,
                                      int& tgt, float (&sh)[3]) const {
    const int col = c / G;
    const int u = member_u[(c - col * G) * kDirsN + s];
    tgt = stencil_col[static_cast<size_t>(col) * U + u];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      sh[a] = static_cast<float>(kHalfDirs[s][a]) * L8[a];
  }
};

template <bool kCoulomb, bool kExcl, class Dirs>
__global__ void __launch_bounds__(kThreads)
cellpair_half_kernel(const float* __restrict__ slots, Dirs dirs,
                     const float* __restrict__ L8,
                     const int* __restrict__ counts,
                     const float* __restrict__ sigma,
                     const float* __restrict__ eps,
                     const float* __restrict__ shift,
                     float* __restrict__ out_p,
                     float* __restrict__ out_q,
                     float* __restrict__ out_sums,
                     int cap, int n_stencil, int T,
                     float krf, float crf, float keR, int dg) {
  using Hit = ljpair::Hit<kCoulomb, kExcl>;
  constexpr int kAcc = Hit::kAcc;
  extern __shared__ __align__(16) unsigned char smem[];

  const int c = blockIdx.x;               // home cell
  const int s0 = blockIdx.y * dg;         // first stencil direction
  const int nd = min(dg, n_stencil - s0);
  const int t = threadIdx.x;
  // counts come from the caller: never let them index past the tile
  const int np = min(counts[c], cap);
  // an empty home cell adds nothing: the CTA leaves before staging
  if (np == 0) return;

  const int TT = T * T;
  const sweep::Layout lay =
      ljpair::make_layout(cap, dg, dg, T, kExcl, kThreads / 32);
  const sweep::View v = sweep::make_view(smem, lay, dg, dg);
  const Hit f{T, TT, krf, crf, keR};
  __shared__ float pbox[kThreads / 32][6];
  if (t < nd) {
    int tgt;
    float sh[3];
    dirs.get(c, s0 + t, L8, tgt, sh);
    v.dtgt[t] = tgt;
    v.dcnt[t] = min(counts[tgt], cap);
    v.dblk[t] = t;
#pragma unroll
    for (int a = 0; a < 3; ++a) v.dsh[3 * t + a] = sh[a];
  }
  if (t == 0) *v.next = 0;
  for (int k = t; k < TT; k += kThreads) {
    v.tab[k] = sigma[k];
    v.tab[TT + k] = eps[k];
    v.tab[2 * TT + k] = shift[k];
  }
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

  float sums[Hit::kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  sweep::sweep(v, f, cap, nd, dself, rcut2, sums);
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
  // the q side of the kept entries only: no other q slot has a partner
  for (int idx = t; idx < nd * cap; idx += kThreads) {
    const int d = idx / cap;
    const int pos = idx - d * cap;
    if (pos >= v.dnq[d]) continue;        // the self block: its live slots
    const int j = d == dself ? pos : Hit::slot_of(v.q4[d * cap + pos].w);
    float* oq = out_q + static_cast<size_t>(v.dtgt[d]) * kRec * cap + j;
#pragma unroll
    for (int k = 0; k < kAcc; ++k)
      atomicAdd(&oq[k * cap], v.aq[(d * kAcc + k) * cap + j]);
  }
  sweep::reduce_sums<false>(
      sums, out_sums + static_cast<size_t>(dirs.sums_row(c)) * 8);
}

template <bool kCoulomb, bool kExcl, class Dirs>
cudaError_t launch(const float* slots, Dirs dirs, const float* L8,
                   const int* counts, const float* sigma, const float* eps,
                   const float* shift, float* out_p, float* out_q,
                   float* out_sums, int ncell, int cap, int n_stencil, int T,
                   float krf, float crf, float keR, cudaStream_t stream) {
  if (ncell < 1 || n_stencil < 1 || T < 1 || cap < 32 ||
      cap > sweep::kMaxCap || cap % 32)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  auto bytes = [&](int nd) {
    return ljpair::make_layout(cap, nd, nd, T, kExcl, kThreads / 32).bytes;
  };
  // directions a CTA: all that fit in the budget (at least one) ...
  int fit = n_stencil < sweep::kMaxDirs ? n_stencil : sweep::kMaxDirs;
  while (fit > 1 && bytes(fit) > kSmemBudget) --fit;
  if (bytes(fit) > sweep::kSmemMax) return cudaErrorInvalidValue;
  // ... spread over more CTAs when the grid has few cells
  const int want = (kFillCtasPerSm * sms + ncell - 1) / ncell;
  int groups = (n_stencil + fit - 1) / fit;
  if (groups < want) groups = want < n_stencil ? want : n_stencil;
  const int dg = (n_stencil + groups - 1) / groups;
  groups = (n_stencil + dg - 1) / dg;
  const int smem = bytes(dg);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cellpair_half_kernel<kCoulomb, kExcl, Dirs>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ncell, groups);
  cellpair_half_kernel<kCoulomb, kExcl, Dirs><<<grid, kThreads, smem, stream>>>(
      slots, dirs, L8, counts, sigma, eps, shift, out_p, out_q, out_sums,
      cap, n_stencil, T, krf, crf, keR, dg);
  return cudaGetLastError();
}

template <class Dirs>
cudaError_t launch_any(int coulomb, int excl, const float* slots, Dirs dirs,
                       const float* L8, const int* counts, const float* sigma,
                       const float* eps, const float* shift, float* out_p,
                       float* out_q, float* out_sums, int ncell, int cap,
                       int n_stencil, int T, float krf, float crf, float keR,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return fn(slots, dirs, L8, counts, sigma, eps, shift, out_p, out_q,
              out_sums, ncell, cap, n_stencil, T, krf, crf, keR, st);
  };
  if (coulomb)
    return excl ? go(launch<true, true, Dirs>) : go(launch<true, false, Dirs>);
  return excl ? go(launch<false, true, Dirs>) : go(launch<false, false, Dirs>);
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
  return static_cast<int>(launch_any(
      coulomb, excl, slots, StencilDirs{stencil, n_stencil}, L8, counts,
      sigma, eps, shift, out_p, out_q, out_cell, ncell, cap, n_stencil, T,
      krf, crf, keR, stream));
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
//            included, since the q side is staged from counts[tgt]
//   out_p    (n_prog*cap, 4); out_q (n_slot, 8, cap); out_cell (n_prog, 8)
// The device code indexes p by its program cell and q by the stencil
// target, so this is the per-cell launch with n_prog cells of programs;
// what is new is the contract that the q side spans n_slot cells.  A
// direction that reaches the sentinel (count 0) stages and adds nothing,
// so the sentinel's out_q rows stay exactly 0.  Bound as the per-cell
// kernel: the distance test over every candidate pair the pruning keeps
// (csrc/sweep.cuh).
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

// The sweep over COLUMN tables (replaces the TPU kernel
// ddcmd_tpu/ops/pallas_cellpair.py:_kernel_half_col, the tile math of
// _kernel_half over G z-contiguous cells sharing a union of U blocks).
// Contract as ddcmd_cellpair_half except
//   stencil_col (ncol, U) int32: the U union blocks of column c (cells
//               pairwise distinct within a column; ops/cellpair_half.py:
//               pack_stencil_col); the members of column c are the cells
//               c*G .. c*G+G-1
//   member_u    (G, 14) int32: union index of member g's s-th half-stencil
//               block, shifted by the static direction kHalfDirs[s] *
//               L/ncells (col_plan_grid)
//   out_col     (ncol, 8) [e vxx vyy vzz vxy vxz vyz 0], each pair once
// The TPU kernel stages the union once per column, saving its DMA; here
// the slots stay in L2 and a column is G cells of the per-cell launch,
// each (member, group of directions) a CTA that reads its blocks through
// the tables.  The union-staging design (one CTA a column, the union's
// q-side sums in shared memory, each member staged and swept in rounds
// of seven directions) measured 190 us on the full bilayer's slots
// against 118 for this launch (H100 80GB HBM3, 700 W; PERF.md):
// the bilayer's 240 columns are 240 CTAs, one partial wave, whose phase-2
// shared atomics 16 warps an SM hide worse than the per-cell grid's.
// Periodic aliasing (nz == G) needs nothing more: two directions of a
// member that reach one block through different images are staged apart
// with their own shifts, and every contribution is an atomic add.
extern "C" int ddcmd_cellpair_half_col(
    const float* slots, const int* stencil_col, const int* member_u,
    const float* L8, const int* counts, const float* sigma, const float* eps,
    const float* shift, float* out_p, float* out_q, float* out_col, int ncol,
    int cap, int G, int U, int T, float krf, float crf, float keR,
    int coulomb, int excl, void* stream) {
  if (ncol < 1 || G < 1 || U < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_any(
      coulomb, excl, slots, ColumnDirs{stencil_col, member_u, G, U}, L8,
      counts, sigma, eps, shift, out_p, out_q, out_col, ncol * G, cap,
      kDirsN, T, krf, crf, keR, stream));
}
