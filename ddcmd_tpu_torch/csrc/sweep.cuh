// The two-phase half-stencil sweep every cell-list kernel of the port
// that adds both sides of a pair shares: the EAM passes (csrc/eam_half.cu,
// csrc/eam_half_col.cu, hit evaluator in csrc/eam_sweep.cuh) and the LJ +
// reaction-field pair kernels (csrc/cellpair_half.cu, hit evaluator in
// csrc/pair_hit.cuh).  A warp sweeps a tile of 32 kept p slots of a home
// cell against a chunk of 32 kept q slots of one staged half-stencil
// direction; what a hit adds is the evaluator's.
//
// What bounds such a sweep on an H100: at the shapes of the port's decks
// (cells of ~70-85 particles at cap 128, about two cutoffs wide) a p
// particle meets ~1,000-1,200 candidates in its 14 blocks and 2-3% of
// them lie inside the cutoff, so the work is the distance test of every
// candidate (operations, not bytes: the slots stay in L2), and the pair
// arithmetic must not run on warps that are ~1/32 full.  The design:
//   - fewer candidates.  A block in direction s can only hold partners of
//     the p particles near the face, edge or corner it touches, and only
//     its q particles near that face matter.  Staging keeps, per
//     direction, the q particles within rcut (per axis) of the bounding
//     box of the home cell's particles, and then the p particles within
//     rcut of the bounding box of the kept q particles.  The boxes are
//     those of the particles themselves, so nothing is assumed about
//     particles staying inside their cells between rebuilds, and a pair
//     that passes the distance test is never dropped (|dx| <= rcut
//     follows from d2 < rcut^2; the margin kBoxSlack covers rounding).
//     That leaves about a quarter of the tests.  The self block is kept
//     whole and in place (its pairs are j > i);
//   - two phases.  Phase 1 is the distance test alone: a lane holds one
//     kept p slot in registers and the warp walks the kept q slots in
//     chunks of 32, unrolled: one 16-byte shared load (a broadcast) and a
//     dozen operations per candidate, the hit kept as one bit of a
//     per-lane mask, no branch.  After a chunk the lanes' bits are
//     compacted with __ballot_sync / __popc into a ring of 64 packed
//     (direction, p slot, q position) entries per warp, one bit a lane a
//     round.  Phase 2 runs when 32 are queued (and once at the end of the
//     warp's work): each lane takes one hit and hands it to the
//     evaluator, which recomputes the distance from the two staged
//     records with the same operations and adds the p side and the q side
//     to shared memory.  The heavy arithmetic runs once per hit, on full
//     warps;
//   - q slots staged as float4 (x + shift, y + shift, z + shift, w), w
//     carrying the slot and the type as bits the evaluator packs; a masked
//     or padding entry sits at kFar, where no distance test passes; what
//     only phase 2 reads (EAM's dF, a pair's charge and exclusion
//     channels) in kX rows of their own, for the home cell and for each
//     staged direction;
//   - work follows `counts`: only live slots are staged, tiles of 32 are
//     cut from the kept p slots, and the warps of a CTA draw (direction,
//     p tile, q chunk) items from a shared counter, so none idles while
//     another has work; the CTA size is fixed, whatever cap is.
// The distance arithmetic keeps the plain PyTorch versions' order of
// operations (built with --fmad=false), so kernel and plain version take
// the same cutoff decision for every pair; sums are atomic and unordered.
//
// A hit evaluator F supplies
//   kX, kAcc, kSums   extra rows per staged slot, accumulator rows per
//                     slot, per-lane sums reduced per CTA;
//   kNonzeroD2        whether the distance test also asks d2 > 0;
//   p_w(P, cap, i)    w of a valid home slot (a float >= 0);
//   q_bits(Q, cap, j) w of a kept q slot, as bits (slot j in its low bits);
//   load_px / load_qx the kX extra values of a home / q slot;
//   eval(v, entry, cap, sums)  phase 2 for one hit.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace sweep {

constexpr int kRec = 8;          // record rows per slot
constexpr int kDirsN = 14;       // half stencil: self + 13 positive offsets
constexpr int kMaxWarps = 16;    // a CTA of any sweep kernel has no more
constexpr int kMaxDirs = 32;     // staged directions a round (a lane each)
constexpr int kMaxCap = 1024;    // slots a cell may have (every launch checks)
constexpr int kQueue = 64;       // hit ring per warp (a power of two >= 63)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448; // bytes a block may use on sm_90 (227 KB)
constexpr float kFar = 1.0e18f;  // x of an entry no test may pass
constexpr float kBoxSlack = 1.0001f;   // on rcut, in the box tests

// _half_dirs(): self first, then the lexicographically positive offsets
// (the static directions of the column tables)
__constant__ int kHalfDirs[kDirsN][3] = {
    {0, 0, 0},   {0, 0, 1},  {0, 1, -1}, {0, 1, 0},  {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1},   {1, 1, -1}, {1, 1, 0},  {1, 1, 1}};

// Byte offsets of a CTA's dynamic shared memory: the home cell's records
// p4 (at 0) and the nd staged direction blocks q4, their nx extra rows
// each (px, qx), the p-side accumulator ap (acc rows of cap), nblk q-side
// accumulator blocks aq (acc rows of cap each), the kept p slots of each
// direction, the parameter table, the warps' hit rings and the integer
// tables.  ops/eam_half.py (_sweep_smem_bytes) and ops/cellpair_half.py
// (sweep_smem_bytes) mirror the total.
struct Layout {
  int q4, px, qx, ap, aq, plist, tab, queue, meta, bytes;
};

__host__ __device__ inline Layout make_layout(int cap, int nd, int nblk,
                                              int ntab, int nx, int acc,
                                              int nwarps) {
  Layout L;
  int o = cap * 16;                      // p4
  L.q4 = o;    o += nd * cap * 16;
  L.px = o;    o += nx * cap * 4;
  L.qx = o;    o += nd * nx * cap * 4;
  L.ap = o;    o += acc * cap * 4;
  L.aq = o;    o += nblk * acc * cap * 4;
  L.plist = o; o += nd * cap * 4;
  L.tab = o;   o += ntab * 4;
  L.queue = o; o += nwarps * kQueue * 4;
  L.meta = o;  o += (8 * nd + nblk + 4) * 4;
  L.bytes = o;
  return L;
}

struct View {
  float4* p4;       // home cell: x y z w, w = p_w or -1 (masked)
  float4* q4;       // [nd][cap] kept q slots, shifted into the p frame
  float* px;        // [nx][cap] extra rows of the home cell
  float* qx;        // [nd][nx][cap] extra rows of the kept q slots
  float* ap;        // [acc][cap] p-side sums of the home cell
  float* aq;        // [nblk][acc][cap] q-side sums
  int* plist;       // [nd][cap] kept p slots of each direction
  float* tab;       // the evaluator's parameter table
  unsigned* queue;  // [warps][kQueue] packed hits
  int* dcnt;        // [nd] live slots of each direction's cell
  int* dnq;         // [nd] kept q slots of each direction
  int* dnp;         // [nd] kept p slots of each direction
  int* dblk;        // [nd] accumulator block of each direction
  int* dtgt;        // [nd] slot cell of each direction
  float* dsh;       // [nd][3] image shift of each direction
  int* bnq;         // [nblk] live slots of each accumulator block
  int* next;        // the CTA's item counter
};

__device__ __forceinline__ View make_view(unsigned char* s, const Layout& L,
                                          int nd, int nblk) {
  View v;
  v.p4 = reinterpret_cast<float4*>(s);
  v.q4 = reinterpret_cast<float4*>(s + L.q4);
  v.px = reinterpret_cast<float*>(s + L.px);
  v.qx = reinterpret_cast<float*>(s + L.qx);
  v.ap = reinterpret_cast<float*>(s + L.ap);
  v.aq = reinterpret_cast<float*>(s + L.aq);
  v.plist = reinterpret_cast<int*>(s + L.plist);
  v.tab = reinterpret_cast<float*>(s + L.tab);
  v.queue = reinterpret_cast<unsigned*>(s + L.queue);
  int* m = reinterpret_cast<int*>(s + L.meta);
  v.dcnt = m;
  v.dnq = m + nd;
  v.dnp = m + 2 * nd;
  v.dblk = m + 3 * nd;
  v.dtgt = m + 4 * nd;
  v.dsh = reinterpret_cast<float*>(m + 5 * nd);
  v.bnq = m + 8 * nd;
  v.next = m + 8 * nd + nblk;
  return v;
}

// phase 2's shared-memory sums (float atomics, compare-and-swap loops on
// this card)
__device__ __forceinline__ void shared_add(float* a, float x) {
  atomicAdd(a, x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// min of lo[], max of hi[] over the warp, in every lane
__device__ __forceinline__ void warp_box(float (&lo)[3], float (&hi)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], o));
    }
  }
}

// Is (x, y, z) within r, per axis, of the box [lo, hi]?  False for an
// empty box (lo = +inf, hi = -inf).
__device__ __forceinline__ bool near_box(float x, float y, float z,
                                         const float (&lo)[3],
                                         const float (&hi)[3], float r) {
  return (x >= lo[0] - r) & (x <= hi[0] + r) & (y >= lo[1] - r) &
         (y <= hi[1] + r) & (z >= lo[2] - r) & (z <= hi[2] + r);
}

// Stage the home cell's np live slots (w = f.p_w, or -1 for a slot whose
// validity row is not positive) with their extra rows, clear its p-side
// sums, and leave each warp's bounding box of the valid slots in
// pbox[warp] ([lo(3), hi(3)]).
template <class F>
__device__ __forceinline__ void stage_home(const View& v, const F& f,
                                           const float* P, int cap, int np,
                                           float (*pbox)[6]) {
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const float x = P[i], y = P[cap + i], z = P[2 * cap + i];
    const bool ok = P[5 * cap + i] > 0.f;
    v.p4[i] = make_float4(x, y, z, ok ? f.p_w(P, cap, i) : -1.f);
    float ex[F::kX > 0 ? F::kX : 1];
#pragma unroll
    for (int r = 0; r < F::kX; ++r) ex[r] = 0.f;
    f.load_px(P, cap, i, ex);
#pragma unroll
    for (int r = 0; r < F::kX; ++r) v.px[r * cap + i] = ex[r];
#pragma unroll
    for (int k = 0; k < F::kAcc; ++k) v.ap[k * cap + i] = 0.f;
    if (ok) {
      lo[0] = fminf(lo[0], x);
      lo[1] = fminf(lo[1], y);
      lo[2] = fminf(lo[2], z);
      hi[0] = fmaxf(hi[0], x);
      hi[1] = fmaxf(hi[1], y);
      hi[2] = fmaxf(hi[2], z);
    }
  }
  warp_box(lo, hi);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pbox[threadIdx.x >> 5][a] = lo[a];
      pbox[threadIdx.x >> 5][3 + a] = hi[a];
    }
  }
}

// Stage the nd directions the tables dtgt / dcnt / dsh describe, a warp a
// direction, after a barrier behind stage_home.  The self block (dself,
// or -1) is staged whole and in place, its masked and padding entries at
// kFar, with every live p slot listed.  Of any other block the valid q
// slots within rc per axis of the home cell's box are kept, packed to the
// front and padded to a multiple of 32 with entries at kFar (the sweep's
// chunk; cap is one), and then the valid p slots within rc of the kept q
// slots' box are listed.  w of a kept entry = f.q_bits, as bits.  Leaves
// dnq and dnp.
template <class F>
__device__ __forceinline__ void stage_dirs(const View& v, const F& f,
                                           const float* slots, int cap,
                                           int np, int nd, int dself,
                                           float rc, float (*pbox)[6]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int nwarps = blockDim.x >> 5;
  float plo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float phi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int w = 0; w < nwarps; ++w) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      plo[a] = fminf(plo[a], pbox[w][a]);
      phi[a] = fmaxf(phi[a], pbox[w][3 + a]);
    }
  }
  for (int d = threadIdx.x >> 5; d < nd; d += nwarps) {
    const float* Q = slots + static_cast<size_t>(v.dtgt[d]) * kRec * cap;
    const int n = v.dcnt[d];
    const float sx = v.dsh[3 * d], sy = v.dsh[3 * d + 1], sz = v.dsh[3 * d + 2];
    float4* q4 = v.q4 + d * cap;
    float* qx = v.qx + d * F::kX * cap;
    int* plist = v.plist + d * cap;
    const bool self = d == dself;
    float qlo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float qhi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    int kept = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      float x = kFar, y = 0.f, z = 0.f;
      float ex[F::kX > 0 ? F::kX : 1];
#pragma unroll
      for (int r = 0; r < F::kX; ++r) ex[r] = 0.f;
      unsigned bits = 0u;
      bool ok = false;
      if (j < n) {
        ok = Q[5 * cap + j] > 0.f;
        if (ok) {
          x = Q[j] + sx;
          y = Q[cap + j] + sy;
          z = Q[2 * cap + j] + sz;
          f.load_qx(Q, cap, j, ex);
          bits = f.q_bits(Q, cap, j);
          if (!self) ok = near_box(x, y, z, plo, phi, rc);
        }
      }
      int pos = j;                       // the self block stays in place
      if (!self) {
        const unsigned m = __ballot_sync(kFull, ok);
        pos = kept + __popc(m & below);
        kept += __popc(m);
        if (ok) {
          qlo[0] = fminf(qlo[0], x);
          qlo[1] = fminf(qlo[1], y);
          qlo[2] = fminf(qlo[2], z);
          qhi[0] = fmaxf(qhi[0], x);
          qhi[1] = fmaxf(qhi[1], y);
          qhi[2] = fmaxf(qhi[2], z);
        }
      }
      if (ok | self) {
        q4[pos] = make_float4(ok ? x : kFar, y, z, __uint_as_float(bits));
#pragma unroll
        for (int r = 0; r < F::kX; ++r) qx[r * cap + pos] = ex[r];
      }
    }
    if (self) {
      kept = n;
      for (int i = lane; i < np; i += 32) plist[i] = i;
      if (lane == 0) v.dnp[d] = np;
    } else {
      const int pos = kept + lane;       // pad the last chunk
      if (pos < ((kept + 31) & ~31)) q4[pos] = make_float4(kFar, 0.f, 0.f, 0.f);
      warp_box(qlo, qhi);
      int listed = 0;
      for (int i0 = 0; i0 < np; i0 += 32) {
        const int i = i0 + lane;
        bool ok = false;
        if (i < np) {
          const float4 P = v.p4[i];
          ok = (P.w >= 0.f) & near_box(P.x, P.y, P.z, qlo, qhi, rc);
        }
        const unsigned m = __ballot_sync(kFull, ok);
        if (ok) plist[listed + __popc(m & below)] = i;
        listed += __popc(m);
      }
      if (lane == 0) v.dnp[d] = listed;
    }
    if (lane == 0) v.dnq[d] = kept;
  }
}

// A hit: entry = d << 20 | p slot << 10 | q position.
static_assert(kMaxCap <= (1 << 10) && kMaxDirs <= (1 << 12),
              "a hit packs its p slot and q position in 10 bits each");

// The sweep of the staged directions by the CTA's warps, after a barrier
// behind stage_dirs.  Items are (direction d, tile of 32 kept p slots,
// chunk of 32 kept q slots), drawn from *v.next (set to 0 before that
// barrier); dself is the self block (pairs j > i only) or -1.  A pair
// (p, q) is a hit when both slots are valid and d2 < rcut2 (and d2 > 0
// with F::kNonzeroD2).  Each lane adds its hits' per-CTA terms to sums.
// Every thread of the CTA calls this; nd <= kMaxDirs.
template <class F>
__device__ __forceinline__ void sweep(const View& v, const F& f, int cap,
                                      int nd, int dself, float rcut2,
                                      float (&sums)[F::kSums]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned* ring = v.queue + (threadIdx.x >> 5) * kQueue;
  // lane d: the items up to and with direction d (every lane past nd - 1
  // holds the total)
  int upto = lane < nd
                 ? ((v.dnp[lane] + 31) >> 5) * ((v.dnq[lane] + 31) >> 5)
                 : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int other = __shfl_up_sync(kFull, upto, o);
    if (lane >= o) upto += other;
  }
  const int nitems = __shfl_sync(kFull, upto, 31);
  int head = 0, count = 0;
  for (;;) {
    int it = 0;
    if (lane == 0) it = atomicAdd(v.next, 1);
    it = __shfl_sync(kFull, it, 0);
    if (it >= nitems) break;
    const int d = __popc(__ballot_sync(kFull, upto <= it));
    const int first = __shfl_sync(kFull, upto, d > 0 ? d - 1 : 0);
    const int chunks = (v.dnq[d] + 31) >> 5;
    const int tile = (it - (d > 0 ? first : 0)) / chunks;
    const int j0 = (it - (d > 0 ? first : 0) - tile * chunks) << 5;
    const int k = (tile << 5) + lane;    // among the direction's kept p
    const bool self = d == dself;
    // the self block takes j > i only (there i = k and a q slot's
    // position is its slot): the chunks before a tile's own hold none
    if (self && j0 < (tile << 5)) continue;
    int i = 0;
    float4 P = make_float4(0.f, 0.f, 0.f, -1.f);
    if (k < v.dnp[d]) {
      i = v.plist[d * cap + k];
      P = v.p4[i];
    }
    const bool pv = P.w >= 0.f;
    const float4* q4 = v.q4 + d * cap;
    const unsigned tag = (static_cast<unsigned>(d) << 20) |
                         (static_cast<unsigned>(i) << 10);
    unsigned mask = 0u;                // bit b: position j0 + b is a hit
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const float4 Q = q4[j0 + b];
      const float dx = P.x - Q.x;
      const float dy = P.y - Q.y;
      const float dz = P.z - Q.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      bool hit = d2 < rcut2;
      if (F::kNonzeroD2) hit = hit & (d2 > 0.f);
      if (hit) mask |= 1u << b;
    }
    if (!pv) mask = 0u;
    if (self) {                        // drop the bits of j <= i
      const int keep = i - j0 + 1;
      if (keep >= 32)
        mask = 0u;
      else if (keep > 0)
        mask &= kFull << keep;
    }
    // compact: every lane with a bit left queues its lowest one
    for (unsigned any = __ballot_sync(kFull, mask != 0u); any != 0u;
         any = __ballot_sync(kFull, mask != 0u)) {
      if (mask != 0u) {
        ring[(head + count + __popc(any & below)) & (kQueue - 1)] =
            tag | static_cast<unsigned>(j0 + __ffs(mask) - 1);
        mask &= mask - 1u;
      }
      count += __popc(any);
      if (count >= 32) {
        __syncwarp();
        const unsigned entry = ring[(head + lane) & (kQueue - 1)];
        __syncwarp();
        f.eval(v, entry, cap, sums);
        head = (head + 32) & (kQueue - 1);
        count -= 32;
      }
    }
  }
  __syncwarp();
  if (lane < count) f.eval(v, ring[(head + lane) & (kQueue - 1)], cap, sums);
}

// Sum the lanes' N per-CTA terms over the CTA and add (or, with kStore,
// store) the N sums at out.  Every thread of the CTA calls this.
template <bool kStore, int N>
__device__ __forceinline__ void reduce_sums(const float (&vals)[N],
                                            float* out) {
  __shared__ float red[kMaxWarps][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float s = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float t = 0.f;
    for (int w = 0; w < (blockDim.x >> 5); ++w) t += red[w][threadIdx.x];
    if (kStore)
      out[threadIdx.x] = t;
    else
      atomicAdd(&out[threadIdx.x], t);
  }
}

}  // namespace sweep
