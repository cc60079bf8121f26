"""Half-stencil cell-pair engine: planning, slot packing and the kernels.

Counterpart of ddcmd_tpu/ops/pallas_cellpair.py for the main paths:
`plan_lanes` (fat cells sized to a lane capacity), `pack_stencil` and
`pack_slots` (the (ncell, 8, cap) record contract, with the in-kernel
exclusion channels in rows 6-7), the column plan (`choose_col_group`,
`fit_col_group`, `col_plan_grid`, `pack_stencil_col`), three half-stencil
entry points of one pair kernel with their plain PyTorch twins:

  cellpair_half      / cellpair_half_plain      per-cell kernel (TPU #1)
  cellpair_half_col  / cellpair_half_col_plain  column kernel   (TPU #2)
  cellpair_half_ext  / cellpair_half_plain      extended grid   (TPU #6)

and `cellpair_eval_half` (the counterpart of pallas_cellpair_eval_half):
pack, run the kernel the plan picks, scatter the per-slot results back to
particles.

The kernel is hand-written CUDA (csrc/cellpair_half.cu on the sweep of
csrc/sweep.cuh and the hit evaluator of csrc/pair_hit.cuh; its fourth
entry point is the full-stencil kernel of ops/cellpair_full.py, and the
EAM kernels of ops/eam_half.py build here too), compiled with nvcc on
first use into `ddcmd_tpu_torch/_build/` (one nvcc process per source,
started together) and loaded with ctypes; nothing is compiled or
imported for them when this module loads.  On a CPU tensor a wrapper runs its plain
twin; on a CUDA tensor it launches its kernel or raises.

The TPU kernel's `_alias_groups_half` (merging stencil directions that
reach one cell through two periodic images before its in-order q-side
read-modify-write) has no counterpart: the CUDA kernels add the q side
with atomics and the twins with index_add_, both exact under aliasing.
The column plan keeps JAX's alias-deduplicated union all the same, so
the union tables equal the JAX package's.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from .cellpair import (CellBlockGrid, _build_stencil, _cell_coords,
                       _half_dirs, excluded_pairs)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD = os.path.join(_PKG, "_build")
# kernel name -> CUDA source; each builds into _build/lib<name>.so
KERNEL_SOURCES = {
    name: os.path.join(_PKG, "csrc", name + ".cu")
    for name in ("cellpair_half", "eam_half", "eam_half_col")}
# headers the sources include (a newer header rebuilds every library)
KERNEL_HEADERS = [os.path.join(_PKG, "csrc", h)
                  for h in ("sweep.cuh", "pair_hit.cuh", "eam_forms.cuh",
                            "eam_sweep.cuh")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# shared memory a block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448
# the pair kernel's CTA size (kThreads of csrc/cellpair_half.cu) and the
# hit ring of csrc/sweep.cuh (kQueue), which the shared-memory counts
# mirror
PAIR_CELL_THREADS = 128
SWEEP_QUEUE = 64

_lock = threading.Lock()
_libs: dict = {}


# ---------------------------------------------------------------------------
# planning and packing (host + torch)
# ---------------------------------------------------------------------------

LANE_CAP = 128


def plan_lanes(box_lengths, rcut: float, skin: float, n_particles: int,
               density_safety: float = 1.3,
               plan_margin: float = 1.0) -> CellBlockGrid:
    """Plan a FAT cell grid: cells as large as the lane capacity allows
    (expected occupancy * safety <= LANE_CAP) but never smaller than
    rlist * plan_margin, then greedily coarsened; cap rounds up to a
    multiple of 128.  plan_margin > 1 reserves shrink headroom for NPT
    runs.  Same plan as the JAX package at its default lane cap."""
    L = np.asarray(box_lengths, dtype=np.float64)
    rlist = rcut + skin
    rplan = rlist * plan_margin
    vol = float(np.prod(L))
    density = n_particles / vol

    def need(nc):
        # fluctuation-aware capacity: mean * safety bounds the systematic
        # part, mean + 4 sqrt(mean) the Poisson tail
        mean = density * vol / float(np.prod(nc))
        return int(max(mean * density_safety,
                       mean + 4.0 * math.sqrt(mean))) + 8

    edge_cap = ((LANE_CAP - 4) / (density * density_safety)) ** (1.0 / 3.0)
    ncells = [min(max(1, int(math.ceil(l / edge_cap))),
                  max(1, int(math.floor(l / rplan)))) for l in L]
    # refine to feasibility (the closed-form edge ignores the Poisson
    # tail), adding cells on the fattest axis while the rlist floor allows
    for _ in range(64):
        if need(ncells) <= LANE_CAP:
            break
        grow = [i for i in range(3)
                if ncells[i] + 1 <= max(1, int(math.floor(L[i] / rplan)))]
        if not grow:
            break                        # rlist-floored: cap absorbs the rest
        i = max(grow, key=lambda j: L[j] / ncells[j])
        ncells[i] += 1
    # coarsen greedily: fewer, fatter cells = fuller tiles
    improved = True
    while improved:
        improved = False
        for i in sorted(range(3), key=lambda j: -ncells[j]):
            trial = list(ncells)
            if trial[i] <= 1:
                continue
            trial[i] -= 1
            if need(trial) <= LANE_CAP:
                ncells = trial
                improved = True
                break
    ncells = tuple(ncells)
    cap = LANE_CAP * int(math.ceil(need(ncells) / float(LANE_CAP)))
    stencil_cells, wrap = _build_stencil(ncells)
    return CellBlockGrid(ncells=ncells, cap=cap, rlist=rlist,
                         stencil_cells=stencil_cells, wrap=wrap)


def pack_stencil(grid: CellBlockGrid) -> np.ndarray:
    """(ncell, S*4) int32: [cell_id, dx, dy, dz]*S where d is the UNWRAPPED
    stencil offset (-1/0/+1); the exact q shift into p's cell-centred
    frame is d * L/ncells per axis."""
    c3 = np.stack(_cell_coords(grid.ncells), axis=1)       # (C,3)
    q3 = c3[grid.stencil_cells]                            # (C,S,3)
    n3 = np.asarray(grid.ncells)
    delta = q3 - c3[:, None, :] + grid.wrap.astype(np.int64) * n3
    packed = np.concatenate(
        [grid.stencil_cells[:, :, None].astype(np.int32),
         delta.astype(np.int32)], axis=2)
    return packed.reshape(grid.ncell, -1)


def frac_centers(grid: CellBlockGrid) -> np.ndarray:
    """(ncell, 3) f32 cell centres as fractions of the box, origin-centred;
    rounded step by step in f32 as the JAX package's pack_slots does."""
    c3 = np.stack(_cell_coords(grid.ncells), axis=1).astype(np.float32)
    n = np.asarray(grid.ncells, dtype=np.float32)
    return (c3 + np.float32(0.5)) / n - np.float32(0.5)


# ---------------------------------------------------------------------------
# the column plan (TPU kernel #2's host side)
# ---------------------------------------------------------------------------

def choose_col_group(grid: CellBlockGrid) -> int:
    """Column-group size G for the column kernels: G z-contiguous cells
    share one union of stencil blocks (TPU #2 stages it once).  The JAX
    package's rule for its default (bcast) variant: grids under 256 cells
    stay on the per-cell kernel; otherwise the largest G <= g_max that
    divides nz, with g_max 5 at cap <= 128 and 3 above."""
    nz = grid.ncells[2]
    if grid.ncell < 256:
        return 1
    g_max = 5 if grid.cap <= 128 else 3
    for G in range(min(g_max, nz), 1, -1):
        if nz % G == 0 and grid.ncell > G:
            return G
    return 1


def fit_col_group(grid: CellBlockGrid, G: int, smem_bytes_fn) -> int:
    """The plan's G on this card: the largest divisor of nz that is <= G
    and whose column kernel fits in a block's shared memory
    (smem_bytes_fn(U) <= SMEM_LIMIT, U the union size at that G); 1 -- the
    per-cell kernel -- when none fits.  Decided at plan time from the
    byte counts the column kernels launch with, so no launch is refused
    mid-run.  choose_col_group stays the JAX package's rule, which its
    VMEM limit bounds instead."""
    nz = grid.ncells[2]
    for g in range(G, 1, -1):
        if nz % g == 0 and \
                smem_bytes_fn(len(col_plan_grid(grid, g)[0])) <= SMEM_LIMIT:
            return g
    return 1


def col_plan_grid(grid: CellBlockGrid, G: int):
    """(union_dirs, member_u) for a column of G z-contiguous cells: the
    distinct (dx, dy, dzu) block offsets from the column's base cell,
    deduplicated by periodic alias class (on small-nz grids several union
    directions reach one cell through different images, e.g. dzu = -1 and
    G-1 when nz == G), and member_u[g][s] = the union index of member g's
    s-th half-stencil block.  The per-member image shift stays the static
    direction (dz = dzu - g); only the block index changes."""
    nx, ny, nz = grid.ncells
    dirs = _half_dirs()
    raw = sorted({(dx, dy, dz + g) for (dx, dy, dz) in dirs
                  for g in range(G)})
    reps: dict = {}
    for d in raw:
        reps.setdefault((d[0] % nx, d[1] % ny, d[2] % nz), d)
    union = sorted(reps.values())
    uidx = {k: i for i, (k, _) in
            enumerate(sorted(reps.items(), key=lambda kv: kv[1]))}
    member = tuple(
        tuple(uidx[(dx % nx, dy % ny, (dz + g) % nz)]
              for (dx, dy, dz) in dirs)
        for g in range(G))
    return union, member


def pack_stencil_col(grid: CellBlockGrid, G: int) -> np.ndarray:
    """(ncol, U) int32 union-block cell ids per column (pairwise distinct
    within a column); the image shifts are the static directions."""
    nx, ny, nz = grid.ncells
    assert nz % G == 0
    union, _ = col_plan_grid(grid, G)
    ncol = grid.ncell // G
    base = np.arange(ncol) * G
    cx, rem = np.divmod(base, ny * nz)
    cy, cz = np.divmod(rem, nz)
    out = np.zeros((ncol, len(union)), np.int32)
    for u, (dx, dy, dzu) in enumerate(union):
        out[:, u] = ((((cx + dx) % nx) * ny + ((cy + dy) % ny)) * nz
                     + ((cz + dzu) % nz))
    return out


def grid_tensors(grid: CellBlockGrid, device, G: int = 1) -> dict:
    """The grid's constant device tensors, made once per plan so the
    per-step path copies nothing from the host.  G > 1 selects the column
    kernel: `stencil` is then pack_stencil_col's (ncol, U) table and
    `member_u` col_plan_grid's (G, 14) map."""
    gt = dict(
        frac_centers=torch.as_tensor(frac_centers(grid), device=device),
        ncells=torch.tensor(grid.ncells, dtype=torch.float32, device=device),
        G=G)
    if G > 1:
        _, member = col_plan_grid(grid, G)
        gt["stencil"] = torch.as_tensor(pack_stencil_col(grid, G),
                                        device=device)
        gt["member_u"] = torch.as_tensor(np.asarray(member, np.int32),
                                         device=device)
    else:
        gt["stencil"] = torch.as_tensor(pack_stencil(grid), device=device)
    return gt


def pack_slots(r, q, tidx, perm, box_lengths, grid: CellBlockGrid,
               frac_centers_t, excl_vals=None):
    """(ncell, 8, cap) f32 slot records in cell-centred coordinates:
    rows [x, y, z, q, type, valid, ex6, ex7].  ex6/ex7 are the in-kernel
    exclusion channels (run/forces._excl_channels), zero without
    exclusions.  Returns (slots, centers)."""
    n_pad = r.shape[0]
    dt = torch.float32
    ncell, cap = grid.ncell, grid.cap
    centers = frac_centers_t * box_lengths.to(dt)               # (C,3)
    zero = torch.zeros((1,), dtype=dt, device=r.device)
    r_ext = torch.cat([r.to(dt), zero.expand(1, 3)])
    q_ext = torch.cat([q.to(dt), zero])
    t_ext = torch.cat([tidx.to(dt), zero])
    v_ext = torch.cat([torch.ones((n_pad,), dtype=dt, device=r.device),
                       zero])
    if excl_vals is None:
        ex = torch.zeros((ncell, cap, 2), dtype=dt, device=r.device)
    else:
        e_ext = torch.cat([excl_vals.to(dt), zero.expand(1, 2)])
        ex = e_ext[perm].reshape(ncell, cap, 2)
    P = r_ext[perm].reshape(ncell, cap, 3) - centers[:, None, :]
    rec = torch.cat([
        P,
        q_ext[perm].reshape(ncell, cap, 1),
        t_ext[perm].reshape(ncell, cap, 1),
        v_ext[perm].reshape(ncell, cap, 1),
        ex,
    ], dim=2)                                                   # (C,cap,8)
    return rec.transpose(1, 2).contiguous(), centers


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def cellpair_half_plain(slots, stencil, L8, counts, sigma, eps, shift, *,
                        krf: float, crf: float, keR: float, coulomb: bool,
                        excl: bool = False):
    """Plain PyTorch version of the per-cell kernel (same contract and
    outputs) and of the extended-grid kernel: the p side runs over the
    first n_prog = stencil.shape[0] cells of `slots` (all of them on a
    single-device grid), the q side over every slot cell.  Loops over the
    stencil blocks so memory stays at (n_prog, cap, cap) per block; the q
    side is scattered with index_add_.  `counts` is not needed: empty
    slots carry valid = 0."""
    del counts
    ncell, _, cap = slots.shape
    n_prog = stencil.shape[0]
    S = stencil.shape[1] // 4
    T = sigma.shape[0]
    dt = slots.dtype
    dev = slots.device
    L8 = L8.reshape(-1)
    rcut2 = L8[3]
    home = slots[:n_prog]
    px, py, pz = home[:, 0, :, None], home[:, 1, :, None], home[:, 2, :, None]
    pq, pv = home[:, 3, :, None], home[:, 5, :, None]
    pt = home[:, 4].long()
    if excl:
        # exclusion channels: row6 = component id, row7 = B + 2^-(intra+1)
        p_ch = home[:, 6:8].transpose(1, 2)
    upper = (torch.arange(cap, device=dev)[None, :]
             > torch.arange(cap, device=dev)[:, None])        # j > i
    out_p = torch.zeros((n_prog, cap, 4), dtype=dt, device=dev)
    out_q4 = torch.zeros((ncell, 4, cap), dtype=dt, device=dev)
    out_cell = torch.zeros((n_prog, 8), dtype=dt, device=dev)
    for s in range(S):
        tgt = stencil[:, 4 * s].long()
        sh = stencil[:, 4 * s + 1:4 * s + 4].to(dt) * L8[0:3]  # (C,3)
        Q = slots[tgt]                                         # (C,8,cap)
        dx = px - (Q[:, 0] + sh[:, 0:1])[:, None, :]           # (C,cap,cap)
        dy = py - (Q[:, 1] + sh[:, 1:2])[:, None, :]
        dz = pz - (Q[:, 2] + sh[:, 2:3])[:, None, :]
        d2 = dx * dx + dy * dy + dz * dz
        valid = (pv * Q[:, 5, None, :] > 0) & (d2 < rcut2)
        if s == 0:
            valid = valid & upper
        if excl:
            valid = valid & ~excluded_pairs(p_ch, Q[:, 6:8].transpose(1, 2))
        w = valid.to(dt)
        d2s = torch.where(valid, d2, torch.ones_like(d2))
        ir2 = 1.0 / d2s
        if T == 1:
            sig, ep, shf = sigma[0, 0], eps[0, 0], shift[0, 0]
        else:
            qt = Q[:, 4].long()
            sig = sigma[pt[:, :, None], qt[:, None, :]]
            ep = eps[pt[:, :, None], qt[:, None, :]]
            shf = shift[pt[:, :, None], qt[:, None, :]]
        s2 = sig * sig * ir2
        s6 = s2 * s2 * s2
        s12 = s6 * s6
        e_pair = (4.0 * ep * (s12 - s6) + shf) * w
        dvdr = 24.0 * ep * (s6 - 2.0 * s12) * ir2
        if coulomb:
            ir = torch.rsqrt(d2s)
            kqq = keR * pq * Q[:, 3, None, :]
            e_pair = e_pair + kqq * (ir + krf * d2s - crf) * w
            dvdr = dvdr + kqq * (2.0 * krf - ir2 * ir)
        coef = dvdr * w
        fdx, fdy, fdz = coef * dx, coef * dy, coef * dz
        out_p += torch.stack([-fdx.sum(2), -fdy.sum(2), -fdz.sum(2),
                              0.5 * e_pair.sum(2)], dim=2)
        out_q4.index_add_(0, tgt, torch.stack(
            [fdx.sum(1), fdy.sum(1), fdz.sum(1), 0.5 * e_pair.sum(1)], 1))
        out_cell[:, :7] += torch.stack([
            e_pair.sum((1, 2)),
            -(fdx * dx).sum((1, 2)), -(fdy * dy).sum((1, 2)),
            -(fdz * dz).sum((1, 2)), -(fdx * dy).sum((1, 2)),
            -(fdx * dz).sum((1, 2)), -(fdy * dz).sum((1, 2))], dim=1)
    out_q = torch.cat([out_q4, torch.zeros_like(out_q4)], dim=1)
    return out_p.reshape(n_prog * cap, 4), out_q, out_cell


def col_to_cell_stencil(stencil_col, member_u):
    """The per-cell half stencil (ncell, 14*4) a column table encodes:
    member g of column c is cell c*G + g, its s-th block the union block
    member_u[g][s] with the static shift of direction s."""
    ncol = stencil_col.shape[0]
    G, S = member_u.shape
    tgt = stencil_col[:, member_u.reshape(-1).long()].reshape(ncol, G, S)
    d = torch.tensor(_half_dirs(), dtype=stencil_col.dtype,
                     device=stencil_col.device)                # (S, 3)
    packed = torch.cat([tgt[..., None], d.expand(ncol, G, S, 3)], dim=3)
    return packed.reshape(ncol * G, S * 4).contiguous()


def cellpair_half_col_plain(slots, stencil_col, member_u, L8, counts, sigma,
                            eps, shift, *, krf: float, crf: float,
                            keR: float, coulomb: bool, excl: bool = False):
    """Plain PyTorch version of the column kernel: the same sweep as the
    per-cell twin over the per-cell stencil the column table encodes, the
    per-cell [e, virial6] summed per column."""
    G = member_u.shape[0]
    out_p, out_q, out_cell = cellpair_half_plain(
        slots, col_to_cell_stencil(stencil_col, member_u), L8, counts,
        sigma, eps, shift, krf=krf, crf=crf, keR=keR, coulomb=coulomb,
        excl=excl)
    return out_p, out_q, out_cell.reshape(-1, G, 8).sum(dim=1)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in csrc/")
    return nvcc


def lib_path(name: str) -> str:
    return os.path.join(_BUILD, f"lib{name}.so")


def build_kernels(force: bool = False, names=None) -> dict:
    """Compile the CUDA sources with nvcc into _build/ (those missing,
    older than their source, or all with `force`), one nvcc process per
    source, all started together; returns {name: library path}.  Each
    compiler report (-Xptxas -v: registers, shared memory, spills) is kept
    beside its library in _build/<name>.ptxas.txt."""
    with _lock:
        return _build_locked(list(names or KERNEL_SOURCES), force)


def _build_locked(names, force: bool) -> dict:
    newest_header = max(os.path.getmtime(h) for h in KERNEL_HEADERS)
    todo = [n for n in names
            if force or not os.path.exists(lib_path(n))
            or os.path.getmtime(lib_path(n))
            < max(os.path.getmtime(KERNEL_SOURCES[n]), newest_header)]
    if todo:
        os.makedirs(_BUILD, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = f"{lib_path(n)}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCES[n]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {KERNEL_SOURCES[n]}:\n{err}")
                continue
            with open(os.path.join(_BUILD, f"{n}.ptxas.txt"), "w") as f:
                f.write(out + err)
            os.replace(tmp, lib_path(n))
        if failed:
            raise RuntimeError("\n".join(failed))
    return {n: lib_path(n) for n in names}


_ARGTYPES = {
    # pointers..., ints (shape), floats (krf crf keR), coulomb, excl, stream
    "cellpair_half": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                      + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p]),
    "cellpair_half_col": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                          + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                          + [ctypes.c_void_p]),
    # pointers..., ints (ncell cap S s_self T), floats, coulomb, stream
    "cellpair_full": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                      + [ctypes.c_float] * 3 + [ctypes.c_int]
                      + [ctypes.c_void_p]),
    # pointers..., ints (shape, npar, degree, form, force), stream
    "eam_half": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "eam_half_col": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p]),
    # the extended-grid entry points: (n_prog, n_slot) replace ncell
    "cellpair_half_ext": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                          + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                          + [ctypes.c_void_p]),
    "eam_rho_half_ext": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p]),
    "eam_force_half_ext": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p]),
}


def _kernel_fn(name: str, source: str | None = None):
    """The C entry point ddcmd_<name> of _build/lib<source>.so (source
    defaults to name), built on first use."""
    source = source or name
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_build_locked([source], False)[source])
            fn = getattr(lib, "ddcmd_" + name)
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES[name]
            _libs[name] = (lib, fn)
        return _libs[name][1]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(want: dict, device):
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, slots on {device}")


def _check_common(slots, L8, counts, sigma, eps, shift):
    if slots.dim() != 3 or slots.shape[1] != 8:
        raise ValueError(f"slots must be (ncell, 8, cap), got {tuple(slots.shape)}")
    ncell, _, cap = slots.shape
    T = sigma.shape[0] if sigma.dim() == 2 else -1
    if T < 1:
        raise ValueError("tables must be (T, T), T >= 1")
    _check({"slots": (slots, torch.float32, (ncell, 8, cap)),
            "L8": (L8, torch.float32, (1, 8)),
            "counts": (counts, torch.int32, (ncell,)),
            "sigma": (sigma, torch.float32, (T, T)),
            "eps": (eps, torch.float32, (T, T)),
            "shift": (shift, torch.float32, (T, T))}, slots.device)
    if slots.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu, not {slots.device}")
    if slots.device.type == "cuda" and (cap % 32 or not 32 <= cap <= 1024):
        raise ValueError(f"cap={cap}: the kernels take multiples of 32 up to 1024")
    return ncell, cap, T


def cellpair_half(slots, stencil, L8, counts, sigma, eps, shift, *,
                  krf: float, crf: float, keR: float, coulomb: bool,
                  excl: bool = False):
    """N3L half-stencil pair sweep, one CTA per (cell, group of
    directions) (contract in csrc/cellpair_half.cu); excl=True masks the
    pairs the record rows 6-7 exclude.

    Returns (per-slot p side (ncell*cap, 4) [f, pe], accumulated q side
    (ncell, 8, cap), per-cell (ncell, 8) [e, virial6]).  A CPU tensor runs
    cellpair_half_plain; a CUDA tensor launches the kernel (counted in
    `cellpair_half.launches`, and in `cellpair_half.launches_excl` when
    excl) or raises."""
    ncell, cap, T = _check_common(slots, L8, counts, sigma, eps, shift)
    if stencil.dim() != 2 or stencil.shape[1] % 4:
        raise ValueError("stencil must be (ncell, S*4)")
    _check({"stencil": (stencil, torch.int32, (ncell, stencil.shape[1]))},
           slots.device)
    kw = dict(krf=krf, crf=crf, keR=keR, coulomb=coulomb, excl=excl)
    if slots.device.type == "cpu":
        return cellpair_half_plain(slots, stencil, L8, counts, sigma, eps,
                                   shift, **kw)
    if cell_smem_bytes(cap, T, excl) > SMEM_LIMIT:
        raise ValueError(f"T={T} tables do not fit in shared memory at cap={cap}")
    fn = _kernel_fn("cellpair_half")
    out_p = torch.zeros((ncell * cap, 4), dtype=torch.float32, device=slots.device)
    out_q = torch.zeros((ncell, 8, cap), dtype=torch.float32, device=slots.device)
    out_cell = torch.zeros((ncell, 8), dtype=torch.float32, device=slots.device)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slots.data_ptr(), stencil.data_ptr(), L8.data_ptr(),
                 counts.data_ptr(), sigma.data_ptr(), eps.data_ptr(),
                 shift.data_ptr(), out_p.data_ptr(), out_q.data_ptr(),
                 out_cell.data_ptr(), ncell, cap, stencil.shape[1] // 4, T,
                 krf, crf, keR, int(bool(coulomb)), int(bool(excl)), stream)
    if err != 0:
        raise RuntimeError(f"cellpair_half launch failed: CUDA error {err}")
    cellpair_half.launches += 1
    if excl:
        cellpair_half.launches_excl += 1
    return out_p, out_q, out_cell


cellpair_half.launches = 0          # every launch of the kernel
cellpair_half.launches_excl = 0     # the launches with exclusions


def check_ext(slots, stencil, counts):
    """(n_prog, n_slot, cap) of an extended-grid call: stencil rows are
    the n_prog core cells, slots and counts span all n_slot cells."""
    if slots.dim() != 3 or slots.shape[1] != 8:
        raise ValueError(f"slots must be (n_slot, 8, cap), got {tuple(slots.shape)}")
    if stencil.dim() != 2 or stencil.shape[1] % 4:
        raise ValueError("stencil must be (n_prog, S*4)")
    n_slot, _, cap = slots.shape
    n_prog = stencil.shape[0]
    if not 1 <= n_prog <= n_slot:
        raise ValueError(f"{n_prog} programs over {n_slot} slot cells")
    _check({"stencil": (stencil, torch.int32, (n_prog, stencil.shape[1])),
            "counts": (counts, torch.int32, (n_slot,))}, slots.device)
    return n_prog, n_slot, cap


def cellpair_half_ext(slots, stencil, L8, counts, sigma, eps, shift, *,
                      krf: float, crf: float, keR: float, coulomb: bool,
                      excl: bool = False):
    """The per-cell sweep on a brick's extended cell grid (contract in
    csrc/cellpair_half.cu:ddcmd_cellpair_half_ext): programs over the
    n_prog core cells (stencil rows), slots (n_slot, 8, cap) and counts
    (n_slot,) over core, halo shell and sentinel.

    Returns (p side (n_prog*cap, 4) [f, pe], accumulated q side (n_slot,
    8, cap), per-core-cell (n_prog, 8) [e, virial6]).  A CPU tensor runs
    cellpair_half_plain; a CUDA tensor launches the kernel (counted in
    `cellpair_half_ext.launches`, and in `cellpair_half_ext.launches_excl`
    when excl) or raises."""
    n_prog, n_slot, cap = check_ext(slots, stencil, counts)
    _, _, T = _check_common(slots, L8, counts, sigma, eps, shift)
    kw = dict(krf=krf, crf=crf, keR=keR, coulomb=coulomb, excl=excl)
    if slots.device.type == "cpu":
        return cellpair_half_plain(slots, stencil, L8, counts, sigma, eps,
                                   shift, **kw)
    if cell_smem_bytes(cap, T, excl) > SMEM_LIMIT:
        raise ValueError(f"T={T} tables do not fit in shared memory at cap={cap}")
    fn = _kernel_fn("cellpair_half_ext", "cellpair_half")
    dev = slots.device
    out_p = torch.zeros((n_prog * cap, 4), dtype=torch.float32, device=dev)
    out_q = torch.zeros((n_slot, 8, cap), dtype=torch.float32, device=dev)
    out_cell = torch.zeros((n_prog, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slots.data_ptr(), stencil.data_ptr(), L8.data_ptr(),
                 counts.data_ptr(), sigma.data_ptr(), eps.data_ptr(),
                 shift.data_ptr(), out_p.data_ptr(), out_q.data_ptr(),
                 out_cell.data_ptr(), n_prog, n_slot, cap,
                 stencil.shape[1] // 4, T, krf, crf, keR, int(bool(coulomb)),
                 int(bool(excl)), stream)
    if err != 0:
        raise RuntimeError(f"cellpair_half_ext launch failed: CUDA error {err}")
    cellpair_half_ext.launches += 1
    if excl:
        cellpair_half_ext.launches_excl += 1
    return out_p, out_q, out_cell


cellpair_half_ext.launches = 0
cellpair_half_ext.launches_excl = 0


def sweep_smem_bytes(cap: int, nd: int, nblk: int, ntab: int, nx: int,
                     acc: int, threads: int) -> int:
    """Dynamic shared memory of a CTA of the sweep kernels
    (csrc/sweep.cuh:make_layout): the home cell and nd staged direction
    blocks as 16-byte records with nx extra rows of cap each, a p-side
    accumulator and nblk q-side accumulator blocks of `acc` rows of cap,
    the kept p slots of each direction, a table of ntab floats, a
    SWEEP_QUEUE-entry hit ring per warp and the integer tables."""
    return (16 * cap * (1 + nd) + 4 * cap * nx * (1 + nd)
            + 4 * acc * cap * (1 + nblk) + 4 * cap * nd + 4 * ntab
            + 4 * SWEEP_QUEUE * (threads // 32) + 4 * (8 * nd + nblk + 4))


def _pair_extra_rows(excl: bool) -> int:
    """Extra rows a staged pair slot carries (csrc/pair_hit.cuh): the
    charge, and with exclusions the component id and one more channel."""
    return 3 if excl else 1


def cell_smem_bytes(cap: int, T: int, excl: bool) -> int:
    """The least dynamic shared memory the pair kernel launches with
    (csrc/cellpair_half.cu): one direction a CTA, per cell or over column
    tables alike, so whatever a column's union.  The launch takes more
    directions a CTA while they fit its budget."""
    return sweep_smem_bytes(cap, 1, 1, 3 * T * T, _pair_extra_rows(excl), 4,
                            PAIR_CELL_THREADS)


def cellpair_half_col(slots, stencil_col, member_u, L8, counts, sigma, eps,
                      shift, *, krf: float, crf: float, keR: float,
                      coulomb: bool, excl: bool = False):
    """The pair sweep over column tables: G z-contiguous cells a column,
    each (member, group of directions) a CTA of the per-cell body that
    reads its blocks through the tables (contract in csrc/cellpair_half.cu:
    ddcmd_cellpair_half_col).  stencil_col (ncol, U) from
    pack_stencil_col, member_u (G, 14) from col_plan_grid.

    Returns (per-slot p side (ncell*cap, 4), accumulated q side (ncell, 8,
    cap), per-column (ncol, 8) [e, virial6]).  A CPU tensor runs
    cellpair_half_col_plain; a CUDA tensor launches the kernel (counted in
    `cellpair_half_col.launches`) or raises -- also when a CTA does not
    fit in shared memory (never running another kernel instead)."""
    ncell, cap, T = _check_common(slots, L8, counts, sigma, eps, shift)
    if stencil_col.dim() != 2 or member_u.dim() != 2 \
            or member_u.shape[1] != 14:
        raise ValueError("stencil_col must be (ncol, U), member_u (G, 14)")
    ncol, U = stencil_col.shape
    G = member_u.shape[0]
    if ncol * G != ncell:
        raise ValueError(f"{ncol} columns of {G} cells != {ncell} cells")
    _check({"stencil_col": (stencil_col, torch.int32, (ncol, U)),
            "member_u": (member_u, torch.int32, (G, 14))}, slots.device)
    kw = dict(krf=krf, crf=crf, keR=keR, coulomb=coulomb, excl=excl)
    if slots.device.type == "cpu":
        return cellpair_half_col_plain(slots, stencil_col, member_u, L8,
                                       counts, sigma, eps, shift, **kw)
    smem = cell_smem_bytes(cap, T, excl)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"column kernel: cap={cap}, T={T} need {smem} bytes of shared "
            f"memory, more than the {SMEM_LIMIT} a block may use")
    fn = _kernel_fn("cellpair_half_col", "cellpair_half")
    out_p = torch.zeros((ncell * cap, 4), dtype=torch.float32, device=slots.device)
    out_q = torch.zeros((ncell, 8, cap), dtype=torch.float32, device=slots.device)
    out_col = torch.zeros((ncol, 8), dtype=torch.float32, device=slots.device)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slots.data_ptr(), stencil_col.data_ptr(),
                 member_u.data_ptr(), L8.data_ptr(), counts.data_ptr(),
                 sigma.data_ptr(), eps.data_ptr(), shift.data_ptr(),
                 out_p.data_ptr(), out_q.data_ptr(), out_col.data_ptr(),
                 ncol, cap, G, U, T, krf, crf, keR, int(bool(coulomb)),
                 int(bool(excl)), stream)
    if err != 0:
        raise RuntimeError(f"cellpair_half_col launch failed: CUDA error {err}")
    cellpair_half_col.launches += 1
    return out_p, out_q, out_col


cellpair_half_col.launches = 0


def kernel_inputs(r, q, tidx, perm, box_lengths, grid: CellBlockGrid,
                  tables, gt: dict, coulomb: bool, excl_vals=None):
    """(kernel, args, kw): the wrapper the plan picks -- the column kernel
    when gt["G"] > 1, else the per-cell kernel -- and its arguments as
    cellpair_eval_half packs them.  `grid` comes from half_grid(), `gt`
    from grid_tensors(grid, device, G); excl_vals (n_pad, 2) are the
    exclusion channels or None."""
    n_pad = r.shape[0]
    ncell, cap = grid.ncell, grid.cap
    slots, _ = pack_slots(r, q, tidx, perm, box_lengths, grid,
                          gt["frac_centers"], excl_vals=excl_vals)
    L8 = torch.nn.functional.pad(box_lengths.to(torch.float32)
                                 / gt["ncells"], (0, 5))
    L8[3] = tables["rcut2"]
    # per-cell occupancy: slots fill rank-contiguously, so the count of
    # filled slots bounds both loops of the kernels exactly
    counts = (perm.reshape(ncell, cap) != n_pad).sum(
        dim=1, dtype=torch.int32)
    kw = dict(krf=tables["krf"], crf=tables["crf"], keR=tables["keR"],
              coulomb=coulomb, excl=excl_vals is not None)
    tabs = (tables["sigma"], tables["eps"], tables["shift"])
    if gt["G"] > 1:
        return cellpair_half_col, (slots, gt["stencil"], gt["member_u"],
                                   L8.reshape(1, 8), counts, *tabs), kw
    return cellpair_half, (slots, gt["stencil"], L8.reshape(1, 8), counts,
                           *tabs), kw


def cellpair_eval_half(r, q, tidx, perm, box_lengths, grid: CellBlockGrid,
                       tables, gt: dict, coulomb: bool, excl_vals=None):
    """Forces, energy, virial and per-particle pe of the pair term through
    the kernel the plan picks (counterpart of pallas_cellpair_eval_half;
    arguments as kernel_inputs).  q-side reactions arrive pre-accumulated
    per target cell."""
    n_pad = r.shape[0]
    ncell, cap = grid.ncell, grid.cap
    kernel, args, kw = kernel_inputs(r, q, tidx, perm, box_lengths, grid,
                                     tables, gt, coulomb, excl_vals)
    out_p, out_q, out_cells = kernel(*args, **kw)

    back = out_q.transpose(1, 2).reshape(ncell * cap, 8)
    F = out_p[:, 0:3] + back[:, 0:3]
    pe_slot = out_p[:, 3] + back[:, 3]
    # each particle owns one slot; empty slots write the spill row n_pad
    f = torch.zeros((n_pad + 1, 3), dtype=torch.float32, device=r.device)
    f[perm] = F
    pe = torch.zeros((n_pad + 1,), dtype=torch.float32, device=r.device)
    pe[perm] = pe_slot
    e = out_cells[:, 0].sum()
    v6 = out_cells[:, 1:7].sum(dim=0)
    virial = torch.stack([v6[0], v6[3], v6[4],
                          v6[3], v6[1], v6[5],
                          v6[4], v6[5], v6[2]]).reshape(3, 3)
    return f[:n_pad], e, virial, pe[:n_pad]
