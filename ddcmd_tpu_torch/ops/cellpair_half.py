"""Half-stencil cell-pair engine: planning, slot packing and the kernel.

Counterpart of ddcmd_tpu/ops/pallas_cellpair.py for the main path:
`plan_lanes` (fat cells sized to a lane capacity), `pack_stencil` and
`pack_slots` (the (ncell, 8, cap) record contract), the kernel wrapper
`cellpair_half` with its plain PyTorch twin `cellpair_half_plain`, and
`cellpair_eval_half` (the counterpart of pallas_cellpair_eval_half):
pack, run the kernel, scatter the per-slot results back to particles.

The kernel is hand-written CUDA (csrc/cellpair_half.cu).  It is compiled
with nvcc on first use into `ddcmd_tpu_torch/_build/` and loaded with
ctypes; nothing is compiled or imported for it when this module loads.
On a CPU tensor the wrapper runs the plain twin; on a CUDA tensor it
launches the kernel or raises.

The TPU kernel's `_alias_groups_half` (merging stencil directions that
reach one cell through two periodic images before its in-order q-side
read-modify-write) has no counterpart: the CUDA kernel adds the q side
with atomics and the twin with index_add_, both exact under aliasing.
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

from .cellpair import CellBlockGrid, _build_stencil, _cell_coords

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "cellpair_half.cu")
_BUILD = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD, "libcellpair_half.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


# ---------------------------------------------------------------------------
# planning and packing (host + torch)
# ---------------------------------------------------------------------------

LANE_CAP = 128


def plan_lanes(box_lengths, rcut: float, skin: float, n_particles: int,
               density_safety: float = 1.3) -> CellBlockGrid:
    """Plan a FAT cell grid: cells as large as the lane capacity allows
    (expected occupancy * safety <= LANE_CAP) but never smaller than
    rlist, then greedily coarsened; cap rounds up to a multiple of 128.
    Same plan as the JAX package at its defaults (static box)."""
    L = np.asarray(box_lengths, dtype=np.float64)
    rlist = rcut + skin
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
                  max(1, int(math.floor(l / rlist)))) for l in L]
    # refine to feasibility (the closed-form edge ignores the Poisson
    # tail), adding cells on the fattest axis while the rlist floor allows
    for _ in range(64):
        if need(ncells) <= LANE_CAP:
            break
        grow = [i for i in range(3)
                if ncells[i] + 1 <= max(1, int(math.floor(L[i] / rlist)))]
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


def grid_tensors(grid: CellBlockGrid, device) -> dict:
    """The grid's constant device tensors, made once per plan so the
    per-step path copies nothing from the host."""
    return dict(
        stencil=torch.as_tensor(pack_stencil(grid), device=device),
        frac_centers=torch.as_tensor(frac_centers(grid), device=device),
        ncells=torch.tensor(grid.ncells, dtype=torch.float32, device=device),
    )


def pack_slots(r, q, tidx, perm, box_lengths, grid: CellBlockGrid,
               frac_centers_t):
    """(ncell, 8, cap) f32 slot records in cell-centred coordinates:
    rows [x, y, z, q, type, valid, ex6, ex7] (ex6/ex7, the in-kernel
    exclusion channels, are zero: exclusions are slice 2).  Returns
    (slots, centers)."""
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
    P = r_ext[perm].reshape(ncell, cap, 3) - centers[:, None, :]
    rec = torch.cat([
        P,
        q_ext[perm].reshape(ncell, cap, 1),
        t_ext[perm].reshape(ncell, cap, 1),
        v_ext[perm].reshape(ncell, cap, 1),
        torch.zeros((ncell, cap, 2), dtype=dt, device=r.device),
    ], dim=2)                                                   # (C,cap,8)
    return rec.transpose(1, 2).contiguous(), centers


# ---------------------------------------------------------------------------
# the kernel: plain twin, build, wrapper
# ---------------------------------------------------------------------------

def cellpair_half_plain(slots, stencil, L8, counts, sigma, eps, shift, *,
                        krf: float, crf: float, keR: float, coulomb: bool):
    """Plain PyTorch version of the kernel (same contract and outputs).
    Loops over the stencil blocks so memory stays at (ncell, cap, cap)
    per block; the q side is scattered with index_add_.  `counts` is not
    needed: empty slots carry valid = 0."""
    del counts
    ncell, _, cap = slots.shape
    S = stencil.shape[1] // 4
    T = sigma.shape[0]
    dt = slots.dtype
    dev = slots.device
    L8 = L8.reshape(-1)
    rcut2 = L8[3]
    px, py, pz = slots[:, 0, :, None], slots[:, 1, :, None], slots[:, 2, :, None]
    pq, pv = slots[:, 3, :, None], slots[:, 5, :, None]
    pt = slots[:, 4].long()
    upper = (torch.arange(cap, device=dev)[None, :]
             > torch.arange(cap, device=dev)[:, None])        # j > i
    out_p = torch.zeros((ncell, cap, 4), dtype=dt, device=dev)
    out_q4 = torch.zeros((ncell, 4, cap), dtype=dt, device=dev)
    out_cell = torch.zeros((ncell, 8), dtype=dt, device=dev)
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
    return out_p.reshape(ncell * cap, 4), out_q, out_cell


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/cellpair_half.cu")
    return nvcc


def build_kernel(force: bool = False) -> str:
    """Compile csrc/cellpair_half.cu with nvcc into _build/ (when missing,
    older than the source, or `force`); returns the library path.  The
    compiler's report (-Xptxas -v: registers, shared memory, spills) is
    kept beside it in _build/cellpair_half.ptxas.txt."""
    with _lock:
        return _build_locked(force)


def _build_locked(force: bool) -> str:
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
    with open(os.path.join(_BUILD, "cellpair_half.ptxas.txt"), "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _kernel_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build_locked(False))
            fn = lib.ddcmd_cellpair_half
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                           + [ctypes.c_float] * 3 + [ctypes.c_int,
                                                     ctypes.c_void_p])
            _lib = lib
        return _lib


def _check_args(slots, stencil, L8, counts, sigma, eps, shift):
    if slots.dim() != 3 or slots.shape[1] != 8:
        raise ValueError(f"slots must be (ncell, 8, cap), got {tuple(slots.shape)}")
    ncell, _, cap = slots.shape
    T = sigma.shape[0] if sigma.dim() == 2 else -1
    want = {"slots": (slots, torch.float32, (ncell, 8, cap)),
            "stencil": (stencil, torch.int32, (ncell, stencil.shape[-1])),
            "L8": (L8, torch.float32, (1, 8)),
            "counts": (counts, torch.int32, (ncell,)),
            "sigma": (sigma, torch.float32, (T, T)),
            "eps": (eps, torch.float32, (T, T)),
            "shift": (shift, torch.float32, (T, T))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != slots.device:
            raise ValueError(f"{name} is on {t.device}, slots on {slots.device}")
    if stencil.shape[1] % 4 or T < 1:
        raise ValueError("stencil must be (ncell, S*4); tables (T, T), T >= 1")


def cellpair_half(slots, stencil, L8, counts, sigma, eps, shift, *,
                  krf: float, crf: float, keR: float, coulomb: bool,
                  excl: bool = False):
    """N3L half-stencil pair sweep (contract in csrc/cellpair_half.cu).

    Returns (per-slot p side (ncell*cap, 4) [f, pe], accumulated q side
    (ncell, 8, cap), per-cell (ncell, 8) [e, virial6]).  A CPU tensor runs
    cellpair_half_plain; a CUDA tensor launches the kernel (counted in
    `cellpair_half.launches`) or raises."""
    if excl:
        raise NotImplementedError(
            "in-kernel exclusions are slice 2 (ROADMAP queue 2, kernel "
            "item 1: the excl channels)")
    _check_args(slots, stencil, L8, counts, sigma, eps, shift)
    if slots.device.type == "cpu":
        return cellpair_half_plain(slots, stencil, L8, counts, sigma, eps,
                                   shift, krf=krf, crf=crf, keR=keR,
                                   coulomb=coulomb)
    if slots.device.type != "cuda":
        raise ValueError(f"cellpair_half runs on cuda or cpu, not {slots.device}")
    ncell, _, cap = slots.shape
    T = sigma.shape[0]
    if cap % 32 or not 32 <= cap <= 1024:
        raise ValueError(f"cap={cap}: the kernel takes multiples of 32 up to 1024")
    if ncell > 65535:
        raise ValueError(f"ncell={ncell} exceeds the grid's y extent (65535)")
    if (10 * cap + 3 * T * T) * 4 > 227 * 1024:
        raise ValueError(f"T={T} tables do not fit in shared memory at cap={cap}")
    lib = _kernel_lib()
    out_p = torch.zeros((ncell * cap, 4), dtype=torch.float32, device=slots.device)
    out_q = torch.zeros((ncell, 8, cap), dtype=torch.float32, device=slots.device)
    out_cell = torch.zeros((ncell, 8), dtype=torch.float32, device=slots.device)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ddcmd_cellpair_half(
            slots.data_ptr(), stencil.data_ptr(), L8.data_ptr(),
            counts.data_ptr(), sigma.data_ptr(), eps.data_ptr(),
            shift.data_ptr(), out_p.data_ptr(), out_q.data_ptr(),
            out_cell.data_ptr(), ncell, cap, stencil.shape[1] // 4, T,
            krf, crf, keR, int(bool(coulomb)), stream)
    if err != 0:
        raise RuntimeError(f"cellpair_half launch failed: CUDA error {err}")
    cellpair_half.launches += 1
    return out_p, out_q, out_cell


cellpair_half.launches = 0


def cellpair_eval_half(r, q, tidx, perm, box_lengths, grid: CellBlockGrid,
                       tables, gt: dict, coulomb: bool):
    """Forces, energy, virial and per-particle pe of the pair term through
    the kernel (counterpart of pallas_cellpair_eval_half).  `grid` comes
    from half_grid(), `gt` from grid_tensors(grid, device); q-side
    reactions arrive pre-accumulated per target cell."""
    n_pad = r.shape[0]
    dt = torch.float32
    ncell, cap = grid.ncell, grid.cap
    slots, _ = pack_slots(r, q, tidx, perm, box_lengths, grid,
                          gt["frac_centers"])
    L8 = torch.nn.functional.pad(box_lengths.to(dt) / gt["ncells"], (0, 5))
    L8[3] = tables["rcut2"]
    # per-cell occupancy: slots fill rank-contiguously, so the count of
    # filled slots bounds both loops of the kernel exactly
    counts = (perm.reshape(ncell, cap) != n_pad).sum(
        dim=1, dtype=torch.int32)
    out_p, out_q, out_cells = cellpair_half(
        slots, gt["stencil"], L8.reshape(1, 8), counts, tables["sigma"],
        tables["eps"], tables["shift"], krf=tables["krf"], crf=tables["crf"],
        keR=tables["keR"], coulomb=coulomb)

    back = out_q.transpose(1, 2).reshape(ncell * cap, 8)
    F = out_p[:, 0:3] + back[:, 0:3]
    pe_slot = out_p[:, 3] + back[:, 3]
    # each particle owns one slot; empty slots write the spill row n_pad
    f = torch.zeros((n_pad + 1, 3), dtype=dt, device=r.device)
    f[perm] = F
    pe = torch.zeros((n_pad + 1,), dtype=dt, device=r.device)
    pe[perm] = pe_slot
    e = out_cells[:, 0].sum()
    v6 = out_cells[:, 1:7].sum(dim=0)
    virial = torch.stack([v6[0], v6[3], v6[4],
                          v6[3], v6[1], v6[5],
                          v6[4], v6[5], v6[2]]).reshape(3, 3)
    return f[:n_pad], e, virial, pe[:n_pad]
