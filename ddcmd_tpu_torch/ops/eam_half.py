"""Two-pass EAM on the half-stencil cell blocks: the kernels, their plain
twins and the evaluation.

Counterpart of ddcmd_tpu/ops/pallas_eam.py for the analytic forms (FS /
SC / EXP / AT / RATIONAL, the last also as the tabularFit=rational refit
of a TABULAR deck) and alloys of 1-4 species:

  eam_rho_half       / eam_rho_half_plain        per-cell pass A (TPU #4)
  eam_force_half     / eam_force_half_plain      per-cell pass B (TPU #4)
  eam_rho_half_col   / eam_rho_half_col_plain    column pass A   (TPU #5)
  eam_force_half_col / eam_force_half_col_plain  column pass B   (TPU #5)
  eam_rho_half_ext   / eam_rho_half_plain        extended-grid pass A (TPU #7)
  eam_force_half_ext / eam_force_half_plain      extended-grid pass B (TPU #7)

and `eam_eval_half` (pallas_eam_eval): pack the slot records with the
particle mask folded into the validity row, run pass A, add the two
sides' densities, compute the embedding F(rho), dF(rho) per slot with
torch ops, write dF into record row 6, run pass B, and scatter the
per-slot force and energy back to particles.

The refit's fits are monomials of a shifted, scaled variable u = (x - X0)
S (ddcmd_tpu/potentials/eam.py:fit_tabular_rational); the kernels take
such a deck as the form RATIONAL_SHIFTED, whose row is the RATIONAL row
followed by SHIFT_KEYS, and the unshifted RATIONAL keeps its own
instruction stream.

The kernels are hand-written CUDA (csrc/eam_half.cu, csrc/eam_half_col.cu,
the two-phase sweep of csrc/sweep.cuh they share with the pair kernels,
their hit evaluator in csrc/eam_sweep.cuh, the per-pair forms in
csrc/eam_forms.cuh), built and loaded like the pair
kernels (ops/cellpair_half.py: nvcc on first use into _build/, ctypes).
The TPU kernels bake the form parameters in as constants; here they
travel as a (T*T, npar) table (`eam_kernel_tables`), one row per ordered
species pair, which the twins read too.  On a CPU tensor a wrapper runs
its plain twin; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..potentials.eam import _embedding, _pair_eval
from .cellpair import CellBlockGrid
from .cellpair_half import (SMEM_LIMIT, SWEEP_QUEUE, _check, _kernel_fn,
                            check_ext, col_to_cell_stencil, pack_slots,
                            sweep_smem_bytes)

# the forms the kernels take, in eam::Form order (csrc/eam_forms.cuh);
# the deck forms are the first five, RATIONAL_SHIFTED is a refit's
FORMS = ("FS", "SC", "EXP", "AT", "RATIONAL", "RATIONAL_SHIFTED")
DECK_FORMS = FORMS[:5]
# the tail of a RATIONAL_SHIFTED row: each fit's shift and scale
SHIFT_KEYS = ("phiX0", "phiS", "rhoX0", "rhoS")
# launch constants of the kernels (kThreads of csrc/eam_half.cu; kThreads
# and kColDirs of csrc/eam_half_col.cu, keyed by `force`: the force and
# the density pass; kQueue of csrc/sweep.cuh), which the shared-memory
# counts mirror
EAM_CELL_THREADS, EAM_QUEUE = 128, SWEEP_QUEUE
EAM_COL_THREADS = {True: 256, False: 384}
EAM_COL_DIRS = {True: 7, False: 14}
# parameter row of each closed form, in the column order eam_forms.cuh
# reads; a RATIONAL row is [phi_cut, rho_cut, phiP, phiQ, rhoP, rhoQ]
# with each coefficient block `degree` wide, a RATIONAL_SHIFTED row the
# same followed by SHIFT_KEYS
PARAM_KEYS = {
    "FS": ("a", "b", "c", "m", "n", "ro", "x"),
    "SC": ("eps", "a", "n", "m"),
    "EXP": ("f_e", "phi_e", "beta", "gamma", "r_e_inv"),
    "AT": ("B", "b0", "alpha", "c", "c0", "c1", "c2", "d"),
}


def eam_half_supported(tables) -> bool:
    """Analytic forms (a refit's too), 1-4 species
    (pallas_eam_supported): not TABULAR, not more than 4 species."""
    return (1 <= int(tables.get("n_species", 0)) <= 4
            and tables.get("form") in DECK_FORMS)


def eam_kernel_tables(tables) -> dict:
    """eam_device_tables' dict plus the kernels' form `kform` (the deck's,
    or RATIONAL_SHIFTED for a refit's tables), their parameter table
    `params` (T*T, npar) f32 and the Horner `degree` (0 but for the
    rationals).  The shorter of the phi and rho fits is zero-padded at
    the top, which leaves its Horner sums unchanged bit for bit."""
    form, pt = tables["form"], tables["pair"]
    TT = int(tables["n_species"]) ** 2
    kform = form
    if form == "RATIONAL":
        degree = max(pt["phiP"].shape[-1], pt["rhoP"].shape[-1])

        def block(k):
            v = pt[k].reshape(TT, -1)
            return torch.nn.functional.pad(v, (0, degree - v.shape[1]))

        cols = [pt["phi_cut"].reshape(TT, 1), pt["rho_cut"].reshape(TT, 1),
                *(block(k) for k in ("phiP", "phiQ", "rhoP", "rhoQ"))]
        if SHIFT_KEYS[0] in pt:
            kform = "RATIONAL_SHIFTED"
            cols += [pt[k].reshape(TT, 1) for k in SHIFT_KEYS]
    else:
        degree = 0
        cols = [pt[k].reshape(TT, 1) for k in PARAM_KEYS[form]]
    params = torch.cat(cols, dim=1).to(torch.float32).contiguous()
    return dict(tables, params=params, degree=degree, kform=kform)


def n_params(form: str, degree: int) -> int:
    """Floats in a parameter row of the kernel form `form`."""
    if form == "RATIONAL":
        return 2 + 4 * degree
    if form == "RATIONAL_SHIFTED":
        return 2 + 4 * degree + len(SHIFT_KEYS)
    return len(PARAM_KEYS[form])


def _unpack(form: str, params, degree: int) -> dict:
    """The pair-table dict _pair_eval reads, from the packed rows of the
    kernel form `form` (a RATIONAL_SHIFTED row adds the shift keys)."""
    if form in ("RATIONAL", "RATIONAL_SHIFTED"):
        D = degree
        pt = dict(phi_cut=params[:, 0], rho_cut=params[:, 1],
                  phiP=params[:, 2:2 + D], phiQ=params[:, 2 + D:2 + 2 * D],
                  rhoP=params[:, 2 + 2 * D:2 + 3 * D],
                  rhoQ=params[:, 2 + 3 * D:2 + 4 * D])
        if form == "RATIONAL_SHIFTED":
            pt.update({k: params[:, 2 + 4 * D + i]
                       for i, k in enumerate(SHIFT_KEYS)})
        return pt
    return {k: params[:, i] for i, k in enumerate(PARAM_KEYS[form])}


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def _blocks(slots, stencil, L8):
    """The half-stencil sweep the twins share: for each direction s, the
    target cells and the (n_prog, cap, cap) pair geometry (dx, dy, dz,
    d2s, ir, ir2, valid) of the home cells' p slots against the shifted
    q blocks (_pair_tile, bcast variant).  The home cells are the first
    n_prog = stencil.shape[0] slot cells: all of them on a single-device
    grid, the core cells on a brick's extended grid."""
    _, _, cap = slots.shape
    dt = slots.dtype
    L8 = L8.reshape(-1)
    rcut2 = L8[3]
    home = slots[:stencil.shape[0]]
    px, py, pz = home[:, 0, :, None], home[:, 1, :, None], home[:, 2, :, None]
    pv = home[:, 5, :, None]
    upper = (torch.arange(cap, device=slots.device)[None, :]
             > torch.arange(cap, device=slots.device)[:, None])   # j > i
    for s in range(stencil.shape[1] // 4):
        tgt = stencil[:, 4 * s].long()
        sh = stencil[:, 4 * s + 1:4 * s + 4].to(dt) * L8[0:3]  # (C,3)
        Q = slots[tgt]                                         # (C,8,cap)
        dx = px - (Q[:, 0] + sh[:, 0:1])[:, None, :]           # (C,cap,cap)
        dy = py - (Q[:, 1] + sh[:, 1:2])[:, None, :]
        dz = pz - (Q[:, 2] + sh[:, 2:3])[:, None, :]
        d2 = dx * dx + dy * dy + dz * dz
        valid = (pv * Q[:, 5, None, :] > 0) & (d2 < rcut2) & (d2 > 0)
        if s == 0:
            valid = valid & upper
        d2s = torch.where(valid, d2, torch.ones_like(d2))
        yield tgt, Q, (dx, dy, dz), d2s, torch.rsqrt(d2s), 1.0 / d2s, valid


def _typed(form, pt, T, ptype, Q, d2s, ir, ir2, derivative):
    """(e, p, pT): the pair term and density term at (t_p, t_q) and the
    density term at (t_q, t_p), the density on the q side
    (_typed_pair_sums)."""
    if form == "RATIONAL_SHIFTED":    # _pair_eval reads the shift from pt
        form = "RATIONAL"
    if T == 1:
        e, p = _pair_eval(form, pt, 0, d2s, ir, ir2, derivative)
        return e, p, p
    qtype = Q[:, 4].long()[:, None, :]
    e, p = _pair_eval(form, pt, ptype * T + qtype, d2s, ir, ir2, derivative)
    _, pT = _pair_eval(form, pt, qtype * T + ptype, d2s, ir, ir2, derivative)
    return e, p, pT


def eam_rho_half_plain(slots, stencil, L8, counts, params, *, form: str,
                       T: int, degree: int):
    """Plain PyTorch version of the per-cell density pass, and of the
    extended-grid one (p side over the first n_prog = stencil.shape[0]
    cells): (per-slot p side (n_prog*cap, 2) [rho, pe], accumulated q
    side (ncell, 8, cap) rows [rho, pe, 0...]).  Loops over the stencil
    blocks; the q side is scattered with index_add_.  `counts` is not
    needed: empty slots carry valid = 0."""
    del counts
    ncell, _, cap = slots.shape
    n_prog = stencil.shape[0]
    pt = _unpack(form, params, degree)
    ptype = slots[:n_prog, 4].long()[:, :, None]
    out_p = torch.zeros((n_prog, cap, 2), dtype=slots.dtype, device=slots.device)
    acc = torch.zeros((ncell, 2, cap), dtype=slots.dtype, device=slots.device)
    for tgt, Q, _, d2s, ir, ir2, valid in _blocks(slots, stencil, L8):
        e, p, pT = (torch.where(valid, x, 0.0) for x in
                    _typed(form, pt, T, ptype, Q, d2s, ir, ir2, False))
        out_p += torch.stack([p.sum(2), 0.5 * e.sum(2)], dim=2)
        acc.index_add_(0, tgt, torch.stack([pT.sum(1), 0.5 * e.sum(1)], 1))
    return (out_p.reshape(n_prog * cap, 2),
            torch.cat([acc, torch.zeros((ncell, 6, cap), dtype=slots.dtype,
                                        device=slots.device)], dim=1))


def eam_force_half_plain(slots, stencil, L8, counts, params, *, form: str,
                         T: int, degree: int):
    """Plain PyTorch version of the per-cell force pass (dF in record row
    6), and of the extended-grid one (p side over the first n_prog =
    stencil.shape[0] cells): (p-side force (n_prog*cap, 3), accumulated
    q-side reaction (ncell, 8, cap) rows [fx, fy, fz, 0...], per-home-cell
    (n_prog, 8) [vxx vyy vzz vxy vxz vyz 0 0] with each pair once)."""
    del counts
    ncell, _, cap = slots.shape
    n_prog = stencil.shape[0]
    pt = _unpack(form, params, degree)
    ptype = slots[:n_prog, 4].long()[:, :, None]
    dFp = slots[:n_prog, 6, :, None]
    out_f = torch.zeros((n_prog, cap, 3), dtype=slots.dtype, device=slots.device)
    acc = torch.zeros((ncell, 3, cap), dtype=slots.dtype, device=slots.device)
    out_cell = torch.zeros((n_prog, 8), dtype=slots.dtype, device=slots.device)
    for tgt, Q, (dx, dy, dz), d2s, ir, ir2, valid in _blocks(slots, stencil, L8):
        de, dp, dpT = _typed(form, pt, T, ptype, Q, d2s, ir, ir2, True)
        coef = torch.where(valid, de + dFp * dp + Q[:, 6, None, :] * dpT, 0.0)
        fdx, fdy, fdz = coef * dx, coef * dy, coef * dz
        out_f -= torch.stack([fdx.sum(2), fdy.sum(2), fdz.sum(2)], dim=2)
        acc.index_add_(0, tgt, torch.stack(
            [fdx.sum(1), fdy.sum(1), fdz.sum(1)], 1))
        out_cell[:, :6] -= torch.stack([
            (fdx * dx).sum((1, 2)), (fdy * dy).sum((1, 2)),
            (fdz * dz).sum((1, 2)), (fdx * dy).sum((1, 2)),
            (fdx * dz).sum((1, 2)), (fdy * dz).sum((1, 2))], dim=1)
    return (out_f.reshape(n_prog * cap, 3),
            torch.cat([acc, torch.zeros((ncell, 5, cap), dtype=slots.dtype,
                                        device=slots.device)], dim=1),
            out_cell)


def eam_rho_half_col_plain(slots, stencil_col, member_u, L8, counts, params,
                           *, form: str, T: int, degree: int):
    """Plain PyTorch version of the column density pass: the per-cell
    twin over the per-cell stencil the column table encodes."""
    return eam_rho_half_plain(slots, col_to_cell_stencil(stencil_col,
                                                         member_u),
                              L8, counts, params, form=form, T=T,
                              degree=degree)


def eam_force_half_col_plain(slots, stencil_col, member_u, L8, counts,
                             params, *, form: str, T: int, degree: int):
    """Plain PyTorch version of the column force pass: the per-cell twin
    over the encoded per-cell stencil, the virial summed per column."""
    G = member_u.shape[0]
    out_f, out_q, out_cell = eam_force_half_plain(
        slots, col_to_cell_stencil(stencil_col, member_u), L8, counts,
        params, form=form, T=T, degree=degree)
    return out_f, out_q, out_cell.reshape(-1, G, 8).sum(dim=1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_eam(slots, L8, counts, params, form, T, degree):
    if slots.dim() != 3 or slots.shape[1] != 8:
        raise ValueError(f"slots must be (ncell, 8, cap), got {tuple(slots.shape)}")
    if form not in FORMS:
        raise ValueError(f"EAM form {form!r}: the kernels take {FORMS}")
    if not 1 <= T <= 4:
        raise ValueError(f"T={T}: the kernels take 1-4 species")
    ncell, _, cap = slots.shape
    npar = n_params(form, degree)
    _check({"slots": (slots, torch.float32, (ncell, 8, cap)),
            "L8": (L8, torch.float32, (1, 8)),
            "counts": (counts, torch.int32, (ncell,)),
            "params": (params, torch.float32, (T * T, npar))}, slots.device)
    if slots.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu, not {slots.device}")
    if slots.device.type == "cuda" and (cap % 32 or not 32 <= cap <= 1024):
        raise ValueError(f"cap={cap}: the kernels take multiples of 32 up to 1024")
    return ncell, cap, npar


def _eam_half(force: bool, slots, stencil, L8, counts, params, *, form, T,
              degree):
    ncell, cap, npar = _check_eam(slots, L8, counts, params, form, T, degree)
    if stencil.dim() != 2 or stencil.shape[1] % 4:
        raise ValueError("stencil must be (ncell, S*4)")
    _check({"stencil": (stencil, torch.int32, (ncell, stencil.shape[1]))},
           slots.device)
    kw = dict(form=form, T=T, degree=degree)
    if slots.device.type == "cpu":
        plain = eam_force_half_plain if force else eam_rho_half_plain
        return plain(slots, stencil, L8, counts, params, **kw)
    if eam_cell_smem_bytes(cap, T, npar, force) > SMEM_LIMIT:
        raise ValueError(f"T={T} tables do not fit in shared memory at cap={cap}")
    fn = _kernel_fn("eam_half")
    dev = slots.device
    width = 3 if force else 2
    out_p = torch.zeros((ncell * cap, width), dtype=torch.float32, device=dev)
    out_q = torch.zeros((ncell, 8, cap), dtype=torch.float32, device=dev)
    out_cell = torch.zeros((ncell, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slots.data_ptr(), stencil.data_ptr(), L8.data_ptr(),
                 counts.data_ptr(), params.data_ptr(), out_p.data_ptr(),
                 out_q.data_ptr(), out_cell.data_ptr(), ncell, cap,
                 stencil.shape[1] // 4, T, npar, degree, FORMS.index(form),
                 int(force), stream)
    if err != 0:
        raise RuntimeError(f"eam_half launch failed: CUDA error {err}")
    return (out_p, out_q, out_cell) if force else (out_p, out_q)


def eam_rho_half(slots, stencil, L8, counts, params, *, form: str, T: int,
                 degree: int):
    """EAM density pass on the half stencil, one CTA per (cell, group of
    directions) (contract in csrc/eam_half.cu).  Returns (p side (ncell*cap, 2) [rho,
    pe], accumulated q side (ncell, 8, cap) rows [rho, pe, 0...]).  A CPU
    tensor runs eam_rho_half_plain; a CUDA tensor launches the kernel
    (counted in `eam_rho_half.launches`) or raises."""
    out = _eam_half(False, slots, stencil, L8, counts, params, form=form,
                    T=T, degree=degree)
    if slots.device.type == "cuda":
        eam_rho_half.launches += 1
    return out


def eam_force_half(slots, stencil, L8, counts, params, *, form: str, T: int,
                   degree: int):
    """EAM force pass (dF in record row 6) on the half stencil (contract
    in csrc/eam_half.cu).  Returns (p-side force (ncell*cap, 3), q-side
    reaction (ncell, 8, cap), per-cell (ncell, 8) [virial6, 0, 0]).  A CPU
    tensor runs eam_force_half_plain; a CUDA tensor launches the kernel
    (counted in `eam_force_half.launches`) or raises."""
    out = _eam_half(True, slots, stencil, L8, counts, params, form=form,
                    T=T, degree=degree)
    if slots.device.type == "cuda":
        eam_force_half.launches += 1
    return out


eam_rho_half.launches = 0
eam_force_half.launches = 0


def _eam_half_ext(force: bool, slots, stencil, L8, counts, params, *, form,
                  T, degree):
    n_prog, n_slot, cap = check_ext(slots, stencil, counts)
    _, _, npar = _check_eam(slots, L8, counts, params, form, T, degree)
    kw = dict(form=form, T=T, degree=degree)
    if slots.device.type == "cpu":
        plain = eam_force_half_plain if force else eam_rho_half_plain
        return plain(slots, stencil, L8, counts, params, **kw)
    if eam_cell_smem_bytes(cap, T, npar, force) > SMEM_LIMIT:
        raise ValueError(f"T={T} tables do not fit in shared memory at cap={cap}")
    dev = slots.device
    out_p = torch.zeros((n_prog * cap, 3 if force else 2),
                        dtype=torch.float32, device=dev)
    out_q = torch.zeros((n_slot, 8, cap), dtype=torch.float32, device=dev)
    ptrs = [slots.data_ptr(), stencil.data_ptr(), L8.data_ptr(),
            counts.data_ptr(), params.data_ptr(), out_p.data_ptr(),
            out_q.data_ptr()]
    if force:
        out_cell = torch.zeros((n_prog, 8), dtype=torch.float32, device=dev)
        ptrs.append(out_cell.data_ptr())
    name = "eam_force_half_ext" if force else "eam_rho_half_ext"
    fn = _kernel_fn(name, "eam_half")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, n_prog, n_slot, cap, stencil.shape[1] // 4, T, npar,
                 degree, FORMS.index(form), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return (out_p, out_q, out_cell) if force else (out_p, out_q)


def eam_rho_half_ext(slots, stencil, L8, counts, params, *, form: str,
                     T: int, degree: int):
    """The density pass on a brick's extended cell grid (contract in
    csrc/eam_half.cu:ddcmd_eam_rho_half_ext): programs over the n_prog
    core cells (stencil rows), slots and counts over all n_slot cells.
    Returns (p side (n_prog*cap, 2) [rho, pe], accumulated q side (n_slot,
    8, cap)).  A CPU tensor runs eam_rho_half_plain; a CUDA tensor
    launches the kernel (counted in `eam_rho_half_ext.launches`) or
    raises."""
    out = _eam_half_ext(False, slots, stencil, L8, counts, params, form=form,
                        T=T, degree=degree)
    if slots.device.type == "cuda":
        eam_rho_half_ext.launches += 1
    return out


def eam_force_half_ext(slots, stencil, L8, counts, params, *, form: str,
                       T: int, degree: int):
    """The force pass (dF in record row 6) on a brick's extended cell
    grid (contract in csrc/eam_half.cu:ddcmd_eam_force_half_ext).
    Returns (p-side force (n_prog*cap, 3), q-side reaction (n_slot, 8,
    cap), per-core-cell (n_prog, 8) [virial6, 0, 0]).  A CPU tensor runs
    eam_force_half_plain; a CUDA tensor launches the kernel (counted in
    `eam_force_half_ext.launches`) or raises."""
    out = _eam_half_ext(True, slots, stencil, L8, counts, params, form=form,
                        T=T, degree=degree)
    if slots.device.type == "cuda":
        eam_force_half_ext.launches += 1
    return out


eam_rho_half_ext.launches = 0
eam_force_half_ext.launches = 0


def _sweep_smem_bytes(cap: int, nd: int, nblk: int, ntab: int,
                      force: bool, threads: int) -> int:
    """Dynamic shared memory of a CTA of the EAM kernels
    (csrc/eam_sweep.cuh:make_layout on csrc/sweep.cuh's): the dF rows (pass
    B) as the one extra row, 2 (3) accumulator rows."""
    return sweep_smem_bytes(cap, nd, nblk, ntab, 1 if force else 0,
                            3 if force else 2, threads)


def eam_cell_smem_bytes(cap: int, T: int, npar: int,
                        force: bool = True) -> int:
    """The least dynamic shared memory a per-cell EAM pass launches with
    (csrc/eam_half.cu): one direction a CTA.  The launch takes more
    directions a CTA while they fit its budget."""
    return _sweep_smem_bytes(cap, 1, 1, T * T * npar, force,
                             EAM_CELL_THREADS)


def eam_col_smem_bytes(U: int, cap: int, T: int, npar: int,
                       force: bool = True) -> int:
    """Dynamic shared memory of a column EAM pass (csrc/eam_half_col.cu):
    EAM_COL_DIRS[force] staged direction blocks a round and one q-side
    accumulator block per union block.  The force pass is the larger."""
    return _sweep_smem_bytes(cap, EAM_COL_DIRS[force], U, T * T * npar,
                             force, EAM_COL_THREADS[force])


def _eam_half_col(force: bool, slots, stencil_col, member_u, L8, counts,
                  params, *, form, T, degree):
    ncell, cap, npar = _check_eam(slots, L8, counts, params, form, T, degree)
    if stencil_col.dim() != 2 or member_u.dim() != 2 \
            or member_u.shape[1] != 14:
        raise ValueError("stencil_col must be (ncol, U), member_u (G, 14)")
    ncol, U = stencil_col.shape
    G = member_u.shape[0]
    if ncol * G != ncell:
        raise ValueError(f"{ncol} columns of {G} cells != {ncell} cells")
    _check({"stencil_col": (stencil_col, torch.int32, (ncol, U)),
            "member_u": (member_u, torch.int32, (G, 14))}, slots.device)
    kw = dict(form=form, T=T, degree=degree)
    if slots.device.type == "cpu":
        plain = eam_force_half_col_plain if force else eam_rho_half_col_plain
        return plain(slots, stencil_col, member_u, L8, counts, params, **kw)
    smem = eam_col_smem_bytes(U, cap, T, npar, force)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"column EAM kernel: {U} union blocks at cap={cap} need {smem} "
            f"bytes of shared memory, more than the {SMEM_LIMIT} a block "
            "may use")
    fn = _kernel_fn("eam_half_col")
    dev = slots.device
    width = 3 if force else 2
    out_p = torch.zeros((ncell * cap, width), dtype=torch.float32, device=dev)
    out_q = torch.zeros((ncell, 8, cap), dtype=torch.float32, device=dev)
    out_col = torch.zeros((ncol, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slots.data_ptr(), stencil_col.data_ptr(),
                 member_u.data_ptr(), L8.data_ptr(), counts.data_ptr(),
                 params.data_ptr(), out_p.data_ptr(), out_q.data_ptr(),
                 out_col.data_ptr(), ncol, cap, G, U, T, npar, degree,
                 FORMS.index(form), int(force), stream)
    if err != 0:
        raise RuntimeError(f"eam_half_col launch failed: CUDA error {err}")
    return (out_p, out_q, out_col) if force else (out_p, out_q)


def eam_rho_half_col(slots, stencil_col, member_u, L8, counts, params, *,
                     form: str, T: int, degree: int):
    """Column density pass: one CTA per column of G z-contiguous cells,
    the q-side sums of the column's U union blocks kept in shared memory
    (contract in csrc/eam_half_col.cu).  Returns as eam_rho_half.  A CPU
    tensor runs eam_rho_half_col_plain; a CUDA tensor launches the kernel
    (counted in `eam_rho_half_col.launches`) or raises -- also when the
    union's sums do not fit in shared memory."""
    out = _eam_half_col(False, slots, stencil_col, member_u, L8, counts,
                        params, form=form, T=T, degree=degree)
    if slots.device.type == "cuda":
        eam_rho_half_col.launches += 1
    return out


def eam_force_half_col(slots, stencil_col, member_u, L8, counts, params, *,
                       form: str, T: int, degree: int):
    """Column force pass.  Returns (p-side force (ncell*cap, 3), q-side
    reaction (ncell, 8, cap), per-column (ncol, 8) [virial6, 0, 0]).  A
    CPU tensor runs eam_force_half_col_plain; a CUDA tensor launches the
    kernel (counted in `eam_force_half_col.launches`) or raises."""
    out = _eam_half_col(True, slots, stencil_col, member_u, L8, counts,
                        params, form=form, T=T, degree=degree)
    if slots.device.type == "cuda":
        eam_force_half_col.launches += 1
    return out


eam_rho_half_col.launches = 0
eam_force_half_col.launches = 0


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def eam_kernel_inputs(r, sidx, fmask, perm, box_lengths, grid: CellBlockGrid,
                      tables, gt: dict):
    """(rho_kernel, force_kernel, slots, args, kw): the two passes the plan
    picks -- the column kernels when gt["G"] > 1, else the per-cell ones
    -- with the packed slot records (species index in row 4, the particle
    mask folded into row 5) and the arguments after them, as
    eam_eval_half calls them.  `tables` from eam_kernel_tables, `gt` from
    grid_tensors(grid, device, G)."""
    n_pad = r.shape[0]
    ncell, cap = grid.ncell, grid.cap
    q0 = torch.zeros((n_pad,), dtype=torch.float32, device=r.device)
    slots, _ = pack_slots(r, q0, sidx, perm, box_lengths, grid,
                          gt["frac_centers"])
    fm_ext = torch.cat([fmask.to(torch.float32),
                        torch.zeros((1,), dtype=torch.float32,
                                    device=r.device)])
    slots[:, 5, :] *= fm_ext[perm].reshape(ncell, cap)
    L8 = torch.nn.functional.pad(box_lengths.to(torch.float32)
                                 / gt["ncells"], (0, 5))
    L8[3] = tables["rcut2"]
    counts = (perm.reshape(ncell, cap) != n_pad).sum(dim=1, dtype=torch.int32)
    kw = dict(form=tables["kform"], T=int(tables["n_species"]),
              degree=tables["degree"])
    if gt["G"] > 1:
        return (eam_rho_half_col, eam_force_half_col, slots,
                (gt["stencil"], gt["member_u"], L8.reshape(1, 8), counts,
                 tables["params"]), kw)
    return (eam_rho_half, eam_force_half, slots,
            (gt["stencil"], L8.reshape(1, 8), counts, tables["params"]), kw)


def embed_slots(slots, out_p, acc_a, tables):
    """Between the passes: rho = p side + q side of pass A per slot, the
    embedding F(rho), dF(rho) with torch ops, dF written into record row
    6 of `slots` in place (pass A does not read it).  Returns the
    per-slot energy, half the pair energies plus F.  On an extended grid
    the p side covers the first n_prog cells only (the rest add none)."""
    ncell, _, cap = slots.shape
    out_p = torch.nn.functional.pad(out_p, (0, 0, 0,
                                            ncell * cap - out_p.shape[0]))
    rho = out_p[:, 0] + acc_a[:, 0, :].reshape(-1)             # (ncell*cap,)
    pe_pair = out_p[:, 1] + acc_a[:, 1, :].reshape(-1)
    valid = slots[:, 5, :].reshape(-1) > 0
    F_emb, dF = _embedding(tables["form"], tables["embed"],
                           slots[:, 4, :].reshape(-1).long(), rho)
    slots[:, 6, :] = torch.where(valid, dF, 0.0).reshape(ncell, cap)
    return pe_pair + torch.where(valid, F_emb, 0.0)


def eam_eval_half(r, sidx, fmask, perm, box_lengths, grid: CellBlockGrid,
                  tables, gt: dict):
    """Forces, energy, virial and per-particle pe of the EAM term through
    the two passes the plan picks (counterpart of pallas_eam_eval;
    arguments as eam_kernel_inputs)."""
    n_pad = r.shape[0]
    rho_k, force_k, slots, args, kw = eam_kernel_inputs(
        r, sidx, fmask, perm, box_lengths, grid, tables, gt)
    out_p, acc_a = rho_k(slots, *args, **kw)
    pe_slot = embed_slots(slots, out_p, acc_a, tables)
    out_f, acc_b, out_cells = force_k(slots, *args, **kw)

    F = out_f + acc_b[:, 0:3, :].transpose(1, 2).reshape(-1, 3)
    # each particle owns one slot; empty slots write the spill row n_pad
    f = torch.zeros((n_pad + 1, 3), dtype=torch.float32, device=r.device)
    f[perm] = F
    pe = torch.zeros((n_pad + 1,), dtype=torch.float32, device=r.device)
    pe[perm] = pe_slot
    v6 = out_cells[:, 0:6].sum(dim=0)
    virial = torch.stack([v6[0], v6[3], v6[4],
                          v6[3], v6[1], v6[5],
                          v6[4], v6[5], v6[2]]).reshape(3, 3)
    return f[:n_pad], pe_slot.sum(), virial, pe[:n_pad]
