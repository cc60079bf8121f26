"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--kernels-only]

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; imports
nothing of JAX.  Phases, one line each (any failure raises, exit != 0):

  1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc;
  2. build: compile every kernel of the main paths from csrc/, one nvcc
     process per source, all started together (ptxas registers, spills);
  3. kernel vs plain: each kernel's wrapper against its plain PyTorch
     twin on the same CUDA tensors, with CUDA-event times per call:
     - the per-cell kernel at the water box's shapes (80 cells, cap 128,
       one LJ type, no Coulomb) and on charged two-type systems whose
       grids have 3-, 2- and 1-cell axes;
     - the per-cell kernel with exclusions on a small bilayer whose grid
       stays on the per-cell kernel;
     - the column kernel on the full bilayer's packed slots (the grid, G
       and cap plan_lanes and choose_col_group give), on a charged grid
       with nz == G (aliased union), and against the per-cell kernel on
       the same full-bilayer slots (their times side by side, and beside
       the times of the bodies they replaced);
     - both pair kernels on a ragged occupancy (cells of 0, 1, 31, 32, 33
       and cap live slots, a tenth of the live slots masked) at cap 128
       and 256, charged, two LJ types, without and with exclusion
       channels, the column kernel at G = 2 and G = nz = 4; and on the
       same slots packed from a binning made before the particles moved
       by up to half the skin, so particles lie outside their cells;
     - the per-cell EAM kernels (density and force pass) on the nc = 12
       crystal's slots: RATIONAL (the deck's form), FS, SC, EXP, AT and
       a T = 2 FS alloy with an asymmetric density; the column EAM
       kernels on the nc = 32 crystal's slots, on an nz == G grid, and
       against the per-cell EAM kernels on the nc = 32 slots (their times
       side by side, and beside the times of the bodies they replaced);
       both on a ragged occupancy (cells of 0, 1, 31, 32, 33 and cap live
       slots, a tenth of the slots masked inside the counts) at cap 128
       and at cap 256;
     - the per-cell pair and EAM kernels on plans of more than 65,535
       cells at cap 32, most cells empty;
     - the full-stencil kernel (TPU #3) on the water box's records, on
       the full bilayer's (T = 5, reaction field; two calls also against
       each other), on charged grids with 2- and 1-cell axes, on the
       ragged and drifted records at cap 128 and 256 and on the
       65,600-cell plan at cap 32, each but the last also against the
       per-cell kernel on the same records, and its device time on the
       water box's and the full bilayer's records;
     - the extended-grid kernels (TPU #6, #7) of the brick mesh: the pair
       kernel on the (1,1,1) water plan's slots (and against the
       per-cell kernel there), on one brick of a (2,2,2) plan at the
       water density with its halo shell filled (charged, T = 2), on
       a grid with 2-cell periodic axes, and with exclusions on the full
       bilayer's (1,1,1) plan and on one brick of the nx = 8 bilayer's
       (2,2,2) plan; the EAM passes on the (1,1,1) nc = 32 plan and on
       one brick of a (2,2,2) plan at the copper density; the sentinel
       cell's q side stays exactly 0;
     and, for each main-path case, the least time the card could take
     (bound_ms: operations over the f32 peak or bytes over the memory
     rate, from the in-cutoff pairs these inputs hold), and for the water
     box's #1 and #6 the kernel's device time (torch.profiler), which the
     event time around the wrapper (its host time) hides on 80 cells;
     then TPU #3's own main path, its entry point cellpair_eval_full on
     the water box's and the full bilayer's start states (no simulate
     path reaches it), against the half-stencil evaluation;
  4. water slice: the Martini water box through `ddcmd_tpu_torch.run.cli
     simulate`, 3000 NVT steps in dispatches of 400;
  5. small-bilayer slice: a 2,888-bead bilayer through the CLI, 400 NPT
     steps on the per-cell kernel with exclusions;
  6. bilayer slice: the ~100k-bead DPPC bilayer through the CLI in two
     stages, as bench.py runs it: 3000 steps at dt = 5 fs, a checkpoint,
     then 8000 NPT steps at dt = 20 fs from that restart;
  7. EAM crystal, nc = 12 (6,912 Cu atoms, RATIONAL, per-cell EAM
     kernels): 3000 NVT steps through the CLI, a checkpoint, then 2000
     NVE steps (a FREE group) from that restart, whose energy drift is
     read;
  8. EAM crystal, nc = 32 (131,072 atoms, column EAM kernels): 2000 NVT
     steps through the CLI;
  9. agreement: small deterministic runs on the card (water box; a small
     bilayer with bonds, constraints, exclusions and the barostat; a
     500-atom EAM crystal) against the same runs on the CPU (plain
     twins);
 10. mesh water: `ParallelSimulation` on the water box at (1,1,1): first
     energy against the single-device Simulation's, 3000 NVT steps in
     dispatches of 400 through the extended-grid pair kernel only;
 11. mesh EAM: the nc = 32 crystal (131,072 atoms) the same way, 2000
     NVT steps through the two extended-grid EAM passes only;
 12. mesh bilayer (run inside phase 6, from its 20 fs restart): the
     100,296-bead bilayer through `ParallelSimulation` at (1,1,1), first
     energy against the single-device Simulation's on the same restart,
     2000 NPT steps (bonds, angles, RATTLE, in-kernel exclusions) through
     the extended-grid pair kernel with exclusions only.

Every main-path phase (and each entry-point call of TPU #3) sets the
launch counters to 0 just before it and reads them just after.  Prints
the kernels' JSON line, the card line, and last {"ok": true, "device":
{...}}.  --kernels-only stops after phase 3 and prints no result.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

SLICE_STEPS = 3000
DISPATCH = 400
TAIL = 1000              # steps the temperature and rate are read over
TIMED_CALLS = 200        # kernel calls per timing
PLAIN_CALLS = 10         # plain-twin calls per timing (slow at full size)
BILAYER_NX = 48          # the builder's default: ~100k beads
EQ_STEPS, EQ_DT = 3000, 5.0
RUN_STEPS = 8000
SMALL_NX, SMALL_STEPS = 8, 400
BILAYER_T = 323.0
TEMP_TOL = 10.0          # K, on the mean T over the last TAIL steps
EAM_NC, EAM_STEPS, EAM_NVE_STEPS = 12, 3000, 2000
EAM_BIG_NC, EAM_BIG_STEPS = 32, 2000
EAM_BIG_PLAN = ((11, 12, 12), 4, 29)    # its cells, G and union size U
EAM_T = 300.0
# us/call of the bodies the sweep design replaced (PERF.md, H100 80GB
# HBM3 at 700 W): one CTA of cap threads per
# (direction, cell), the pair arithmetic inside the distance sweep; the
# column kernels with their union staged in shared memory, one CTA an SM;
# the full stencil (#3) with one CTA of cap threads a cell over its 27
# blocks
OLD_BODY_US = {"eam_rho": 106.6, "eam_force": 93.7, "eam_rho_col": 1155.4,
               "eam_force_col": 1388.3, "eam_rho_ext": 484.4,
               "eam_force_ext": 589.6, "eam_rho_on_col_slots": 477.3,
               "eam_force_on_col_slots": 590.0,
               "cellpair_half": 84.9, "cellpair_half_excl": 55.5,
               "cellpair_half_col": 713.8, "cellpair_half_ext": 120.5,
               "cellpair_half_ext_excl": 272.4,
               "cellpair_half_on_col_slots": 275.0,
               "cellpair_full": 672.6, "cellpair_full_water": 224.2}
RAGGED_COUNTS = (0, 1, 31, 32, 33)        # live slots of the ragged cells,
RAGGED_CAPS = (128, 256)                  # and cap itself, at each of these caps
BIG_NCELLS = (41, 40, 40)                 # 65,600 cells: past a 16-bit grid axis
RAGGED_RCUT, RAGGED_SKIN = 0.6, 0.3       # the pair kernels' ragged cases
NVE_DRIFT_TOL = 1e-3     # eV/atom, max |Etot - Etot0| over the NVE leg
DEVICE = "cuda:0"
MESH_STEPS, MESH_EAM_STEPS, MESH_BL_STEPS = 3000, 2000, 2000
# the least time the card could take (H100 SXM peaks at 700 W): f32
# outside the tensor cores, and HBM3
PEAK_F32, PEAK_BW = 67e12, 3.35e12
# f32 operations the function needs, whatever the algorithm: for each
# in-cutoff pair of these inputs its distance test (3 sub, 3 mul, 2 add,
# the validity product) and its arithmetic, counted from the sources
# (csrc/cellpair_half.cu: LJ 41, reaction field 14 more; csrc/eam_half.cu
# with eam_forms.cuh, RATIONAL of Horner degree D: density pass 19 + 16 (D
# - 1), force pass 40 + 16 (D - 1)).  The tests of pairs outside the
# cutoff are a cell list's overhead, not the function's work (an exact
# prune can skip them), so the bound does not count them
OPS_TEST = 9
OPS_LJ, OPS_RF = 41, 14
# the analytic EAM forms besides the crystal's RATIONAL, one species each
# (per-species values in the units compile_eam documents; rmax = the
# crystal's 5.5 A, so all forms share its plan)
EAM_FORM_DECKS = {
    "FS": "form=FS; Cu = 0.8 2.0 1.5 5.0 7.0 3.6;",
    "SC": "form=SC; Cu = 0.012 3.61 9 6 39.432;",
    "EXP": ("form=EXP; atomvolume=11.81 Angstrom^3; phi_e=0.59 eV; "
            "r_e=2.556 Angstrom; alpha=5.09; beta=5.85; gamma=8.0; "
            "E_c=3.54 eV;"),
    "AT": "form=AT; Cu = 1.5 1.0 2.4 1.0 4.5 0.1 -0.02 0.001 4.0;",
}


def phase(name, text):
    print(f"[{name}] {text}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_line():
    from ddcmd_tpu_torch.ops.cellpair_half import nvcc_path

    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def synthetic(n, L, seed=11):
    """Charged two-type LJ + RF system on a jittered lattice (the
    JAX package's tests/test_nbr_martini.make_system)."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    r = (g + 0.5) / m * L - 0.5 * L + (rng.random((n, 3)) - 0.5) * (0.25 * L / m)
    q = rng.choice([-1.0, 0.0, 1.0], size=n) * 0.3
    tidx = rng.integers(0, 2, size=n)
    return (r, q, tidx, *synthetic_tables())


def synthetic_tables():
    """(tables, rcut) of synthetic's two LJ types with a reaction field."""
    from ddcmd_tpu_torch.objects import units as U

    sigma = np.array([[0.47, 0.57], [0.57, 0.47]])
    eps = np.array([[5.0, 5.6], [5.6, 5.0]])
    rcut = 1.1
    sr6 = (sigma / rcut) ** 6
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    tables = dict(sigma=sigma, eps=eps, shift=-4 * eps * (sr6 ** 2 - sr6),
                  rcut2=f32(rcut ** 2), krf=f32(0.5 / rcut ** 3),
                  crf=f32(1.5 / rcut), keR=f32(U.ke / 15.0))
    return tables, rcut


def made_grid(ncells, cap, rlist):
    """A cell grid of a given shape and capacity (plan_lanes sizes its
    own from the density)."""
    from ddcmd_tpu_torch.ops.cellpair import CellBlockGrid, _build_stencil

    return CellBlockGrid(tuple(ncells), cap, rlist, *_build_stencil(ncells))


def ragged_system(ncells=(3, 3, 4), cap=128, seed=23):
    """A box of `ncells` cells whose occupancies cycle through
    RAGGED_COUNTS and cap (0, 1, 31, 32, 33 and cap atoms), what the
    kernels' tile cutting and queue flush must survive: each cell's atoms
    sit on a jittered m x m x 4 sub-lattice strictly inside it (m = 6 in
    cells of 1.3 nm at cap 128, 8 in cells of 1.73 nm at cap 256; closest
    pairs ~2 A), in shuffled order, with random species 0/1 and a
    particle mask that drops a tenth of them.  Binned with a mask of ones
    the dropped atoms stay inside the cells' counts.  Returns (r (n, 3)
    f32, box lengths, species (n,), mask (n,) f32, grid), all host."""
    m = {128: 6, 256: 8}[cap]
    edge = 1.3 * m / 6
    assert cap <= m * m * 4
    occupancy = (*RAGGED_COUNTS, cap)
    rng = np.random.default_rng(seed)
    sites = (np.stack(np.meshgrid(np.arange(m), np.arange(m), np.arange(4),
                                  indexing="ij"), -1).reshape(-1, 3) + 0.5) \
        / np.array([m, m, 4]) * edge
    L = np.array(ncells, np.float64) * edge
    r = []
    for k, c3 in enumerate(np.ndindex(*ncells)):
        pick = rng.permutation(len(sites))[:occupancy[k % len(occupancy)]]
        r.append(np.array(c3) * edge - L / 2 + sites[pick])
    r = np.concatenate(r)
    r = r + np.clip(rng.standard_normal(r.shape) * 0.01, -0.03, 0.03)
    r = r[rng.permutation(len(r))].astype(np.float32)
    n = len(r)
    return (r, L.tolist(), rng.integers(0, 2, n),
            (rng.random(n) >= 0.1).astype(np.float32),
            made_grid(ncells, cap, 0.65))


def slab_lattice(ncells, edge, layers=3, per_edge=3, seed=29):
    """Atoms on a jittered cubic lattice (per_edge^3 a cell, never
    crossing a cell face) in the first `layers` cell layers along x of a
    box of `ncells` cells of `edge` nm; the rest of the box is empty.
    Returns (r (n, 3), box lengths)."""
    h = edge / per_edge
    m = [layers * per_edge, ncells[1] * per_edge, ncells[2] * per_edge]
    g = np.stack(np.meshgrid(*[np.arange(k) for k in m], indexing="ij"),
                 -1).reshape(-1, 3)
    L = np.array(ncells, np.float64) * edge
    rng = np.random.default_rng(seed)
    r = (g + 0.5) * h - L / 2 + (rng.random(g.shape) - 0.5) * 0.2 * h
    return r, L.tolist()


def packed_inputs(r, q, tidx, L, grid, tables, dev, G=1, ex=None,
                  r_pack=None, valid=None):
    """Pack as the main path does (cellpair_eval_half), on the card; the
    arguments of the column kernel when G > 1.  ex (n, 2): the exclusion
    channels; r_pack: the positions packed into slots binned at r (a
    stale binning); valid (n,): the validity row of each particle (1 by
    default)."""
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors, pack_slots

    n = len(r)
    n_pad = ((n + 127) // 128) * 128
    pad = lambda a, shape: torch.tensor(np.concatenate(          # noqa: E731
        [np.asarray(a), np.zeros((n_pad - n,) + shape)]),
        dtype=torch.float32, device=dev)
    rt = pad(r, (3,))
    qt = pad(q, ())
    tt = pad(tidx, ()).long()
    fmask = (torch.arange(n_pad, device=dev) < n).float()
    Lt = torch.tensor(L, dtype=torch.float32, device=dev)
    perm, ov = build_cell_slots(rt, fmask, Lt, grid)
    assert not bool(ov), "overflow packing the comparison case"
    hg = half_grid(grid)
    gt = grid_tensors(hg, dev, G)
    slots, _ = pack_slots(rt if r_pack is None else pad(r_pack, (3,)), qt,
                          tt, perm, Lt, hg, gt["frac_centers"],
                          excl_vals=None if ex is None else pad(ex, (2,)))
    if valid is not None:
        vt = torch.cat([pad(valid, ()), torch.zeros(1, device=dev)])
        slots[:, 5, :] = vt[perm].reshape(hg.ncell, hg.cap)
    L8 = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    L8[0, :3] = Lt / gt["ncells"]
    L8[0, 3] = tables["rcut2"]
    counts = (perm.reshape(hg.ncell, hg.cap) != n_pad).sum(
        1, dtype=torch.int32)
    tabs = [torch.tensor(np.asarray(tables[k]), dtype=torch.float32,
                         device=dev).contiguous()
            for k in ("sigma", "eps", "shift")]
    if G > 1:
        return (slots, gt["stencil"], gt["member_u"], L8, counts, *tabs)
    return (slots, gt["stencil"], L8, counts, *tabs)


def pad_p(out_p, out_q):
    """The p side padded to every slot cell of out_q (an extended grid's
    p side covers its first n_prog cells only)."""
    ncell, _, cap = out_q.shape
    return torch.nn.functional.pad(out_p, (0, 0, 0,
                                           ncell * cap - out_p.shape[0]))


def per_slot(*outs):
    """(f, pe per slot, e, virial6) of a pair kernel's outputs: (out_p,
    out_q, out_cell) of a half-stencil kernel, (out_p, out_cell) of the
    full-stencil kernel, which writes no q side."""
    out_p, out_cell = outs[0], outs[-1]
    f, pe = out_p[:, :3].double(), out_p[:, 3].double()
    if len(outs) == 3:
        out_q = outs[1]
        ncell, _, cap = out_q.shape
        out_p = pad_p(out_p, out_q)
        back = out_q.transpose(1, 2).reshape(ncell * cap, 8)
        f = (out_p[:, :3] + back[:, :3]).double()
        pe = (out_p[:, 3] + back[:, 3]).double()
    return f, pe, out_cell[:, 0].double().sum(), out_cell[:, 1:7].double().sum(0)


def cell_view(args):
    """(slots, per-cell stencil, L8, counts) of a kernel call's arguments,
    a column call's table unfolded into the per-cell stencil it encodes."""
    from ddcmd_tpu_torch.ops.cellpair_half import col_to_cell_stencil

    if args[2].dtype == torch.int32:            # (slots, stencil_col, member_u, ...)
        return (args[0], col_to_cell_stencil(args[1], args[2]), args[3],
                args[4])
    return args[:4]


def full_call(grid, args, kw, dev):
    """The full-stencil call (TPU #3) on the records of a half-stencil
    or column call's arguments: the same slots, L8, counts and tables
    with `grid`'s 27-direction stencil (grid: the plan_lanes grid).
    Returns (args, kw, hargs): hargs the per-cell half-stencil call (#1)
    on the same records, which tests each unordered pair once."""
    from ddcmd_tpu_torch.ops.cellpair import half_grid
    from ddcmd_tpu_torch.ops.cellpair_full import self_index
    from ddcmd_tpu_torch.ops.cellpair_half import pack_stencil

    slots, _, L8, counts = cell_view(args)
    rest = (L8, counts, *args[-3:])
    fargs = (slots, torch.as_tensor(pack_stencil(grid), device=dev), *rest)
    hargs = (slots, torch.as_tensor(pack_stencil(half_grid(grid)),
                                    device=dev), *rest)
    return fargs, dict(s_self=self_index(grid), krf=kw["krf"], crf=kw["crf"],
                       keR=kw["keR"], coulomb=kw["coulomb"]), hargs


def full_vs_half(name, fargs, fkw, hargs):
    """#3 against #1 (no exclusions) on the same records: the same
    physics, summed in another order, at the tolerances of agree()."""
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch

    hkw = {k: v for k, v in fkw.items() if k != "s_self"}
    got = per_slot(*cf.cellpair_full(*fargs, **fkw))
    ref = per_slot(*ch.cellpair_half(*hargs, **hkw))
    torch.cuda.synchronize()
    ferr, scale = agree(f"full vs half stencil: {name}", got, ref)
    phase("kernel", f"full-stencil #3 vs half-stencil #1 on {name}: force "
          f"err {ferr:.3g} (scale {scale:.4g}), e {float(got[2]):.8g} vs "
          f"{float(ref[2]):.8g}")


def sweep_work(slots, stencil, L8, counts):
    """(candidate pairs, in-cutoff pairs) of one half-stencil sweep on
    these inputs.  Candidates, reported only: counts[c] * counts[tgt] per
    (cell, direction), counts[c] (counts[c] - 1) / 2 in the self block 0,
    what a sweep trimmed by `counts` alone would test.  In cutoff, what
    the bound counts: both slots valid and 0 < d2 < rcut^2.  Each
    unordered pair is counted once."""
    n_prog, cap = stencil.shape[0], slots.shape[2]
    L8 = L8.reshape(-1)
    home = slots[:n_prog]
    nc = counts[:n_prog].long()
    upper = (torch.arange(cap, device=slots.device)[None, :]
             > torch.arange(cap, device=slots.device)[:, None])
    cand = hits = 0
    for s in range(stencil.shape[1] // 4):
        tgt = stencil[:, 4 * s].long()
        cand += int((nc * (nc - 1) // 2).sum() if s == 0
                    else (nc * counts[tgt].long()).sum())
        sh = stencil[:, 4 * s + 1:4 * s + 4].float() * L8[0:3]
        Q = slots[tgt]
        d2 = sum((home[:, a, :, None] - (Q[:, a] + sh[:, a:a + 1])[:, None, :])
                 ** 2 for a in range(3))
        ok = (home[:, 5, :, None] * Q[:, 5, None, :] > 0) & (d2 < L8[3]) \
            & (d2 > 0)
        if s == 0:
            ok &= upper
        hits += int(ok.sum())
    return cand, hits


def bound(args, outs, ops_pair, work=None):
    """(bound_ms, bound_by, candidates, in-cutoff pairs): the larger of
    the f32 operations these inputs need over PEAK_F32 and the bytes the
    call must move (each input read once, each output written once) over
    PEAK_BW.  The operations are the distance test and the ops_pair
    operations of every in-cutoff pair (sweep_work) of `work`, a
    half-stencil call's arguments on the same records (`args` by
    default): a full-stencil call computes the same function, each pair
    met from both sides, and its bound counts each pair once."""
    cand, hits = sweep_work(*cell_view(args if work is None else work))
    ops = (OPS_TEST + ops_pair) * hits
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if torch.is_tensor(t))
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BW
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", cand, hits)


def compare(name, kernel, plain, args, kw, with_bound=False, work=None,
            device_key=None):
    """Kernel vs plain twin on the same CUDA tensors, at the tolerances
    of tests/test_pallas_cellpair.py; returns (max_abs_err of the force,
    ms per kernel call, ms per plain call, bound_ms, bound_by), the bound
    None unless with_bound (its operations from `work`, see bound).  With
    device_key, the kernels of that name are also timed on the device
    (device_us), which on small grids the event time around the wrapper,
    its host time, hides."""
    outs = kernel(*args, **kw)
    got = per_slot(*outs)
    ref = per_slot(*plain(*args, **kw))
    torch.cuda.synchronize()
    ferr, scale = agree(name, got, ref)
    ms = time_calls(lambda: kernel(*args, **kw), TIMED_CALLS)
    plain_ms = time_calls(lambda: plain(*args, **kw), PLAIN_CALLS)
    bnd, by, text = None, None, ""
    if device_key:
        dev_us = device_us(lambda: kernel(*args, **kw), TIMED_CALLS,
                           device_key)
        text += f"; device {dev_us:.2f} us/call (profiler)"
    if with_bound:
        bnd, by, cand, hits = bound(
            args, outs, OPS_LJ + (OPS_RF if kw["coulomb"] else 0),
            work=work)
        text += (f"; bound {1e3 * bnd:.3f} us ({by}; {cand} candidate "
                 f"pairs, {hits} in cutoff)")
    phase("kernel", f"{name}: force err {ferr:.3g} (scale {scale:.4g}), "
          f"e {float(got[2]):.6g} vs {float(ref[2]):.6g}; kernel "
          f"{1e3 * ms:.2f} us/call, plain {1e3 * plain_ms:.2f} us/call{text}")
    return ferr, ms, plain_ms, bnd, by


def agree(name, got, ref):
    """Raise unless two (f, pe, e, virial6) sets agree within the
    tolerances of tests/test_pallas_cellpair.py."""
    (f1, pe1, e1, v1), (f0, pe0, e0, v0) = got, ref
    scale = max(1.0, float(f0.abs().max()))
    ferr = float((f1 - f0).abs().max())
    checks = {
        "force": ferr <= 2e-5 * scale,
        "e": abs(float(e1 - e0)) <= 1e-4 * abs(float(e0)) + 1e-2,
        "virial": bool(((v1 - v0).abs() <= 2e-3 * v0.abs() + 0.5).all()),
        "pe": bool(((pe1 - pe0).abs() <= 1e-3 * pe0.abs() + 2e-3).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"{name}: outputs disagree: {checks} (force "
                             f"err {ferr:.3g}, scale {scale:.4g})")
    return ferr, scale


def device_us(fn, n, key):
    """Mean device time, us, of the kernels whose name holds `key` that
    one call of fn launches (torch.profiler over n calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if key in e.key) / n
    if us <= 0:
        raise AssertionError(f"the profiler saw no {key} kernel")
    return us


def time_calls(fn, n):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def water_deck(d, n, printrate, free=False):
    """martini_water deck; free=True swaps the Langevin group for FREE
    (a deterministic run)."""
    from ddcmd_tpu_torch.models import martini_water

    martini_water(d, n=n)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=100;", f"printrate={printrate};")
    if free:
        text = text.replace("type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
                            "type=FREE;")
    with open(p, "w") as f:
        f.write(text)
    return p


def bilayer_deck(d, nx, dt_fs, printrate, free=False):
    """martini_bilayer deck (full width at nx = 48); free=True swaps the
    Langevin group for FREE (a deterministic run)."""
    from ddcmd_tpu_torch.models import martini_bilayer

    kw = dict(water_nm=1.2) if nx < 8 else {}
    martini_bilayer(d, nx=nx, ny=nx, dt_fs=dt_fs, **kw)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=200;", f"printrate={printrate};")
    if free:
        text = text.replace(f"type=LANGEVIN; Teq={BILAYER_T}K; tau=1.0ps;",
                            "type=FREE;")
    with open(p, "w") as f:
        f.write(text)
    return p


def read_rows(run_dir):
    with open(os.path.join(run_dir, "data")) as f:
        return np.array([ln.split() for ln in f.read().splitlines()[1:]],
                        dtype=np.float64)


def tail_rate(sim, tail=TAIL):
    """steps/s over the last `tail` accepted steps (dispatch host clock)."""
    steps = secs = 0
    for k, s in reversed(sim.dispatch_log):
        if steps >= tail:
            break
        steps, secs = steps + k, secs + s
    return steps / secs, steps


def cli_run(argv, device=None):
    from ddcmd_tpu_torch.run import cli

    with contextlib.redirect_stdout(io.StringIO()):
        return cli.run(argv + ["--device", str(device or DEVICE)])


def sim_kernel_inputs(sim):
    """The pair kernel call the main path makes on sim's current state:
    (kernel, args, kw) plus the half grid."""
    ss, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov), "overflow packing the comparison case"
    term = sim.force_fn.terms[0]
    kernel, args, kw = term.kernel_inputs(ss.state, ss.box, perm)
    return kernel, args, kw, term.grid


def eam_deck(d, nc, printrate, free=False):
    """eam_crystal deck (4 nc^3 Cu atoms, RATIONAL); free=True swaps the
    Langevin group for FREE (NVE, deterministic)."""
    from ddcmd_tpu_torch.models import eam_crystal

    eam_crystal(d, nc=nc)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=100;", f"printrate={printrate};")
    if free:
        text = text.replace(f"type=LANGEVIN; Teq={EAM_T}K; tau=0.1ps;",
                            "type=FREE;")
    with open(p, "w") as f:
        f.write(text)
    return p


def eam_form_tables(form, dev):
    """Kernel tables of one EAM_FORM_DECKS form for one species, Cu."""
    from ddcmd_tpu_torch.core.species import Species
    from ddcmd_tpu_torch.objects import ObjectDB
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_tables
    from ddcmd_tpu_torch.potentials.eam import compile_eam, eam_device_tables

    db = ObjectDB()
    db.compile_string("pot POTENTIAL { type=EAM; rmax=5.5 Angstrom; "
                      + EAM_FORM_DECKS[form] + " }")
    parms = compile_eam(db, "pot", [Species("Cu", 0, "ATOM", 0.0, 63.55)])
    return eam_kernel_tables(eam_device_tables(parms, device=dev))


def eam_alloy_tables(dev):
    """A T = 2 FS alloy whose density b is asymmetric (the JAX package's
    tests/test_pallas_cellpair.py alloy): the case that tells
    rho(t_p, t_q) from rho(t_q, t_p)."""
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_tables
    from ddcmd_tpu_torch.potentials.eam import EamParms, eam_device_tables

    eV, Ang, rcut = U.unit_scale("eV"), U.unit_scale("Angstrom"), 0.55
    parms = EamParms(
        "FS", 2, rcut,
        dict(a=np.array([[0.8, 0.7], [0.7, 0.9]]) * eV,
             b=np.array([[2.0, 3.5], [1.2, 2.6]]) * eV * eV,
             c=np.array([[1.5, 1.4], [1.4, 1.6]]) * Ang,
             m=np.full((2, 2), 5.0), n=np.full((2, 2), 7.0),
             ro=np.full((2, 2), 1.0) * Ang, x=np.full((2, 2), rcut)), {})
    return eam_kernel_tables(eam_device_tables(parms, device=dev))


def with_tables(slots, args, tables, seed=None):
    """The same packed call with another form's parameter table (the
    last argument); with a seed, the records' species row set to random
    types 0..T-1 (an alloy on the same positions)."""
    if seed is not None:
        T = int(tables["n_species"])
        t = np.random.default_rng(seed).integers(0, T, slots.shape[::2])
        slots = slots.clone()
        slots[:, 4, :] = torch.as_tensor(t, dtype=torch.float32,
                                         device=slots.device)
    kw = dict(form=tables["form"], T=int(tables["n_species"]),
              degree=tables["degree"])
    return slots, (*args[:-1], tables["params"]), kw


def eam_sums(rho_out, force_out):
    """Per-slot rho, total pe (pass A); per-slot force, virial6 (pass B)."""
    (p, q), (fp, fq, cell) = rho_out, force_out
    p, fp = pad_p(p, q), pad_p(fp, fq)
    ncell, _, cap = q.shape
    rho = (p[:, 0] + q[:, 0].reshape(-1)).double()
    e = (p[:, 1].double().sum() + q[:, 1].double().sum())
    f = (fp + fq[:, 0:3].transpose(1, 2).reshape(ncell * cap, 3)).double()
    assert not q[:, 2:].any() and not fq[:, 3:].any(), "unused q-side rows"
    return rho, e, f, cell[:, 0:6].double().sum(0)


def eam_agree(name, got, ref):
    """Raise unless two eam_sums agree within the tolerances of
    tests/test_pallas_cellpair.py:305-309 (energy rel 2e-5, force 5e-5
    of max(1, |f|max), virial rel 5e-3 abs 1.0; rho per slot, as the
    energy, rel 2e-5 of its largest value); returns (max |d rho|, max
    |d f|, force scale)."""
    (r1, e1, f1, v1), (r0, e0, f0, v0) = got, ref
    rerr = float((r1 - r0).abs().max())
    scale = max(1.0, float(f0.abs().max()))
    ferr = float((f1 - f0).abs().max())
    checks = {
        "rho": rerr <= 2e-5 * float(r0.abs().max()),
        "e": abs(float(e1 - e0)) <= 2e-5 * abs(float(e0)),
        "force": ferr < 5e-5 * scale,
        "virial": bool(((v1 - v0).abs() <= 5e-3 * v0.abs() + 1.0).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"{name}: outputs disagree: {checks} (rho err "
                             f"{rerr:.3g}, force err {ferr:.3g}, scale "
                             f"{scale:.4g})")
    return rerr, ferr, scale


def eam_compare(name, kernels, plains, slots, args, kw, tables,
                with_bound=False):
    """Both EAM kernels against their twins on the same CUDA tensors:
    pass A on `slots`, pass B on a copy holding the twin's dF in row 6.
    Returns {"rho": (max |d rho|, ms, plain ms, bound_ms, bound_by),
    "force": (max |d f|, ms, plain ms, bound_ms, bound_by)}, the bounds
    None unless with_bound (RATIONAL forms only)."""
    from ddcmd_tpu_torch.ops.eam_half import embed_slots

    (rho_k, force_k), (rho_p, force_p) = kernels, plains
    ref_a = rho_p(slots, *args, **kw)
    fslots = slots.clone()
    embed_slots(fslots, *ref_a, tables)
    out_a, out_b = rho_k(slots, *args, **kw), force_k(fslots, *args, **kw)
    got = eam_sums(out_a, out_b)
    ref = eam_sums(ref_a, force_p(fslots, *args, **kw))
    torch.cuda.synchronize()
    rerr, ferr, scale = eam_agree(name, got, ref)
    bnd = {"rho": (None, None), "force": (None, None)}
    text = ""
    if with_bound:
        assert kw["form"] == "RATIONAL", kw
        horner = 16 * (kw["degree"] - 1)
        ba = bound((slots, *args), out_a, 19 + horner)
        bb = bound((fslots, *args), out_b, 40 + horner)
        bnd = {"rho": ba[:2], "force": bb[:2]}
        text = (f"; bounds {1e3 * ba[0]:.3f} / {1e3 * bb[0]:.3f} us "
                f"({ba[1]} / {bb[1]}; {ba[2]} candidate pairs, {ba[3]} in "
                "cutoff)")
    t = {"rho": (rerr, time_calls(lambda: rho_k(slots, *args, **kw),
                                  TIMED_CALLS),
                 time_calls(lambda: rho_p(slots, *args, **kw), PLAIN_CALLS),
                 *bnd["rho"]),
         "force": (ferr, time_calls(lambda: force_k(fslots, *args, **kw),
                                    TIMED_CALLS),
                   time_calls(lambda: force_p(fslots, *args, **kw),
                              PLAIN_CALLS), *bnd["force"])}
    phase("kernel", f"{name}: rho err {rerr:.3g}, force err {ferr:.3g} "
          f"(scale {scale:.4g}), e {float(got[1]):.8g} vs "
          f"{float(ref[1]):.8g}; rho kernel {1e3 * t['rho'][1]:.2f} us/call, "
          f"plain {1e3 * t['rho'][2]:.2f}; force kernel "
          f"{1e3 * t['force'][1]:.2f} us/call, plain "
          f"{1e3 * t['force'][2]:.2f}{text}")
    return t


def eam_sim_inputs(nc, dev):
    """The EAM call the main path makes on the nc crystal's start state:
    (rho kernel, force kernel, slots, args, kw, tables, half grid, G)."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation

    with tempfile.TemporaryDirectory() as d:
        eam_deck(d, nc, 100)
        sim = Simulation(*load(d), run_dir=d, device=dev)
    ss, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov), "overflow packing the comparison case"
    term = sim.force_fn.terms[0]
    return (*term.kernel_inputs(ss.state, ss.box, perm), term.tables,
            term.grid, term.G)


def eam_crystal_inputs(nc, G, tables, dev, seed=3):
    """eam_kernel_inputs for a jittered fcc crystal of nc^3 unit cells on
    its plan_lanes grid, with the column group forced to G and random
    species 0..T-1."""
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors, plan_lanes
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_inputs

    a = 0.3615
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    r = ((cells[:, None, :] + base).reshape(-1, 3) * a - nc * a / 2
         + rng.standard_normal((4 * nc ** 3, 3)) * 0.006)
    n = len(r)
    L = torch.tensor([nc * a] * 3, dtype=torch.float32, device=dev)
    rt = torch.tensor(r, dtype=torch.float32, device=dev)
    fmask = torch.ones(n, device=dev)
    grid = plan_lanes([nc * a] * 3, 0.55, 0.1, n)
    perm, ov = build_cell_slots(rt, fmask, L, grid)
    assert not bool(ov), "overflow packing the comparison case"
    hg = half_grid(grid)
    sidx = torch.as_tensor(rng.integers(0, int(tables["n_species"]), n),
                           device=dev)
    return eam_kernel_inputs(rt, sidx, fmask, perm, L, hg, tables,
                             grid_tensors(hg, dev, G)), hg


def eam_kernel_phase(dev):
    """Phase 3, EAM; returns {kernel entry: (max_abs_err, ms, plain_ms)}
    of the main-path case of each EAM kernel."""
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.ops.cellpair_half import pack_stencil

    cell = ((eh.eam_rho_half, eh.eam_force_half),
            (eh.eam_rho_half_plain, eh.eam_force_half_plain))
    col = ((eh.eam_rho_half_col, eh.eam_force_half_col),
           (eh.eam_rho_half_col_plain, eh.eam_force_half_col_plain))
    res = {}
    # per-cell, on the nc = 12 crystal's slots: the deck's RATIONAL, the
    # other forms and the asymmetric alloy on the same positions
    rho_k, _, slots, args, kw, tables, hg, G = eam_sim_inputs(EAM_NC, dev)
    assert rho_k is eh.eam_rho_half and G == 1, (rho_k, G)
    assert (hg.ncells, hg.cap) == ((4, 5, 5), 128), (hg.ncells, hg.cap)
    what = f"nc={EAM_NC} crystal, {hg.ncell} cells, cap {hg.cap}"
    t = eam_compare(f"per-cell EAM RATIONAL T=1: {what}", *cell, slots,
                    args, kw, tables, with_bound=True)
    res["eam_rho"], res["eam_force"] = t["rho"], t["force"]
    for form in EAM_FORM_DECKS:
        ft = eam_form_tables(form, dev)
        eam_compare(f"per-cell EAM {form} T=1: {what}", *cell,
                    *with_tables(slots, args, ft), ft)
    at = eam_alloy_tables(dev)
    eam_compare(f"per-cell EAM FS alloy T=2 (asymmetric rho): {what}", *cell,
                *with_tables(slots, args, at, seed=5), at)
    del slots, args

    # column, on the nc = 32 crystal's slots, then against the per-cell
    # kernels on the same slots
    rho_k, _, slots, args, kw, tables, hg, G = eam_sim_inputs(EAM_BIG_NC, dev)
    U = args[0].shape[1]
    assert rho_k is eh.eam_rho_half_col and (hg.ncells, G, U) == \
        EAM_BIG_PLAN, (rho_k, hg.ncells, G, U)
    t = eam_compare(f"column EAM RATIONAL T=1: nc={EAM_BIG_NC} crystal, "
                    f"{hg.ncell} cells, cap {hg.cap}, G={G}, U={U}", *col,
                    slots, args, kw, tables, with_bound=True)
    res["eam_rho_col"], res["eam_force_col"] = t["rho"], t["force"]
    cell_args = (torch.as_tensor(pack_stencil(hg), device=dev), *args[2:])
    fslots = slots.clone()
    eh.embed_slots(fslots, *eh.eam_rho_half_plain(slots, *cell_args, **kw),
                   tables)
    got = eam_sums(eh.eam_rho_half_col(slots, *args, **kw),
                   eh.eam_force_half_col(fslots, *args, **kw))
    ref = eam_sums(eh.eam_rho_half(slots, *cell_args, **kw),
                   eh.eam_force_half(fslots, *cell_args, **kw))
    torch.cuda.synchronize()
    rerr, ferr, scale = eam_agree("column vs per-cell EAM", got, ref)
    ms_rho = time_calls(lambda: eh.eam_rho_half(slots, *cell_args, **kw),
                        TIMED_CALLS)
    ms_force = time_calls(lambda: eh.eam_force_half(fslots, *cell_args, **kw),
                          TIMED_CALLS)
    phase("kernel", f"column vs per-cell EAM kernels on the nc={EAM_BIG_NC} "
          f"slots: rho err {rerr:.3g}, force err {ferr:.3g} (scale "
          f"{scale:.4g}); per-cell rho kernel {1e3 * ms_rho:.2f} us/call, "
          f"force kernel {1e3 * ms_force:.2f} us/call, beside the column "
          f"kernels' {1e3 * res['eam_rho_col'][1]:.2f}, "
          f"{1e3 * res['eam_force_col'][1]:.2f} in this run")
    res["eam_rho_on_col_slots"] = (rerr, ms_rho)
    res["eam_force_on_col_slots"] = (ferr, ms_force)
    del slots, fslots, args, cell_args

    # column on a grid with nz == G (aliased union), the alloy
    at = eam_alloy_tables(dev)
    (rho_k, _, slots, args, kw), hg = eam_crystal_inputs(8, 3, at, dev)
    assert rho_k is eh.eam_rho_half_col and hg.ncells[2] == 3, hg.ncells
    eam_compare(f"column EAM FS alloy T=2: nc=8 crystal, cells {hg.ncells}, "
                f"nz == G = 3 (aliased union, U={args[0].shape[1]})", *col,
                slots, args, kw, at)
    for cap in RAGGED_CAPS:
        ragged_eam_cases(dev, cell, col, tables, at, cap)
    big_grid_cases(dev, tables)
    return res


def ragged_eam_cases(dev, cell, col, tables, alloy, cap):
    """The per-cell and column EAM kernels against their plain versions
    on ragged_system(cap=cap): RATIONAL with one species and the
    asymmetric T = 2 alloy, the column kernels at G = 2 and at G = nz =
    4."""
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_inputs

    r, L, sidx, fmask, grid = ragged_system(cap=cap)
    n = len(r)
    rt = torch.tensor(r, device=dev)
    Lt = torch.tensor(L, dtype=torch.float32, device=dev)
    # binned unmasked, so the masked atoms keep their slots
    perm, ov = build_cell_slots(rt, torch.ones(n, device=dev), Lt, grid)
    assert not bool(ov), "overflow packing the ragged case"
    hg = half_grid(grid)
    for name, tab, species in (("RATIONAL T=1", tables, np.zeros(n, np.int64)),
                               ("FS alloy T=2", alloy, sidx)):
        for G in (1, 2, 4):
            _, _, slots, args, kw = eam_kernel_inputs(
                rt, torch.as_tensor(species, device=dev),
                torch.tensor(fmask, device=dev), perm, Lt, hg, tab,
                grid_tensors(hg, dev, G))
            counts = args[-2]
            live = torch.arange(hg.cap, device=dev)[None, :] < counts[:, None]
            assert sorted(set(counts.tolist())) == [*RAGGED_COUNTS, cap], \
                sorted(set(counts.tolist()))
            assert bool(((slots[:, 5] == 0) & live).any()), \
                "no masked slot inside the counts"
            what = ("per-cell EAM" if G == 1 else
                    f"column EAM G={G} (U={args[0].shape[1]})")
            eam_compare(f"{what} {name}: ragged occupancy, cells "
                        f"{hg.ncells} of {(*RAGGED_COUNTS, cap)} live slots, "
                        f"{int((fmask == 0).sum())} of {n} atoms masked",
                        *(cell if G == 1 else col), slots, args, kw, tab)


def big_grid_cases(dev, tables):
    """Plans of more than 65,535 cells (BIG_NCELLS) at cap 32, atoms in
    three cell layers and the rest empty: the per-cell pair kernel (#1,
    charged, T = 2), the full-stencil kernel (#3) on the same records and
    the per-cell EAM kernels (#4, the crystal's RATIONAL) against their
    plain versions."""
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors

    ncell = int(np.prod(BIG_NCELLS))
    assert ncell > 65535
    # #1: cells of 1.5 nm at rlist 1.4, 27 beads a live cell
    tabs, rcut = synthetic_tables()
    r, L = slab_lattice(BIG_NCELLS, 1.5)
    rng = np.random.default_rng(31)
    grid = made_grid(BIG_NCELLS, 32, rcut + 0.3)
    a = packed_inputs(r, rng.choice([-1.0, 0.0, 1.0], size=len(r)) * 0.3,
                      rng.integers(0, 2, size=len(r)), L, grid, tabs, dev)
    empty = float((a[3] == 0).float().mean())
    assert a[0].shape[0] == ncell and empty > 0.9, (a[0].shape, empty)
    what = (f"{ncell} cells {BIG_NCELLS}, cap 32, {len(r)} beads, "
            f"{100 * empty:.1f}% of the cells empty, charged T=2")
    kw = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
              coulomb=True)
    compare(f"per-cell: {what}", ch.cellpair_half, ch.cellpair_half_plain, a,
            kw)
    fa, fkw, _ = full_call(grid, a, kw, dev)
    compare(f"full stencil: {what}", cf.cellpair_full, cf.cellpair_full_plain,
            fa, fkw)
    del a, fa
    # #4: cells of 0.75 nm at rlist 0.65, 27 atoms a live cell, 2.5 A apart
    r, L = slab_lattice(BIG_NCELLS, 0.75)
    n = len(r)
    grid = made_grid(BIG_NCELLS, 32, 0.65)
    rt = torch.tensor(r, dtype=torch.float32, device=dev)
    Lt = torch.tensor(L, dtype=torch.float32, device=dev)
    fmask = torch.ones(n, device=dev)
    perm, ov = build_cell_slots(rt, fmask, Lt, grid)
    assert not bool(ov), "overflow packing the big-grid case"
    hg = half_grid(grid)
    rho_k, force_k, slots, args, kw = eh.eam_kernel_inputs(
        rt, torch.zeros(n, dtype=torch.int64, device=dev), fmask, perm, Lt,
        hg, tables, grid_tensors(hg, dev, 1))
    empty = float((args[-2] == 0).float().mean())
    assert slots.shape[0] == ncell and empty > 0.9, (slots.shape, empty)
    eam_compare(f"per-cell EAM RATIONAL T=1: {ncell} cells {BIG_NCELLS}, cap "
                f"32, {n} atoms, {100 * empty:.1f}% of the cells empty",
                (rho_k, force_k),
                (eh.eam_rho_half_plain, eh.eam_force_half_plain), slots,
                args, kw, tables)


def kernel_phase(dev):
    """Phase 3; returns {kernel entry: (max_abs_err, ms, plain_ms)} of
    the main-path case of each kernel."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load, martini_water
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops.cellpair_half import plan_lanes
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.simulate import Simulation

    pair = (ch.cellpair_half, ch.cellpair_half_plain)
    col = (ch.cellpair_half_col, ch.cellpair_half_col_plain)
    full = (cf.cellpair_full, cf.cellpair_full_plain)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        martini_water(d, n=6173)
        sd = build_system(load(d)[0], d, device=dev)
    L = sd.box.lengths.cpu().numpy().astype(np.float64)
    grid = plan_lanes(L, sd.rcut_max, sd.neighbor_deltaR, sd.state.n_local)
    assert (grid.ncell, grid.cap) == (80, 128), (grid.ncells, grid.cap)
    mtab = martini_device_tables(sd.potentials[0][2])
    water = dict(mtab, sigma=mtab["sigma"][:1, :1].numpy(),
                 eps=mtab["eps"][:1, :1].numpy(),
                 shift=mtab["shift"][:1, :1].numpy())
    n = sd.state.n_local
    r = sd.box.back_in_box(sd.state.r)[:n].cpu().numpy()
    args = packed_inputs(r, np.zeros(n), np.zeros(n, np.int64), L, grid,
                         water, dev)
    kw = dict(krf=water["krf"], crf=water["crf"], keR=water["keR"],
              coulomb=False)
    res["cellpair_half"] = compare(
        "per-cell: waterbox 6173 beads, 80 cells, cap 128, T=1", *pair,
        args, kw, with_bound=True, device_key="cellpair_half_kernel")
    # TPU #3, the full stencil, on the same water records, and against #1
    fa, fkw, ha = full_call(grid, args, kw, dev)
    res["cellpair_full_water"] = compare(
        "full stencil: waterbox 6173 beads, 80 cells, cap 128, T=1", *full,
        fa, fkw, with_bound=True, work=ha, device_key="cellpair_full_kernel")
    full_vs_half("the water slots", fa, fkw, ha)
    for n_syn, L_syn in ((800, 6.6), (220, 4.2), (60, 2.6)):
        r, q, tidx, tabs, rcut = synthetic(n_syn, L_syn)
        g = plan_lanes([L_syn] * 3, rcut, 0.3, n_syn)
        a = packed_inputs(r, q, tidx, [L_syn] * 3, g, tabs, dev)
        kwc = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
                   coulomb=True)
        what = f"charged T=2 n={n_syn} L={L_syn} cells {g.ncells}"
        compare(f"per-cell: {what}", *pair, a, kwc)
        if min(g.ncells) <= 2:
            # #3 where -1 and +1 reach one cell through two images (2-cell
            # axes) or are the home cell's own images (1-cell axes)
            fa, fkw, ha = full_call(g, a, kwc, dev)
            compare(f"full stencil: {what} ({min(g.ncells)}-cell axes)",
                    *full, fa, fkw)
            full_vs_half(what, fa, fkw, ha)

    # (a) per-cell kernel with exclusions on a small bilayer
    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, SMALL_NX, 20.0, 200)
        sim = Simulation(*load(d), run_dir=d, device=dev)
        kernel, a, kw, hg = sim_kernel_inputs(sim)
    assert kernel is ch.cellpair_half and kw["excl"], (kernel, kw)
    res["cellpair_half_excl"] = compare(
        f"per-cell + exclusions: bilayer nx={SMALL_NX} "
        f"{sim.sysdef.state.n_local} beads, cells {hg.ncells}, cap "
        f"{hg.cap}, T={a[-1].shape[0]}, Coulomb", *pair, a, kw,
        with_bound=True)

    # (b) the column kernel on the full bilayer's packed slots
    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, BILAYER_NX, EQ_DT, 200)
        sim = Simulation(*load(d), run_dir=d, device=dev)
        kernel, a, kw, hg = sim_kernel_inputs(sim)
    G = a[2].shape[0]
    assert kernel is ch.cellpair_half_col and kw["excl"], (kernel, kw)
    res["cellpair_half_col"] = compare(
        f"column + exclusions: full bilayer {sim.sysdef.state.n_local} "
        f"beads, cells {hg.ncells}, G={G}, U={a[1].shape[1]}, cap "
        f"{hg.cap}", *col, a, kw, with_bound=True)
    # (d) column kernel vs per-cell kernel on the same slots
    from ddcmd_tpu_torch.ops.cellpair_half import pack_stencil

    cell_args = (a[0], torch.as_tensor(pack_stencil(hg), device=dev), *a[3:])
    got = per_slot(*ch.cellpair_half_col(*a, **kw))
    ref = per_slot(*ch.cellpair_half(*cell_args, **kw))
    torch.cuda.synchronize()
    ferr, scale = agree("column vs per-cell", got, ref)
    ms_cell = time_calls(lambda: ch.cellpair_half(*cell_args, **kw),
                         TIMED_CALLS)
    phase("kernel", f"column vs per-cell kernel on the full bilayer slots: "
          f"force err {ferr:.3g} (scale {scale:.4g}); per-cell kernel "
          f"{1e3 * ms_cell:.2f} us/call, beside the column kernel's "
          f"{1e3 * res['cellpair_half_col'][1]:.2f} in this run")
    res["cellpair_half_on_col_slots"] = (ferr, ms_cell)
    # (e) TPU #3 on the full bilayer's records (it has no exclusions:
    # rows 6-7 are not read), and against #1 without exclusions there
    fa, fkw, ha = full_call(sim.grid, a, kw, dev)
    res["cellpair_full"] = compare(
        f"full stencil: full bilayer {sim.sysdef.state.n_local} beads, "
        f"cells {sim.grid.ncells}, cap {hg.cap}, T={a[-1].shape[0]}, "
        f"Coulomb", *full, fa, fkw, with_bound=True, work=ha,
        device_key="cellpair_full_kernel")
    full_vs_half("the full bilayer slots", fa, fkw, ha)
    # its atomic sums are unordered: two calls agree within tolerance
    ferr, scale = agree("two calls of #3 on the full bilayer slots",
                        per_slot(*cf.cellpair_full(*fa, **fkw)),
                        per_slot(*cf.cellpair_full(*fa, **fkw)))
    phase("kernel", f"two calls of #3 on the full bilayer slots: force "
          f"err {ferr:.3g} (scale {scale:.4g})")
    del sim, a, cell_args, fa, ha

    # (c) the column kernel on a charged grid with nz == G
    r, q, tidx, tabs, rcut = synthetic(6173, 9.4)
    g = plan_lanes([9.4] * 3, rcut, 0.3, 6173)
    G = g.ncells[2]
    assert 2 <= G <= 5, g.ncells
    a = packed_inputs(r, q, tidx, [9.4] * 3, g, tabs, dev, G=G)
    compare(f"column: charged T=2 n=6173 cells {g.ncells}, nz == G = {G} "
            f"(aliased union, U={a[1].shape[1]})", *col, a,
            dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
                 coulomb=True))
    for cap in RAGGED_CAPS:
        ragged_pair_cases(dev, cap)
    return res


def ragged_pair_tables():
    """(tables, rcut) of two LJ types with a reaction field at
    RAGGED_RCUT, sized for ragged_system's ~2 A closest pairs."""
    from ddcmd_tpu_torch.objects import units as U

    sigma = np.array([[0.20, 0.24], [0.24, 0.22]])
    eps = np.array([[5.0, 5.6], [5.6, 4.4]])
    rcut = RAGGED_RCUT
    sr6 = (sigma / rcut) ** 6
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    return dict(sigma=sigma, eps=eps, shift=-4 * eps * (sr6 ** 2 - sr6),
                rcut2=f32(rcut ** 2), krf=f32(0.5 / rcut ** 3),
                crf=f32(1.5 / rcut), keR=f32(U.ke / 15.0)), rcut


def chain_exclusions(r, rng):
    """Exclusion pairs of chains of four mutual near neighbours (three
    bonds and the two 1-3 pairs each) over about a third of the
    particles, as the exclusion channels encode them."""
    free = np.ones(len(r), bool)
    pairs = []
    for i in rng.permutation(len(r))[:len(r) // 12]:
        if not free[i]:
            continue
        d = np.linalg.norm(r - r[i], axis=1)
        d[~free] = np.inf
        chain = np.argsort(d)[:4]
        if not np.isfinite(d[chain]).all():
            continue
        free[chain] = False
        a, b, c, e = (int(x) for x in chain)
        pairs += [(a, b), (b, c), (c, e), (a, c), (b, e)]
    return np.asarray(pairs, np.int64)


def drift(rng, n, skin=RAGGED_SKIN):
    """(n, 3) displacements of at most skin / 2: one common step of 0.9
    skin / 2 along +-x, which carries the particles near an x face across
    it, and a jitter of at most 0.1 skin / 2 each, which moves them apart
    by less than their closest distance."""
    u = np.array([rng.choice([-1.0, 1.0]), 0.0, 0.0])
    j = rng.standard_normal((n, 3))
    j *= rng.random((n, 1)) / np.linalg.norm(j, axis=1, keepdims=True)
    return (0.9 * u + 0.1 * j) * skin / 2


def ragged_pair_cases(dev, cap):
    """The pair kernels against their plain versions on
    ragged_system(cap=cap), charged, T = 2, a tenth of the live slots
    masked in the validity row: #1, and #2 at G = 2 and at G = nz = 4,
    without and with exclusion channels, and #3 over the full stencil of
    the same records (also against #1); then the same on a drifted
    state: the slots packed from a binning made before every particle
    moved by up to RAGGED_SKIN / 2, so particles lie outside their cells
    (what the box pruning must not drop a pair for)."""
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.run.forces import _excl_channels

    r, L, tidx, valid, grid = ragged_system(cap=cap)
    n = len(r)
    rng = np.random.default_rng(41)
    q = rng.choice([-0.3, 0.0, 0.3], n)
    tabs, _ = ragged_pair_tables()
    kw = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
              coulomb=True)
    moved = r + drift(rng, n)
    pair = {1: (ch.cellpair_half, ch.cellpair_half_plain)}
    pair[2] = pair[4] = (ch.cellpair_half_col, ch.cellpair_half_col_plain)
    full = (cf.cellpair_full, cf.cellpair_full_plain)
    for drifted in (False, True):
        ex = _excl_channels(chain_exclusions(moved if drifted else r, rng), n)
        for excl in (False, True):
            for G in (1, 2, 4):
                a = packed_inputs(r, q, tidx, L, grid, tabs, dev, G=G,
                                  ex=ex if excl else None,
                                  r_pack=moved if drifted else None,
                                  valid=valid)
                counts = a[-4]
                live = torch.arange(cap, device=dev)[None, :] < counts[:, None]
                assert sorted(set(counts.tolist())) == \
                    [*RAGGED_COUNTS, cap], sorted(set(counts.tolist()))
                assert bool(((a[0][:, 5] == 0) & live).any()), \
                    "no masked slot inside the counts"
                if drifted:
                    edge = float(L[0]) / grid.ncells[0]
                    outside = (a[0][:, 0:3].abs() > edge / 2).any(1) & live
                    assert bool(outside.any()), "no particle left its cell"
                what = "per-cell" if G == 1 else \
                    f"column G={G} (U={a[1].shape[1]})"
                state = ("drifted by up to skin/2 after binning"
                         if drifted else "ragged occupancy")
                text = (f"{state}, cells {grid.ncells} of "
                        f"{(*RAGGED_COUNTS, cap)} live slots, "
                        f"{int((valid == 0).sum())} of {n} masked, charged T=2")
                compare(f"{what}{' + exclusions' if excl else ''}: {text}",
                        *pair[G], a, dict(kw, excl=excl))
                if G == 1 and not excl:
                    # #3 over the 27 directions on the same records
                    fa, fkw, ha = full_call(grid, a, kw, dev)
                    compare(f"full stencil: {text}", *full, fa, fkw)
                    full_vs_half(text, fa, fkw, ha)


ENTRY_DECKS = (("water box", lambda d: water_deck(d, 6173, 100)),
               ("full bilayer", lambda d: bilayer_deck(d, BILAYER_NX, EQ_DT,
                                                       200)))


def start_sim(make_deck, dev):
    """A Simulation on the start state of the deck make_deck(dir) writes."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation

    with tempfile.TemporaryDirectory() as d:
        make_deck(d)
        return Simulation(*load(d), run_dir=d, device=dev)


def entry_calls(sim, dev):
    """TPU #3's entry point on sim's current state: (full, half, what),
    full() = make_cellpair_full + cellpair_eval_full, half() =
    cellpair_eval_half (#1 without exclusions) on the same state, each
    returning (f, e, virial, pe), and a description of the state."""
    from ddcmd_tpu_torch.ops.cellpair import half_grid
    from ddcmd_tpu_torch.ops.cellpair_full import (cellpair_eval_full,
                                                   make_cellpair_full)
    from ddcmd_tpu_torch.ops.cellpair_half import (cellpair_eval_half,
                                                   grid_tensors, pack_stencil)
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables

    ss, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov), "overflow packing the entry-point case"
    st, sd = ss.state, sim.sysdef
    parms = next(p[2] for p in sd.potentials if p[0] == "MARTINI")
    tables = martini_device_tables(parms, device=dev)
    tidx = torch.as_tensor(parms.species_lj_type, device=dev)[st.species]
    coul = bool(st.q.abs().max() > 0)
    grid = sim.grid
    stencil = torch.as_tensor(pack_stencil(grid), device=dev)
    eval_fn = make_cellpair_full(grid, tables, coulomb=coul)
    hg = half_grid(grid)
    gt = grid_tensors(hg, dev)
    r, q, L = st.r, st.q, ss.box.lengths
    what = (f"{st.n_local} particles, cells {grid.ncells}, cap {grid.cap}, "
            f"T={tables['sigma'].shape[0]}, Coulomb {coul}")
    return ((lambda: cellpair_eval_full(r, q, tidx, perm, L, grid, tables,
                                        stencil, eval_fn)),
            (lambda: cellpair_eval_half(r, q, tidx, perm, L, hg, tables, gt,
                                        coulomb=coul)), what)


def full_entry_phase(dev, counters_zero, all_counters):
    """TPU #3 through its entry point, its main path (no simulate path
    reaches it): make_cellpair_full + cellpair_eval_full on the water
    box's and the full bilayer's start states, every launch counter set
    to 0 just before each call and read just after; the result held
    against cellpair_eval_half (#1 without exclusions) on the same state
    at the tolerances of agree().  Returns #3's launches."""
    launches = 0
    for name, make_deck in ENTRY_DECKS:
        full, half, what = entry_calls(start_sim(make_deck, dev), dev)
        counters_zero()
        f, e, vir, pe = full()
        torch.cuda.synchronize()
        c = all_counters()
        assert c["cellpair_full"] == 1 and sum(c.values()) == 1, c
        launches += c["cellpair_full"]
        ref = half()
        v6 = lambda v: torch.stack([v[0, 0], v[1, 1], v[2, 2], v[0, 1],  # noqa: E731
                                    v[0, 2], v[1, 2]]).double()
        ok = torch.isfinite(f).all() and torch.isfinite(e)
        assert ok, f"{name}: non-finite entry-point result"
        ferr, scale = agree(f"entry point on the {name}",
                            (f.double(), pe.double(), e.double(), v6(vir)),
                            (ref[0].double(), ref[3].double(),
                             ref[1].double(), v6(ref[2])))
        ms = time_calls(full, PLAIN_CALLS)
        phase("full-entry", f"cellpair_eval_full on the {name} ({what}): "
              f"e {float(e):.8g} vs half-stencil {float(ref[1]):.8g}, "
              f"force err {ferr:.3g} (scale {scale:.4g}); #3 launched "
              f"{c['cellpair_full']} time(s), no other kernel; "
              f"{1e3 * ms:.2f} us a call (events)")
        del full, half
    return launches


def brick_inputs(r, q, tidx, L, shape, idx3, rcut, skin, rcut2, dev,
                 ex=None):
    """One brick's extended-grid call of a `shape` plan, as the mesh step
    packs it: the rows whose brick-frame fraction lies in brick idx3's
    core or halo shell (so the halo cells are filled), binned and packed
    on the card, with the exclusion channels `ex` (n, 2) when given.
    Returns (plan, (slots, stencil, L8, counts))."""
    from ddcmd_tpu_torch.parallel import shard_cells as sc

    cp = sc.plan_shard_cells(L, shape, rcut, skin, len(r))
    geom = sc.dev_geom(cp, idx3, dev)
    Lv = torch.tensor(L, dtype=torch.float32, device=dev)
    u = sc.brick_frame_frac(torch.tensor(r, dtype=torch.float32, device=dev),
                            Lv, cp, geom)
    inside = torch.ones(len(r), dtype=torch.bool, device=dev)
    for a in range(3):
        if cp.open_axes[a]:
            h = 1.0 / cp.ncore[a]
            inside &= (u[:, a] >= -0.5 - h) & (u[:, a] < 0.5 + h)
    perm, counts, ov = sc.bin_pool_ext(u, inside, cp)
    assert not bool(ov), "overflow packing the comparison case"
    span_cart = geom[1] * Lv
    slots = sc.pack_slots_ext(
        u, torch.tensor(q, device=dev), torch.tensor(tidx, device=dev), perm,
        span_cart, cp, None if ex is None else torch.tensor(ex, device=dev))
    return cp, (slots, torch.as_tensor(cp.stencil_packed, device=dev),
                sc.ext_L8(span_cart, cp, rcut2), counts)


def bilayer_arrays(nx, dev):
    """The nx bilayer deck's start state on the host: positions in the
    box, charges, LJ types, exclusion channels (run/forces.
    _excl_channels), box lengths, rcut and skin, and the Martini kernel
    tables on `dev` (T = 5, reaction field)."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.forces import _excl_channels

    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, nx, EQ_DT, 200)
        sd = build_system(load(d)[0], d)
    n = sd.state.n_local
    parms = sd.potentials[0][2]
    return dict(r=sd.box.back_in_box(sd.state.r)[:n].numpy(),
                q=sd.state.q[:n].numpy(),
                tidx=parms.species_lj_type[sd.state.species[:n].numpy()],
                ex=_excl_channels(sd.bonded.exclusions, n),
                L=sd.box.lengths.numpy().astype(np.float64),
                rcut=sd.rcut_max, skin=sd.neighbor_deltaR,
                tables=martini_device_tables(parms, device=dev))


def sentinel_zero(name, out_q):
    """The sentinel's q-side rows (the last slot cell) stay exactly 0."""
    if out_q[-1].any():
        raise AssertionError(f"{name}: out_q[sentinel] is not 0")


def fcc(nc, seed, a=0.3615):
    """A jittered fcc crystal of nc^3 unit cells: (positions, box edge)."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    r = ((cells[:, None, :] + base).reshape(-1, 3) * a - nc * a / 2
         + rng.standard_normal((4 * nc ** 3, 3)) * 0.006)
    return r, nc * a


def ext_kernel_phase(dev):
    """Phase 3, extended grids (TPU #6 and #7); returns {kernel entry:
    (max_abs_err, ms, plain_ms, bound_ms, bound_by)} of the mesh phases'
    calls, the (1,1,1) plans."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    ext = (ch.cellpair_half_ext, ch.cellpair_half_plain)
    res = {}
    # (a) the (1,1,1) water plan's slots, and #1 on the same cells
    with tempfile.TemporaryDirectory() as d:
        water_deck(d, 6173, 100)
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
    cp = ps.cplan
    assert kernel is ch.cellpair_half_ext and cp.n_slot == cp.n_prog + 1
    res["cellpair_half_ext"] = compare(
        f"extended grid (1,1,1): water box 6173 beads, {cp.n_prog} core "
        f"cells + sentinel, cap {cp.cap}, T=1", *ext, args, kw,
        with_bound=True, device_key="cellpair_half_kernel")
    outs = kernel(*args, **kw)
    sentinel_zero("extended grid (1,1,1)", outs[1])
    slots, stencil, L8, counts = args[:4]
    npc = cp.n_prog * cp.cap
    got = per_slot(*outs)
    ref = per_slot(*ch.cellpair_half(slots[:cp.n_prog].contiguous(), stencil,
                                     L8, counts[:cp.n_prog].contiguous(),
                                     *args[4:], **kw))
    torch.cuda.synchronize()
    ferr, scale = agree("extended vs per-cell kernel",
                        (got[0][:npc], got[1][:npc], got[2], got[3]), ref)
    phase("kernel", f"extended-grid vs per-cell kernel on the (1,1,1) water "
          f"slots: force err {ferr:.3g} (scale {scale:.4g})")
    del ps

    # (b) one brick of a (2,2,2) plan at the water density: charged, T=2
    r, q, tidx, tabs, rcut = synthetic(6173, 9.4)
    cp, a = brick_inputs(r, q, tidx, [9.4] * 3, (2, 2, 2), (1, 0, 1), rcut,
                         0.4, tabs["rcut2"], dev)
    t3 = [torch.tensor(np.asarray(tabs[k]), dtype=torch.float32, device=dev)
          for k in ("sigma", "eps", "shift")]
    kwc = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
               coulomb=True)
    halo = int(a[3][cp.n_prog:-1].sum())
    assert halo > 0 and int(a[3][-1]) == 0, (halo, int(a[3][-1]))
    compare(f"extended grid, brick (1,0,1) of (2,2,2): charged T=2 n=6173 "
            f"L=9.4, ncore {cp.ncore}, {cp.n_slot} slot cells, "
            f"{int(a[3][:cp.n_prog].sum())} core + {halo} halo particles",
            *ext, (*a, *t3), kwc)
    sentinel_zero("extended grid (2,2,2) brick", ch.cellpair_half_ext(
        *a, *t3, **kwc)[1])

    # (c) 2-cell periodic axes: a (2,1,1) plan in a 9.4 x 3.2 x 3.2 box
    L = np.array([9.4, 3.2, 3.2])
    m = np.round(L * 7.47 ** (1 / 3)).astype(int)     # the water density
    g = np.stack(np.meshgrid(*[np.arange(k) for k in m], indexing="ij"),
                 -1).reshape(-1, 3)
    rng = np.random.default_rng(5)
    n = len(g)
    r = ((g + 0.5) / m - 0.5) * L + (rng.random((n, 3)) - 0.5) * 0.1
    q = rng.choice([-1.0, 0.0, 1.0], size=n) * 0.3
    tidx = rng.integers(0, 2, size=n)
    cp, a = brick_inputs(r, q, tidx, L, (2, 1, 1), (1, 0, 0), rcut, 0.4,
                         tabs["rcut2"], dev)
    assert cp.ncore[1:] == (2, 2), cp.ncore
    compare(f"extended grid, brick (1,0,0) of (2,1,1): box {L.tolist()}, "
            f"{n} beads, ncore "
            f"{cp.ncore} (2-cell periodic y and z)", *ext, (*a, *t3), kwc)

    # (d) #6 with exclusions: the full bilayer's (1,1,1) plan, then one
    # brick of a (2,2,2) plan of the nx = 8 bilayer
    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, BILAYER_NX, EQ_DT, 200)
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
    cp = ps.cplan
    assert kernel is ch.cellpair_half_ext and kw["excl"], kw
    res["cellpair_half_ext_excl"] = compare(
        f"extended grid (1,1,1) + exclusions: full bilayer "
        f"{ps.sysdef.state.n_local} beads, {cp.n_prog} core cells "
        f"{cp.ncore} + sentinel, cap {cp.cap}, T={args[-1].shape[0]}, "
        f"Coulomb", *ext, args, kw, with_bound=True)
    sentinel_zero("extended grid (1,1,1) + exclusions",
                  kernel(*args, **kw)[1])
    del ps, args
    b = bilayer_arrays(SMALL_NX, dev)
    t5 = [b["tables"][k] for k in ("sigma", "eps", "shift")]
    kwx = dict(krf=b["tables"]["krf"], crf=b["tables"]["crf"],
               keR=b["tables"]["keR"], coulomb=True, excl=True)
    cp, a = brick_inputs(b["r"], b["q"], b["tidx"], b["L"], (2, 2, 2),
                         (1, 1, 0), b["rcut"], b["skin"],
                         b["tables"]["rcut2"], dev, ex=b["ex"])
    halo = int(a[3][cp.n_prog:-1].sum())
    assert halo > 0 and int(a[3][-1]) == 0, (halo, int(a[3][-1]))
    assert a[0][:, 6].any(), "no exclusion channels in the records"
    compare(f"extended grid + exclusions, brick (1,1,0) of (2,2,2): bilayer "
            f"nx={SMALL_NX} {len(b['r'])} beads, ncore {cp.ncore}, "
            f"{cp.n_slot} slot cells, {int(a[3][:cp.n_prog].sum())} core + "
            f"{halo} halo beads, T=5, Coulomb", *ext, (*a, *t5), kwx)
    sentinel_zero("extended grid + exclusions (2,2,2) brick",
                  ch.cellpair_half_ext(*a, *t5, **kwx)[1])

    # (e) EAM: the (1,1,1) nc = 32 plan, then a brick of a (2,2,2) plan at
    # the copper density
    eam_ext = ((eh.eam_rho_half_ext, eh.eam_force_half_ext),
               (eh.eam_rho_half_plain, eh.eam_force_half_plain))
    with tempfile.TemporaryDirectory() as d:
        eam_deck(d, EAM_BIG_NC, 100)
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
    cp, tables = ps.cplan, ps.tables
    assert kernel is eh.eam_rho_half_ext
    t = eam_compare(f"extended-grid EAM (1,1,1): nc={EAM_BIG_NC} crystal, "
                    f"{cp.n_prog} core cells + sentinel, cap {cp.cap}",
                    *eam_ext, args[0], args[1:], kw, tables, with_bound=True)
    res["eam_rho_ext"], res["eam_force_ext"] = t["rho"], t["force"]
    sentinel_zero("extended-grid EAM (1,1,1)", kernel(*args, **kw)[1])
    del ps, args
    r, L = fcc(EAM_BIG_NC, seed=4)
    cp, a = brick_inputs(r, np.zeros(len(r)), np.zeros(len(r), np.int64),
                         [L] * 3, (2, 2, 2), (0, 1, 1), 0.55, 0.1,
                         tables["rcut2"], dev)
    eam_compare(f"extended-grid EAM, brick (0,1,1) of (2,2,2): nc="
                f"{EAM_BIG_NC} crystal, ncore {cp.ncore}, {cp.n_slot} slot "
                f"cells, {int(a[3][cp.n_prog:].sum())} halo atoms", *eam_ext,
                a[0], (*a[1:], tables["params"]), kw, tables)
    fslots = a[0].clone()
    fslots[:, 6, :] = 0.01
    for k in eam_ext[0]:
        sentinel_zero(f"{k.__name__} brick", k(fslots, *a[1:],
                                                tables["params"], **kw)[1])
    return res


def mesh_phases(card, dev, counters_zero, counters, single_rates):
    """Phases 10 and 11: ParallelSimulation at (1,1,1) on the card;
    returns the extended-grid kernels' launch counts of their runs."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    launches = {}
    cases = (("water", lambda d: water_deck(d, 6173, 10), MESH_STEPS, 310.0,
              ("cellpair_half_ext",)),
             ("eam", lambda d: eam_deck(d, EAM_BIG_NC, 10), MESH_EAM_STEPS,
              EAM_T, ("eam_rho_ext", "eam_force_ext")))
    for name, make_deck, steps, T0, kernels in cases:
        with tempfile.TemporaryDirectory() as d:
            make_deck(d)
            sim = Simulation(*load(d), run_dir=d, device=dev)
            sim.first_energy()
            e1 = float(sim.ss.energy.eion)
            del sim
            ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
        e_mesh = ps.first_energy()
        rel = abs(e_mesh - e1) / abs(e1)
        assert rel <= 2e-5, f"{name}: mesh first energy {e_mesh} vs {e1}"
        lines = []
        counters_zero()
        ps.run(steps, print_fn=lines.append, max_steps_per_dispatch=DISPATCH)
        c = counters()
        for k in kernels:
            assert c[k] >= steps, c
            launches[k] = c[k]
        assert not any(v for k, v in c.items() if k not in kernels), c
        n = ps.sysdef.state.n_local
        assert ps.loop == steps and int(ps.mask.sum()) == n
        loops = np.array([int(ln.split()[0]) for ln in lines])
        temps = np.array([float(ln.split("T=")[1].split()[0])
                          for ln in lines])
        epot = np.array([float(ln.split("epot/N=")[1].split()[0])
                         for ln in lines])
        assert np.isfinite(temps).all() and np.isfinite(epot).all(), \
            "non-finite scalars"
        temp = float(temps[loops > steps - TAIL].mean())
        assert abs(temp - T0) <= TEMP_TOL, f"{name}: mean T {temp}"
        rate, tail = tail_rate(ps)
        cp = ps.cplan
        phase("mesh", f"{name} at (1,1,1): {n} particles, ncore {cp.ncore} "
              f"cap {cp.cap}; first energy {e_mesh:.8g} vs single-device "
              f"{e1:.8g} (rel {rel:.2g}); {steps} NVT steps (dispatch "
              f"{DISPATCH}): mean T {temp:.2f} K over the last {TAIL} steps, "
              f"launches {[c[k] for k in kernels]}, {rate:.1f} steps/s over "
              f"the last {tail} steps vs single-device "
              f"{single_rates[name]:.1f} (JAX yardstick: within ~15% of "
              f"unsharded, bench.py:307-308; not gated) on {card}")
        del ps
    return launches


def mesh_bilayer_phase(card, dev, d, counters_zero, all_counters,
                       single_rate):
    """Phase 12: the full bilayer through ParallelSimulation at (1,1,1)
    from phase 6's 20 fs restart in `d`: first energy against the
    single-device Simulation's on the same restart, then MESH_BL_STEPS
    NPT steps through #6 with exclusions only.  Returns #6-excl's
    launches."""
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    restart = os.path.join(d, "restart")
    sim = Simulation(*load(d, restart), run_dir=d, device=dev)
    sim.first_energy()
    e1 = float(sim.ss.energy.eion)
    del sim
    ps = ParallelSimulation(*load(d, restart), shape=(1, 1, 1), device=dev)
    e_mesh = ps.first_energy()
    rel = abs(e_mesh - e1) / abs(e1)
    assert rel <= 2e-5, f"mesh bilayer first energy {e_mesh} vs {e1}"
    L0 = ps.Lv.cpu().numpy().astype(np.float64)
    lines = []
    loop0 = ps.loop
    counters_zero()
    ps.run(MESH_BL_STEPS, print_fn=lines.append,
           max_steps_per_dispatch=DISPATCH)
    c = all_counters()
    steps = MESH_BL_STEPS
    assert c["cellpair_half_ext_excl"] >= steps, c
    assert c["cellpair_half_ext"] == c["cellpair_half_ext_excl"], c
    assert not any(v for k, v in c.items()
                   if k not in ("cellpair_half_ext",
                                "cellpair_half_ext_excl")), c
    n = ps.sysdef.state.n_local
    assert ps.loop == loop0 + steps and int(ps.mask.sum()) == n
    loops = np.array([int(ln.split()[0]) for ln in lines])
    temps = np.array([float(ln.split("T=")[1].split()[0]) for ln in lines])
    assert np.isfinite(temps).all(), "non-finite scalars"
    temp = float(temps[loops > loop0 + steps - TAIL].mean())
    assert abs(temp - BILAYER_T) <= TEMP_TOL, f"mesh bilayer mean T {temp}"
    L1 = ps.Lv.cpu().numpy().astype(np.float64)
    assert np.isfinite(L1).all() and (np.abs(L1 / L0 - 1.0) <= 0.2).all(), \
        (L0, L1)
    bt = ps.sysdef.bonded
    resid = constraint_residual(
        SimpleNamespace(r=ps.gather_by_gid(("r",))["r"]), bt.cons_atoms,
        bt.cons_pairs, bt.cons_dist, box_lengths=L1)
    assert resid < 5e-3, f"mesh bilayer RATTLE residual {resid}"
    rate, tail = tail_rate(ps)
    cp = ps.cplan
    phase("mesh", f"bilayer at (1,1,1): {n} beads, ncore {cp.ncore} cap "
          f"{cp.cap}, chunk {ps.chunk_steps} steps; first energy "
          f"{e_mesh:.8g} vs single-device {e1:.8g} (rel {rel:.2g}) on the "
          f"20 fs restart; {steps} NPT steps (dispatch {DISPATCH}): box "
          f"{L0.round(4).tolist()} -> {L1.round(4).tolist()} nm, mean T "
          f"{temp:.2f} K over the last {TAIL} steps, RATTLE residual "
          f"{resid:.3g}, #6 with exclusions launched "
          f"{c['cellpair_half_ext_excl']} times, {rate:.1f} steps/s over the "
          f"last {tail} steps vs single-device {single_rate:.1f} (stage 2, "
          f"same call) on {card}")
    return c["cellpair_half_ext_excl"]


def eam_slice_phases(card, counters_zero, counters, eam_counters):
    """Phases 7 and 8, the EAM crystal through the CLI; returns the EAM
    kernels' launch counts of their main-path runs and phase 8's steps/s
    over its last TAIL steps."""
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.ops import cellpair_half as ch

    # --- phase 7: the EAM crystal, nc = 12, per-cell EAM kernels ------------
    with tempfile.TemporaryDirectory() as d_eq, \
            tempfile.TemporaryDirectory() as d:
        deck_eq = eam_deck(d_eq, EAM_NC, printrate=10)
        deck = eam_deck(d, EAM_NC, printrate=10, free=True)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck_eq, "-n", str(EAM_STEPS),
                       "--run-dir", d_eq])
        n_rho, n_force, n_rho_col, n_force_col = eam_counters()
        assert n_rho >= EAM_STEPS and n_force >= EAM_STEPS, eam_counters()
        assert n_rho_col == n_force_col == 0 and not any(counters()), (
            eam_counters(), counters())
        launches = {"eam_rho": n_rho, "eam_force": n_force}
        rows = read_rows(d_eq)
        assert sim.ss.loop == EAM_STEPS and np.isfinite(rows).all()
        temp = float(rows[rows[:, 0] > EAM_STEPS - TAIL][:, 5].mean())
        assert abs(temp - EAM_T) <= TEMP_TOL, f"mean T over the last {TAIL}: {temp}"
        rate, steps = tail_rate(sim)
        n_eam = sim.sysdef.state.n_local
        phase("eam", f"eam_crystal nc={EAM_NC}: {n_eam} atoms, cells "
              f"{sim.grid.ncells} cap {sim.grid.cap} "
              f"G={sim.force_fn.terms[0].G}, {EAM_STEPS} NVT steps at dt=2 fs "
              f"(dispatch {DISPATCH}): mean T {temp:.2f} K over the last "
              f"{TAIL} steps, Etot/atom {rows[-1, 2]:.6f} eV, rho/force "
              f"kernel launches {n_rho}/{n_force}, redos {sim.redos}, "
              f"{rate:.1f} steps/s over the last {steps} steps on {card}")
        # the NVE leg: the same deck with a FREE group from a checkpoint
        write_checkpoint(sim, d)
        run_dir = os.path.join(d, "run")
        sim = cli_run(["simulate", "-o", deck, "-r",
                       os.path.join(d, "restart"), "-n", str(EAM_NVE_STEPS),
                       "--run-dir", run_dir])
        rows = read_rows(run_dir)
    assert sim.ss.loop == EAM_STEPS + EAM_NVE_STEPS and np.isfinite(rows).all()
    drift = float(np.abs(rows[:, 2] - rows[0, 2]).max())
    rate, steps = tail_rate(sim)
    phase("eam", f"NVE leg: {EAM_NVE_STEPS} steps from the checkpoint, "
          f"max |Etot - Etot0| {drift:.3g} eV/atom (bound {NVE_DRIFT_TOL}), "
          f"mean T {rows[:, 5].mean():.2f} K, {rate:.1f} steps/s")
    assert drift < NVE_DRIFT_TOL, f"NVE drift {drift} eV/atom"

    # --- phase 8: the EAM crystal, nc = 32, column EAM kernels ---------------
    with tempfile.TemporaryDirectory() as d:
        deck = eam_deck(d, EAM_BIG_NC, printrate=10)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(EAM_BIG_STEPS),
                       "--run-dir", d])
        n_rho, n_force, n_rho_col, n_force_col = eam_counters()
        rows = read_rows(d)
    assert n_rho_col >= EAM_BIG_STEPS and n_force_col >= EAM_BIG_STEPS, \
        eam_counters()
    assert n_rho == n_force == 0 and not any(counters()), (
        eam_counters(), counters())
    launches["eam_rho_col"], launches["eam_force_col"] = n_rho_col, n_force_col
    assert sim.ss.loop == EAM_BIG_STEPS and np.isfinite(rows).all()
    temp = float(rows[rows[:, 0] > EAM_BIG_STEPS - TAIL][:, 5].mean())
    assert abs(temp - EAM_T) <= TEMP_TOL, f"mean T over the last {TAIL}: {temp}"
    rate, steps = tail_rate(sim)
    term = sim.force_fn.terms[0]
    phase("eam", f"eam_crystal nc={EAM_BIG_NC}: {sim.sysdef.state.n_local} "
          f"atoms, {EAM_BIG_STEPS} NVT steps at dt=2 fs: cells "
          f"{term.grid.ncells} ({term.grid.ncell}) cap {term.grid.cap} "
          f"G={term.G} U={len(ch.col_plan_grid(term.grid, term.G)[0])}; mean "
          f"T {temp:.2f} K over the last {TAIL} steps, Etot/atom "
          f"{rows[-1, 2]:.6f} eV, column rho/force launches "
          f"{n_rho_col}/{n_force_col}, redos {sim.redos}, {rate:.1f} steps/s "
          f"over the last {steps} steps on {card}")
    return launches, rate


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import ddcmd_tpu_torch  # noqa: F401  (pins TF32 off)
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.ops.cellpair_half import build_kernels

    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {nvcc_line()}")

    t0 = time.perf_counter()
    libs = build_kernels(force=True)
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        with open(os.path.join(os.path.dirname(lib), f"{name}.ptxas.txt")) as f:
            ptxas = " | ".join(ln.strip() for ln in f
                               if "registers" in ln or "spill" in ln)
        phase("build", f"{name}.cu -> {os.path.relpath(lib)}; ptxas: {ptxas}")
    phase("build", f"{len(libs)} sources in parallel in {build_s:.2f} s")

    counted = (ch.cellpair_half, ch.cellpair_half_col, eh.eam_rho_half,
               eh.eam_force_half, eh.eam_rho_half_col, eh.eam_force_half_col,
               ch.cellpair_half_ext, eh.eam_rho_half_ext,
               eh.eam_force_half_ext, cf.cellpair_full)

    def counters_zero():
        ch.cellpair_half.launches_excl = 0
        ch.cellpair_half_ext.launches_excl = 0
        for k in counted:
            k.launches = 0

    def counters():
        """(pair, pair with exclusions, pair column) launches"""
        return (ch.cellpair_half.launches, ch.cellpair_half.launches_excl,
                ch.cellpair_half_col.launches)

    def eam_counters():
        """(rho, force, rho column, force column) launches"""
        return tuple(k.launches for k in counted[2:6])

    def ext_counters():
        """(pair, rho, force) launches of the extended-grid kernels, and
        the full-stencil kernel's"""
        return tuple(k.launches for k in counted[6:])

    def all_counters():
        """{kernels JSON entry: launches} of every counted kernel"""
        names = ("cellpair_half", "cellpair_half_col", "eam_rho",
                 "eam_force", "eam_rho_col", "eam_force_col",
                 "cellpair_half_ext", "eam_rho_ext", "eam_force_ext",
                 "cellpair_full")
        return dict(zip(names, (k.launches for k in counted)),
                    cellpair_half_excl=ch.cellpair_half.launches_excl,
                    cellpair_half_ext_excl=ch.cellpair_half_ext.launches_excl)

    res = kernel_phase(dev)
    res.update(eam_kernel_phase(dev))
    res.update(ext_kernel_phase(dev))
    launches = {"cellpair_full": full_entry_phase(dev, counters_zero,
                                                  all_counters)}
    if "--kernels-only" in argv:
        return
    # --- phase 4: the water slice through the CLI ---------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = water_deck(d, 6173, printrate=10)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(SLICE_STEPS),
                       "--run-dir", d])
        n_all, n_excl, n_col = counters()
        rows = read_rows(d)
    assert sim.device == dev and sim.ss.loop == SLICE_STEPS
    assert np.isfinite(rows).all(), "non-finite printinfo row"
    assert n_all >= SLICE_STEPS and n_excl == 0 and n_col == 0, counters()
    assert not any(eam_counters()) and not any(ext_counters()), (
        eam_counters(), ext_counters())
    launches["cellpair_half"] = n_all
    single_rates = {"water": tail_rate(sim)[0]}
    temp = float(rows[rows[:, 0] > SLICE_STEPS - TAIL][:, 5].mean())
    assert abs(temp - 310.0) <= TEMP_TOL, f"mean T over the last {TAIL} steps: {temp}"
    rate, steps = tail_rate(sim)
    phase("water", f"martini_water 6173 beads NVT {SLICE_STEPS} steps "
          f"(dispatch {DISPATCH}): Etot/bead {rows[-1, 2]:.6f} eV, mean T "
          f"{temp:.2f} K over the last {TAIL} steps, kernel launches "
          f"{n_all}, {rate:.1f} steps/s over the last {steps} steps "
          f"on {card}")

    # --- phase 5: a small bilayer: per-cell kernel with exclusions ----------
    with tempfile.TemporaryDirectory() as d:
        deck = bilayer_deck(d, SMALL_NX, EQ_DT, 10)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(SMALL_STEPS),
                       "--run-dir", d])
        n_all, n_excl, n_col = counters()
        rows = read_rows(d)
    assert np.isfinite(rows).all(), "non-finite printinfo row"
    assert n_excl >= SMALL_STEPS and n_col == 0, counters()
    launches["cellpair_half_excl"] = n_excl
    phase("small-bilayer", f"{sim.sysdef.state.n_local} beads, cells "
          f"{sim.grid.ncells} cap {sim.grid.cap}, {SMALL_STEPS} NPT steps at "
          f"dt={EQ_DT} fs: T {rows[-1, 5]:.2f} K, per-cell kernel with "
          f"exclusions launched {n_excl} times, redos {sim.redos}")

    # --- phase 6: the full bilayer, staged as bench.py runs it --------------
    with tempfile.TemporaryDirectory() as d_eq, \
            tempfile.TemporaryDirectory() as d:
        deck_eq = bilayer_deck(d_eq, BILAYER_NX, EQ_DT, 200)
        deck = bilayer_deck(d, BILAYER_NX, 20.0, 10)
        t0 = time.perf_counter()
        sim_eq = cli_run(["simulate", "-o", deck_eq, "-n", str(EQ_STEPS),
                          "--run-dir", d_eq])
        eq_s = time.perf_counter() - t0
        assert sim_eq.ss.loop == EQ_STEPS
        # checkpoint into the measured deck's directory, so the restart's
        # relative files= path resolves against it
        write_checkpoint(sim_eq, d)
        L_eq = sim_eq.ss.box.lengths.cpu().numpy().astype(np.float64)
        phase("bilayer", f"stage 1: {sim_eq.sysdef.state.n_local} beads, "
              f"{EQ_STEPS} steps at dt={EQ_DT} fs in {eq_s:.1f} s (set-up "
              f"included), box {L_eq.round(4).tolist()} nm, cells "
              f"{sim_eq.grid.ncells} cap {sim_eq.grid.cap}, redos "
              f"{sim_eq.redos}; checkpoint written")
        del sim_eq
        run_dir = os.path.join(d, "run")
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-r",
                       os.path.join(d, "restart"), "-n", str(RUN_STEPS),
                       "--run-dir", run_dir])
        n_all, n_excl, n_col = counters()
        rows = read_rows(run_dir)
        sd = sim.sysdef
        assert sim.ss.loop == EQ_STEPS + RUN_STEPS, sim.ss.loop
        assert np.isfinite(rows).all(), "non-finite printinfo row"
        assert n_col >= RUN_STEPS, counters()
        launches["cellpair_half_col"] = n_col
        L0 = sd.box.lengths.cpu().numpy().astype(np.float64)
        L1 = sim.ss.box.lengths.cpu().numpy().astype(np.float64)
        assert np.allclose(L0, L_eq, rtol=1e-6), (L0, L_eq)
        assert np.isfinite(L1).all() and \
            (np.abs(L1 / L0 - 1.0) <= 0.2).all(), (L0, L1)
        tail = rows[rows[:, 0] > EQ_STEPS + RUN_STEPS - TAIL]
        temp = float(tail[:, 5].mean())
        assert abs(temp - BILAYER_T) <= TEMP_TOL, \
            f"mean T over the last {TAIL}: {temp}"
        bt = sd.bonded
        resid = constraint_residual(sim.ss.state, bt.cons_atoms, bt.cons_pairs,
                                    bt.cons_dist, box_lengths=L1)
        assert resid < 5e-3, f"RATTLE residual {resid}"
        rate, steps = tail_rate(sim)
        phase("bilayer", f"stage 2: {sd.state.n_local} beads, {RUN_STEPS} NPT "
              f"steps at dt=20 fs from the restart (dispatch {DISPATCH}): "
              f"cells {sim.grid.ncells} G={sim.force_fn.terms[0].G} "
              f"cap {sim.grid.cap}; stale redos {sim.redos['stale']}, "
              f"overflow replans {sim.redos['overflow']}; box "
              f"{L0.round(4).tolist()} -> "
              f"{L1.round(4).tolist()} nm; mean T {temp:.2f} K over the last "
              f"{TAIL} steps; Etot/bead {rows[-1, 2]:.6f} eV; RATTLE residual "
              f"{resid:.3g}; column kernel launches {n_col}; {rate:.2f} "
              f"steps/s over the last {steps} steps on {card}")
        # --- phase 12: the same restart through the mesh at (1,1,1) --------
        launches["cellpair_half_ext_excl"] = mesh_bilayer_phase(
            card, dev, d, counters_zero, all_counters, rate)

    eam_launches, single_rates["eam"] = eam_slice_phases(
        card, counters_zero, counters, eam_counters)
    launches.update(eam_launches)
    assert not any(ext_counters()), ext_counters()

    # --- phase 9: small-input agreement, card vs CPU -------------------------
    def final(where, make_deck, n):
        with tempfile.TemporaryDirectory() as d:
            deck = make_deck(d)
            s = cli_run(["simulate", "-o", deck, "-n", str(n), "--run-dir", d],
                        where)
            return (float(s.ss.energy.eion), float(s.ss.energy.rk),
                    s.ss.state.r.cpu().numpy(),
                    s.ss.box.lengths.cpu().numpy().astype(np.float64))

    cases = (("water 400 beads FREE 40 steps",
              lambda d: water_deck(d, 400, printrate=100, free=True), 40),
             ("bilayer nx=4 FREE NPT 20 steps",
              lambda d: bilayer_deck(d, 4, 20.0, 100, free=True), 20),
             ("EAM crystal nc=5 (500 atoms) FREE 40 steps",
              lambda d: eam_deck(d, 5, 100, free=True), 40))
    for name, make_deck, n in cases:
        (e1, k1, r1, L1), (e0, k0, r0, L0) = (final(w, make_deck, n)
                                              for w in ("cuda", "cpu"))
        dr = r1 - r0
        dr -= L0 * np.round(dr / L0)
        ok = (math.isclose(e1, e0, rel_tol=1e-4, abs_tol=1e-2)
              and math.isclose(k1, k0, rel_tol=1e-3, abs_tol=1e-2)
              and float(np.abs(dr).max()) < 1e-3
              and np.allclose(L1, L0, rtol=1e-5))
        phase("agree", f"{name}, card vs CPU: eion {e1:.6g} vs {e0:.6g}, "
              f"rk {k1:.6g} vs {k0:.6g}, max |dr| {np.abs(dr).max():.3g} nm, "
              f"box {L1.round(5).tolist()} vs {L0.round(5).tolist()}")
        if not ok:
            raise AssertionError(f"{name}: card run disagrees with the CPU run")

    # --- phases 10 and 11: ParallelSimulation at (1,1,1) ------------------
    launches.update(mesh_phases(card, dev, counters_zero, all_counters,
                                single_rates))
    assert "jax" not in sys.modules

    for name, old_us in OLD_BODY_US.items():
        phase("redesign", f"{name}: {1e3 * res[name][1]:.2f} us/call, the "
              f"body it replaced {old_us:.1f} us/call "
              f"({old_us / (1e3 * res[name][1]):.2f}x) on {card}")
    cellpair, eam = "ddcmd_tpu/ops/pallas_cellpair.py", "ddcmd_tpu/ops/pallas_eam.py"
    shard = "ddcmd_tpu/parallel/pallas_shard.py"
    kernels = {   # entry: (source, the TPU kernel it replaces)
        "cellpair_half": ("cellpair_half.cu", f"{cellpair}:559"),
        "cellpair_half_excl": ("cellpair_half.cu", f"{cellpair}:559"),
        "cellpair_half_col": ("cellpair_half.cu", f"{cellpair}:837"),
        "eam_rho": ("eam_half.cu", f"{eam}:230"),
        "eam_force": ("eam_half.cu", f"{eam}:269"),
        "eam_rho_col": ("eam_half_col.cu", f"{eam}:363"),
        "eam_force_col": ("eam_half_col.cu", f"{eam}:411"),
        "cellpair_half_ext": ("cellpair_half.cu", f"{shard}:361"),
        "cellpair_half_ext_excl": ("cellpair_half.cu", f"{shard}:361"),
        "cellpair_full": ("cellpair_half.cu", f"{cellpair}:389"),
        "eam_rho_ext": ("eam_half.cu", f"{shard}:434"),
        "eam_force_ext": ("eam_half.cu", f"{shard}:434"),
    }
    # no single PyTorch call computes a cell-list half-stencil sum, so
    # library_ms is null for every kernel
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "ddcmd_tpu_torch/csrc/" + src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": res[name][0],
         "ms": res[name][1], "plain_ms": res[name][2],
         "bound_ms": res[name][3], "bound_by": res[name][4],
         "library_ms": None}
        for name, (src, tpu) in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
