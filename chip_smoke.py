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
       the same full-bilayer slots;
     - the per-cell EAM kernels (density and force pass) on the nc = 12
       crystal's slots: RATIONAL (the deck's form), FS, SC, EXP, AT and
       a T = 2 FS alloy with an asymmetric density; the column EAM
       kernels on the nc = 32 crystal's slots, on an nz == G grid, and
       against the per-cell EAM kernels on the nc = 32 slots;
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
     twins).

Every main-path phase sets the launch counters to 0 just before it and
reads them just after.  Prints the kernels' JSON line, the card line,
and last {"ok": true, "device": {...}}.  --kernels-only stops after
phase 3 and prints no result.
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
NVE_DRIFT_TOL = 1e-3     # eV/atom, max |Etot - Etot0| over the NVE leg
DEVICE = "cuda:0"
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
    from ddcmd_tpu_torch.objects import units as U

    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    r = (g + 0.5) / m * L - 0.5 * L + (rng.random((n, 3)) - 0.5) * (0.25 * L / m)
    q = rng.choice([-1.0, 0.0, 1.0], size=n) * 0.3
    tidx = rng.integers(0, 2, size=n)
    sigma = np.array([[0.47, 0.57], [0.57, 0.47]])
    eps = np.array([[5.0, 5.6], [5.6, 5.0]])
    rcut = 1.1
    sr6 = (sigma / rcut) ** 6
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    tables = dict(sigma=sigma, eps=eps, shift=-4 * eps * (sr6 ** 2 - sr6),
                  rcut2=f32(rcut ** 2), krf=f32(0.5 / rcut ** 3),
                  crf=f32(1.5 / rcut), keR=f32(U.ke / 15.0))
    return r, q, tidx, tables, rcut


def packed_inputs(r, q, tidx, L, grid, tables, dev, G=1):
    """Pack as the main path does (cellpair_eval_half), on the card; the
    arguments of the column kernel when G > 1."""
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors, pack_slots

    n = len(r)
    n_pad = ((n + 127) // 128) * 128
    pad = lambda a, shape: np.concatenate(                      # noqa: E731
        [np.asarray(a), np.zeros((n_pad - n,) + shape)])
    rt = torch.tensor(pad(r, (3,)), dtype=torch.float32, device=dev)
    qt = torch.tensor(pad(q, ()), dtype=torch.float32, device=dev)
    tt = torch.tensor(pad(tidx, ()), dtype=torch.int64, device=dev)
    fmask = (torch.arange(n_pad, device=dev) < n).float()
    Lt = torch.tensor(L, dtype=torch.float32, device=dev)
    perm, ov = build_cell_slots(rt, fmask, Lt, grid)
    assert not bool(ov), "overflow packing the comparison case"
    hg = half_grid(grid)
    gt = grid_tensors(hg, dev, G)
    slots, _ = pack_slots(rt, qt, tt, perm, Lt, hg, gt["frac_centers"])
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


def per_slot(out_p, out_q, out_cell):
    ncell, _, cap = out_q.shape
    back = out_q.transpose(1, 2).reshape(ncell * cap, 8)
    f = (out_p[:, :3] + back[:, :3]).double()
    pe = (out_p[:, 3] + back[:, 3]).double()
    return f, pe, out_cell[:, 0].double().sum(), out_cell[:, 1:7].double().sum(0)


def compare(name, kernel, plain, args, kw):
    """Kernel vs plain twin on the same CUDA tensors, at the tolerances
    of tests/test_pallas_cellpair.py; returns (max_abs_err of the force,
    ms per kernel call, ms per plain call)."""
    got = per_slot(*kernel(*args, **kw))
    ref = per_slot(*plain(*args, **kw))
    torch.cuda.synchronize()
    ferr, scale = agree(name, got, ref)
    ms = time_calls(lambda: kernel(*args, **kw), TIMED_CALLS)
    plain_ms = time_calls(lambda: plain(*args, **kw), PLAIN_CALLS)
    phase("kernel", f"{name}: force err {ferr:.3g} (scale {scale:.4g}), "
          f"e {float(got[2]):.6g} vs {float(ref[2]):.6g}; kernel "
          f"{1e3 * ms:.2f} us/call, plain {1e3 * plain_ms:.2f} us/call")
    return ferr, ms, plain_ms


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


def eam_compare(name, kernels, plains, slots, args, kw, tables):
    """Both EAM kernels against their twins on the same CUDA tensors:
    pass A on `slots`, pass B on a copy holding the twin's dF in row 6.
    Returns {"rho": (max |d rho|, ms, plain ms), "force": (max |d f|,
    ms, plain ms)}."""
    from ddcmd_tpu_torch.ops.eam_half import embed_slots

    (rho_k, force_k), (rho_p, force_p) = kernels, plains
    ref_a = rho_p(slots, *args, **kw)
    fslots = slots.clone()
    embed_slots(fslots, *ref_a, tables)
    got = eam_sums(rho_k(slots, *args, **kw), force_k(fslots, *args, **kw))
    ref = eam_sums(ref_a, force_p(fslots, *args, **kw))
    torch.cuda.synchronize()
    rerr, ferr, scale = eam_agree(name, got, ref)
    t = {"rho": (rerr, time_calls(lambda: rho_k(slots, *args, **kw),
                                  TIMED_CALLS),
                 time_calls(lambda: rho_p(slots, *args, **kw), PLAIN_CALLS)),
         "force": (ferr, time_calls(lambda: force_k(fslots, *args, **kw),
                                    TIMED_CALLS),
                   time_calls(lambda: force_p(fslots, *args, **kw),
                              PLAIN_CALLS))}
    phase("kernel", f"{name}: rho err {rerr:.3g}, force err {ferr:.3g} "
          f"(scale {scale:.4g}), e {float(got[1]):.8g} vs "
          f"{float(ref[1]):.8g}; rho kernel {1e3 * t['rho'][1]:.2f} us/call, "
          f"plain {1e3 * t['rho'][2]:.2f}; force kernel "
          f"{1e3 * t['force'][1]:.2f} us/call, plain "
          f"{1e3 * t['force'][2]:.2f}")
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
                    args, kw, tables)
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
                    slots, args, kw, tables)
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
          f"force kernel {1e3 * ms_force:.2f} us/call")
    del slots, fslots, args, cell_args

    # column on a grid with nz == G (aliased union), the alloy
    at = eam_alloy_tables(dev)
    (rho_k, _, slots, args, kw), hg = eam_crystal_inputs(8, 3, at, dev)
    assert rho_k is eh.eam_rho_half_col and hg.ncells[2] == 3, hg.ncells
    eam_compare(f"column EAM FS alloy T=2: nc=8 crystal, cells {hg.ncells}, "
                f"nz == G = 3 (aliased union, U={args[0].shape[1]})", *col,
                slots, args, kw, at)
    return res


def kernel_phase(dev):
    """Phase 3; returns {kernel entry: (max_abs_err, ms, plain_ms)} of
    the main-path case of each kernel."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load, martini_water
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops.cellpair_half import plan_lanes
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.simulate import Simulation

    pair = (ch.cellpair_half, ch.cellpair_half_plain)
    col = (ch.cellpair_half_col, ch.cellpair_half_col_plain)
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
        args, kw)
    for n_syn, L_syn in ((800, 6.6), (220, 4.2), (60, 2.6)):
        r, q, tidx, tabs, rcut = synthetic(n_syn, L_syn)
        g = plan_lanes([L_syn] * 3, rcut, 0.3, n_syn)
        a = packed_inputs(r, q, tidx, [L_syn] * 3, g, tabs, dev)
        compare(f"per-cell: charged T=2 n={n_syn} L={L_syn} cells "
                f"{g.ncells}", *pair, a,
                dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
                     coulomb=True))

    # (a) per-cell kernel with exclusions on a small bilayer
    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, SMALL_NX, 20.0, 200)
        sim = Simulation(*load(d), run_dir=d, device=dev)
        kernel, a, kw, hg = sim_kernel_inputs(sim)
    assert kernel is ch.cellpair_half and kw["excl"], (kernel, kw)
    res["cellpair_half_excl"] = compare(
        f"per-cell + exclusions: bilayer nx={SMALL_NX} "
        f"{sim.sysdef.state.n_local} beads, cells {hg.ncells}, cap "
        f"{hg.cap}, T={a[-1].shape[0]}, Coulomb", *pair, a, kw)

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
        f"{hg.cap}", *col, a, kw)
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
          f"{1e3 * ms_cell:.2f} us/call")
    del sim, a, cell_args

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
    return res


def eam_slice_phases(card, counters_zero, counters, eam_counters):
    """Phases 7 and 8, the EAM crystal through the CLI; returns the EAM
    kernels' launch counts of their main-path runs."""
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
    return launches


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import ddcmd_tpu_torch  # noqa: F401  (pins TF32 off)
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.io.restart import write_checkpoint
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

    res = kernel_phase(dev)
    res.update(eam_kernel_phase(dev))
    if "--kernels-only" in argv:
        return

    counted = (ch.cellpair_half, ch.cellpair_half_col, eh.eam_rho_half,
               eh.eam_force_half, eh.eam_rho_half_col, eh.eam_force_half_col)

    def counters_zero():
        ch.cellpair_half.launches_excl = 0
        for k in counted:
            k.launches = 0

    def counters():
        """(pair, pair with exclusions, pair column) launches"""
        return (ch.cellpair_half.launches, ch.cellpair_half.launches_excl,
                ch.cellpair_half_col.launches)

    def eam_counters():
        """(rho, force, rho column, force column) launches"""
        return tuple(k.launches for k in counted[2:])

    launches = {}
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
    assert not any(eam_counters()), eam_counters()
    launches["cellpair_half"] = n_all
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
    assert np.isfinite(L1).all() and (np.abs(L1 / L0 - 1.0) <= 0.2).all(), (L0, L1)
    temp = float(rows[rows[:, 0] > EQ_STEPS + RUN_STEPS - TAIL][:, 5].mean())
    assert abs(temp - BILAYER_T) <= TEMP_TOL, f"mean T over the last {TAIL}: {temp}"
    bt = sd.bonded
    resid = constraint_residual(sim.ss.state, bt.cons_atoms, bt.cons_pairs,
                                bt.cons_dist, box_lengths=L1)
    assert resid < 5e-3, f"RATTLE residual {resid}"
    rate, steps = tail_rate(sim)
    phase("bilayer", f"stage 2: {sd.state.n_local} beads, {RUN_STEPS} NPT "
          f"steps at dt=20 fs from the restart (dispatch {DISPATCH}): "
          f"cells {sim.grid.ncells} G={sim.force_fn.terms[0].G} "
          f"cap {sim.grid.cap}; stale redos {sim.redos['stale']}, overflow "
          f"replans {sim.redos['overflow']}; box {L0.round(4).tolist()} -> "
          f"{L1.round(4).tolist()} nm; mean T {temp:.2f} K over the last "
          f"{TAIL} steps; Etot/bead {rows[-1, 2]:.6f} eV; RATTLE residual "
          f"{resid:.3g}; column kernel launches {n_col}; {rate:.2f} steps/s "
          f"over the last {steps} steps on {card}")

    launches.update(eam_slice_phases(card, counters_zero, counters,
                                     eam_counters))

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
    assert "jax" not in sys.modules

    kernels = {   # entry: (source, the TPU kernel it replaces)
        "cellpair_half": ("cellpair_half.cu", "pallas_cellpair.py:559"),
        "cellpair_half_excl": ("cellpair_half.cu", "pallas_cellpair.py:559"),
        "cellpair_half_col": ("cellpair_half_col.cu", "pallas_cellpair.py:837"),
        "eam_rho": ("eam_half.cu", "pallas_eam.py:230"),
        "eam_force": ("eam_half.cu", "pallas_eam.py:269"),
        "eam_rho_col": ("eam_half_col.cu", "pallas_eam.py:363"),
        "eam_force_col": ("eam_half_col.cu", "pallas_eam.py:411"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "ddcmd_tpu_torch/csrc/" + src,
         "replaces": "ddcmd_tpu/ops/" + tpu, "launches": launches[name],
         "max_abs_err": res[name][0], "ms": res[name][1],
         "plain_ms": res[name][2]}
        for name, (src, tpu) in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
