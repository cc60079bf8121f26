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
  4. water slice: the Martini water box through `ddcmd_tpu_torch.run.cli
     simulate`, 3000 NVT steps in dispatches of 400;
  5. small-bilayer slice: a 2,888-bead bilayer through the CLI, 400 NPT
     steps on the per-cell kernel with exclusions;
  6. bilayer slice: the ~100k-bead DPPC bilayer through the CLI in two
     stages, as bench.py runs it: 3000 steps at dt = 5 fs, a checkpoint,
     then 8000 NPT steps at dt = 20 fs from that restart;
  7. agreement: small deterministic runs on the card (water box; a small
     bilayer with bonds, constraints, exclusions and the barostat)
     against the same runs on the CPU (plain twins).

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
DEVICE = "cuda:0"


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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import ddcmd_tpu_torch  # noqa: F401  (pins TF32 off)
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.ops import cellpair_half as ch
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
    if "--kernels-only" in argv:
        return

    def counters_zero():
        ch.cellpair_half.launches = 0
        ch.cellpair_half.launches_excl = 0
        ch.cellpair_half_col.launches = 0

    def counters():
        return (ch.cellpair_half.launches, ch.cellpair_half.launches_excl,
                ch.cellpair_half_col.launches)

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
    from ddcmd_tpu_torch.ops.cellpair import half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import choose_col_group

    phase("bilayer", f"stage 2: {sd.state.n_local} beads, {RUN_STEPS} NPT "
          f"steps at dt=20 fs from the restart (dispatch {DISPATCH}): "
          f"cells {sim.grid.ncells} G={choose_col_group(half_grid(sim.grid))} "
          f"cap {sim.grid.cap}; stale redos {sim.redos['stale']}, overflow "
          f"replans {sim.redos['overflow']}; box {L0.round(4).tolist()} -> "
          f"{L1.round(4).tolist()} nm; mean T {temp:.2f} K over the last "
          f"{TAIL} steps; Etot/bead {rows[-1, 2]:.6f} eV; RATTLE residual "
          f"{resid:.3g}; column kernel launches {n_col}; {rate:.2f} steps/s "
          f"over the last {steps} steps on {card}")

    # --- phase 7: small-input agreement, card vs CPU -------------------------
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
              lambda d: bilayer_deck(d, 4, 20.0, 100, free=True), 20))
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

    replaces = {"cellpair_half": "ddcmd_tpu/ops/pallas_cellpair.py:559",
                "cellpair_half_excl": "ddcmd_tpu/ops/pallas_cellpair.py:559",
                "cellpair_half_col": "ddcmd_tpu/ops/pallas_cellpair.py:837"}
    source = {"cellpair_half": "ddcmd_tpu_torch/csrc/cellpair_half.cu",
              "cellpair_half_excl": "ddcmd_tpu_torch/csrc/cellpair_half.cu",
              "cellpair_half_col": "ddcmd_tpu_torch/csrc/cellpair_half_col.cu"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": res[name][0], "ms": res[name][1],
         "plain_ms": res[name][2]}
        for name in ("cellpair_half", "cellpair_half_excl",
                     "cellpair_half_col")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
