"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; imports
nothing of JAX.  Phases, one line each (any failure raises, exit != 0):

  1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc;
  2. build: compile every kernel of the main path from csrc/;
  3. kernel vs plain: each kernel's wrapper against its plain PyTorch
     twin on the same CUDA tensors, at the main path's shapes (the
     6,173-bead Martini water box: 80 cells, cap 128, one LJ type, no
     Coulomb) and on charged two-type systems whose cell grids have 3-,
     2- and 1-cell axes; times per call with CUDA events;
  4. slice: the Martini water box through `ddcmd_tpu_torch.run.cli
     simulate`, 3000 NVT steps in dispatches of 400, with the launch
     counters set to 0 just before and read just after;
  5. agreement: a small deterministic run on the card against the same
     run on the CPU (plain twins).

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}.
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
TIMED_CALLS = 200


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


def packed_inputs(r, q, tidx, L, grid, tables, dev):
    """Pack as the main path does (cellpair_eval_half), on the card."""
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
    gt = grid_tensors(hg, dev)
    slots, _ = pack_slots(rt, qt, tt, perm, Lt, hg, gt["frac_centers"])
    L8 = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    L8[0, :3] = Lt / gt["ncells"]
    L8[0, 3] = tables["rcut2"]
    counts = (perm.reshape(hg.ncell, hg.cap) != n_pad).sum(
        1, dtype=torch.int32)
    tabs = [torch.tensor(np.asarray(tables[k]), dtype=torch.float32,
                         device=dev).contiguous()
            for k in ("sigma", "eps", "shift")]
    return (slots, gt["stencil"], L8, counts, *tabs)


def per_slot(out_p, out_q, out_cell):
    ncell, _, cap = out_q.shape
    back = out_q.transpose(1, 2).reshape(ncell * cap, 8)
    f = (out_p[:, :3] + back[:, :3]).double()
    pe = (out_p[:, 3] + back[:, 3]).double()
    return f, pe, out_cell[:, 0].double().sum(), out_cell[:, 1:7].double().sum(0)


def compare(name, args, kw):
    """Kernel vs plain twin on the same CUDA tensors, at the tolerances
    of tests/test_pallas_cellpair.py; returns (max_abs_err of the force,
    ms per kernel call, ms per plain call)."""
    from ddcmd_tpu_torch.ops.cellpair_half import (cellpair_half,
                                                   cellpair_half_plain)

    got = per_slot(*cellpair_half(*args, **kw))
    ref = per_slot(*cellpair_half_plain(*args, **kw))
    torch.cuda.synchronize()
    (f1, pe1, e1, v1), (f0, pe0, e0, v0) = got, ref
    scale = max(1.0, float(f0.abs().max()))
    ferr = float((f1 - f0).abs().max())
    checks = {
        "force": ferr <= 2e-5 * scale,
        "e": abs(float(e1 - e0)) <= 1e-4 * abs(float(e0)) + 1e-2,
        "virial": bool(((v1 - v0).abs() <= 2e-3 * v0.abs() + 0.5).all()),
        "pe": bool(((pe1 - pe0).abs() <= 1e-3 * pe0.abs() + 2e-3).all()),
    }
    ms = time_calls(lambda: cellpair_half(*args, **kw))
    plain_ms = time_calls(lambda: cellpair_half_plain(*args, **kw))
    phase("kernel", f"{name}: force err {ferr:.3g} (scale {scale:.4g}), "
          f"e {float(e1):.6g} vs {float(e0):.6g}, checks {checks}; "
          f"kernel {1e3 * ms:.2f} us/call, plain {1e3 * plain_ms:.2f} "
          f"us/call")
    if not all(checks.values()):
        raise AssertionError(f"{name}: kernel disagrees with plain: {checks}")
    return ferr, ms, plain_ms


def time_calls(fn):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIMED_CALLS


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import ddcmd_tpu_torch  # noqa: F401  (pins TF32 off)
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load, martini_water
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops.cellpair_half import build_kernel, plan_lanes
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run import cli

    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {nvcc_line()}")

    t0 = time.perf_counter()
    lib = build_kernel(force=True)
    build_s = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(lib), "cellpair_half.ptxas.txt")) as f:
        ptxas = " ".join(ln.strip() for ln in f if "registers" in ln or "spill" in ln)
    phase("build", f"cellpair_half.cu -> {os.path.relpath(lib)} in "
          f"{build_s:.2f} s; ptxas: {ptxas}")

    # --- kernel vs plain -------------------------------------------------
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
    args = packed_inputs(r, np.zeros(n),
                         np.zeros(n, np.int64), L, grid, water, dev)
    kw = dict(krf=water["krf"], crf=water["crf"], keR=water["keR"],
              coulomb=False)
    err, ms, plain_ms = compare("waterbox 6173 beads, 80 cells, cap 128, T=1",
                                args, kw)
    for n_syn, L_syn in ((800, 6.6), (220, 4.2), (60, 2.6)):
        r, q, tidx, tabs, rcut = synthetic(n_syn, L_syn)
        g = plan_lanes([L_syn] * 3, rcut, 0.3, n_syn)
        a = packed_inputs(r, q, tidx, [L_syn] * 3, g, tabs, dev)
        compare(f"charged T=2 n={n_syn} L={L_syn} cells {g.ncells}", a,
                dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
                     coulomb=True))

    # --- the slice through the CLI ----------------------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = water_deck(d, 6173, printrate=10)
        ch.cellpair_half.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sim = cli.run(["simulate", "-o", deck, "-n", str(SLICE_STEPS),
                           "--run-dir", d])
        launches = ch.cellpair_half.launches
        with open(os.path.join(d, "data")) as f:
            rows = np.array([ln.split() for ln in f.read().splitlines()[1:]],
                            dtype=np.float64)
    assert sim.device.type == "cuda" and sim.ss.loop == SLICE_STEPS
    assert np.isfinite(rows).all(), "non-finite printinfo row"
    assert launches >= SLICE_STEPS, f"kernel launched {launches} times"
    tail = rows[rows[:, 0] > SLICE_STEPS - TAIL]
    temp = float(tail[:, 5].mean())
    assert abs(temp - 310.0) <= 10.0, f"mean T over the last {TAIL} steps: {temp}"
    steps = secs = 0
    for k, s in reversed(sim.dispatch_log):
        if steps >= TAIL:
            break
        steps, secs = steps + k, secs + s
    rate = steps / secs
    phase("slice", f"martini_water 6173 beads NVT {SLICE_STEPS} steps "
          f"(dispatch {DISPATCH}): Etot/bead {rows[-1, 2]:.6f} eV, mean T "
          f"{temp:.2f} K over the last {TAIL} steps, kernel launches "
          f"{launches}, {rate:.1f} steps/s over the last {steps} steps "
          f"on {card}")

    # --- small-input agreement: card vs CPU --------------------------------
    finals = {}
    for where in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as d:
            deck = water_deck(d, 400, printrate=100, free=True)
            with contextlib.redirect_stdout(io.StringIO()):
                s = cli.run(["simulate", "-o", deck, "-n", "40",
                             "--run-dir", d, "--device", where])
            finals[where] = (float(s.ss.energy.eion), float(s.ss.energy.rk),
                             s.ss.state.r.cpu().numpy(),
                             s.ss.box.lengths.cpu().numpy())
    (e1, k1, r1, Lw), (e0, k0, r0, _) = finals["cuda"], finals["cpu"]
    dr = r1 - r0
    dr -= Lw * np.round(dr / Lw)
    agree = (math.isclose(e1, e0, rel_tol=1e-4, abs_tol=1e-2)
             and math.isclose(k1, k0, rel_tol=1e-3, abs_tol=1e-2)
             and float(np.abs(dr).max()) < 1e-3)
    phase("agree", f"400 beads FREE 40 steps, card vs CPU: eion {e1:.6g} vs "
          f"{e0:.6g}, rk {k1:.6g} vs {k0:.6g}, max |dr| {np.abs(dr).max():.3g} nm")
    if not agree:
        raise AssertionError("card run disagrees with the CPU run")
    assert "jax" not in sys.modules

    print(json.dumps({"kernels": [{
        "name": "cellpair_half", "route": "cuda",
        "source": "ddcmd_tpu_torch/csrc/cellpair_half.cu",
        "replaces": "ddcmd_tpu/ops/pallas_cellpair.py:559",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
