"""Where the time goes in the PyTorch port's main paths, on the GPU.

    python scripts/profile_torch_slice.py [--n 6173] [--steps 200]
    python scripts/profile_torch_slice.py --bilayer 48 [--steps 200]
    python scripts/profile_torch_slice.py --eam 12 [--steps 200]
    python scripts/profile_torch_slice.py --lj 131072 [--mesh]
    python scripts/profile_torch_slice.py --npt [--mesh]
    python scripts/profile_torch_slice.py --mesh [--eam 32 | --bilayer 48]

Runs the Martini water box NVT (default), the Martini DPPC bilayer NPT
(--bilayer NX: 2*NX*NX lipids plus water, NX = 48 is the ~100k-bead
full width; equilibrated at dt = 5 fs) or the EAM copper crystal NVT
(--eam NC: 4*NC^3 atoms; NC = 12 runs the per-cell EAM kernels, NC = 32
the column ones), the PAIR Lennard-Jones fluid NVT (--lj N atoms at the
builder's density) or the water box under the reference deck's
NGLFCONSTRAINT barostat (--npt: P0 1 bar, beta 3.0e-4/bar, tauBarostat
1 ps) through ddcmd_tpu_torch's Simulation, or with --mesh
through ParallelSimulation on a (1,1,1) brick mesh (the extended-grid
kernels; the bilayer there with exclusions, bonded terms, RATTLE and
the NPT chunk): --warm steps,
then --steps timed steps, then the same number traced with
torch.profiler.  Prints steps/s (untraced), the device busy
share (summed kernel time over wall time), kernel launches per step and
the CUDA kernels by total time.  For the bilayer's Simulation it also
takes each phase alone at the equilibrated state (pair kernel term, bonded term,
RATTLE front and back, molecular virial, barostat with the molecular
virial, rebuild, one whole step): its device time and kernel launches
per call from a profiler trace, and its time per call between CUDA
events over back-to-back calls.  One JSON line at the end carries the
numbers; the Chrome trace goes to --out when given.  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddcmd_tpu_torch.models import (eam_crystal, lj_fluid, load,  # noqa: E402
                                    martini_bilayer, martini_water)
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation  # noqa: E402
from ddcmd_tpu_torch.run.simulate import Simulation  # noqa: E402


# the reference deck's integrator (BASELINE.md:14)
NPT = ("type=NGLFCONSTRAINT; T=310.0K; P0=1.0 bar; beta=3.0e-4/bar; "
       "tauBarostat=1.0 ps;")


def event_ms(fn, n=50):
    """ms per call of fn, CUDA events around n back-to-back calls: the
    device's wall time, which includes its idle gaps when the host's
    launch rate bounds the calls."""
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


def kernel_us(fn, n=20):
    """(device us, kernel launches) per call of fn: the summed time of the
    CUDA kernels it launches, from a torch.profiler trace of n calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ks) / n, len(ks) / n


def phase_times(sim):
    """{phase: (event ms per call, device us per call, launches per
    call)} of each bilayer phase at sim's current state."""
    from ddcmd_tpu_torch.integrators.nglf import barostat_scale

    ss, perm, _ = sim._build_nbr(sim.ss)
    st, box = ss.state, ss.box
    dt = sim.sysdef.cfg.dt
    pair, bonded = sim.force_fn.terms[0], sim.force_fn.terms[1]
    zero = torch.zeros_like(st.r)
    phases = {
        "pair": lambda: pair(st, box, perm),
        "bonded": lambda: bonded(st, box, perm),
        "rattle_front": lambda: sim.constraint_fn(
            st, dt, "front", box_lengths=box.lengths),
        "rattle_back": lambda: sim.constraint_fn(
            st, dt, "back", box_lengths=box.lengths),
        "molecular_virial": lambda: sim.mol_virial_fn(
            st, box, ss.energy.virial),
        "barostat": lambda: barostat_scale(
            st, box, ss.energy.virial, sim.barostat, dt, sim.mol_virial_fn),
        "rebuild": lambda: sim._build_nbr(ss),
        "step": lambda: sim.step_fn(ss, perm, sim.coeffs, zero, zero),
    }
    return {name: (event_ms(fn), *kernel_us(fn))
            for name, fn in phases.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=6173)
    p.add_argument("--bilayer", type=int, default=0, metavar="NX",
                   help="profile the DPPC bilayer with NX x NX lipids a "
                        "leaflet instead of the water box")
    p.add_argument("--eam", type=int, default=0, metavar="NC",
                   help="profile the EAM copper crystal of 4*NC^3 atoms "
                        "instead of the water box")
    p.add_argument("--lj", type=int, default=0, metavar="N",
                   help="profile the PAIR Lennard-Jones fluid of N atoms "
                        "instead of the water box")
    p.add_argument("--npt", action="store_true",
                   help="run the water box under the reference deck's "
                        "NGLFCONSTRAINT barostat")
    p.add_argument("--mesh", action="store_true",
                   help="run ParallelSimulation on a (1,1,1) mesh instead "
                        "of Simulation")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--warm", type=int, default=1000)
    p.add_argument("--out", default=None,
                   help="directory for the Chrome trace (none if unset)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA device")
    with tempfile.TemporaryDirectory() as d:
        if args.bilayer:
            martini_bilayer(d, nx=args.bilayer, ny=args.bilayer, dt_fs=5.0)
        elif args.eam:
            eam_crystal(d, nc=args.eam)
        elif args.lj:
            lj_fluid(d, n=args.lj)
        else:
            martini_water(d, n=args.n)
            if args.npt:
                deck = os.path.join(d, "object.data")
                with open(deck) as f:
                    text = f.read()
                with open(deck, "w") as f:
                    f.write(text.replace("type=NGLF; T=310.0K;", NPT))
        db, base = load(d)
        if args.mesh:
            sim = ParallelSimulation(db, base, shape=(1, 1, 1),
                                     device="cuda")
        else:
            sim = Simulation(db, base, run_dir=d, device="cuda")
        quiet = lambda line: None                              # noqa: E731
        sim.run(args.warm, print_fn=quiet)
        torch.cuda.synchronize()
        # the same window unprofiled: the profiler's own cost slows the
        # host, so steps/s comes from this run
        t0 = time.perf_counter()
        sim.run(args.steps, print_fn=quiet,
                max_steps_per_dispatch=args.steps)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run(args.steps, print_fn=quiet,
                    max_steps_per_dispatch=args.steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        phases = phase_times(sim) if args.bilayer and not args.mesh else {}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    # Simulation.run starts with one first_energy; the mesh's run does not
    steps = args.steps + (0 if args.mesh else 1)
    what = (f"bilayer nx={args.bilayer}" if args.bilayer
            else f"eam_crystal nc={args.eam}" if args.eam
            else f"lj_fluid n={args.lj}" if args.lj
            else f"water n={args.n}" + (" NPT" if args.npt else ""))
    if args.mesh:
        what += " mesh (1,1,1)"
        plan = (f"core cells {sim.cplan.ncore} cap {sim.cplan.cap}, "
                f"rebuild every {sim.chunk_steps} steps")
    else:
        plan = (f"cells {sim.grid.ncells} cap {sim.grid.cap} "
                f"G={sim.force_fn.terms[0].G}, redos {sim.redos}")
    print(f"{what}, {sim.sysdef.state.n_local} particles, {plan}, on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"unprofiled: {steps} steps in {plain_wall:.4f} s = "
          f"{steps / plain_wall:.1f} steps/s; profiled: {wall:.4f} s, "
          f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e4 / wall:.1f}% "
          f"of profiled wall, {busy_us / 1e4 / plain_wall:.1f}% of "
          f"unprofiled wall; {len(kernels) / steps:.1f} kernel launches/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, c) in top:
        print(f"{t / steps:10.2f} us/step {c / steps:6.2f}/step  {name[:90]}")
    for name, (ms, dev_us, nk) in phases.items():
        print(f"phase {name:18s} device {dev_us:9.2f} us/call in "
              f"{nk:6.1f} kernels; {1e3 * ms:9.2f} us/call between CUDA "
              "events (host-bound calls included)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    print(json.dumps({
        "what": what,
        "steps_per_s": steps / plain_wall,
        "busy_share_profiled": busy_us / 1e6 / wall,
        "busy_share_unprofiled": busy_us / 1e6 / plain_wall,
        "launches_per_step": len(kernels) / steps,
        "top_us_per_step": {n[:60]: t / steps for n, (t, _) in top[:8]},
        "phase_device_us_per_call": {k: v[1] for k, v in phases.items()},
        "phase_launches_per_call": {k: v[2] for k, v in phases.items()},
        "phase_event_us_per_call": {k: 1e3 * v[0]
                                    for k, v in phases.items()}}))


if __name__ == "__main__":
    main()
