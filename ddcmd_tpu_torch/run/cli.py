"""Command-line entry:
`python -m ddcmd_tpu_torch.run.cli [master] -o deck [-r restart] [-n N]
[--run-dir D] [--device cuda|cpu] [--f64]`.

Counterpart of ddcmd_tpu/run/cli.py (reference CLI, ddcMD
src/commandLineOptions.c:69-120).  Masters: simulate (the default),
thermalize, readWrite, eightFold, testForce, testPressure (always in
float64), integrationTest (float64) and unitTest (the port's pytest
suite); analysis and transform raise NotImplementedError (ROADMAP queue
1, item 24).  The run goes to the CUDA card; without one it raises
unless --device cpu asks for the CPU.  --f64 runs in float64, on the
plain cell-block engine (the kernels are f32).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..objects import ObjectDB

MASTERS = ("simulate", "analysis", "transform", "thermalize", "readWrite",
           "eightFold", "testForce", "testPressure", "integrationTest",
           "unitTest")


def load_db(object_files: list[str], restart_file: str | None,
            base_dir: str = "."):
    """objectSetup analog (ddcMD src/objectSetup.c:14-79): compile
    deck(s) + restart + referenced parmfiles into one DB."""
    db = ObjectDB()
    for f in object_files:
        db.compile_file(f)
    if restart_file:
        db.compile_file(restart_file)
    for pot in db.by_class("POTENTIAL"):
        pf = pot.get_str("parmfile", "")
        if pf:
            path = pf if os.path.isabs(pf) else os.path.join(base_dir, pf)
            if os.path.exists(path):
                db.compile_file(path)
    return db


def run(argv=None):
    """Parse arguments and run the master; returns what the master
    returns (the Simulation for simulate and the masters built on one,
    testForce's worst error and rows, testPressure's sweeps, unitTest's
    exit code)."""
    p = argparse.ArgumentParser(prog="ddcmd-tpu-torch")
    p.add_argument("master", nargs="?", default="simulate", choices=MASTERS)
    p.add_argument("-o", "--object", action="append", default=None,
                   help="object deck file(s)")
    p.add_argument("-r", "--restart", default=None, help="restart file")
    p.add_argument("-n", "--nloops", type=int, default=None,
                   help="override number of loops (deltaloop)")
    p.add_argument("--run-dir", default=".")  # created if absent (below)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only as "
                        "--device cpu)")
    p.add_argument("--f64", action="store_true",
                   help="run in float64 (the plain cell-block engine)")
    args = p.parse_args(argv)
    from . import masters

    if args.master == "unitTest":
        return masters.unit_test_master()
    if args.master in ("analysis", "transform"):
        # item 24's registries: these raise naming it
        return getattr(masters, f"{args.master}_master")()

    decks = args.object or ["object.data"]
    base_dir = os.path.dirname(os.path.abspath(decks[0]))
    db = load_db(decks, args.restart, base_dir)
    os.makedirs(args.run_dir, exist_ok=True)
    dtype = torch.float64 if args.f64 else torch.float32
    kw = dict(device=args.device, dtype=dtype)

    if args.master == "simulate":
        from .simulate import simulate_master

        return simulate_master(db, base_dir, run_dir=args.run_dir,
                               n_loops=args.nloops, **kw)
    if args.master == "testForce":
        from .testforce import testforce_master

        return testforce_master(db, base_dir, **kw)
    if args.master == "testPressure":
        from .testpressure import testpressure_master

        # the delta-halving sweep needs f64: at f32 the central difference
        # hits roundoff after ~3 halvings and the slope check means nothing
        return testpressure_master(db, base_dir, device=args.device,
                                   dtype=torch.float64, out_dir=args.run_dir)
    if args.master == "integrationTest":
        return masters.integration_test_master(db, base_dir,
                                               run_dir=args.run_dir,
                                               device=args.device)
    fn = {"thermalize": masters.thermalize_master,
          "readWrite": masters.read_write_master,
          "eightFold": masters.eightfold_master}[args.master]
    return fn(db, base_dir, run_dir=args.run_dir, **kw)


def main(argv=None) -> int:
    out = run(argv)
    # unitTest returns pytest's exit code; every other master raises on
    # failure
    return out if isinstance(out, int) else 0


if __name__ == "__main__":
    sys.exit(main())
