"""Command-line entry:
`python -m ddcmd_tpu_torch.run.cli simulate -o deck [-r restart] [-n N]
[--run-dir D] [--device cuda|cpu] [--f64]`.

Counterpart of ddcmd_tpu/run/cli.py (reference CLI, ddcMD
src/commandLineOptions.c:69-120).  Only the simulate master is ported;
the others raise NotImplementedError (ROADMAP queue 1, item 23).  The
run goes to the CUDA card; without one it raises unless --device cpu
asks for the CPU.  --f64 runs in float64, on the plain cell-block engine
(the kernels are f32).
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
    returns (the Simulation for simulate)."""
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
    if args.master != "simulate":
        raise NotImplementedError(
            f"master {args.master!r} is not ported yet (ROADMAP queue 1, "
            "item 23)")

    decks = args.object or ["object.data"]
    base_dir = os.path.dirname(os.path.abspath(decks[0]))
    db = load_db(decks, args.restart, base_dir)
    os.makedirs(args.run_dir, exist_ok=True)

    from .simulate import simulate_master

    return simulate_master(
        db, base_dir, run_dir=args.run_dir, n_loops=args.nloops,
        device=args.device,
        dtype=torch.float64 if args.f64 else torch.float32)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
