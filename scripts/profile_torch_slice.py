"""Where the time goes in the PyTorch port's main path, on the GPU.

    python scripts/profile_torch_slice.py [--n 6173] [--steps 200]

Runs the Martini water box NVT through ddcmd_tpu_torch's Simulation,
equilibrates for --warm steps, times --steps steps, then traces the
same number of steps with torch.profiler.  Prints steps/s (untraced),
the device busy share (summed kernel time over wall time), kernel
launches per step and the CUDA kernels by total time, then one JSON
line with the same numbers.  The Chrome trace goes to --out when given.
Needs a CUDA card.
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

from ddcmd_tpu_torch.models import load, martini_water  # noqa: E402
from ddcmd_tpu_torch.run.simulate import Simulation  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=6173)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--warm", type=int, default=1000)
    p.add_argument("--out", default=None,
                   help="directory for the Chrome trace (none if unset)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA device")
    with tempfile.TemporaryDirectory() as d:
        martini_water(d, n=args.n)
        db, base = load(d)
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    steps = args.steps + 1           # run() starts with one first_energy
    print(f"unprofiled: {steps} steps in {plain_wall:.4f} s = "
          f"{steps / plain_wall:.1f} steps/s; profiled: {wall:.4f} s, "
          f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e4 / wall:.1f}% "
          f"of profiled wall, {busy_us / 1e4 / plain_wall:.1f}% of "
          f"unprofiled wall; {len(kernels) / steps:.1f} kernel launches/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, c) in top:
        print(f"{t / steps:10.2f} us/step {c / steps:6.2f}/step  {name[:90]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    print(json.dumps({
        "steps_per_s": steps / plain_wall,
        "busy_share_profiled": busy_us / 1e6 / wall,
        "busy_share_unprofiled": busy_us / 1e6 / plain_wall,
        "launches_per_step": len(kernels) / steps,
        "top_us_per_step": {n[:60]: t / steps for n, (t, _) in top[:8]}}))


if __name__ == "__main__":
    main()
