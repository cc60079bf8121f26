"""Device time of the four EAM passes on the nc^3 copper crystal's slots,
for the sources as they are or with text substitutions of your own.

    python scripts/eam_kernel_variants.py [--nc 32] [--calls 20]
        [--sub FILE OLD NEW [--sub ...]]

Needs one CUDA card and nvcc.  Copies the package to a temporary
directory, applies each --sub to FILE under its csrc/ (an OLD text that
is not there stops the script), imports that copy, which builds its own
kernels, packs the crystal's slots as the main path does (131,072 atoms
at nc = 32: plan (11,12,12), cap 128, G = 4) and prints the mean device
time of the kernel (torch.profiler, `--calls` launches) of the per-cell
passes A / B (TPU #4, the body of #7) and the column passes A / B (#5).
Without --sub the kernels are also held against the plain PyTorch
version at chip_smoke.py's tolerances.  A substitution that takes work
away (no phase 2, plain adds for the atomics) leaves wrong sums: only its
times mean something, read beside a run without --sub in the same call.
"""

import argparse
import os
import shutil
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "ddcmd_tpu_torch"


def patched_copy(tmp, subs):
    """The package under tmp, csrc/FILE with OLD replaced by NEW."""
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(tmp, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in subs:
        path = os.path.join(tmp, PKG, "csrc", fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"{fname} does not hold {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))


def kernel_us(fn, calls):
    """Mean device time, us, of the EAM kernel one call of fn launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "eam_half" in e.key) / calls


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nc", type=int, default=32)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--sub", nargs=3, action="append", default=[],
                   metavar=("FILE", "OLD", "NEW"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("eam_kernel_variants: no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        patched_copy(tmp, args.sub)
        sys.path[:0] = [tmp, ROOT]          # the copy before the checkout
        import chip_smoke as cs
        from ddcmd_tpu_torch.ops import cellpair_half as ch
        from ddcmd_tpu_torch.ops import eam_half as eh

        assert ch.__file__.startswith(tmp), ch.__file__
        dev = torch.device("cuda:0")
        rho_k, _, slots, cargs, kw, tables, hg, G = cs.eam_sim_inputs(
            args.nc, dev)
        if rho_k is not eh.eam_rho_half_col:
            raise SystemExit(f"nc={args.nc} plans G={G}: the column kernels "
                             "need a plan with G > 1 (nc = 32)")
        pargs = (torch.as_tensor(ch.pack_stencil(hg), device=dev), *cargs[2:])
        ref_a = eh.eam_rho_half_plain(slots, *pargs, **kw)
        fslots = slots.clone()
        eh.embed_slots(fslots, *ref_a, tables)
        calls = (lambda: eh.eam_rho_half(slots, *pargs, **kw),
                 lambda: eh.eam_force_half(fslots, *pargs, **kw),
                 lambda: eh.eam_rho_half_col(slots, *cargs, **kw),
                 lambda: eh.eam_force_half_col(fslots, *cargs, **kw))
        t = [kernel_us(fn, args.calls) for fn in calls]
        note = f"{len(args.sub)} substitutions, sums not checked"
        if not args.sub:
            ref = cs.eam_sums(ref_a, eh.eam_force_half_plain(fslots, *pargs,
                                                             **kw))
            cs.eam_agree("per-cell vs plain",
                         cs.eam_sums(calls[0](), calls[1]()), ref)
            cs.eam_agree("column vs plain",
                         cs.eam_sums(calls[2](), calls[3]()), ref)
            note = "as built, agrees with the plain version"
        print(f"eam_crystal nc={args.nc}: {hg.ncell} cells {hg.ncells} cap "
              f"{hg.cap}, G={G}, U={cargs[0].shape[1]}, on {cs.card_line()}; "
              f"device us per launch: per-cell A / B {t[0]:.1f} / {t[1]:.1f}, "
              f"column A / B {t[2]:.1f} / {t[3]:.1f} ({note})", flush=True)


if __name__ == "__main__":
    main()
