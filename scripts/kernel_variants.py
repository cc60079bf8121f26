"""Device time of the sweep kernels on a main path's slots, for the
sources as they are or with text substitutions of your own.

    python scripts/kernel_variants.py [--family eam|pair|full] [--nc 32]
        [--calls 20] [--sub FILE OLD NEW [--sub ...]]

Needs one CUDA card and nvcc.  Copies the package to a temporary
directory, applies each --sub to FILE under its csrc/ (an OLD text that
is not there stops the script), imports that copy, which builds its own
kernels, packs the slots as the main path does and prints the mean device
time of the kernel (torch.profiler, `--calls` launches; chip_smoke.py's
device_us):

  eam   the nc^3 copper crystal (131,072 atoms at nc = 32: plan
        (11,12,12), cap 128, G = 4): the per-cell passes A / B (TPU #4,
        the body of #7) and the column passes A / B (#5);
  pair  the 100,296-bead DPPC bilayer's start state (plan (15,16,5), cap
        128, G = 5, U = 25, T = 5, reaction field, exclusions): the
        per-cell kernel (TPU #1, the body of #6) and the column kernel
        (#2) on the same slots; then #1 on the 2,888-bead bilayer's (36
        cells, exclusions) and on the 6,173-bead water box's (80 cells,
        T = 1) start slots.
  full  the full-stencil kernel (TPU #3) on the full bilayer's start
        slots (plan (15,16,5), cap 128, T = 5, reaction field) and on the
        water box's (80 cells, T = 1), each beside #1 on the same records
        (with the main path's exclusions on the bilayer, and without, the
        same function as #3); also #3's time by CUDA events and that of
        one call of its entry point cellpair_eval_full on each state.

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


def eam_family(cs, args, dev, checked):
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh

    rho_k, _, slots, cargs, kw, tables, hg, G = cs.eam_sim_inputs(args.nc,
                                                                  dev)
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
    t = [cs.device_us(fn, args.calls, "eam_half") for fn in calls]
    if checked:
        ref = cs.eam_sums(ref_a, eh.eam_force_half_plain(fslots, *pargs,
                                                         **kw))
        cs.eam_agree("per-cell vs plain",
                     cs.eam_sums(calls[0](), calls[1]()), ref)
        cs.eam_agree("column vs plain",
                     cs.eam_sums(calls[2](), calls[3]()), ref)
    return (f"eam_crystal nc={args.nc}: {hg.ncell} cells {hg.ncells} cap "
            f"{hg.cap}, G={G}, U={cargs[0].shape[1]}; device us per launch: "
            f"per-cell A / B {t[0]:.1f} / {t[1]:.1f}, column A / B "
            f"{t[2]:.1f} / {t[3]:.1f}")


def pair_family(cs, args, dev, checked):
    from ddcmd_tpu_torch.ops import cellpair_half as ch

    def start_call(make_deck):
        """The pair call the main path makes on a deck's start state."""
        return cs.sim_kernel_inputs(cs.start_sim(make_deck, dev))

    kernel, a, kw, hg = start_call(lambda d: cs.bilayer_deck(
        d, cs.BILAYER_NX, cs.EQ_DT, 200))
    if kernel is not ch.cellpair_half_col:
        raise SystemExit("the bilayer's plan did not take the column kernel")
    cell_args = (a[0], torch.as_tensor(ch.pack_stencil(hg), device=dev),
                 *a[3:])
    small = start_call(lambda d: cs.bilayer_deck(d, cs.SMALL_NX, 20.0, 200))
    water = start_call(lambda d: cs.water_deck(d, 6173, 100))
    calls = (lambda: ch.cellpair_half(*cell_args, **kw),
             lambda: ch.cellpair_half_col(*a, **kw),
             lambda: ch.cellpair_half(*small[1], **small[2]),
             lambda: ch.cellpair_half(*water[1], **water[2]))
    t = [cs.device_us(fn, args.calls, "cellpair_half") for fn in calls]
    if checked:
        ref = cs.per_slot(*ch.cellpair_half_col_plain(*a, **kw))
        cs.agree("per-cell vs plain", cs.per_slot(*calls[0]()), ref)
        cs.agree("column vs plain", cs.per_slot(*calls[1]()), ref)
        for name, (_, sa, skw, _), fn in (("small bilayer", small, calls[2]),
                                          ("water", water, calls[3])):
            cs.agree(f"{name} vs plain", cs.per_slot(*fn()),
                     cs.per_slot(*ch.cellpair_half_plain(*sa, **skw)))
    return (f"bilayer nx={cs.BILAYER_NX}: {hg.ncell} cells {hg.ncells} cap "
            f"{hg.cap}, G={a[2].shape[0]}, U={a[1].shape[1]}, "
            f"T={a[-1].shape[0]}, excl={kw['excl']}; device us per launch: "
            f"per-cell {t[0]:.1f}, column {t[1]:.1f}; per-cell on the nx="
            f"{cs.SMALL_NX} bilayer ({small[3].ncell} cells, exclusions) "
            f"{t[2]:.1f}, on the water box ({water[3].ncell} cells) "
            f"{t[3]:.1f}")


def full_family(cs, args, dev, checked):
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch

    out = []
    for name, make_deck in reversed(cs.ENTRY_DECKS):
        sim = cs.start_sim(make_deck, dev)
        _, a, kw, _ = cs.sim_kernel_inputs(sim)
        fa, fkw, ha = cs.full_call(sim.grid, a, kw, dev)
        hkw = {k: v for k, v in fkw.items() if k != "s_self"}
        calls = [lambda: cf.cellpair_full(*fa, **fkw),
                 lambda: ch.cellpair_half(*ha, **hkw)]
        if kw["excl"]:      # the main path's call: #1 with exclusions
            calls.append(lambda: ch.cellpair_half(*ha, **kw))
        t = [cs.device_us(calls[0], args.calls, "cellpair_full_kernel")]
        t += [cs.device_us(fn, args.calls, "cellpair_half_kernel")
              for fn in calls[1:]]
        ev = 1e3 * cs.time_calls(calls[0], args.calls)
        if checked:
            cs.agree(f"{name}: #3 vs plain", cs.per_slot(*calls[0]()),
                     cs.per_slot(*cf.cellpair_full_plain(*fa, **fkw)))
            cs.agree(f"{name}: #3 vs #1", cs.per_slot(*calls[0]()),
                     cs.per_slot(*calls[1]()))
        del a, fa, ha, calls
        full, _, what = cs.entry_calls(sim, dev)
        entry = 1e3 * cs.time_calls(full, args.calls)
        del sim, full
        excl = (f", #1 with the main path's exclusions {t[2]:.1f}"
                if len(t) > 2 else "")
        out.append(f"{name} ({what}): device us per launch: #3 {t[0]:.1f} "
                   f"(events {ev:.1f}), #1 on the same records {t[1]:.1f}"
                   f"{excl}; #3 / #1 {t[0] / t[1]:.2f}; one "
                   f"cellpair_eval_full call {entry:.1f} us (events)")
    return "; ".join(out)


FAMILIES = {"eam": eam_family, "pair": pair_family, "full": full_family}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", choices=sorted(FAMILIES), default="eam")
    p.add_argument("--nc", type=int, default=32)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--sub", nargs=3, action="append", default=[],
                   metavar=("FILE", "OLD", "NEW"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        patched_copy(tmp, args.sub)
        sys.path[:0] = [tmp, ROOT]          # the copy before the checkout
        import chip_smoke as cs
        from ddcmd_tpu_torch.ops import cellpair_half as ch

        assert ch.__file__.startswith(tmp), ch.__file__
        dev = torch.device("cuda:0")
        text = FAMILIES[args.family](cs, args, dev, checked=not args.sub)
        note = (f"{len(args.sub)} substitutions, sums not checked"
                if args.sub else "as built, agrees with the plain version")
        print(f"{text} ({note}) on {cs.card_line()}", flush=True)


if __name__ == "__main__":
    main()
