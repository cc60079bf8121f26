"""The seam between the port's CUDA sources and their ctypes wrappers,
checked without a compiler: every extern "C" prototype in csrc/*.cu
against the argument kinds the wrappers bind, and the shared-memory
counts the column plan is fitted with against the sources' constants."""

import ctypes
import glob
import os
import re

import pytest

from ddcmd_tpu_torch.ops import cellpair_full as tcf
from ddcmd_tpu_torch.ops import cellpair_half as tch
from ddcmd_tpu_torch.ops import eam_half as teh

CSRC = os.path.join(os.path.dirname(os.path.abspath(tch.__file__)), os.pardir,
                    "csrc")
_PROTO = re.compile(r'extern\s+"C"\s+int\s+ddcmd_(\w+)\s*\(([^)]*)\)', re.S)


def _prototypes():
    """{entry point: [ctypes kind of each argument]} of csrc/*.cu."""
    out = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        with open(path) as f:
            for name, args in _PROTO.findall(f.read()):
                kinds = []
                for a in args.split(","):
                    a = " ".join(a.split())
                    if "*" in a:
                        kinds.append(ctypes.c_void_p)
                    elif a.startswith("int "):
                        kinds.append(ctypes.c_int)
                    elif a.startswith("float "):
                        kinds.append(ctypes.c_float)
                    else:
                        raise AssertionError(f"{name}: argument {a!r}")
                out[name] = kinds
    return out


def test_every_entry_point_is_bound():
    assert sorted(_prototypes()) == sorted(tch._ARGTYPES)
    assert len(tch._ARGTYPES) == 8


@pytest.mark.parametrize("name", sorted(tch._ARGTYPES))
def test_argtypes_match_prototype(name):
    """Argument count and pointer / int / float kinds: a pointer bound as
    an int would be cut to 32 bits."""
    assert tch._ARGTYPES[name] == _prototypes()[name]


def _constant(source, name):
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, (source, name)
    return int(m.group(1))


def _sweep_layout_bytes(cap, nd, nblk, ntab, nx, acc, threads, queue):
    """csrc/sweep.cuh:make_layout, written once more: the order of its
    regions and the bytes of each, for a CTA of `threads` with hit rings
    of `queue` entries."""
    warps = threads // 32
    o = cap * 16                                   # p4
    o += nd * cap * 16                             # q4
    o += nx * cap * 4                              # px
    o += nd * nx * cap * 4                         # qx
    o += acc * cap * 4                             # ap
    o += nblk * acc * cap * 4                      # aq
    o += nd * cap * 4                              # plist
    o += ntab * 4                                  # tab
    o += warps * queue * 4                         # hit rings
    o += (8 * nd + nblk + 4) * 4                   # integer tables
    return o


def _layout_bytes(cap, nd, nblk, ntab, force, threads):
    """csrc/eam_sweep.cuh:make_layout (dF as the one extra row in pass B,
    2 or 3 accumulator rows) on the sweep layout."""
    return _sweep_layout_bytes(cap, nd, nblk, ntab, 1 if force else 0,
                               3 if force else 2, threads,
                               _constant("sweep.cuh", "kQueue"))


@pytest.mark.parametrize("U,cap,T,form,degree", [
    (29, 128, 1, "RATIONAL", 4),      # the nc = 32 crystal's plan
    (27, 128, 2, "FS", 0),            # an alloy on an nz == G union
    (25, 256, 4, "AT", 0),
    (8, 512, 1, "SC", 0),             # a wide cap
])
@pytest.mark.parametrize("force", [False, True])
def test_eam_smem_counts_mirror_the_sources(U, cap, T, form, degree, force):
    npar = teh.n_params(form, degree)
    with open(os.path.join(CSRC, "eam_half_col.cu")) as f:
        col = f.read()
    for name, mirror in (("kColDirs", teh.EAM_COL_DIRS),
                         ("kThreads", teh.EAM_COL_THREADS)):
        m = re.search(rf"{name} = kForce \? (\d+) : (\d+);", col)
        assert mirror == {True: int(m.group(1)), False: int(m.group(2))}, name
    nd = teh.EAM_COL_DIRS[force]
    assert (teh.EAM_CELL_THREADS, teh.EAM_QUEUE) == (
        _constant("eam_half.cu", "kThreads"),
        _constant("sweep.cuh", "kQueue"))
    assert teh.eam_col_smem_bytes(U, cap, T, npar, force) == \
        _layout_bytes(cap, nd, U, T * T * npar, force,
                      teh.EAM_COL_THREADS[force])
    assert teh.eam_cell_smem_bytes(cap, T, npar, force) == \
        _layout_bytes(cap, 1, 1, T * T * npar, force, teh.EAM_CELL_THREADS)
    # the column launch sizes its shared memory with make_layout on the
    # same (cap, kColDirs, U, T*T*npar) the wrapper's count takes
    with open(os.path.join(CSRC, "eam_half_col.cu")) as f:
        assert re.search(r"make_layout\(cap, kColDirs<kForce>, U, "
                         r"T \* T \* npar,\s+kForce,\s+kThreads<kForce> / 32\)"
                         r"\s*\.bytes", f.read())
    assert teh.eam_col_smem_bytes(U, cap, T, npar, force) <= tch.SMEM_LIMIT
    assert _constant("sweep.cuh", "kSmemMax") == tch.SMEM_LIMIT


# (cap, T, excl, bytes of one direction, directions the launch stages at
# its 32 KB budget): the full bilayer (T = 5, exclusions), the water box
# (T = 1), a replanned cap, the widest cap
PAIR_LAYOUTS = [(128, 5, True, 13_152, 4), (128, 1, False, 10_816, 5),
                (384, 5, False, 30_560, 1), (1024, 5, True, 95_584, 1)]


@pytest.mark.parametrize("cap,T,excl,one_dir,fit", PAIR_LAYOUTS)
def test_pair_smem_counts_mirror_the_layout(cap, T, excl, one_dir, fit):
    """The pair kernel's shared-memory counts (ops/cellpair_half.py, which
    the plan's fit_col_group and the wrappers use) against the sweep
    layout written once more above: charge (and with exclusions two
    channels more) as the extra rows, 4 accumulator rows, the (T, T)
    sigma / eps / shift tables, PAIR_CELL_THREADS a CTA (the column
    launch is the same CTA over the column tables).  At the bilayer's and
    the water box's shapes the launch stages 4 and 5 directions within
    its 32 KB budget."""
    nx = 3 if excl else 1

    def layout(nd):
        return _sweep_layout_bytes(cap, nd, nd, 3 * T * T, nx, 4,
                                   tch.PAIR_CELL_THREADS, tch.SWEEP_QUEUE)

    assert tch.cell_smem_bytes(cap, T, excl) == one_dir == layout(1)
    assert tch.sweep_smem_bytes(cap, 3, 5, 7, 2, 4, 128) == \
        _sweep_layout_bytes(cap, 3, 5, 7, 2, 4, 128, tch.SWEEP_QUEUE)
    budget = 32 * 1024
    assert layout(fit) <= budget or fit == 1
    assert layout(fit + 1) > budget


# (cap, T, bytes of one direction, directions the launch stages at its
# 32 KB budget) of the full-stencil kernel: no q-side blocks
FULL_LAYOUTS = [(32, 1, 3_004, 27), (32, 5, 3_292, 27),
                (128, 1, 8_764, 8), (128, 5, 9_052, 8),
                (256, 1, 16_444, 3), (256, 5, 16_732, 3)]


@pytest.mark.parametrize("cap,T,one_dir,fit", FULL_LAYOUTS)
def test_full_smem_counts_mirror_the_layout(cap, T, one_dir, fit):
    """The full-stencil kernel's shared-memory count (ops/cellpair_full.py,
    which its wrapper checks) against the sweep layout written once more
    above with no q-side accumulator blocks (nblk = 0): the charge as the
    one extra row, 4 accumulator rows, the (T, T) tables, PAIR_CELL_THREADS
    a CTA.  The launch stages `fit` of the 27 directions within its 32 KB
    budget; the source sizes the layout with nblk = 0."""
    def layout(nd):
        return _sweep_layout_bytes(cap, nd, 0, 3 * T * T, 1, 4,
                                   tch.PAIR_CELL_THREADS, tch.SWEEP_QUEUE)

    assert tcf.full_smem_bytes(cap, T) == one_dir == layout(1)
    budget = 32 * 1024
    assert layout(fit) <= budget
    assert fit == 27 or layout(fit + 1) > budget
    with open(os.path.join(CSRC, "cellpair_half.cu")) as f:
        assert re.search(r"make_layout\(cap, nd, kFull \? 0 : nd, T, kExcl,",
                         f.read())


def test_no_wrapper_caps_the_cell_count():
    """The cell rides blockIdx.x in every per-cell source, and no wrapper
    refuses a plan for its cell count."""
    for mod in (tch, teh):
        with open(mod.__file__) as f:
            text = f.read()
        assert "65535" not in text and "65,535" not in text, mod.__name__
    for source in ("cellpair_half.cu", "eam_half.cu"):
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
        assert re.search(r"const int c = blockIdx\.x;", text), source
        assert re.search(r"const dim3 grid\(ncell, \w+\);", text), source


def test_headers_rebuild_their_sources():
    """Every header a source includes is in KERNEL_HEADERS, so editing it
    rebuilds the libraries."""
    listed = {os.path.basename(h) for h in tch.KERNEL_HEADERS}
    included = set()
    for path in glob.glob(os.path.join(CSRC, "*.cu*")):
        with open(path) as f:
            included |= set(re.findall(r'#include "(\w+\.cuh)"', f.read()))
    assert included == listed
    for h in tch.KERNEL_HEADERS:
        assert os.path.exists(h), h
