"""Slice 18, items 27 and 28: terms across non-periodic walls.

Item 27, EAM with non-periodic axes on the plain cell-block EAM engine
(ops/cellpair_eam.py with the pbc stencil mask): the engine and
Simulation (auto and "cellblock") against a direct O(N^2) sum over every
pair and periodic image in f64 on decks of 1 and 2 cells an axis (a
slab, a rod, a cluster), and against the JAX package's
Simulation(engine="nlist") in f64 on a slab of 3 list cells on z (the
JAX list masks its stencil right there; its cell-block EAM engine takes
images through the walls and is no reference,
tests/test_torch_cellblock_eam.py).

Item 28, the (N,K) list on a non-periodic axis of fewer than 3 cells:
the list and eam_eval against the direct sum on 1- and 2-cell axes;
the 500-atom LJ slab (2 list cells on z) on engine "nlist" against the
JAX cell-block pair engine, which masks by the pbc bits; and every list
term (EAM, PAIR, PAIRENERGY, ORDERSH) on a thin non-periodic axis
against the JAX list on the same deck with vacuum added on that axis
until it has 3 or more list cells (a non-periodic axis does not feel
added vacuum, and there the JAX list is right).

Tolerances: f64, forces 1e-8 of the force scale, energy rel 1e-10,
virial 1e-8 of its largest entry, per-particle energy 1e-8 of its
largest."""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.nbr import celllist as tcl
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_eam as tce
from ddcmd_tpu_torch.potentials import eam as team
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
from test_torch_eam import _fcc, _parms

torch.set_num_threads(2)

F_REL, E_REL = 1e-8, 1e-10


# ---------------------------------------------------------------------------
# the direct sums
# ---------------------------------------------------------------------------

def _images(L, pbc):
    """Image shifts (S, 3): -1, 0, +1 boxes on each periodic axis, none on
    a non-periodic one (every image within the cutoff when rcut < L)."""
    ax = [(-1, 0, 1) if (pbc >> a) & 1 else (0,) for a in range(3)]
    return torch.tensor([(i, j, k) for i in ax[0] for j in ax[1]
                         for k in ax[2]], dtype=torch.float64) \
        * torch.as_tensor(np.asarray(L, np.float64))


def direct_eam(r, sidx, L, pbc, tables):
    """EAM by an O(N^2) f64 sum over every ordered pair and image within
    the cutoff: (f, e, virial, pe), forces and virial by autograd (the
    virial -sum dE/dd (x) d over the pair displacements d)."""
    r = torch.as_tensor(np.asarray(r), dtype=torch.float64)
    sidx = torch.as_tensor(np.asarray(sidx), dtype=torch.int64)
    n = len(r)
    S = _images(L, pbc)
    d2 = ((r[:, None, None, :] - r[None, :, None, :] - S) ** 2).sum(-1)
    i, j, s = torch.nonzero((d2 < tables["rcut2"]) & (d2 > 0),
                            as_tuple=True)
    rg = r.clone().requires_grad_(True)
    d = rg[i] - rg[j] - S[s]
    r2 = (d * d).sum(-1)
    ir2 = 1.0 / r2
    T = tables["n_species"]
    phi, rho = team._pair_eval(tables["form"], tables["pair"],
                               sidx[i] * T + sidx[j], r2, torch.sqrt(ir2),
                               ir2, False)
    rho_i = torch.zeros(n, dtype=torch.float64).index_add(0, i, rho)
    F, _ = team._embedding(tables["form"], tables["embed"], sidx, rho_i)
    pe = F + 0.5 * torch.zeros(n, dtype=torch.float64).index_add(0, i, phi)
    e = pe.sum()
    gr, gd = torch.autograd.grad(e, (rg, d))
    return (-gr.numpy(), float(e.detach()), -(gd.T @ d).detach().numpy(),
            pe.detach().numpy())


def assert_matches(got, ref):
    """(f, e, virial, pe) against a reference at the module's
    tolerances."""
    f, e, v, pe = (np.asarray(x, np.float64) for x in got)
    rf, re_, rv, rpe = (np.asarray(x, np.float64) for x in ref)
    scale = np.abs(rf).max()
    assert scale > 0
    assert np.abs(f - rf).max() <= F_REL * scale
    assert float(e) == pytest.approx(float(re_), rel=E_REL)
    assert np.abs(v - rv).max() <= F_REL * np.abs(rv).max()
    if rpe is not None and rpe.ndim:
        assert np.abs(pe - rpe).max() <= F_REL * np.abs(rpe).max()


def _slab(nside, lz_cells, seed=3):
    """A jittered fcc crystal of nside^3 cells, a = 0.3615 nm, in a box of
    nside cells on x and y and lz_cells cells on z (vacuum beyond the
    crystal when lz_cells > nside)."""
    r, L = _fcc(0.3615, nside)
    r = r + np.random.default_rng(seed).standard_normal(r.shape) * 0.006
    return r, np.array([L, L, 0.3615 * lz_cells])


# ---------------------------------------------------------------------------
# item 27: the cell-block EAM engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nside,lz,pbc", [
    (3, 3, 3),      # 1 cell an axis, z open: both surfaces in one cell
    (4, 4, 3),      # 2 cells an axis: the +1 reach on z wraps and is cut
    (4, 6, 3),      # a slab with vacuum on z
    (4, 4, 1),      # a rod: y and z open
    (3, 3, 0),      # a cluster
])
def test_cellblock_eam_walls_match_direct_sum(nside, lz, pbc):
    """eam_cellblock_eval_half with pbc_allowed == the direct sum in f64
    (RATIONAL, the crystal's form): no block across a wall adds density
    or force to either side."""
    r, L = _slab(nside, lz)
    n = len(r)
    p = _parms("torch", "RATIONAL", 1)
    tables = team.eam_device_tables(p, dtype=torch.float64)
    grid = tcp.CellBlockGrid.plan(L, 0.55, 0.1, n)
    hg = tcp.half_grid(grid)
    rt = torch.as_tensor(r, dtype=torch.float64)
    Lt = torch.as_tensor(L, dtype=torch.float64)
    perm, ov = tcp.build_cell_slots(rt, torch.ones(n, dtype=torch.float64),
                                    Lt, grid)
    assert not bool(ov)
    sidx = torch.zeros(n, dtype=torch.int64)
    got = tce.eam_cellblock_eval_half(
        rt, sidx, torch.ones(n, dtype=torch.float64), perm, Lt, hg, tables,
        tcp.half_back_map(hg), tcp.pbc_allowed(hg, pbc))
    assert_matches(got, direct_eam(r, sidx, L, pbc, tables))


def test_eam_slab_matches_jax_nlist(tmp_path):
    """Simulation under auto (the cell-block EAM engine) on the 864-atom
    crystal with pbc = 3 (3 list cells on z) == the JAX package's
    Simulation(engine="nlist") in f64: first energy, forces, virial."""
    d = str(tmp_path)
    p = chip_smoke.eam_deck(d, 6, 5)
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(text.replace("pbc=7", "pbc=3"))
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64,
                     engine="nlist")
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    assert ts.engine == "cellblock" and js.engine == "nlist"
    js.first_energy()
    ts.first_energy()
    n = ts.sysdef.state.n_local
    assert_matches(
        (ts.ss.state.f[:n], ts.ss.energy.eion, ts.ss.energy.virial, None),
        (np.asarray(js.ss.state.f[:n]), float(js.ss.energy.eion),
         np.asarray(js.ss.energy.virial), None))


# ---------------------------------------------------------------------------
# item 28: the list on thin non-periodic axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lz", [2, 3, 4])
def test_list_eam_thin_axis_matches_direct_sum(lz):
    """build_neighbor_list and eam_eval with the pbc mask on a slab of
    lz fcc cells on a non-periodic z (1 list cell at lz = 2 and 3, 2 at
    4; 2 cells on x and y) == the direct sum in f64; every row's
    partners are exactly the direct sum's within rlist, and the masked
    displacements and skin test take no image on z."""
    r, L = _slab(4, lz)
    r = r[np.abs(r[:, 2]) < 0.5 * L[2]]       # the film inside the walls
    n = len(r)
    p = _parms("torch", "RATIONAL", 1)
    tables = team.eam_device_tables(p, dtype=torch.float64)
    grid = tcl.CellGrid.plan(L, 0.55, 0.1, n, n)
    assert grid.ncells[2] == (1 if lz < 4 else 2)
    rt = torch.as_tensor(r, dtype=torch.float64)
    Lt = torch.as_tensor(L, dtype=torch.float64)
    nbr, cnt, ov = tcl.build_neighbor_list(
        rt, torch.ones(n, dtype=torch.float64), Lt, grid, pbc=3)
    assert not bool(ov)
    S = _images(L, 3)
    d2 = ((rt[:, None, None, :] - rt[None, :, None, :] - S) ** 2).sum(-1)
    want = ((d2 < grid.rlist ** 2) & (d2 > 0)).any(-1)
    got = torch.zeros((n, n + 1), dtype=torch.bool)
    got[torch.arange(n)[:, None], nbr] = True
    assert torch.equal(got[:, :n], want)
    assert torch.equal(cnt.long(), want.sum(1))
    sidx = torch.zeros(n, dtype=torch.int64)
    ones = torch.ones(n, dtype=torch.float64)
    mask = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64)
    out = team.eam_eval(rt, sidx, ones, nbr, Lt, tables, mask)
    assert_matches(out, direct_eam(r, sidx, L, 3, tables))
    # the displacements and the skin test keep z whole
    dr, valid = tcl.neighbor_displacements(rt, nbr, Lt, mask)
    assert ((dr * dr).sum(-1)[valid] < grid.rlist ** 2).all()
    step = torch.tensor([0.0, 0.0, 0.6 * L[2]], dtype=torch.float64)
    assert float(tcl.max_displacement2(rt + step, rt, ones, Lt, mask)) \
        == pytest.approx(float(step[2]) ** 2, rel=1e-12)
    assert float(tcl.max_displacement2(rt + step, rt, ones, Lt)) \
        == pytest.approx((0.4 * L[2]) ** 2, rel=1e-12)


def test_list_slab_matches_jax_cellblock(tmp_path):
    """The 500-atom LJ slab (pbc = 3, REFLECT walls, 2 list cells on z)
    on engine "nlist" == the JAX package's Simulation(engine="cellblock"),
    whose pair engine masks its stencil by the pbc bits, in f64."""
    d = str(tmp_path)
    chip_smoke.lj_deck(d, 500, 5, edit=chip_smoke.slab_edit)
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64,
                     engine="cellblock")
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64, engine="nlist")
    assert ts.grid.ncells[2] == 2
    js.first_energy()
    ts.first_energy()
    n = ts.sysdef.state.n_local
    assert_matches(
        (ts.ss.state.f[:n], ts.ss.energy.eion, ts.ss.energy.virial,
         ts.ss.state.pe[:n]),
        (np.asarray(js.ss.state.f[:n]), float(js.ss.energy.eion),
         np.asarray(js.ss.energy.virial), np.asarray(js.ss.state.pe[:n])))


def _pbc3(text):
    return text.replace("pbc=7", "pbc=3")


THIN_DECKS = {
    # the 256-atom crystals (2 list cells on each axis) and the LJ slab
    "eam": lambda d: chip_smoke.eam_deck(d, 4, 5),
    "ordersh": lambda d: chip_smoke.ordersh_eam_deck(d, 4, 5),
    "pairenergy": lambda d: chip_smoke.pairenergy_deck(d, 4, 5),
    "pair": lambda d: chip_smoke.lj_deck(d, 500, 5,
                                         edit=chip_smoke.slab_edit),
}


@pytest.mark.parametrize("kind", list(THIN_DECKS))
def test_list_terms_thin_axis_match_padded_box(tmp_path, kind):
    """Every list term on a non-periodic z of 2 list cells (engine
    "nlist", f64) == the JAX list on the same deck with z doubled (4
    cells or more): energy, forces and virial."""
    d, dp = str(tmp_path / "thin"), str(tmp_path / "padded")
    for x, edit in ((d, _pbc3), (dp, chip_smoke.pad_z(2.0))):
        os.makedirs(x)
        chip_smoke.edit_deck(THIN_DECKS[kind](x), edit)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JSimulation(*j_load(dp), run_dir=dp, dtype=jnp.float64,
                         engine="nlist")
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64, engine="nlist")
    assert ts.sysdef.box.pbc == js.sysdef.box.pbc == 3
    assert ts.grid.ncells[2] == 2 and js.grid.ncells[2] >= 4
    js.first_energy()
    ts.first_energy()
    n = ts.sysdef.state.n_local
    assert_matches(
        (ts.ss.state.f[:n], ts.ss.energy.eion, ts.ss.energy.virial, None),
        (np.asarray(js.ss.state.f[:n]), float(js.ss.energy.eion),
         np.asarray(js.ss.energy.virial), None))
