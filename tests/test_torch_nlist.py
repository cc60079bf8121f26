"""Slice 12, the (N,K)-list engine against the JAX package: CellGrid.plan,
build_neighbor_list in float64 (rows element by element, counts, the
overflow flag) on orthorhombic and triclinic boxes, pbc = 3 with 3 or
more cells on z, 2-cell periodic axes and an overflowing plan; the
port's list where the JAX list is wrong (a non-periodic axis of 1 or 2
cells: no pair through the wall), beside the JAX list's through-wall
and asymmetric pairs; the engine choice; the slice: Simulation(engine="nlist") on small decks of
configurations (A) (EAM + ORDERSH) and (B) (the TableFunction fluid), a
PAIRENERGY deck, a bilayer with a widened exclusion graph and an EAM
crystal with pbc = 3 against
JAX's Simulation(engine="nlist"); under the mesh, the refusal of ORDERSH
and PAIRENERGY (item 25; the JAX mesh drops ORDERSH beside EAM) and the
table and widened decks on the brick list engine.

Tolerances: the lists bit for bit; the f64 slice's first energy rel
1e-10, forces 1e-9 of the force scale, virial rel 1e-9 (abs 1e-9 of its
scale); 10 port steps finite.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.nbr import celllist as jcl
from ddcmd_tpu.run import simulate as jsim
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.nbr import celllist as tcl
from ddcmd_tpu_torch.run import simulate as tsim
from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

torch.set_num_threads(2)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


# jitted: one compile a case instead of the eager ops' many
_jax_list = jax.jit(jcl.build_neighbor_list, static_argnames=("grid", "pbc"))


# ---------------------------------------------------------------------------
# the plan and the list
# ---------------------------------------------------------------------------

PLAN_CASES = [
    dict(box_lengths=[2.3, 2.1, 2.6], rcut=0.45, skin=0.1, n_particles=600,
         n_pad=640),
    dict(box_lengths=[11.568] * 3, rcut=0.55, skin=0.1, n_particles=131072,
         n_pad=131072),
    dict(box_lengths=[18.47] * 3, rcut=0.85, skin=0.12, n_particles=131072,
         n_pad=131072, density_safety=1.3, plan_margin=1.08),
    dict(box_lengths=[3.0, 3.0, 1.2], rcut=0.4, skin=0.15, n_particles=50,
         n_pad=128, max_neighbors=64),
    "positions",
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_cellgrid_plan_equals_jax(case):
    """CellGrid.plan (host numpy, copied) equals JAX's: mean-density
    plans, a plan margin and density safety, a given K, and the
    measured-occupancy branch on a clustered state."""
    kw = PLAN_CASES[case]
    if kw == "positions":
        rng = np.random.default_rng(1)
        pos = np.concatenate([rng.normal(0.0, 0.3, (300, 3)),
                              rng.uniform(-1.5, 1.5, (100, 3))])
        kw = dict(box_lengths=[3.0] * 3, rcut=0.5, skin=0.1,
                  n_particles=400, n_pad=512, positions=pos,
                  occupancy_factor=1.2)
    j, t = jcl.CellGrid.plan(**kw), tcl.CellGrid.plan(**kw)
    assert vars(t) == vars(j)


def _monoclinic(L, tilt):
    h = np.diag(np.asarray(L, np.float64))
    h[0, 1] = tilt * L[1]
    h[0, 2] = 0.5 * tilt * L[2]
    return h


def _random_state(n, geom, seed):
    rng = np.random.default_rng(seed)
    geom = np.asarray(geom, np.float64)
    s = rng.random((n, 3)) - 0.5
    r = s * geom if geom.ndim == 1 else s @ geom.T
    fmask = (rng.random(n) > 0.08).astype(np.float64)
    return r, fmask


LIST_CASES = {
    # name: (geom, rlist, pbc, grid overrides)
    "ortho": ([2.3, 2.1, 2.6], 0.55, 7, {}),
    "triclinic": (_monoclinic([2.4, 2.2, 2.5], 0.2), 0.5, 7, {}),
    "pbc3": ([2.3, 2.1, 2.0], 0.6, 3, {}),
    "two-cell": ([1.3, 1.2, 0.9], 0.55, 7, {}),
    "overflow": ([2.3, 2.1, 2.6], 0.55, 7,
                 dict(cell_capacity=8, max_neighbors=16)),
}


@pytest.mark.parametrize("name,rows", [(k, "fmask") for k in LIST_CASES]
                         + [("ortho", "row_mask")])
def test_neighbor_list_equals_jax(name, rows):
    """build_neighbor_list == JAX's in f64, bit for bit: the (N,K) rows
    (stencil order, then cell slot), the counts and the overflow flag,
    on an orthorhombic box, a monoclinic one (fractional binning,
    perpendicular-span plan), pbc = 3 with 3 cells on z (the reaches
    through the z wall dropped), 2- and 1-cell periodic axes, and a plan
    whose cells and rows overflow; with masked particles, and with a
    row mask narrower than the binned set."""
    geom, rlist, pbc, over = LIST_CASES[name]
    geom = np.asarray(geom, np.float64)
    span = geom if geom.ndim == 1 else np.asarray(
        [abs(np.linalg.det(geom)) / np.linalg.norm(np.cross(
            geom[:, (a + 1) % 3], geom[:, (a + 2) % 3])) for a in range(3)])
    r, fmask = _random_state(500, geom, seed=len(name))
    plan = dict(vars(tcl.CellGrid.plan(span, rlist, 0.0, 500, 500)), **over)
    tg, jg = tcl.CellGrid(**plan), jcl.CellGrid(**plan)
    if name == "pbc3":
        assert tg.ncells[2] >= 3
    row_mask = None
    if rows == "row_mask":
        row_mask = fmask * (np.arange(500) % 3 != 0)
    j = _jax_list(
        jnp.asarray(r), jnp.asarray(fmask), jnp.asarray(geom), grid=jg,
        row_mask=None if row_mask is None else jnp.asarray(row_mask),
        pbc=pbc)
    t = tcl.build_neighbor_list(
        _t(r), _t(fmask), _t(geom), tg,
        row_mask=None if row_mask is None else _t(row_mask), pbc=pbc)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    assert bool(t[2]) == bool(j[2]) == (name == "overflow")
    assert int(t[1].max()) > 0

    jd, jm = jcl.neighbor_displacements(jnp.asarray(r), j[0],
                                        jnp.asarray(geom))
    td, tm = tcl.neighbor_displacements(_t(r), t[0], _t(geom))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    r0 = r + np.random.default_rng(2).normal(0, 0.05, r.shape)
    assert float(tcl.max_displacement2(_t(r), _t(r0), _t(fmask), _t(geom))) \
        == pytest.approx(float(jcl.max_displacement2(
            jnp.asarray(r), jnp.asarray(r0), jnp.asarray(fmask),
            jnp.asarray(geom))), rel=1e-14)


@pytest.mark.parametrize("nz,Lz,z,jax_counts,counts", [
    # 0.2 nm apart inside the box, one in each cell: the +1 reach of cell
    # 1 wraps and the JAX list drops it, so only cell 0 sees the pair
    (2, 1.2, 0.1, [1, 0], [1, 1]),
    # one cell: 0.9 nm apart inside, the image 0.1 nm through the wall
    (1, 1.0, 0.45, [1, 1], [0, 0]),
    # 3 cells, 0.2 nm through the wall: both lists right
    (3, 2.0, 0.9, [0, 0], [0, 0]),
])
def test_nonperiodic_axis_of_few_cells(nz, Lz, z, jax_counts, counts):
    """Where the JAX list is wrong (ROADMAP item 28, the finding kept):
    two atoms at z = -+z on the non-periodic z of an L = (3, 3, Lz) box,
    rlist 0.55, pbc = 3.  With 2 cells on z the JAX list is asymmetric
    (counts [1, 0], Newton's third law fails), with 1 cell both atoms
    list each other through the wall.  The port's list keeps the pair
    inside the box from both sides and none through the wall; with 3
    cells it equals JAX's.  Two atoms 0.3 nm apart about z = 0 list each
    other once each on every axis length."""
    geom = np.array([3.0, 3.0, Lz])
    r = np.array([[0.0, 0.0, -z], [0.0, 0.0, z]])
    fm = np.ones(2)
    grid = dict(ncells=(5, 5, nz), cell_capacity=8, max_neighbors=8,
                rlist=0.55)
    j = _jax_list(jnp.asarray(r), jnp.asarray(fm), jnp.asarray(geom),
                  grid=jcl.CellGrid(**grid), pbc=3)
    assert np.asarray(j[1]).tolist() == jax_counts
    t = tcl.build_neighbor_list(_t(r), _t(fm), _t(geom),
                                tcl.CellGrid(**grid), pbc=3)
    assert t[1].tolist() == counts
    if nz >= 3:
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    inside = np.array([[0.0, 0.0, -0.15], [0.0, 0.0, 0.15]])
    t = tcl.build_neighbor_list(_t(inside), _t(fm), _t(geom),
                                tcl.CellGrid(**grid), pbc=3)
    assert t[1].tolist() == [1, 1]
    assert t[0][:, 0].tolist() == [1, 0]


# ---------------------------------------------------------------------------
# decks and the engine choice
# ---------------------------------------------------------------------------

def _deck(tmp_path, kind):
    d = str(tmp_path / kind)
    os.makedirs(d, exist_ok=True)
    if kind == "A":
        chip_smoke.ordersh_eam_deck(d, 4, 5)
    elif kind == "B":
        chip_smoke.table_lj_deck(d, 500, 5)
    elif kind == "pairenergy":
        chip_smoke.pairenergy_deck(d, 4, 5)
    elif kind == "bilayer":
        chip_smoke.bilayer_deck(d, 2, 5.0, 5)
    elif kind == "slab":
        chip_smoke.lj_deck(d, 500, 5, edit=chip_smoke.slab_edit)
    elif kind == "eam-pbc3":
        # 864 atoms, 3 list cells on the non-periodic z
        p = chip_smoke.eam_deck(d, 6, 5)
        with open(p) as f:
            text = f.read()
        with open(p, "w") as f:
            f.write(text.replace("pbc=7", "pbc=3"))
    return d


def test_engine_choice(tmp_path):
    """choose_engine: ORDERSH and PAIRENERGY decks go to "nlist" under
    auto and raise ValueError on an explicit cell engine; the table deck
    raises under auto and on the cell engines, naming engine="nlist";
    the widened bilayer goes to "nlist" under auto with the demotion
    warning and raises ValueError on "kernel"; "nlist" takes any deck,
    the 500-atom slab too (2 list cells on its non-periodic z), whose
    first energy in f64 there equals the cell-block engine's under auto
    (rel 1e-10)."""
    for kind in ("A", "pairenergy"):
        d = _deck(tmp_path, kind)
        assert tsim.Simulation(*t_load(d), run_dir=d,
                               device="cpu").engine == "nlist"
        for eng in ("kernel", "cellblock"):
            with pytest.raises(ValueError, match="nlist"):
                tsim.Simulation(*t_load(d), run_dir=d, device="cpu",
                                engine=eng)
    d = _deck(tmp_path, "B")
    for eng in ("auto", "kernel", "cellblock"):
        with pytest.raises(NotImplementedError,
                           match='TableFunction.*engine="nlist"'):
            tsim.Simulation(*t_load(d), run_dir=d, device="cpu", engine=eng)
    assert tsim.Simulation(*t_load(d), run_dir=d, device="cpu",
                           engine="nlist").engine == "nlist"
    d = _deck(tmp_path, "bilayer")
    with chip_smoke.widened(tsim):
        with pytest.warns(UserWarning, match="demoting kernel -> nlist"):
            assert tsim.Simulation(*t_load(d), run_dir=d,
                                   device="cpu").engine == "nlist"
        with pytest.raises(ValueError, match="exclusion component of 24"):
            tsim.Simulation(*t_load(d), run_dir=d, device="cpu",
                            engine="kernel")
    d = _deck(tmp_path, "slab")
    sims = [tsim.Simulation(*t_load(d), run_dir=d, device="cpu",
                            dtype=torch.float64, engine=eng)
            for eng in ("auto", "nlist")]
    assert [s.engine for s in sims] == ["cellblock", "nlist"]
    assert sims[1].grid.ncells[2] == 2
    e = [float(s.first_energy().energy.eion) for s in sims]
    assert e[1] == pytest.approx(e[0], rel=1e-10)


# ---------------------------------------------------------------------------
# the slice against JAX's Simulation(engine="nlist"), f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["A", "B", "pairenergy", "bilayer",
                                  "eam-pbc3"])
def test_slice_matches_jax_nlist(tmp_path, kind):
    """Simulation on the list engine in f64 == JAX's Simulation(engine=
    "nlist") on the same deck: first energy, forces and virial; then 10
    port steps stay finite.  (A) the 256-atom crystal with the ORDERSH
    bias (auto in both), (B) the 500-atom TableFunction fluid
    (engine="nlist"), the crystal with a PAIRENERGY series (auto), the
    nx = 2 bilayer with its exclusions widened past 12 members the same
    way in both (the port under auto, JAX's engine "nlist"), and an EAM
    crystal with pbc = 3 and 3 list cells on z (engine "nlist"; the
    cell-block EAM engine's turn is tests/test_torch_walls.py)."""
    d = _deck(tmp_path, kind)
    t_eng = "nlist" if kind in ("B", "eam-pbc3") else "auto"
    j_eng = "nlist" if kind in ("B", "bilayer", "eam-pbc3") else "auto"
    with chip_smoke.widened(*((tsim, jsim) if kind == "bilayer" else ())), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = jsim.Simulation(*j_load(d), run_dir=d, dtype=jnp.float64,
                             engine=j_eng)
        ts = tsim.Simulation(*t_load(d), run_dir=d, device="cpu",
                             dtype=torch.float64, engine=t_eng)
    assert js.engine == ts.engine == "nlist"
    js.first_energy()
    ts.first_energy()
    n = ts.sysdef.state.n_local
    jf = np.asarray(js.ss.state.f[:n])
    tf = ts.ss.state.f[:n].numpy()
    assert np.abs(jf).max() > 0
    assert np.abs(tf - jf).max() <= 1e-9 * np.abs(jf).max()
    assert float(ts.ss.energy.eion) == pytest.approx(
        float(js.ss.energy.eion), rel=1e-10)
    jv = np.asarray(js.ss.energy.virial)
    np.testing.assert_allclose(ts.ss.energy.virial.numpy(), jv, rtol=1e-9,
                               atol=1e-9 * np.abs(jv).max())
    ts.run(10, print_fn=lambda line: None)
    assert ts.ss.loop == ts.sysdef.cfg.loop + 10
    assert torch.isfinite(ts.ss.state.r).all()
    assert np.isfinite(float(ts.ss.energy.eion))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,what", [
    ("A", r"ORDERSH \(osh\) under the mesh"),
    ("pairenergy", r"PAIRENERGY \(pen\) under the mesh"),
    ("B", "TableFunction under the mesh"),
    ("bilayer", "exclusion component of 24"),
])
def test_mesh_refuses_list_decks(tmp_path, kind, what):
    """ParallelSimulation at (1,1,1) refuses by name, naming item 25, a
    deck with ORDERSH or PAIRENERGY beside its EAM term (the JAX mesh
    drops such terms; the port never drops a term).  The TableFunction
    PAIR deck and the bilayer whose exclusion graph is wider than the
    in-kernel encoding, once refused here, run on the brick list engine:
    in f64 their first energy and forces match the JAX package's f64
    Simulation on its list engine (rel 1e-10, 1e-10 of the scale), and
    in f32 they run a chunk."""
    from ddcmd_tpu_torch.run import parallel_sim as tps

    d = _deck(tmp_path, kind)
    if kind in ("A", "pairenergy"):
        with pytest.raises(NotImplementedError,
                           match=f"{what}(.|\n)*item 25"):
            ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
        return
    with chip_smoke.widened(*((tps, jsim) if kind == "bilayer" else ())):
        js = jsim.Simulation(*j_load(d), run_dir=d, engine="nlist",
                             dtype=jnp.float64)
        js.first_energy()
        n = js.sysdef.state.n_local
        f0 = np.asarray(js.ss.state.f[:n], np.float64)
        e0 = float(js.ss.energy.eion)
        ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu",
                                dtype=torch.float64)
        assert ps.shard_engine == "nlist"
        assert ps.first_energy() == pytest.approx(e0, rel=1e-10)
        f = ps.gather_by_gid(("f",))["f"]
        assert np.abs(f - f0).max() <= 1e-10 * np.abs(f0).max()
        ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
        assert ps.shard_engine == "nlist"
        ps.run(ps.chunk_steps)
    assert int(ps.mask.sum()) == n and torch.isfinite(ps.f[ps.mask]).all()


def test_jax_mesh_drops_ordersh(tmp_path):
    """The reference finding behind that refusal: JAX's
    ParallelSimulation keeps the EAM term of an EAM + ORDERSH deck and
    drops the bias without a word (parallel_sim.py:58-90): its first
    energy at (1,1,1) is the EAM-only deck's, not its Simulation's."""
    from ddcmd_tpu.run.parallel_sim import \
        ParallelSimulation as JParallelSimulation

    d = _deck(tmp_path, "A")
    e0 = str(tmp_path / "eam")
    os.makedirs(e0)
    chip_smoke.eam_deck(e0, 4, 5)
    out = {}
    for name, dd in (("with", d), ("eam", e0)):
        js = jsim.Simulation(*j_load(dd), run_dir=dd, dtype=jnp.float64)
        js.first_energy()
        out[name] = float(js.ss.energy.eion)
    ps = JParallelSimulation(*j_load(d), shape=(1, 1, 1), dtype=jnp.float64)
    e_mesh = float(ps.first_energy())
    assert e_mesh == pytest.approx(out["eam"], rel=1e-9)
    assert abs(out["with"] - out["eam"]) > 10.0
