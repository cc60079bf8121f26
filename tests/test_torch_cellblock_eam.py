"""Slice 11, the plain cell-block EAM engine and the tabulated decks
through the drivers, against the JAX package: eam_cellblock_eval_half
against the JAX engine in f64 (FS, RATIONAL, TABULAR, the refit, the
asymmetric T = 2 alloy and five species; orthorhombic and triclinic),
the engine choice, the TABULAR deck and its refit through Simulation and
the mesh, triclinic / f64 / five-species decks through the CLI, NONE
terms in both packages, and EAM with non-periodic axes: the JAX engine's
pair through the wall, and the port's masked engine against a direct sum
(item 27; the rest of it in tests/test_torch_walls.py).

Tolerances (as tests/test_torch_tabular_eam.py states them): the f64
engines at 1e-9 of the force scale, energy rel 1e-12, virial and
per-particle energy rel 1e-9; the f32 kernels' plain versions against
JAX's f64 engine at the EAM tolerances of tests/test_torch_eam.py
(energy rel 2e-5, forces 5e-5 of the scale, virial rel 5e-3 abs 1.0);
the mesh against Simulation at rel 2e-5; the refit's first energy within
the fit's rel 5e-3 of the RATIONAL deck's (the JAX package's
tests/test_eam.py tolerance)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.potentials import eam as jeam
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.ops import cellpair as tcp
from ddcmd_tpu_torch.ops import cellpair_eam as tce
from ddcmd_tpu_torch.potentials import eam as team
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
from test_torch_eam import E_REL, F_REL, V_ABS, V_REL, _alloy_parms, _fcc, \
    _parms
from test_torch_tabular_eam import (F64_REL, _jax_cellblock, decks,  # noqa: F401
                                    parms)

torch.set_num_threads(2)

ALLOY5_FS = chip_smoke.ALLOY_FS


# ---------------------------------------------------------------------------
# (c) the plain cell-block EAM engine against the JAX engine, f64
# ---------------------------------------------------------------------------

def _five_parms():
    """The five-species FS alloy of chip_smoke.alloy_eam_deck (JAX's
    compile_eam)."""
    from ddcmd_tpu.objects import ObjectDB

    class Sp:
        def __init__(self, name):
            self.name = name

    db = ObjectDB()
    db.compile_string("pot POTENTIAL { type=EAM; form=FS; rmax=5.5 Angstrom; "
                      + " ".join(f"{k} = {v};" for k, v in ALLOY5_FS.items())
                      + " }")
    return jeam.compile_eam(db, "pot", [Sp(k) for k in ALLOY5_FS])


def _crystal(nc, tilt=0.0, seed=2):
    """A jittered fcc crystal of nc^3 cells in an orthorhombic box
    ((3,) lengths) or one sheared by `tilt` in xy ((3,3) h)."""
    L = 0.3615 * nc
    h = np.diag([L, L, L])
    h[0, 1] = tilt * L
    r, _ = _fcc(1.0 / nc, nc)
    rng = np.random.default_rng(seed)
    r = r @ h.T + rng.standard_normal(r.shape) * 0.006
    return r, (np.diag(h) if tilt == 0.0 else h)


CELL_CASES = [("fs", "ortho"), ("rat", "ortho"), ("tab", "ortho"),
              ("fit", "ortho"), ("alloy", "ortho"), ("five", "ortho"),
              ("tab", "triclinic"), ("alloy", "triclinic")]


@pytest.mark.parametrize("case,geom", CELL_CASES)
def test_cellblock_eam_matches_jax(case, geom, parms):
    """eam_cellblock_eval_half == the JAX package's in f64 on a jittered
    crystal with random species and a tenth of the rows masked: FS (one
    species), the crystal's RATIONAL, TABULAR, the refit, the asymmetric
    T = 2 alloy and five species; orthorhombic and monoclinic (tilt
    0.2)."""
    p, T = {"fs": lambda: (_parms("jax", "FS", 1), 1),
            "alloy": lambda: (_alloy_parms(), 2),
            "five": lambda: (_five_parms(), 5)}.get(
        case, lambda: (parms[case, "jax"], 1))()
    r, g = _crystal(4, tilt=0.2 if geom == "triclinic" else 0.0)
    n = len(r)
    rng = np.random.default_rng(9)
    sidx = rng.integers(0, T, n)
    fmask = (rng.random(n) > 0.1).astype(np.float64)
    tg = tcp.CellBlockGrid.plan(np.asarray(g, np.float64), 0.55, 0.1, n)
    th = tcp.half_grid(tg)
    perm, ov = tcp.build_cell_slots(torch.tensor(r), torch.ones(
        n, dtype=torch.float64), torch.tensor(g), tg)
    assert not bool(ov)
    t = tce.eam_cellblock_eval_half(
        torch.tensor(r), torch.tensor(sidx), torch.tensor(fmask), perm,
        torch.tensor(g), th, team.eam_device_tables(p, dtype=torch.float64),
        tcp.half_back_map(th))
    tf, te, tv, tpe = (x.numpy() for x in t)
    jf, je, jv, jpe_ = _jax_cellblock(r, sidx, fmask, g, p)
    assert np.isfinite(tf).all() and np.abs(jf).max() > 0
    assert np.abs(tf - jf).max() <= F64_REL * max(1.0, np.abs(jf).max())
    assert te == pytest.approx(je, rel=1e-12)
    np.testing.assert_allclose(tv, jv, rtol=1e-9,
                               atol=1e-9 * np.abs(jv).max())
    np.testing.assert_allclose(tpe, jpe_, rtol=1e-9,
                               atol=1e-9 * np.abs(jpe_).max())


# ---------------------------------------------------------------------------
# (d) the decks through the drivers
# ---------------------------------------------------------------------------

def test_engine_choice(decks, tmp_path):
    """Under auto the TABULAR deck and a five-species alloy run on the
    cell-block engine, the refit on the kernels (JAX's pallas_eam_supported
    gives the same split); engine="kernel" on the TABULAR deck raises."""
    from ddcmd_tpu.ops import pallas_eam as jpe

    d5 = str(tmp_path)
    chip_smoke.alloy_eam_deck(d5, 2, 10)
    for d, engine in ((decks["tab"], "cellblock"), (decks["fit"], "kernel"),
                      (d5, "cellblock")):
        sim = TSimulation(*t_load(d), run_dir=d, device="cpu")
        assert sim.engine == engine
        jsd = j_build_system(j_load(d)[0], d)
        jt = jeam.eam_device_tables(jsd.potentials[0][2])
        assert jpe.pallas_eam_supported(jt) == (engine == "kernel")
    with pytest.raises(ValueError, match="EAM form TABULAR"):
        TSimulation(*t_load(decks["tab"]), run_dir=decks["tab"],
                    device="cpu", engine="kernel")


@pytest.mark.parametrize("case", ["tab", "fit"])
def test_slice_matches_jax(case, decks):
    """The port's Simulation on the TABULAR deck (cell-block engine, f64)
    and on its refit (the kernels' plain versions, f32) against JAX's
    Simulation on its f64 cell-block engine: first energy, forces and
    virial (f64: 1e-9 of the force scale, rel 1e-12 and 1e-9; f32: the
    EAM tolerances), the refit's first energy within the fit's rel 5e-3
    of the RATIONAL deck's; then 10 steps, finite."""
    d = decks[case]
    dtype = torch.float64 if case == "tab" else torch.float32
    t = TSimulation(*t_load(d), run_dir=d, device="cpu", dtype=dtype)
    assert t.engine == ("cellblock" if case == "tab" else "kernel")
    t.first_energy()
    j = JSimulation(*j_load(d), run_dir=d, engine="cellblock",
                    dtype=jnp.float64)
    j.first_energy()
    n = t.sysdef.state.n_local
    jf = np.asarray(j.ss.state.f)[:n]
    te, je = float(t.ss.energy.eion), float(j.ss.energy.eion)
    ferr = np.abs(t.ss.state.f[:n].numpy() - jf).max()
    tv, jv = t.ss.energy.virial.numpy(), np.asarray(j.ss.energy.virial)
    if case == "tab":
        assert ferr <= F64_REL * np.abs(jf).max()
        assert te == pytest.approx(je, rel=1e-12)
        np.testing.assert_allclose(tv, jv, rtol=1e-9,
                                   atol=1e-9 * np.abs(jv).max())
    else:
        assert ferr <= F_REL * max(1.0, np.abs(jf).max())
        assert te == pytest.approx(je, rel=E_REL)
        assert tv == pytest.approx(jv, rel=V_REL, abs=V_ABS)
        r = TSimulation(*t_load(decks["rat"]), run_dir=decks["rat"],
                        device="cpu")
        r.first_energy()
        assert te == pytest.approx(float(r.ss.energy.eion), rel=5e-3)
    t.run(10, print_fn=lambda s: None)
    assert t.ss.loop == 10 and np.isfinite(float(t.ss.energy.eion))
    assert np.isfinite(t.ss.state.r.numpy()).all()


@pytest.mark.parametrize("what", ["triclinic", "f64", "five"])
def test_cell_block_eam_decks_step(what, tmp_path):
    """A triclinic, an f64 and a five-species EAM deck through the CLI on
    the CPU: the cell-block EAM engine, 20 finite steps; the triclinic
    deck's first energy equals JAX's (f32: rel 1e-4)."""
    from ddcmd_tpu_torch.run import cli

    d = str(tmp_path)
    deck = {"triclinic": lambda: chip_smoke.triclinic_eam_deck(d, 4, 10),
            "f64": lambda: chip_smoke.eam_deck(d, 4, 10),
            "five": lambda: chip_smoke.alloy_eam_deck(d, 4, 10)}[what]()
    argv = ["simulate", "-o", deck, "-n", "20", "--run-dir", d, "--device",
            "cpu"] + (["--f64"] if what == "f64" else [])
    sim = cli.run(argv)
    assert sim.engine == "cellblock" and sim.ss.loop == 20
    rows = chip_smoke.read_rows(d)
    assert np.isfinite(rows).all() and rows[:, 0].tolist() == [10, 20]
    if what == "triclinic":
        t = TSimulation(*t_load(d), run_dir=d, device="cpu")
        t.first_energy()
        j = JSimulation(*j_load(d), run_dir=d, engine="cellblock",
                        dtype=jnp.float64)
        j.first_energy()
        assert float(t.ss.energy.eion) == pytest.approx(
            float(j.ss.energy.eion), rel=1e-4)


def test_refit_mesh_matches_simulation(decks, tmp_path):
    """The refit deck under ParallelSimulation at (1,1,1) over gloo on
    #7's plain versions: first energy and forces equal Simulation's (rel
    2e-5, F_REL of the scale), then 10 finite steps.  The decks #7 does
    not take, the unfitted TABULAR deck and a five-species FS alloy, run
    on the brick list engine (as the JAX package's pick sends them to
    its own): in f64 their first energy and forces equal the JAX mesh's
    list engine's to 1e-10, and the TABULAR deck runs 10 f32 steps."""
    import torch.distributed as dist

    from ddcmd_tpu.run.parallel_sim import \
        ParallelSimulation as JParallelSimulation
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    d = decks["fit"]
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu")
    sim.first_energy()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
        assert ps.force_kind == "eam" and \
            ps.step_fn.rho_fn.kw["form"] == "RATIONAL_SHIFTED"
        e = ps.first_energy()
        assert e == pytest.approx(float(sim.ss.energy.eion), rel=2e-5)
        n = sim.sysdef.state.n_local
        f0 = sim.ss.state.f[:n].numpy()
        f = ps.gather_by_gid(("f",))["f"]
        assert np.abs(f - f0).max() <= F_REL * np.abs(f0).max()
        ps.run(10, print_fn=lambda s: None)
        assert ps.loop == 10
        five = str(tmp_path / "five")
        os.makedirs(five)
        chip_smoke.alloy_eam_deck(five, 2, 10)
        for deck in (decks["tab"], five):
            jps = JParallelSimulation(*j_load(deck), shape=(1, 1, 1),
                                      dtype=jnp.float64)
            assert jps.shard_engine == "nlist"
            je = jps.first_energy()
            m = np.asarray(jps.mask)
            jg = np.asarray(jps.fields["gid"])[m][:, 0].astype(np.int64)
            ps = ParallelSimulation(*t_load(deck), shape=(1, 1, 1),
                                    device="cpu", dtype=torch.float64)
            assert ps.force_kind == "eam" and ps.shard_engine == "nlist"
            assert abs(ps.first_energy() - je) <= 1e-10 * abs(je)
            jf = np.zeros((len(jg), 3))
            jf[jg] = np.asarray(jps.f)[m]
            f = ps.gather_by_gid(("f",))["f"]
            assert np.abs(f - jf).max() <= 1e-10 * np.abs(jf).max()
        ps = ParallelSimulation(*t_load(decks["tab"]), shape=(1, 1, 1),
                                device="cpu")
        assert ps.shard_engine == "nlist"
        ps.run(10, print_fn=lambda s: None)
        assert ps.loop == 10 and torch.isfinite(ps.f[ps.mask]).all()
    finally:
        dist.destroy_process_group()


def _with_none(src, dst, ptype):
    """The deck in src with a `ptype` (NONE or ZEROPOTENTIAL) POTENTIAL
    beside its EAM term, written to dst."""
    for name in os.listdir(src):
        if name != "object.data":
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "object.data")) as f:
        text = f.read()
    assert "potential=pot;" in text
    text = text.replace("potential=pot;", "potential=pot zero;") \
        + f"zero POTENTIAL {{ type={ptype}; }}\n"
    with open(os.path.join(dst, "object.data"), "w") as f:
        f.write(text)
    return dst


@pytest.mark.parametrize("ptype", ["NONE", "ZEROPOTENTIAL"])
def test_none_term_changes_nothing(ptype, decks, tmp_path):
    """A NONE / ZEROPOTENTIAL term beside EAM builds as ("NONE", name,
    None) and changes no first energy or force, in either package; the
    port's Simulation and mesh drop it."""
    import torch.distributed as dist

    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    base = decks["rat"]
    (tmp_path / "deck").mkdir()
    d = _with_none(base, str(tmp_path / "deck"), ptype)
    out = {}
    for key, dd in (("base", base), ("none", d)):
        t = TSimulation(*t_load(dd), run_dir=dd, device="cpu")
        t.first_energy()
        j = JSimulation(*j_load(dd), run_dir=dd, engine="cellblock")
        j.first_energy()
        out[key] = (t, j)
    (tb, jb), (tn, jn) = out["base"], out["none"]
    assert [p[0] for p in tn.sysdef.potentials] == ["EAM", "NONE"]
    assert [p[0] for p in jn.sysdef.potentials] == ["EAM", "NONE"]
    assert float(tn.ss.energy.eion) == float(tb.ss.energy.eion)
    assert float(jn.ss.energy.eion) == float(jb.ss.energy.eion)
    np.testing.assert_array_equal(tn.ss.state.f.numpy(),
                                  tb.ss.state.f.numpy())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ps = ParallelSimulation(*t_load(d), shape=(1, 1, 1), device="cpu")
        assert ps.first_energy() == pytest.approx(float(tb.ss.energy.eion),
                                                  rel=2e-5)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (e) EAM with non-periodic axes: the JAX engine's finding and item 27
# ---------------------------------------------------------------------------

def test_jax_eam_engine_takes_images_through_walls():
    """The finding behind item 27: two FS atoms at z = +-0.8 nm in a 2 nm
    box are 1.6 nm apart inside the box and 0.4 nm apart through the z
    wall.  The JAX cell-block EAM engine (where its Simulation sends an
    EAM deck with pbc < 7) takes no pbc mask, so the pair across the wall
    acts: each atom is drawn toward the other's image, f_z = +-15.09, e =
    -1.2654 (with pbc = 3 the atoms would not interact, rcut 0.55 nm)."""
    p = _parms("jax", "FS", 1)
    r = np.array([[0.0, 0.0, 0.8], [0.0, 0.0, -0.8]])
    f, e, _, _ = _jax_cellblock(r, np.zeros(2, np.int64), np.ones(2),
                                [2.0, 2.0, 2.0], p)
    assert e == pytest.approx(-1.2654, abs=1e-4)
    np.testing.assert_allclose(f[:, 2], [15.09, -15.09], atol=5e-3)
    np.testing.assert_allclose(f[:, :2], 0.0, atol=1e-9)


@pytest.mark.parametrize("engine", ["auto", "cellblock", "kernel"])
def test_eam_with_open_axes_raises(engine, tmp_path):
    """An EAM deck with pbc = 3 (the 108-atom crystal, one cell of the
    cell-block plan on each axis) runs on the cell-block EAM engine under
    auto and on an explicit "cellblock", its stencil masked at the z
    walls: the first energy, forces, virial and per-particle energy in
    f64 equal a direct O(N^2) sum over every pair and periodic image
    (tests/test_torch_walls.py) at 1e-8 of the force scale.  An explicit
    engine="kernel" still raises ValueError: the EAM kernels are fully
    periodic."""
    from test_torch_walls import assert_matches, direct_eam

    d = str(tmp_path)
    p = chip_smoke.eam_deck(d, 3, 10, free=True)
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(text.replace("pbc=7;", "pbc=3;"))
    if engine == "kernel":
        with pytest.raises(ValueError, match="pbc=3"):
            TSimulation(*t_load(d), run_dir=d, device="cpu", engine=engine)
        return
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu", engine=engine,
                      dtype=torch.float64)
    assert sim.engine == "cellblock" and sim.grid.ncells == (1, 1, 1)
    sim.first_energy()
    st, n = sim.ss.state, sim.sysdef.state.n_local
    tables = team.eam_device_tables(sim.sysdef.potentials[0][2],
                                    dtype=torch.float64)
    ref = direct_eam(st.r[:n].numpy(), st.species[:n].numpy(),
                     sim.ss.box.lengths.numpy(), 3, tables)
    assert_matches((st.f[:n], sim.ss.energy.eion, sim.ss.energy.virial,
                    st.pe[:n]), ref)
