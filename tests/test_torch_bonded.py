"""Slice 2's host layer against the JAX package on the small Martini
bilayer (nx = ny = 4, 528 beads): the builder, the bonded topology and
residue instances, the exclusion channels, the batched bonded terms, the
molecular virial and RATTLE.  Inputs come from the builder's seed or a
numpy seed; each comparison states its tolerance."""

import os

import numpy as np
import pytest
import torch

import chip_smoke

import jax.numpy as jnp

from ddcmd_tpu.core.molecule import build_molecule_class as j_build_mol
from ddcmd_tpu.core.molecule import make_molecular_virial_fn as j_mol_virial
from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.integrators import constraints as jc
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_bilayer as j_martini_bilayer
from ddcmd_tpu.potentials import bonded as jb
from ddcmd_tpu.potentials import bonded_batch as jbb
from ddcmd_tpu.potentials.martini import martini_device_tables as j_tables
from ddcmd_tpu.run.forces import _excl_channels as j_excl_channels
from ddcmd_tpu_torch.core.box import Box
from ddcmd_tpu_torch.core.molecule import build_molecule_class as t_build_mol
from ddcmd_tpu_torch.core.molecule import make_molecular_virial_fn as t_mol_virial
from ddcmd_tpu_torch.core.system import build_system as t_build_system
from ddcmd_tpu_torch.integrators import constraints as tc
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.models import martini_bilayer as t_martini_bilayer
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.potentials import bonded as tb
from ddcmd_tpu_torch.potentials import bonded_batch as tbb
from ddcmd_tpu_torch.potentials.martini import martini_device_tables as t_tables
from ddcmd_tpu_torch.run.forces import _excl_channels as t_excl_channels

torch.set_num_threads(2)


def _deck(d):
    os.makedirs(str(d), exist_ok=True)
    j_martini_bilayer(str(d), nx=4, ny=4, water_nm=1.2)
    return str(d)


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """(jax sysdef, port sysdef, deck dir) of the small bilayer."""
    d = _deck(tmp_path_factory.mktemp("bilayer"))
    return (j_build_system(j_load(d)[0], d), t_build_system(t_load(d)[0], d),
            d)


def test_bilayer_builders_write_identical_decks(tmp_path):
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jd.mkdir()
    td.mkdir()
    j_martini_bilayer(str(jd), nx=4, ny=4, water_nm=1.2)
    t_martini_bilayer(str(td), nx=4, ny=4, water_nm=1.2)
    for name in ("object.data", "bilayer.data", "atoms#000000"):
        assert (jd / name).read_text() == (td / name).read_text(), name


def test_topology_equals_jax(systems):
    """Residue instances, every bonded array, n_constraints, the
    integrator's barostat parameters and the T=5 Martini tables: exact."""
    jsd, tsd, _ = systems
    assert tsd.residue_instances == jsd.residue_instances
    jbt, tbt = jsd.bonded, tsd.bonded
    for k in ("bonds", "bond_parms", "angles", "angle_parms", "angle_kind",
              "exclusions", "cons_atoms", "cons_pairs", "cons_dist"):
        np.testing.assert_array_equal(getattr(tbt, k), getattr(jbt, k),
                                      err_msg=k)
    assert tbt.counts() == jbt.counts()
    assert tsd.n_constraints == jsd.n_constraints == 32
    assert tsd.integrator_type == jsd.integrator_type == "NGLFCONSTRAINT"
    for k in ("T", "P0", "beta", "tauBarostat", "isotropic"):
        assert tsd.integrator_parms[k] == jsd.integrator_parms[k], k
    jp, tp = jsd.potentials[0][2], tsd.potentials[0][2]
    np.testing.assert_array_equal(tp.species_lj_type, jp.species_lj_type)
    jt, tt = j_tables(jp), t_tables(tp)
    assert tt["sigma"].shape == (5, 5)
    for k in ("sigma", "eps", "shift"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    for k in ("rcut2", "krf", "crf", "keR"):
        assert tt[k] == float(jt[k]), k
    np.testing.assert_array_equal(tsd.state.q.numpy(),
                                  np.asarray(jsd.state.q))


def test_exclusion_channels_equal_jax(systems):
    """The (component id, B + 2^-(intra+1)) channels: bit-equal to the
    JAX package's, on the bilayer and on a chain + branch graph."""
    jsd, tsd, _ = systems
    n_pad = tsd.state.n_pad
    np.testing.assert_array_equal(
        t_excl_channels(tsd.bonded.exclusions, n_pad),
        j_excl_channels(jsd.bonded.exclusions, n_pad))
    ex = [(i, i + 1) for i in range(11)] + [(20, 21), (21, 22), (20, 22)]
    np.testing.assert_array_equal(t_excl_channels(ex, 32),
                                  j_excl_channels(ex, 32))


def test_wide_exclusion_component_raises(systems, monkeypatch):
    """A component wider than 12 members raises in the cell engines'
    exclusion channels, naming the list engine (the port never falls back
    to compute-then-subtract); a deck with one (the bilayer, its lipids
    joined in pairs: chip_smoke.widen_exclusions) goes to the (N,K)-list
    engine under auto, with the JAX package's demotion warning, and
    engine="kernel" raises ValueError."""
    from ddcmd_tpu_torch.run import simulate as tsim

    assert j_excl_channels([(i, i + 1) for i in range(13)], 20) is None
    with pytest.raises(NotImplementedError, match='engine="nlist"'):
        t_excl_channels([(i, i + 1) for i in range(13)], 20)

    _, _, d = systems
    monkeypatch.setattr(tsim, "build_system", lambda *a, **kw:
                        chip_smoke.widen_exclusions(t_build_system(*a, **kw)))
    with pytest.warns(UserWarning, match="demoting kernel -> nlist"):
        sim = tsim.Simulation(t_load(d)[0], d, run_dir=d, device="cpu")
    assert sim.engine == "nlist"
    with pytest.raises(ValueError, match="exclusion component of 24"):
        tsim.Simulation(t_load(d)[0], d, run_dir=d, device="cpu",
                        engine="kernel")


def _bonded_tables(sd, mod, **kw):
    mp = sd.potentials[0][2]
    return mod.device_bonded_tables(
        sd.bonded, jnp.float32 if mod is jb else torch.float32, **kw,
        lj_sigma=mp.sigma, lj_eps=mp.eps, lj_shift=mp.shift, rcut=mp.rcut,
        keR=U.ke / mp.epsilon_r, charges=np.asarray(sd.state.q),
        species_lj_type=mp.species_lj_type,
        species_per_particle=np.asarray(sd.state.species),
        excl_mode="rf_add", krf=mp.krf, crf=mp.crf)


def test_batched_bonded_matches_jax(systems):
    """Bonds + G96 cosine angles + rf_add exclusions through the port's
    batched evaluator == the JAX package's batched_bonded_eval at the
    deck's positions jittered by 0.05 nm (numpy seed), within the
    tolerances of tests/test_bonded_batch.py (f, e, virial 1e-3 absolute,
    pe 1e-4)."""
    jsd, tsd, _ = systems
    n_pad = tsd.state.n_pad
    jplan, left = jbb.build_batched_bonded(
        _bonded_tables(jsd, jb), jsd.residue_instances, n_pad, jnp.float32)
    assert not any(k in left for k in ("bonds", "angles", "exclusions"))
    tplan, tleft = tbb.build_batched_bonded(
        _bonded_tables(tsd, tb, device="cpu"), tsd.residue_instances, n_pad)
    assert not tbb.has_terms(tleft)
    rng = np.random.default_rng(7)
    r = np.asarray(jsd.state.r, np.float32)
    r = r + (rng.standard_normal(r.shape) * 0.05).astype(np.float32)
    L = np.asarray(jsd.box.lengths, np.float32)
    fj, ej, vj, pej = jbb.batched_bonded_eval(
        jnp.asarray(r), jnp.asarray(L), jplan, n_pad, jnp.float32)
    ft, et, vt, pet = tbb.batched_bonded_eval(
        torch.tensor(r), torch.tensor(L), tplan, n_pad, torch.float32)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-3)
    assert float(et) == pytest.approx(float(ej), abs=1e-3)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pet.numpy(), np.asarray(pej), rtol=0,
                               atol=1e-4)
    assert float(pet.sum()) == pytest.approx(float(et), abs=1e-3)


# a dihedralList (two torsions and a GROMACS func=2 improper) and a
# pairList edited into the DPPC RESIPARMS of the bilayer deck
_MMFF_TORSIONS = """
DPPC_d0 TORSPARMS { atomI=1; atomJ=2; atomK=4; atomL=5; func=1; kchi=5.0 kJ*mol^-1; n=3; delta=0.0; }
DPPC_d1 TORSPARMS { atomI=4; atomJ=5; atomK=6; atomL=7; func=1; kchi=2.0 kJ*mol^-1; n=1; delta=0.5; }
DPPC_d2 TORSPARMS { atomI=2; atomJ=3; atomK=4; atomL=8; func=2; kchi=20.0 kJ*mol^-1; delta=0.3; }
DPPC_p0 BPAIRPARMS { atomI=0; atomJ=3; sigma=0.47 nm; eps=2.0 kJ*mol^-1; }
"""


def _torsion_deck(d):
    """The small bilayer with _MMFF_TORSIONS in its DPPC residue."""
    _deck(d)
    p = os.path.join(str(d), "bilayer.data")
    with open(p) as f:
        text = f.read()
    new = text.replace("  constraintList= DPPC_cl ;\n",
                       "  constraintList= DPPC_cl ;\n  dihedralList= DPPC_d0 "
                       "DPPC_d1 DPPC_d2 ;\n  pairList= DPPC_p0 ;\n", 1)
    assert new != text
    with open(p, "w") as f:
        f.write(new + _MMFF_TORSIONS)
    return str(d)


def test_mmff_torsions_and_pairs_match_jax(tmp_path):
    """An MMFF deck with a dihedralList and a pairList: the torsion,
    improper and bonded-pair arrays equal JAX's, every term batches, and
    the batched forces, energy and virial equal JAX's batched evaluator
    at the jittered positions of test_batched_bonded_matches_jax (its
    tolerances); the mesh at (1,1,1) gives Simulation's first energy
    within rel 2e-5."""
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    d = _torsion_deck(tmp_path)
    jsd, tsd = j_build_system(j_load(d)[0], d), t_build_system(t_load(d)[0], d)
    assert tsd.bonded.counts()["torsions"] == 2 * 32
    for k in ("torsions", "torsion_parms", "impropers", "improper_parms",
              "bpairs", "bpair_parms"):
        np.testing.assert_array_equal(getattr(tsd.bonded, k),
                                      getattr(jsd.bonded, k), err_msg=k)
    n_pad = tsd.state.n_pad
    jplan, jleft = jbb.build_batched_bonded(
        _bonded_tables(jsd, jb), jsd.residue_instances, n_pad, jnp.float32)
    tplan, tleft = tbb.build_batched_bonded(
        _bonded_tables(tsd, tb, device="cpu"), tsd.residue_instances, n_pad)
    assert not tbb.has_terms(tleft)
    assert not any(k in jleft for k in ("torsions", "impropers", "bpairs"))
    assert {"torsions", "impropers", "bpairs"} <= set(
        next(t for t in tplan["types"] if t["name"] == "DPPC")["fams"])
    rng = np.random.default_rng(7)
    r = np.asarray(jsd.state.r, np.float32)
    r = r + (rng.standard_normal(r.shape) * 0.05).astype(np.float32)
    L = np.asarray(jsd.box.lengths, np.float32)
    fj, ej, vj, pej = jbb.batched_bonded_eval(
        jnp.asarray(r), jnp.asarray(L), jplan, n_pad, jnp.float32)
    ft, et, vt, pet = tbb.batched_bonded_eval(
        torch.tensor(r), torch.tensor(L), tplan, n_pad, torch.float32)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-3)
    assert float(et) == pytest.approx(float(ej), abs=1e-3)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pet.numpy(), np.asarray(pej), rtol=0,
                               atol=1e-4)
    sim = Simulation(t_load(d)[0], d, run_dir=d, device="cpu")
    sim.first_energy()
    ps = ParallelSimulation(t_load(d)[0], d, shape=(1, 1, 1), device="cpu")
    assert ps.first_energy() == pytest.approx(float(sim.ss.energy.eion),
                                              rel=2e-5)


def test_mesh_refuses_leftover_terms(systems, monkeypatch):
    """A bonded term that crosses residue instances (here a bond joining
    two lipids, added in memory to both packages' systems) stays in the
    leftover of the batched plan.  The mesh no longer refuses it: its
    gid-keyed leftover resolves per term beside the batched plan, on the
    cells engine (#6's plain version here), and the mesh's first energy
    and forces at (1,1,1) match the JAX package's f64 Simulation on the
    joined system (energy 1e-5 relative, forces 2e-5 of the scale, the
    bilayer mesh's tolerances)."""
    from ddcmd_tpu.run import simulate as jsim
    from ddcmd_tpu_torch.run import parallel_sim as tps

    _, tsd, d = systems
    rows = [r for name, r in tsd.residue_instances if name == "DPPC"]
    junction = (rows[0][-1], rows[1][0])

    def joiner(build):
        def joined(*a, **kw):
            sd = build(*a, **kw)
            bt = sd.bonded
            bt.bonds = np.concatenate([bt.bonds, [junction]]).astype(
                np.int32)
            bt.bond_parms = np.concatenate([bt.bond_parms, [[1250.0, 0.47]]])
            return sd
        return joined

    tab = _bonded_tables(tsd, tb, device="cpu")
    tab["bonds"] = torch.cat([tab["bonds"], torch.tensor([junction])])
    tab["bond_parms"] = torch.cat([tab["bond_parms"],
                                   torch.tensor([[1250.0, 0.47]])])
    plan, left = tbb.build_batched_bonded(tab, tsd.residue_instances,
                                          tsd.state.n_pad)
    assert plan is not None
    assert left["bonds"].tolist() == [list(junction)]
    monkeypatch.setattr(tps, "build_system", joiner(t_build_system))
    monkeypatch.setattr(jsim, "build_system", joiner(j_build_system))
    ps = tps.ParallelSimulation(t_load(d)[0], d, shape=(1, 1, 1),
                                device="cpu")
    assert ps.shard_engine == "pallas"
    assert ps._bonded_left["bonds_gids"].shape == (1, 2)
    e = ps.first_energy()
    sim = jsim.Simulation(*j_load(d), run_dir=d, engine="nlist",
                          dtype=jnp.float64)
    sim.first_energy()
    n = tsd.state.n_local
    f0 = np.asarray(sim.ss.state.f[:n], np.float64)
    assert e == pytest.approx(float(sim.ss.energy.eion), rel=1e-5)
    f = ps.gather_by_gid(("f",))["f"]
    assert np.abs(f - f0).max() <= 2e-5 * np.abs(f0).max()


def test_molecular_virial_matches_jax(systems):
    """The COM-frame molecular virial correction (single-bead molecules
    filtered out) == the JAX package's, on random forces (numpy seed),
    to f32 reduction order: 1e-5 relative."""
    jsd, tsd, d = systems
    jdb, tdb = j_load(d)[0], t_load(d)[0]
    jmol = j_build_mol(jdb, jdb.get("system", "SYSTEM"),
                       jsd.collection.species_names, jsd.collection.gid)
    tmol = t_build_mol(tdb, tdb.get("system", "SYSTEM"),
                       tsd.collection.species_names, tsd.collection.gid)
    assert tmol.n_molecules == jmol.n_molecules == 32 + 144
    np.testing.assert_array_equal(tmol.atom_rows, jmol.atom_rows)
    f = (np.random.default_rng(3).standard_normal(
        (tsd.state.n_pad, 3)) * 100).astype(np.float32)
    vir = np.diag([10.0, 20.0, 30.0]).astype(np.float32)
    jv = j_mol_virial(jmol)(jsd.state.replace(f=jnp.asarray(f)), jsd.box,
                            jnp.asarray(vir))
    tv = t_mol_virial(tmol)(tsd.state.replace(f=torch.tensor(f)), tsd.box,
                            torch.tensor(vir))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("mode", ["front", "back"])
def test_batched_rattle_matches_jax(systems, mode):
    """Template-batched single-bond RATTLE == the JAX package's batched
    and generic projectors on random velocities (numpy seed) at 5e-6 of
    the velocity scale (tests/test_bonded_batch.py), the port's generic
    projector too; after a front projection and a drift the residual is
    under 5e-4."""
    jsd, tsd, _ = systems
    bt = tsd.bonded
    L = np.asarray(tsd.box.lengths, np.float64)
    n_pad = tsd.state.n_pad
    v = np.zeros((n_pad, 3), np.float32)
    v[:tsd.state.n_local] = np.random.default_rng(1).standard_normal(
        (tsd.state.n_local, 3)) * 0.3
    dt = tsd.cfg.dt
    jst = jsd.state.replace(v=jnp.asarray(v))
    tst = tsd.state.replace(v=torch.tensor(v))
    jv = np.asarray(jc.build_constraint_fn_batched(
        bt.cons_atoms, bt.cons_pairs, bt.cons_dist, n_pad, jnp.float32,
        jsd.residue_instances, box_lengths=L)(jst, dt, mode).v)
    tfb = tc.build_constraint_fn_batched(
        bt.cons_atoms, bt.cons_pairs, bt.cons_dist, n_pad, torch.float32,
        tsd.residue_instances, box_lengths=L)
    tfg = tc.build_constraint_fn(bt.cons_atoms, bt.cons_pairs, bt.cons_dist,
                                 n_pad, torch.float32, box_lengths=L)
    scale = np.abs(jv).max()
    for fn in (tfb, tfg):
        tv = fn(tst, dt, mode).v.numpy()
        assert np.abs(tv - jv).max() / scale < 5e-6
    if mode == "front":
        tv = tfb(tst, dt, mode).v
        st2 = tst.replace(r=tst.r + dt * tv)
        res = tc.constraint_residual(st2, bt.cons_atoms, bt.cons_pairs,
                                     bt.cons_dist, box_lengths=L)
        assert res < 5e-4, res


@pytest.mark.parametrize("mode", ["front", "back"])
def test_generic_multi_pair_rattle_matches_jax(mode):
    """The generic n > 1 projector (Newton iterations of the linearized
    system, batched torch.linalg.solve) == the JAX package's on random
    triangle + chain groups (numpy seed, targets within 2% of the current
    lengths), 1e-5 of the velocity scale."""
    rng = np.random.default_rng(9)
    G, n_pad = 6, 32
    atoms = np.full((G, 4), -1, np.int32)
    pairs = np.zeros((G, 3, 2), np.int32)
    dist = np.zeros((G, 3))
    for g in range(G):
        m = 3 if g % 2 else 4                 # triangle or 4-atom chain
        atoms[g, :m] = np.arange(m) + 4 * g
        pairs[g] = [(0, 1), (1, 2), (0, 2)] if m == 3 else [(0, 1), (1, 2),
                                                            (2, 3)]
    r = (rng.random((n_pad, 3)) * 0.4).astype(np.float32)
    for g in range(G):
        # targets near the current lengths: a solvable projection
        i, j = atoms[g][pairs[g, :, 0]], atoms[g][pairs[g, :, 1]]
        dist[g] = np.linalg.norm(r[i] - r[j], axis=1) * (
            1.0 + 0.02 * rng.standard_normal(3))
    v = (rng.standard_normal((n_pad, 3)) * 0.5).astype(np.float32)
    mass = rng.uniform(50, 80, n_pad).astype(np.float32)

    class St:
        def __init__(self, **kw):
            self.__dict__.update(kw)

        def replace(self, **kw):
            return St(**{**self.__dict__, **kw})

    jst = St(r=jnp.asarray(r), v=jnp.asarray(v), mass=jnp.asarray(mass))
    tst = St(r=torch.tensor(r), v=torch.tensor(v), mass=torch.tensor(mass))
    jv = np.asarray(jc.build_constraint_fn(atoms, pairs, dist, n_pad,
                                           jnp.float32)(jst, 0.02, mode).v)
    tv = tc.build_constraint_fn(atoms, pairs, dist, n_pad,
                                torch.float32)(tst, 0.02, mode).v.numpy()
    assert np.abs(tv - jv).max() / np.abs(jv).max() < 1e-5


def test_constraint_templates_match_jax(systems):
    """build_constraint_templates: the same per-type plan, and its
    project() == the JAX package's on random data (1e-5 relative)."""
    jsd, tsd, _ = systems
    bt = tsd.bonded
    gid = tsd.state.gid[:tsd.state.n_local]
    jplan, jproj = jc.build_constraint_templates(
        bt.cons_atoms, bt.cons_pairs, bt.cons_dist, jsd.residue_instances,
        gid)
    tplan, tproj = tc.build_constraint_templates(
        bt.cons_atoms, bt.cons_pairs, bt.cons_dist, tsd.residue_instances,
        gid)
    assert len(tplan["types"]) == len(jplan["types"]) == 1
    jt, tt = jplan["types"][0], tplan["types"][0]
    assert (tt["M"], tt["A"]) == (jt["M"], jt["A"]) == (32, 12)
    np.testing.assert_array_equal(tt["li"], jt["li"])
    np.testing.assert_array_equal(tt["lj"], jt["lj"])
    np.testing.assert_array_equal(tt["gids"].numpy(), np.asarray(jt["gids"]))
    np.testing.assert_allclose(tt["d2"].numpy(), np.asarray(jt["d2"]))
    rng = np.random.default_rng(2)
    M, A = 32, 12
    rb = (rng.random((3, A, M)) * 2).astype(np.float32)
    vb = rng.standard_normal((3, A, M)).astype(np.float32)
    rm = rng.uniform(0.01, 0.02, (A, M)).astype(np.float32)
    w = (rng.random(M) > 0.3).astype(np.float32)
    L = np.array([3.2, 3.2, 9.0], np.float32)
    for front in (True, False):
        jv = np.asarray(jproj(jnp.asarray(rb), jnp.asarray(vb),
                              jnp.asarray(rm), jnp.asarray(w), jt["d2"],
                              jt["li"], jt["lj"], 0.02, front,
                              jnp.asarray(L)))
        tv = tproj(torch.tensor(rb), torch.tensor(vb), torch.tensor(rm),
                   torch.tensor(w), tt["d2"], tt["li"], tt["lj"], 0.02,
                   front, torch.tensor(L)).numpy()
        assert np.abs(tv - jv).max() / np.abs(jv).max() < 1e-5


def test_box_scale_and_volume():
    box = Box.from_h(np.diag([3.0, 4.0, 5.0]))
    s = box.scale(torch.tensor([1.0, 0.5, 2.0]))
    np.testing.assert_array_equal(s.lengths.numpy(), [3.0, 2.0, 10.0])
    assert float(s.volume) == 60.0
