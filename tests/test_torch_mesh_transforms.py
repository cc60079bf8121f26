"""SIMULATE transform= under the brick mesh: ParallelSimulation applies
each transform at its rate, as the port's Simulation does -- the same
particles re-uploaded at the new box (THERMALIZE, SETVELOCITY, BOX,
GIDSHUFFLE), or the system rebuilt (REPLICATE on a water box and on a
bilayer's topology, a BOX that tilts), the analyses and the graphs line
carried across the replica -- and a transform that keeps part of a
residue raises on every rank.

One two-rank gloo spawn at (2,1,1) (tests/torch_mesh_ranks.
mesh_transforms) runs every leg; meanwhile this process runs the port's
Simulation on each f64 deck (engine "nlist", which wraps positions after
every drift as the mesh's list engine does), the JAX package's
Simulation on the same-count deck, and the JAX mesh on that deck with
and without its transform= list.  The water decks are the 400-bead FREE
box (chip_smoke.mesh_transform_deck, updateRate 20, transforms at rate
20), so both drivers dispatch 20 steps and no leg draws noise.

Tolerances: f64, every step's e_pot and kinetic energy, the box, and
positions (modulo the box) and velocities by gid within 1e-10 of their
scale of Simulation's; the same-count leg within 1e-9 of the JAX
Simulation's (relative; the JAX fast path is the reference for these
transforms); each bonded family's energy after the bilayer's replica
within 1e-10 of twice that before it.  f32 (the cells engine through
#6's plain version, the list engine after the tilt): the first energy
after each transform within 2e-5 relative, and the forces within 2e-5
of their scale, of Simulation's on the same state.  The JAX mesh reads
no transform=: its runs with and without the list are equal to 1e-12."""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import torch_mesh_ranks as ranks
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.parallel_sim import ParallelSimulation as JMesh
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.collection import read_collection
from ddcmd_tpu_torch.models import load
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.run.simulate import Simulation

torch.set_num_threads(2)

QUIET = dict(print_fn=lambda line: None)
REP = {"rep": "type=REPLICATE; nx=2; ny=1; nz=1;"}
# the REPLICATE deck's analysis: its one block of four evals spans the
# replica at loop 20
VAF = {"vaf": "type=VELOCITYAUTOCORRELATION; length=4; eval_rate=10; "
              "outputrate=40;"}
TOL, JAX_TOL, F32_TOL = 1e-10, 1e-9, 2e-5


def _decks(root):
    """{leg: deck dir}: the same-count deck, the REPLICATE deck (rate
    20, with VAF and printGraphs), the nx = 4 bilayer with a REPLICATE of
    no rate, and the
    same-count deck without its transform= list (the JAX mesh's
    baseline)."""
    out = {}
    for leg in ("same", "rep", "bilayer", "plain"):
        out[leg] = str(root / leg)
        os.makedirs(out[leg])
    chip_smoke.mesh_transform_deck(out["same"])
    chip_smoke.edit_deck(
        chip_smoke.mesh_transform_deck(out["rep"], objects=REP),
        lambda t: chip_smoke.analyses_edit(VAF)(t).replace(
            "type=MD;", "type=MD; printinfo=pinfo;", 1)
        + "pinfo PRINTINFO { printGraphs=1; }\n")
    chip_smoke.edit_deck(chip_smoke.bilayer_deck(out["bilayer"], 4, 20.0, 20,
                                                 free=True),
                         chip_smoke.transforms_edit(REP))
    chip_smoke.water_deck(out["plain"], chip_smoke.MT_SMALL_N,
                          chip_smoke.MT_RATE, free=True)
    return out


class _Recorder:
    """Simulation's accepted per-step rows (e_pot, rk; chip_smoke.
    sim_step_rows) and, before the first transform of each multiple, r
    and v (f64 numpy)."""

    def __init__(self, sim, first="therm"):
        self.steps, self.pre = chip_smoke.sim_step_rows(sim), []
        real = sim.apply_transform

        def transform(tobj):
            if tobj.name == first:
                n = sim.sysdef.state.n_local
                st = sim.ss.state
                self.pre.append((st.r[:n].double().numpy().copy(),
                                 st.v[:n].double().numpy().copy()))
            return real(tobj)

        sim.apply_transform = transform


def _sim(d, dtype=torch.float64, run_dir=None):
    kw = dict(engine="nlist") if dtype == torch.float64 else {}
    run_dir = run_dir or d
    os.makedirs(run_dir, exist_ok=True)
    return Simulation(*load(d), run_dir=run_dir, device="cpu", dtype=dtype,
                      **kw)


def _run(sim, steps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # stale-list redos
        sim.run(steps, **QUIET)


def _jmesh(d, steps):
    """The JAX mesh at (1,1,1) in f64, `steps` steps: owned r and v."""
    ps = JMesh(*j_load(d), shape=(1, 1, 1), dtype=jnp.float64)
    ps.first_energy()
    ps.run(steps)
    m = np.asarray(ps.mask).reshape(-1).astype(bool)
    return (np.asarray(ps.fields["r"]).reshape(-1, 3)[m],
            np.asarray(ps.fields["v"]).reshape(-1, 3)[m])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_transforms")
    decks = _decks(root)
    jd = str(root / "jax_same")
    shutil.copytree(decks["same"], jd)
    out = str(root / "mesh.npz")
    # the f64 list engine rebuilds its list every step on a box a few
    # rlist wide (every row's candidates are the whole pool): ~40 s of
    # the ranks' time alone, several times that beside other spawns
    join = ranks.start_ranks(ranks.mesh_transforms, 2, root, decks, out,
                             timeout=300.0)
    ref = {}
    try:
        for leg, deck, steps in (("same", "same", 60), ("rep64", "rep", 40)):
            sim = _sim(decks[deck], run_dir=os.path.join(decks[deck], "sim"))
            rec = _Recorder(sim)
            _run(sim, steps)
            ref[leg] = (sim, rec)
        sim = _sim(decks["bilayer"])
        rec = _Recorder(sim)
        _run(sim, 12)
        ref["bilayer_counts0"] = sim.sysdef.bonded.counts()
        sim.apply_transform(sim.db.get("rep", "TRANSFORM"))
        _run(sim, 12)
        ref["bilayer"] = (sim, rec)
        js = JSimulation(*j_load(jd), run_dir=jd, dtype=jnp.float64,
                         engine="nlist")
        js.run(60, **QUIET)
        ref["jax"] = js
        ref["jmesh"] = (_jmesh(decks["same"], 40), _jmesh(decks["plain"], 40))
    finally:
        join()
    return decks, dict(np.load(out)), ref


def _scale_close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _r_close(got, ref, h, what, tol=TOL):
    """Positions equal modulo the box h, within tol of its largest
    entry."""
    s = (np.asarray(got) - ref) @ np.linalg.inv(h).T
    dr = float(np.abs((s - np.round(s)) @ h.T).max())
    assert dr <= tol * np.abs(h).max(), (what, dr)


def _leg(mesh, leg):
    return {k[len(leg) + 1:]: v for k, v in mesh.items()
            if k.startswith(leg + "_")}


def _held(m, sim, rec, what):
    """The mesh leg m against Simulation: every step's e_pot and rk, the
    box, r (modulo it) and v by gid, the loop and the count."""
    n = sim.sysdef.state.n_local
    ss = sim.ss
    h = ss.box.h.numpy()
    assert int(m["loop"]) == ss.loop and int(m["n"]) == n, what
    assert int(m["owned"].sum()) == n and m["owned"].min() > 0, what
    steps = rec.steps()
    assert m["rows"].shape[0] == steps.shape[0] == ss.loop, what
    for c, name in enumerate(("e_pot", "rk")):
        _scale_close(m["rows"][:, c], steps[:, c], f"{what} {name}")
    _scale_close(m["h"], h, f"{what} h")
    _r_close(m["r"], ss.state.r[:n].numpy(), h, f"{what} r")
    _scale_close(m["v"], ss.state.v[:n].numpy(), f"{what} v")


def test_same_count_transforms_match_simulation(runs):
    """THERMALIZE (seeded), SETVELOCITY, BOX (2% smaller than the deck's
    box) and GIDSHUFFLE at rate 20 over 60 f64 steps at (2,1,1):
    dispatches end on 20, 40 and
    60; every step's row, the box, r and v by gid at the end and before
    the transforms of each multiple equal Simulation's to 1e-10, as do
    the collection's gids (shuffled three times; the rows keep their
    own) and the gathered view's r."""
    _, mesh, ref = runs
    m = _leg(mesh, "same")
    sim, rec = ref["same"]
    assert m["ends"].tolist() == [20, 40, 60]
    assert str(m["engine"]) == "nlist"
    _held(m, sim, rec, "same")
    h = sim.ss.box.h.numpy()
    assert len(rec.pre) == m["pre_r"].shape[0] == 3
    for i, (r, v) in enumerate(rec.pre):
        _r_close(m["pre_r"][i], r, h, f"r before the transforms at {i}")
        _scale_close(m["pre_v"][i], v, f"v before the transforms at {i}")
    n = sim.sysdef.state.n_local
    np.testing.assert_array_equal(m["col_gid"], sim.sysdef.collection.gid)
    np.testing.assert_array_equal(m["row_gid"], sim.ss.state.gid[:n])
    assert not np.array_equal(m["col_gid"], m["row_gid"])
    _r_close(m["view_r"], sim.ss.state.r[:n].numpy(), h, "view r")
    # the BOX sets h 2% smaller than the deck's at loop 20 (the fast path
    # plans the bricks and the grid again) and keeps it at 40 and 60
    L0 = sim.sysdef.box.lengths.numpy()
    np.testing.assert_allclose(np.diagonal(m["h"]), 0.98 * L0, rtol=1e-12)


def test_same_count_transforms_match_jax(runs):
    """The same deck's JAX Simulation (its transform fast path, engine
    "nlist", f64): the mesh's box, positions, e_pot and velocities at
    loop 60, after the transforms there, and the collection's gids
    equal its own to 1e-9."""
    _, mesh, ref = runs
    m = _leg(mesh, "same")
    js = ref["jax"]
    n = int(m["n"])
    jh = np.asarray(js.ss.box.h, np.float64)
    _scale_close(m["h"], jh, "h", JAX_TOL)
    _r_close(m["r"], np.asarray(js.ss.state.r[:n], np.float64), jh, "r",
             JAX_TOL)
    assert float(m["rows"][-1, 0]) == pytest.approx(
        float(js.ss.energy.eion), rel=JAX_TOL, abs=0)
    _scale_close(m["v"], np.asarray(js.ss.state.v[:n], np.float64), "v",
                 JAX_TOL)
    np.testing.assert_array_equal(m["col_gid"],
                                  np.asarray(js.sysdef.collection.gid))


@pytest.mark.parametrize("writer", ["shards", "gathered"])
def test_checkpoint_after_gidshuffle(runs, writer):
    """The mesh's checkpoint at loop 60, written by the shard writers and
    by the gathered writer, reads back with the collection's (shuffled)
    gids, each record at its row's position and velocity."""
    _, mesh, _ = runs
    m = _leg(mesh, "same")
    snap = str(m[f"ck_{writer}"])
    col = read_collection("atoms#", snap)
    gid = np.asarray(col.gid, np.int64)
    assert sorted(gid.tolist()) == sorted(m["col_gid"].tolist())
    order = np.argsort(m["col_gid"])
    back = np.argsort(gid)
    _r_close(col.r[back], m["r"][order], m["h"], "r", 1e-8)
    _scale_close(col.v[back], m["v"][order], "v", 1e-8)


def test_replicate_at_its_rate_matches_simulation(runs):
    """REPLICATE 2x1x1 at rate 20 over 40 f64 steps: 400 -> 800 beads at
    loop 20, then 20 steps on the rebuilt plan, then 1,600 at loop 40;
    every step's row, the box, r and v by gid equal Simulation's to
    1e-10, the gids unique; dispatches end on the VAF's eval rate 10."""
    _, mesh, ref = runs
    m = _leg(mesh, "rep64")
    sim, rec = ref["rep64"]
    assert int(m["n"]) == 1600 and m["ends"].tolist() == [10, 20, 30, 40]
    assert len(set(sim.sysdef.collection.gid)) == 1600
    _held(m, sim, rec, "rep64")


def test_analyses_outlive_the_replica(runs):
    """The REPLICATE deck's VELOCITYAUTOCORRELATION (evals at 10, 20, 30
    and 40 in one block that spans the replica at loop 20: its last two
    rows average over the gids present at both times) writes the rows
    Simulation writes (1e-10 relative), and the mesh's graphs lines show
    400 owned beads at loops 10 and 20 (the line precedes the replica)
    and 800 at 30 and 40, each the sum of the two bricks' counts."""
    decks, _, _ = runs
    d = decks["rep"]
    got, want = (chip_smoke.analysis_rows(os.path.join(d, w, "vaf.dat"))
                 for w in ("mesh64", "sim"))
    assert got[:, 0].tolist() == want[:, 0].tolist() == [10, 20, 30, 40]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    with open(os.path.join(d, "mesh64", "graphs")) as f:
        lines = f.read().splitlines()
    nlocal = [int(ln.split("nlocal=")[1].split()[0]) for ln in lines]
    owned = [sum(int(x) for x in ln.split("owned=")[1].split(","))
             for ln in lines]
    assert nlocal == owned == [400, 400, 800, 800]


@pytest.fixture(scope="module")
def f32_refs(runs):
    """Simulation in f32 (its kernel engine through #1's plain version,
    its cell-block engine after the tilt) on the mesh's states before
    each transform of the rep32 leg: [(e, f)] after each."""
    decks, mesh, _ = runs
    sim = _sim(decks["rep"], torch.float32,
               os.path.join(decks["rep"], "sim32"))
    out = []
    sim.db.compile_string(str(mesh["rep32_tilt"]))
    for i in range(int(mesh["rep32_count"])):
        m = _leg(mesh, f"rep32_{i}")
        st = sim.ss.state
        n = sim.sysdef.state.n_local
        r, v = st.r.clone(), st.v.clone()
        r[:n] = torch.as_tensor(m["r"], dtype=torch.float32)
        v[:n] = torch.as_tensor(m["v"], dtype=torch.float32)
        sim.ss = sim.ss.replace(state=st.replace(r=r, v=v))
        sim.apply_transform(sim.db.get(str(m["name"]), "TRANSFORM"))
        n = sim.sysdef.state.n_local
        out.append((float(sim.ss.energy.eion), sim.ss.state.f[:n].numpy(),
                    sim.engine))
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["replicate", "tilt"])
def test_f32_first_energy_matches_simulation(runs, f32_refs, i):
    """In f32: the REPLICATE at loop 20 moves the mesh from the list
    engine (bricks narrower than 2 rlist) to the cells engine; the BOX
    that tilts then moves it back to the list engine (the cells engine
    takes orthorhombic boxes).  After each, its first energy and forces
    equal Simulation's on the same state within 2e-5 (relative, of the
    force scale)."""
    _, mesh, _ = runs
    m = _leg(mesh, f"rep32_{i}")
    e, f, engine = f32_refs[i]
    want = [("nlist", "pallas", "kernel"), ("pallas", "nlist",
                                            "cellblock")][i]
    assert (str(m["engine0"]), str(m["engine"]), engine) == want
    assert (np.count_nonzero(m["h"] - np.diag(np.diagonal(m["h"]))) > 0) \
        == (i == 1)
    assert float(m["e"]) == pytest.approx(e, rel=F32_TOL, abs=0)
    _scale_close(m["f"], f, "f", F32_TOL)
    assert int(mesh["rep32_loop"]) == 27 and bool(mesh["rep32_finite"])


def test_bilayer_replica_rebuilds_its_topology(runs):
    """The nx = 4 NPT bilayer (528 beads, RATTLE) replicated 2x1x1 after
    12 f64 steps: each bonded family's energy is twice that before it
    (1e-10), the counts double, and the 24 steps equal Simulation's to
    1e-10."""
    _, mesh, ref = runs
    m = _leg(mesh, "bilayer")
    sim, rec = ref["bilayer"]
    c0 = ref["bilayer_counts0"]
    assert list(m["families"]) == ["angles", "bonds", "exclusions"]
    np.testing.assert_allclose(m["fam1"], 2.0 * m["fam0"], rtol=TOL, atol=0)
    assert m["counts"].tolist() == [2 * c0[k] for k in
                                    ("bonds", "angles", "n_constraints")]
    assert int(m["n"]) == 1056
    _held(m, sim, rec, "bilayer")


def test_cut_residue_raises_on_every_rank(runs):
    """A SELECTSUBSET through a lipid of the replicated bilayer raises
    ValueError naming the lipid on both ranks, with no rank left in a
    collective; the count, r, v and f stay as they were and the first
    energy is the last step's."""
    _, mesh, _ = runs
    m = _leg(mesh, "cut")
    errs = [str(e) for e in m["errs"]]
    assert len(errs) == 2 and errs[0] == errs[1]
    assert f"residue DPPC at gid {int(m['gid'])}:" in errs[0]
    assert int(m["n"]) == 1056 and bool(m["same"])
    assert float(m["e1"]) == pytest.approx(float(m["e0"]), rel=1e-12)


def test_randomized_thermalize_is_one_draw(runs):
    """THERMALIZE with randomizeSeed=1 draws on rank 0 only: both ranks
    distribute the same velocities, which the mesh then holds; they are
    new, at about the target temperature."""
    _, mesh, ref = runs
    m = _leg(mesh, "random")
    np.testing.assert_array_equal(m["host_v"][0], m["host_v"][1])
    np.testing.assert_array_equal(m["v"], m["host_v"][0])
    assert not np.allclose(m["v"], m["v0"])
    sd = ref["same"][0].sysdef
    mass = sd.state.mass[:sd.state.n_local].numpy()
    temp = float((mass[:, None] * m["v"] ** 2).sum()
                 / (3 * len(mass) * U.kB))
    assert abs(temp - 310.0) < 0.15 * 310.0, temp


def test_jax_mesh_applies_no_transform(runs):
    """The JAX mesh (f64, (1,1,1)) on the same-count deck: 40 steps equal
    those of the deck without transform= (1e-12), where the transforms
    at loop 20 would have replaced every velocity and shrunk the box --
    as the port's mesh did (ROADMAP section 3)."""
    _, mesh, ref = runs
    (r1, v1), (r0, v0) = ref["jmesh"]
    np.testing.assert_allclose(r1, r0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=1e-12)
    m = _leg(mesh, "same")
    assert not np.allclose(m["pre_v"][1], v0, rtol=1e-3, atol=0)
