"""Slice 17, analyses in the run (ROADMAP item 24b) on the CPU: SIMULATE
analysis= at its rates and PRINTINFO printStress in Simulation against
the JAX package's Simulation (f64, the 400-bead water box under a FREE
group on the (N,K)-list engine in both, 60 steps at a 20-step rebuild
cadence; one JAX run for the module), the dispatch that ends on a rate
the cadence steps over, the final output after a run and after a stop,
the `analysis` command, the rescan of the rates and its rollback, an
analysis at a transform's loop, VELOCITYAUTOCORRELATION across a count
change (ROADMAP item 30: carried by gid in the port, broken in the JAX
package), and the analysis master against the JAX package's.

Tolerances: the run's files within 1e-7 relative of the JAX run's (the
two trajectories part at the f64 rounding level); the master's files
(one state) within 1e-9."""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.masters import analysis_master as j_analysis_master
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.run import cli
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
from chip_smoke import analysis_files, analysis_rows
from test_torch_analysis import same_files

torch.set_num_threads(2)
QUIET = dict(print_fn=lambda line: None)
RATES = "eval_rate=20; outputrate=40;"
# every registry name (ACKLANDJONES and ACKLAND_JONES are one class);
# vcm30's eval_rate is off the 20-step cadence
ANALYSES = {
    "gr": f"type=PAIRCORRELATION; delta_r=0.02 nm; length=75; {RATES}",
    "vcm": f"type=VCMWRITE; {RATES}",
    "vcm30": "type=VCMWRITE; eval_rate=30; outputrate=60; "
             "filename=vcm30.data;",
    "ke": f"type=KINETICENERGYDISTN; nBins=30; max=20 kJ/mol; {RATES}",
    "zd": f"type=ZDENSITY; nBins=10; {RATES}",
    "ssf": f"type=SSF; nShells=8; kmax=10 1/nm; {RATES}",
    "vaf": f"type=VELOCITYAUTOCORRELATION; length=2; {RATES}",
    "sub": f"type=SUBSETWRITE; {RATES}",
    "sw": f"type=STRESSWRITE; {RATES} filename=sw.data;",
    "fa": f"type=FORCEAVERAGE; {RATES}",
    "dsf": f"type=DSF; m=1 2; weight=number; {RATES}",
    "cs": f"type=CENTROSYM; {RATES}",
    "aj": f"type=ACKLAND_JONES; {RATES}",
    "aj2": f"type=ACKLANDJONES; {RATES} filename=aj2.dat;",
    "cg": f"type=COARSEGRAIN; nx=2; ny=2; nz=3; {RATES}",
    "pa": f"type=PAIRANALYSIS; rmax=0.5 nm; {RATES}",
    "qu": f"type=QUATERNION; {RATES}",
    "ch": f"type=CHOLANALYSIS; rmin=-1 nm; rmax=1 nm; {RATES}",
    "ds": f"type=DATASUBSET; {RATES}",
}


def _deck(d, objects=ANALYSES, print_stress=True, extra=""):
    os.makedirs(d)
    deck = chip_smoke.water_deck(d, 400, printrate=20, free=True)
    chip_smoke.edit_deck(deck, lambda s: chip_smoke.analyses_edit(
        objects, print_stress)(s) + extra)
    return d


def _port(d, run_dir=None, **kw):
    rd = run_dir or os.path.join(d, "t")
    os.makedirs(rd, exist_ok=True)
    return TSimulation(*t_load(d), run_dir=rd, device="cpu",
                       dtype=torch.float64, engine="nlist", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The deck with every analysis and printStress, 60 steps in both
    packages (printinfo rows kept); then, in the JAX run, a REPLICATE
    2x2x2 and its VELOCITYAUTOCORRELATION eval (finding 2)."""
    d = _deck(str(tmp_path_factory.mktemp("an") / "deck"),
              extra="rep TRANSFORM { type=REPLICATE; nx=2; ny=2; nz=2; }\n")
    out = {}
    js = JSimulation(*j_load(d), run_dir=os.path.join(d, "j"),
                     dtype=jnp.float64, engine="nlist")
    ts = _port(d)
    for where, sim in (("jax", js), ("torch", ts)):
        os.makedirs(sim.run_dir, exist_ok=True)
        lines = []
        sim.run(60, print_fn=lines.append)
        assert int(sim.ss.loop) == 60
        out[where] = (sim, analysis_files(sim.run_dir), lines)
    js.apply_transform(js.db.get("rep", "TRANSFORM"))
    vaf = next(a for a in js.analyses if a.name == "vaf")
    try:
        vaf.eval(js)
        out["jax_vaf"] = None
    except Exception as err:        # numpy's broadcast error
        out["jax_vaf"] = err
    return d, out


def test_run_files_equal_jax(runs):
    """Every analysis's files after 60 steps, the port's against the JAX
    run's, vcm30's aside (test_eval_rate_the_cadence_steps_over)."""
    _, out = runs
    jf, tf = out["jax"][1], out["torch"][1]
    assert {"paircorrelation.dat", "vcm.data", "keDistn.dat",
            "zdensity.dat", "ssf.dat", "vaf.dat", "sw.data", "stress.data",
            "forceAverage.dat", "rho_k.data", "centrosym.dat",
            "acklandJones.dat", "aj2.dat", "cgrid", "pairAnalysis.dat",
            "cholAnalysis.distn", "ds.data",
            "subset/atoms_000000000040#000000",
            "snapshot.000000000060/quaternion#000000"} <= set(tf)
    same_files(jf, tf, 1e-7, skip=("vcm30.data",))
    # the outputs at 40 and the run's end at 60 (DATASUBSET's two rows)
    rd = out["torch"][0].run_dir
    assert len(analysis_rows(os.path.join(rd, "ds.data"))) == 2
    vcm = analysis_rows(os.path.join(rd, "vcm.data"))
    assert vcm[:, 0].tolist() == [20, 40, 60]


def test_eval_rate_the_cadence_steps_over(runs):
    """vcm30 (eval_rate 30 on the 20-step cadence): the port's dispatches
    end on loop 30, so it evaluates at 30 and 60; the JAX package caps
    its dispatches at 20 and evaluates at 60 only (finding 1).  The rows
    they share agree."""
    _, out = runs
    rows = {w: analysis_rows(os.path.join(out[w][0].run_dir, "vcm30.data"))
            for w in ("jax", "torch")}
    assert rows["torch"][:, 0].tolist() == [30, 60]
    assert rows["jax"][:, 0].tolist() == [60]
    np.testing.assert_allclose(rows["torch"][1], rows["jax"][0], rtol=1e-7,
                               atol=1e-12)


def test_print_stress_rows_at_printrate(runs):
    """printStress's STRESSWRITE writes a row at every printrate loop
    (20, 40, 60), in both packages; -(sxx + syy + szz)/3 is the printed
    pressure (printinfo's GPa, the file's bar) of the same loop."""
    _, out = runs
    for where in ("jax", "torch"):
        sim, _, lines = out[where]
        st = analysis_rows(os.path.join(sim.run_dir, "stress.data"))
        assert st[:, 0].tolist() == [20, 40, 60], where
        p = {int(float(ln.split()[0])): float(ln.split()[6]) for ln in lines}
        bar_per_gpa = U.convert(1.0, "GPa", "bar")
        for row in st:
            assert -row[1:4].sum() / 3 == pytest.approx(
                p[int(row[0])] * bar_per_gpa, rel=1e-5)


def test_vaf_across_a_count_change_is_item_30(runs, tmp_path):
    """A REPLICATE 2x2x2 under VELOCITYAUTOCORRELATION: the JAX package
    replicates and its next VAF eval raises numpy's broadcast error
    (finding 2); the port's VAF carries v(0) by gid, so its eval after
    the replica averages v.v(0) over the 400 gids present at both times
    (the copies' 2,800 new gids join at the block's restart): the rows
    equal a direct C(t) over the kept gids (rel 1e-10)."""
    d, out = runs
    assert isinstance(out["jax_vaf"], ValueError)
    assert "broadcast" in str(out["jax_vaf"])
    ts = _port(d, run_dir=str(tmp_path / "t"))
    ts.first_energy()
    vaf = next(a for a in ts.analyses if a.name == "vaf")
    v0, g0 = ts.ss.state.v[:400].numpy().copy(), ts.ss.state.gid[:400].copy()
    vaf.eval(ts)
    ts.apply_transform(ts.db.get("rep", "TRANSFORM"))
    assert ts.sysdef.state.n_local == 3200
    # new velocities, each particle's its own factor
    st = ts.ss.state
    scale = np.random.default_rng(4).uniform(0.5, 1.5, (st.n_pad, 1))
    ts.ss = ts.ss.replace(state=st.replace(v=st.v * torch.as_tensor(scale)))
    vaf.eval(ts)
    v, g = ts.ss.state.v[:3200].numpy(), ts.ss.state.gid[:3200]
    both, now, then = np.intersect1d(g, g0, return_indices=True)
    assert len(both) == 400 and len(vaf.state["rows"]) == 2
    assert vaf.state["rows"][1][1] == pytest.approx(
        (v[now] * v0[then]).sum() / 400, rel=1e-10)
    vaf.eval(ts)                    # length 2: a new block, all 3,200
    assert vaf.state["rows"][0][1] == pytest.approx(
        (v * v).sum() / 3200, rel=1e-10)


def test_final_output_after_a_run_and_a_stop(tmp_path):
    """outputrate 1000, never reached: the run's end writes every
    analysis once, also when ddcMD_CMDS stopped the run after its first
    dispatch."""
    objs = {"vcm": "type=VCMWRITE; eval_rate=10; outputrate=1000;",
            "ds": "type=DATASUBSET; eval_rate=10; outputrate=1000;"}
    for stop, end in ((False, 30), (True, 10)):
        d = _deck(str(tmp_path / f"d{stop}"), objs, print_stress=False)
        sim = _port(d)
        if stop:
            with open(os.path.join(sim.run_dir, "ddcMD_CMDS"), "w") as f:
                f.write("stop\n")
        sim.run(30, max_steps_per_dispatch=10, **QUIET)
        assert sim.ss.loop == end
        vcm = analysis_rows(os.path.join(sim.run_dir, "vcm.data"))
        assert vcm[:, 0].tolist() == list(range(10, end + 1, 10))
        assert len(analysis_rows(os.path.join(sim.run_dir, "ds.data"))) == 1


def test_analysis_command_writes_every_file(tmp_path):
    """`analysis` in ddcMD_CMDS after the first dispatch (loop 10)
    evaluates and writes every registered analysis there, printStress's
    too, though none of their rates divides 10."""
    objs = {"vcm": "type=VCMWRITE; eval_rate=40; outputrate=40;",
            "zd": "type=ZDENSITY; eval_rate=40; outputrate=40;",
            "aj": "type=ACKLAND_JONES; eval_rate=40; outputrate=40;"}
    d = _deck(str(tmp_path / "d"), objs)
    sim = _port(d)
    with open(os.path.join(sim.run_dir, "ddcMD_CMDS"), "w") as f:
        f.write("analysis\n")
    sim.run(10, **QUIET)
    rd = sim.run_dir
    # the command's output wrote the rows; the run's end finds none left
    assert analysis_rows(os.path.join(rd, "vcm.data"))[:, 0].tolist() == [10]
    stress = analysis_rows(os.path.join(rd, "stress.data"))
    assert stress[:, 0].tolist() == [10]
    assert os.path.exists(os.path.join(rd, "zdensity.dat"))
    # ACKLAND_JONES writes its last classification at every output
    with open(os.path.join(rd, "acklandJones.dat")) as f:
        assert [ln.split()[0] for ln in f] == ["loop=10", "loop=10"]


def test_rescan_moves_the_rates_and_rolls_back(tmp_path):
    """ddcMD_CMDS object text after loop 20 sets vcm's eval_rate 10: its
    later rows come 10 apart (the dispatches end on them).  The text
    names an ANALYSIS object, and the poll matches its command words
    anywhere in the text (as the JAX package's does), so it also runs
    the `analysis` command: a second row at 20.  A second text with
    eval_rate=abc fails the rescan after loop 50: a warning, and every
    analysis keeps the rates it had (and the command adds a row at
    50)."""
    objs = {"vcm": "type=VCMWRITE; eval_rate=20; outputrate=20;",
            "ke": "type=KINETICENERGYDISTN; evalrate=20; outputrate=20;"}
    d = _deck(str(tmp_path / "d"), objs, print_stress=False)
    sim = _port(d)
    cmds = os.path.join(sim.run_dir, "ddcMD_CMDS")
    with open(cmds, "w") as f:
        f.write("vcm ANALYSIS { type=VCMWRITE; eval_rate=10; "
                "outputrate=20; }\n")
    sim.run(40, **QUIET)
    vcm = os.path.join(sim.run_dir, "vcm.data")
    assert analysis_rows(vcm)[:, 0].tolist() == [20, 20, 30, 40]
    assert [(a.eval_rate, a.output_rate) for a in sim.analyses] == [
        (10, 20), (20, 20)]
    with open(cmds, "w") as f:
        f.write("vcm ANALYSIS { type=VCMWRITE; eval_rate=5; }\n"
                "ke ANALYSIS { type=KINETICENERGYDISTN; evalrate=abc; }\n")
    with pytest.warns(UserWarning, match="rescan failed"):
        sim.run(20, **QUIET)
    assert [(a.eval_rate, a.output_rate) for a in sim.analyses] == [
        (10, 20), (20, 20)]
    assert sim.db.get("vcm", "ANALYSIS").get_int("eval_rate", 0) == 10
    assert sim.db.get("ke", "ANALYSIS").get_int("evalrate", 0) == 20
    assert analysis_rows(vcm)[:, 0].tolist() == [20, 20, 30, 40, 50, 50,
                                                  60]


def test_analysis_sees_the_state_before_a_transform(tmp_path):
    """VCMWRITE and an ADDVELOCITY (1e-4 A/fs in x) both at rate 20: the
    row at loop 20 is the centre-of-mass velocity before the first kick,
    the row at 40 after one kick and before the second."""
    objs = {"vcm": "type=VCMWRITE; eval_rate=20; outputrate=20;"}
    kick = ("kick TRANSFORM { type=ADDVELOCITY; velocity=1e-4 0 0 "
            "Angstrom/fs; rate=20; }\n")
    d = _deck(str(tmp_path / "d"), objs, print_stress=False, extra=kick)
    chip_smoke.edit_deck(os.path.join(d, "object.data"), lambda s: s.replace(
        "type=MD;", "type=MD; transform=kick;", 1))
    sim = _port(d)
    vcm0 = float(sim.ss.state.v[:400, 0].mean())
    sim.run(40, **QUIET)
    rows = analysis_rows(os.path.join(sim.run_dir, "vcm.data"))
    assert rows[:, 0].tolist() == [20, 40]
    # 1e-4 A/fs = 0.01 nm/ps; FREE water conserves its momentum
    assert rows[0, 1] == pytest.approx(vcm0, abs=1e-9)
    assert rows[1, 1] == pytest.approx(vcm0 + 0.01, abs=1e-9)


def test_analysis_master_equals_jax(tmp_path, capsys):
    """The analysis master on a deck whose SIMULATE lists none: every
    ANALYSIS object of the deck (an unknown type skipped, as DeckError)
    evaluated and written once after the first energy, in f64, the same
    files as the JAX package's analysis_master; and through the CLI."""
    objs = {k: ANALYSES[k] for k in ("gr", "vcm", "zd", "sw", "fa", "cs",
                                     "qu", "ds")}
    d = str(tmp_path / "d")
    os.makedirs(d)
    deck = chip_smoke.water_deck(d, 400, printrate=20, free=True)
    chip_smoke.edit_deck(deck, lambda s: s + "".join(
        f"{k} ANALYSIS {{ {v} }}\n" for k, v in objs.items())
        + "bad ANALYSIS { type=NOPE; }\n")
    from ddcmd_tpu_torch.run.masters import analysis_master

    jd, td, cd = (str(tmp_path / w) for w in ("j", "t", "c"))
    for x in (jd, td):
        os.makedirs(x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = j_analysis_master(*j_load(d), run_dir=jd, dtype=jnp.float64)
    ts = analysis_master(*t_load(d), run_dir=td, device="cpu",
                         dtype=torch.float64)
    assert [a.name for a in ts.analyses] == [a.name for a in js.analyses] \
        == list(objs)
    jf, tf = analysis_files(jd), analysis_files(td)
    assert len(tf) == len(objs)
    same_files(jf, tf, 1e-9)
    sim = cli.run(["analysis", "-o", deck, "--run-dir", cd, "--device",
                   "cpu", "--f64"])
    assert sim.ss.loop == 0 and len(sim.analyses) == len(objs)
    same_files(tf, analysis_files(cd), 1e-12)
