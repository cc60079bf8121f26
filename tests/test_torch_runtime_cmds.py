"""Slice 15, the run-time commands of Simulation (ROADMAP item 23,
port-only): the ddcMD_CMDS file (checkpoint, exit, kill, stop, hpm,
profile, and object text that is compiled and rescanned), the phase
profile, max_seconds.  The rescan moves a LANGEVIN Teq and the run's
temperature follows (tests/test_masters.py:184-225 in the JAX
package)."""

import os

import pytest
import torch

from ddcmd_tpu_torch.io.restart import write_checkpoint
from ddcmd_tpu_torch.models import lj_fluid
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
from ddcmd_tpu_torch.utils.profile import PROFILE
from test_torch_runtime import QUIET, _two_group_lj

torch.set_num_threads(2)


def _cmds(d, text):
    with open(os.path.join(d, "ddcMD_CMDS"), "w") as f:
        f.write(text)


@pytest.mark.parametrize("cmd,stop_at,ckpt", [
    ("checkpoint exit\n", 10, 10), ("EXIT\n", 10, 10), ("kill\n", 10, None),
    ("stop\n", 10, None), ("checkpoint\n", 30, 10), ("hpm\n", 30, None)])
def test_command_file_acts_and_is_consumed(tmp_path, capsys, cmd, stop_at,
                                           ckpt):
    """checkpoint / exit / kill / stop / hpm after the first dispatch:
    the file is removed, exit checkpoints and stops, kill and stop stop
    without one, checkpoint alone runs on."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    _cmds(d, cmd)
    sim.run(30, on_checkpoint=lambda s: write_checkpoint(s, d),
            max_steps_per_dispatch=10, **QUIET)
    assert sim.ss.loop == stop_at
    assert not os.path.exists(os.path.join(d, "ddcMD_CMDS"))
    link = os.path.join(d, "restart")
    assert (os.readlink(link) if os.path.islink(link) else None) == (
        None if ckpt is None else f"snapshot.{ckpt:06d}/restart")
    assert ("hpm: no-op" in capsys.readouterr().out) == (cmd == "hpm\n")


def test_command_file_rescan_moves_teq(tmp_path):
    """Object text in ddcMD_CMDS is compiled and rescanned: both groups'
    Teq 120 K -> 400 K (tau 0.1 ps) reaches the kick coefficients and the
    temperature follows; a RAMP Teq makes the coefficients refresh every
    dispatch; a new integrator T rebuilds the step."""
    d = _two_group_lj(tmp_path, n=300, graphs=False,
                      groups="type=LANGEVIN; Teq=120K; tau=0.5ps;")
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    sim.run(20, max_steps_per_dispatch=10, **QUIET)
    noise0 = sim.coeffs[2].clone()
    t0 = sim.ss.energy.rk
    _cmds(d, "top GROUP { type=LANGEVIN; Teq=400K; tau=0.1ps; }\n"
          "bot GROUP { type=LANGEVIN; Teq=400K; tau=0.1ps; }\n")
    sim.run(100, max_steps_per_dispatch=10, **QUIET)
    assert [float(g.Teq(0.0)) for g in sim.sysdef.groups] == [400.0, 400.0]
    assert not torch.equal(sim.coeffs[2], noise0)
    assert float(sim.ss.energy.rk) > 2.0 * float(t0)
    assert not sim._refresh_coeffs
    step0 = sim.step_fn
    _cmds(d, "top GROUP { type=LANGEVIN; Teq=RAMP(400,500,0,10ps); "
          "tau=0.1ps; }\ninteg INTEGRATOR { type=NGLF; T=400K; }\n")
    sim.run(10, **QUIET)
    assert sim._refresh_coeffs and sim.step_fn is not step0
    assert sim.sysdef.integrator_parms["T"] == pytest.approx(400.0)


def test_profile_command_and_phases(tmp_path, capsys):
    """`profile` in ddcMD_CMDS times the rebuild, the force, the group
    kick and the fused step into PROFILE and prints the table;
    profile_phases(detail=True) adds each force term; the run's loop,
    md_steps and printinfo spans are in the table, and each checkpoint
    writes it into its snapshot."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    _cmds(d, "profile\n")
    sim.run(20, on_checkpoint=lambda s: write_checkpoint(s, d),
            max_steps_per_dispatch=10, **QUIET)
    for k in ("phase.nbr_rebuild", "phase.force", "phase.group_kick",
              "phase.step_fused", "loop", "printinfo"):
        assert PROFILE.timers[k].total > 0, k
    assert PROFILE.counters["md_steps"] >= 20
    assert "phase.force" in capsys.readouterr().out
    out = sim.profile_phases(n_iter=2, detail=True)
    assert out["phase.term.pair"] > 0 and out["phase.rtt"] > 0
    assert "errors" not in out
    write_checkpoint(sim, d)
    with open(os.path.join(d, "snapshot.000020", "profile")) as f:
        assert "phase.step_fused" in f.read()


def test_max_seconds_stops_after_a_dispatch(tmp_path):
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    sim.run(100, max_seconds=0.0, max_steps_per_dispatch=10, **QUIET)
    assert sim.ss.loop == 10


def test_trace_writes_a_chrome_trace(tmp_path):
    """utils/profile.start_trace / stop_trace wrap torch.profiler: the
    trace of a few steps lands in logdir as a Chrome trace."""
    from ddcmd_tpu_torch.utils.profile import start_trace, stop_trace

    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    logdir = str(tmp_path / "trace")
    prof = start_trace(logdir)
    sim.run(5, **QUIET)
    path = stop_trace(prof, logdir)
    assert path == os.path.join(logdir, "trace.json")
    with open(path) as f:
        assert '"traceEvents"' in f.read()

