"""Slice 15, the NaN rollback ladder of Simulation (ROADMAP item 23,
port-only): a one-shot non-finite dispatch is redone with fresh noise
(kick_noise's attempt 1), a persistent one raises the kill switch after
3 retries with its checkpoint written and the restart link unmoved, the
DDCMD_BLOWUP_DUMP record, and the noise a stale redo and a restart
replay (attempt 0); tests/test_masters.py:145-162 in the JAX package."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from ddcmd_tpu_torch.core.groups import kick_noise
from ddcmd_tpu_torch.io.restart import write_checkpoint
from ddcmd_tpu_torch.models import lj_fluid, martini_water
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
from test_torch_runtime import QUIET

torch.set_num_threads(2)


def test_one_shot_nan_is_rolled_back_with_fresh_noise(tmp_path):
    """A NaN on the last step of the second dispatch: the dispatch is
    redone once (redos["nan"] == 1) with a warning naming the step and
    the dispatch; the retry draws other noise than the first attempt,
    and every other dispatch draws kick_noise at attempt 0."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    fired = chip_smoke.nan_once(sim, 20)
    draws = chip_smoke.record_noise(sim)
    with pytest.warns(UserWarning, match=r"non-finite energy at step 20 "
                      r"\(chunk 10\+10.*atom row 0; rollback retry 1/3"):
        sim.run(30, max_steps_per_dispatch=10, **QUIET)
    assert fired and sim.ss.loop == 30
    assert sim.redos == {"stale": 0, "overflow": 0, "nan": 1}
    assert np.isfinite(sim.ss.state.v.numpy()).all()
    attempts = {(s, a): x for s, a, x in draws}
    assert sorted(attempts) == sorted(
        [(s, 0) for s in range(30)] + [(s, 1) for s in range(10, 20)])
    for s in range(10, 20):
        assert not torch.equal(attempts[(s, 0)], attempts[(s, 1)])
    gen = torch.Generator()
    for s in (*range(10), *range(20, 30)):
        assert torch.equal(attempts[(s, 0)], kick_noise(
            gen, sim.sysdef.random_seed, s, 0, (2, 384, 3),
            dtype=torch.float64))


def test_persistent_nan_raises_the_kill_switch(tmp_path):
    """Two beads on one site (infinite LJ) after a checkpoint: every
    retry is non-finite, and after 3 retries the pre-dispatch state is
    written without moving the restart link and FloatingPointError
    names the kill switch (tests/test_masters.py:145-162)."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    sim.run(10, **QUIET)
    write_checkpoint(sim, d)
    sim.run(10, **QUIET)
    r = sim.ss.state.r.clone()
    r[1] = r[0]
    sim.ss = sim.ss.replace(state=sim.ss.state.replace(r=r))
    with pytest.warns(UserWarning, match="rollback retry 3/3"), \
            pytest.raises(FloatingPointError, match="kill switch"):
        sim.run(10, **QUIET)
    assert sim.redos["nan"] == 3 and sim.ss.loop == 20
    assert os.path.exists(os.path.join(d, "snapshot.000020", "restart"))
    assert os.readlink(os.path.join(d, "restart")) == \
        os.path.join("snapshot.000010", "restart")


def test_blowup_dump_records_the_noise_key(tmp_path, monkeypatch):
    """DDCMD_BLOWUP_DUMP: the first NaN writes the pre-dispatch checkpoint
    and an .npz with the dispatch's noise key (seed, first loop,
    attempt) and the hottest particle's trace."""
    d = str(tmp_path / "deck")
    os.makedirs(d)
    lj_fluid(d, n=300)
    dump = str(tmp_path / "blowup.npz")
    monkeypatch.setenv("DDCMD_BLOWUP_DUMP", dump)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    chip_smoke.nan_once(sim, 20)
    with pytest.warns(UserWarning, match="non-finite"):
        sim.run(20, max_steps_per_dispatch=10, **QUIET)
    z = np.load(dump)
    assert (int(z["seed"]), int(z["loop0"]), int(z["attempt"]),
            int(z["bad"]), int(z["hot_row"])) == (
        sim.sysdef.random_seed, 10, 0, 9, 0)
    assert str(z["snapdir"]).endswith("snapshot.000010")
    assert len(z["vmax2"]) == 10 and np.isnan(z["vmax2"][-1])


def test_stale_redo_and_restart_replay_the_noise(tmp_path):
    """kick_noise's attempt: 0 is the step's noise, 1-3 differ.  A stale
    redo draws the same noise at attempt 0 as the dispatch it redoes,
    and a Simulation restarted at loop 20 draws what the run drew."""
    gen = torch.Generator()
    a0 = kick_noise(gen, 7, 120, 0, (64, 3))
    assert torch.equal(a0, kick_noise(gen, 7, 120, 0, (64, 3), attempt=0))
    for a in (1, 2, 3):
        assert not torch.equal(a0, kick_noise(gen, 7, 120, 0, (64, 3),
                                              attempt=a))
    d = str(tmp_path / "w")
    os.makedirs(d)
    martini_water(d, n=400)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu",
                      dtype=torch.float64)
    draws = chip_smoke.record_noise(sim)
    with pytest.warns(UserWarning, match="stale"):
        sim.run(20, **QUIET)
    assert sim.redos["stale"] >= 1
    by_step = {}
    for s, a, x in draws:
        assert a == 0
        by_step.setdefault(s, []).append(x)
    assert any(len(v) > 1 for v in by_step.values())
    for v in by_step.values():
        assert all(torch.equal(v[0], x) for x in v[1:])
    write_checkpoint(sim, d)
    sim.run(10, **QUIET)
    back = TSimulation(*t_load(d, restart=os.path.join(d, "restart")),
                       run_dir=d, device="cpu", dtype=torch.float64)
    again = chip_smoke.record_noise(back)
    back.run(10, **QUIET)
    first = {s: x for s, a, x in draws if s >= 20}
    assert [s for s, _, _ in again][:10] == list(range(20, 30))
    for s, _, x in again:
        assert torch.equal(first[s], x)
