"""Slice 15, the masters through the port's CLI on the CPU (ROADMAP item
23), and testPressure's tables against the JAX package's (f64, rel
1e-9): thermalize, readWrite (positions bit-equal through the codec),
eightFold, testForce, testPressure and integrationTest with --device
cpu; analysis and transform raise naming item 24; unitTest's pytest
command; integrationTest's pass and fail; testPressure's slope check on
a broken virial and its molecular sweep."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.testpressure import testpressure_master as j_testpressure
from ddcmd_tpu_torch.models import lj_fluid, martini_water
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run import cli
from ddcmd_tpu_torch.run import masters as t_masters
from ddcmd_tpu_torch.run import testpressure as t_tp
from ddcmd_tpu_torch.run.testpressure import \
    testpressure_master as t_testpressure
from test_torch_masters import _deck

torch.set_num_threads(2)


def test_testpressure_tables_match_jax(tmp_path):
    """The per-axis sweeps (delta0 1e-2, 9 halvings) of a 300-atom LJ fluid
    in f64: pressure{ax}.data against the JAX package's (rel 1e-9), the
    slope check passes, the best error under 1e-6 of |P_virial|."""
    d = _deck(tmp_path, lambda d: lj_fluid(d, n=300))
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jd)
    os.makedirs(td)
    kw = dict(delta0=1e-2, n_halvings=9, verbose=False)
    res = t_testpressure(*t_load(d), device="cpu", out_dir=td, **kw)
    j_testpressure(*j_load(d), dtype=jnp.float64, out_dir=jd, **kw)
    assert res["molecular"] is None
    for ax, p_vir, rows in res["atomic"]:
        a = np.loadtxt(os.path.join(td, f"pressure{ax}.data"))
        b = np.loadtxt(os.path.join(jd, f"pressure{ax}.data"))
        assert a.shape == (10, 4)
        np.testing.assert_allclose(a[:, :2], b[:, :2], rtol=1e-9)
        np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=1e-6,
                                   atol=1e-9 * abs(p_vir))
        assert min(r[2] for r in rows) < 1e-6 * max(abs(p_vir), 1e-6)


def test_testpressure_slope_check_catches_a_broken_virial(tmp_path):
    """A virial off by 1% plateaus: _check_quadratic raises."""
    d = _deck(tmp_path, lambda d: lj_fluid(d, n=300))
    res = t_testpressure(*t_load(d), device="cpu", delta0=1e-2,
                         n_halvings=9, out_dir=d, check_slope=False,
                         verbose=False)
    ax, p_vir, rows = res["atomic"][0]
    t_tp._check_quadratic(rows, ax, "atomic virial", p_vir)
    broken = [(dd, p, abs(p - 1.01 * p_vir)) for dd, p, _ in rows]
    with pytest.raises(AssertionError, match=r"delta\^2"):
        t_tp._check_quadratic(broken, ax, "atomic virial")


def test_testpressure_molecular_sweep_runs(tmp_path):
    """A deck with multi-bead molecules (the nx = 4 bilayer) also sweeps
    the molecular virial: pressureMol{ax}.data, finite pressures."""
    from ddcmd_tpu_torch.models import martini_bilayer

    d = _deck(tmp_path, lambda d: martini_bilayer(d, nx=4, ny=4,
                                                  water_nm=1.0))
    res = t_testpressure(*t_load(d), device="cpu", delta0=5e-3,
                         n_halvings=2, out_dir=d, check_slope=False,
                         verbose=False)
    assert len(res["molecular"]) == 3
    for ax, p_vir, rows in res["molecular"]:
        assert os.path.exists(os.path.join(d, f"pressureMol{ax}.data"))
        assert np.isfinite(p_vir) and all(np.isfinite(r[1]) for r in rows)


def test_integration_test_master(tmp_path):
    """martini against martini passes; two PAIR potentials of different
    well depths fail with AssertionError naming the pair."""
    d = _deck(tmp_path, lambda d: martini_water(d, n=400))
    with open(os.path.join(d, "object.data"), "a") as f:
        f.write("it INTEGRATIONTEST { testPotentialPotential=martini "
                "martini; }\n")
    _, res = t_masters.integration_test_master(*t_load(d), device="cpu")
    assert res == [("martini", "martini", 0.0)]
    d2 = _deck(tmp_path, lambda d: lj_fluid(d, n=300), "lj")
    p = os.path.join(d2, "object.data")
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(text.replace("potential=pot;", "potential=pot pot2;")
                + "pot2 POTENTIAL { type=PAIR; cutoff=8.5 Angstrom; "
                "eps=0.0208 eV; sigma=3.4 Angstrom; }\n"
                "it INTEGRATIONTEST { testPotentialPotential=pot pot2; }\n")
    with pytest.raises(AssertionError, match="pot.*pot2"):
        t_masters.integration_test_master(*t_load(d2), device="cpu")


@pytest.mark.parametrize("tier,slow", [("fast", True), ("full", False)])
def test_unit_test_master_command(monkeypatch, tier, slow):
    """unitTest runs the port's own suite, tests/test_torch_*.py, with
    -m "not slow" unless the tier is full."""
    import subprocess

    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: calls.append(cmd) or 0)
    monkeypatch.setenv("DDCMD_UNITTEST_TIER", tier)
    assert cli.main(["unitTest"]) == 0
    (cmd,) = calls
    files = [c for c in cmd if c.endswith(".py")]
    here = os.path.dirname(os.path.abspath(__file__))
    assert cmd[1:3] == ["-m", "pytest"]
    assert sorted(os.path.basename(f) for f in files) == sorted(
        f for f in os.listdir(here)
        if f.startswith("test_torch_") and f.endswith(".py"))
    assert any(f.endswith("test_torch_masters.py") for f in files)
    assert (cmd[-2:] == ["-m", "not slow"]) == slow


def test_cli_runs_every_master(tmp_path):
    """thermalize, readWrite, eightFold, testForce, testPressure and
    integrationTest through `cli.run --device cpu` on the 400-bead water
    box; readWrite's positions come back bit-equal through the codec;
    analysis and transform raise naming item 24."""
    from ddcmd_tpu_torch.run.simulate import Simulation

    d = _deck(tmp_path, lambda d: martini_water(d, n=400))
    with open(os.path.join(d, "object.data"), "a") as f:
        f.write("it INTEGRATIONTEST { testPotentialPotential=martini "
                "martini; }\n")
    deck = os.path.join(d, "object.data")

    def run(master, *extra, run_dir=None):
        rd = str(tmp_path / (run_dir or master))
        return cli.run([master, "-o", deck, "--run-dir", rd, "--device",
                        "cpu", *extra]), rd

    sim, rd = run("readWrite")
    db, _ = t_load(d, restart=os.path.join(rd, "restart"))
    back = Simulation(db, rd, run_dir=rd, device="cpu")
    assert torch.equal(back.ss.state.r, sim.ss.state.r)
    sim, rd = run("thermalize")
    assert float(sim.ss.state.v.abs().max()) > 0
    sim, rd = run("eightFold")
    assert os.path.exists(os.path.join(rd, "snapshot.8fold", "restart"))
    (worst, rows), _ = run("testForce", "--f64")
    assert worst < 5e-3
    res, rd = run("testPressure")
    assert len(res["atomic"]) == 3
    assert os.path.exists(os.path.join(rd, "pressure2.data"))
    (_, it), _ = run("integrationTest")
    assert it[0][2] == 0.0
    for master in ("analysis", "transform"):
        with pytest.raises(NotImplementedError, match="item 24"):
            run(master)
