"""Slice 14, NPTGLF (integrators/nptglf.py) and NGLFNK
(integrators/nglfnk.py) against the JAX package in f64: one step of each
from the same state, fed JAX's draws (split(fold_in(key, 0)): the kicks'
noise, NGLFNK's g1 and g2), NGLFNK orthorhombic and on the fixed-shape
triclinic path; 20-step Simulation runs without noise (NPTGLF with a
FREE group, NGLFNK at T = 0) at the JAX package's fixed rebuild cadence,
the port's; zeta and bdot through a checkpoint, read back by both
packages; the NVEGLF variants' plain coefficients.

Tolerances: one step and the 20-step runs 1e-10 of each quantity's
scale (r modulo the box, v, h, zeta, bdot); the restart's zeta and bdot
rel 1e-11 (the checkpoint's %.12e text); coefficients exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.restart import write_checkpoint
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)

# the NGLFNK decks start with a moving piston (bdot, A/fs)
_BDOT = " bdot=2e-5 2e-5 -3e-5 Angstrom/fs;"


def _deck(d, kind, noise=True, bdot=True):
    """The 500-atom LJ fluid, LANGEVIN or (without noise) FREE: nptglf
    under NPTGLF (500 bar); nglfnk / nglfnk_tri under NGLFNK (T = 120 K,
    or 0 without noise; with `bdot`, a moving piston at the start), the
    second in a box whose b vector is tilted."""
    d = str(d)
    if kind == "nptglf":
        chip_smoke.lj_deck(d, 500, printrate=10, free=not noise,
                           edit=chip_smoke.nptglf_edit(
                               chip_smoke.SMALL_LJ_GAMMA, 500.0))
        return d
    edit = chip_smoke.chain(
        chip_smoke.nglfnk_edit(W=200.0, P=2000.0),
        lambda t: t.replace("W=200.0 200.0 200.0 amu;",
                            "W=200.0 200.0 200.0 amu;"
                            + (_BDOT if bdot else "")),
        (lambda t: t) if noise else (lambda t: t.replace("T=120.0K;",
                                                         "T=0K;")),
        chip_smoke.tilt_edit if kind == "nglfnk_tri" else (lambda t: t))
    chip_smoke.lj_deck(d, 500, printrate=10, edit=edit)
    return d


def _close(got, ref, what, tol=1e-10):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= tol * scale, (
        what, np.abs(got - ref).max(), scale)


def _frac_diff(a, b, h):
    s = (a - b) @ np.linalg.inv(h).T
    return (s - np.round(s)) @ h.T


def _pair(d):
    js = JSimulation(*j_load(d), run_dir=d, dtype=jnp.float64)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    assert js.engine == ts.engine == "cellblock"
    return js, ts


@pytest.mark.parametrize("kind", ["nptglf", "nglfnk", "nglfnk_tri"])
def test_one_step_matches_jax(tmp_path, kind):
    """From the same state (random velocities) one step of the port's
    integrator with JAX's draws equals one JAX step."""
    d = _deck(tmp_path, kind)
    js, ts = _pair(d)
    n_pad, n = js.ss.state.n_pad, js.ss.state.n_local
    v0 = np.zeros((n_pad, 3))
    v0[:n] = np.random.default_rng(4).standard_normal((n, 3)) * 0.2
    js.ss = js.ss.replace(state=js.ss.state.replace(v=jnp.asarray(v0)))
    ts.ss = ts.ss.replace(state=ts.ss.state.replace(v=torch.tensor(v0)))
    js.first_energy()
    ts.first_energy()
    # the JAX first energy drops bdot (test_jax_first_energy_drops_bdot):
    # start its step from the deck's, as the port's
    js.ss = js.ss.replace(bdot=jnp.asarray(ts.ss.bdot.numpy()))
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 0))
    g1, g2 = (torch.tensor(np.asarray(jax.random.normal(
        k, (n_pad, 3), dtype=jnp.float64))) for k in (k1, k2))
    jss, jperm, _ = js._build_nbr_jit(js.ss)
    j1 = jax.jit(js.step_fn)(jss, jperm, key, js.coeffs)
    tss, tperm, _ = ts._build_nbr(ts.ss)
    t1 = ts.step_fn(tss, tperm, ts.coeffs, g1, g2)
    h = np.asarray(j1.box.h)
    _close(t1.box.h.numpy(), h, "h")
    assert np.abs(_frac_diff(t1.state.r.numpy()[:n],
                             np.asarray(j1.state.r)[:n], h)).max() \
        <= 1e-10 * np.abs(h).max()
    _close(t1.state.v.numpy(), np.asarray(j1.state.v), "v")
    _close(float(t1.zeta), float(j1.zeta), "zeta")
    _close(t1.bdot.numpy(), np.asarray(j1.bdot), "bdot")
    _close(float(t1.energy.eion), float(j1.energy.eion), "eion")
    _close(t1.energy.tion.numpy(), np.asarray(j1.energy.tion), "tion")
    if kind == "nptglf":
        assert float(t1.zeta) != 0.0
    else:
        assert not np.array_equal(t1.bdot.numpy(), ts.ss.bdot.numpy())


@pytest.mark.parametrize("kind", ["nptglf", "nglfnk", "nglfnk_tri"])
def test_runs_match_jax(tmp_path, monkeypatch, kind):
    """20 noiseless steps through both Simulations (the JAX package at
    its fixed rebuild cadence, DDCMD_FIXED_REBUILD=1, the port's), the
    piston at rest at the start: the same positions, velocities, box,
    zeta and bdot."""
    monkeypatch.setenv("DDCMD_FIXED_REBUILD", "1")
    d = _deck(tmp_path, kind, noise=False, bdot=False)
    js, ts = _pair(d)
    js.run(20, print_fn=lambda s: None)
    ts.run(20, print_fn=lambda s: None)
    n = ts.sysdef.state.n_local
    h = np.asarray(js.ss.box.h)
    _close(ts.ss.box.h.numpy(), h, "h")
    assert not np.allclose(h, ts.sysdef.box.h.numpy(), rtol=1e-6)
    assert np.abs(_frac_diff(ts.ss.state.r.numpy()[:n],
                             np.asarray(js.ss.state.r)[:n], h)).max() \
        <= 1e-10 * np.abs(h).max()
    _close(ts.ss.state.v.numpy(), np.asarray(js.ss.state.v), "v")
    _close(float(ts.ss.zeta), float(js.ss.zeta), "zeta")
    _close(ts.ss.bdot.numpy(), np.asarray(js.ss.bdot), "bdot")
    if kind == "nglfnk":
        # Pxx and Pyy averaged, equal W and bdot on x and y: Lx == Ly
        assert float(ts.ss.box.h[0, 0]) == float(ts.ss.box.h[1, 1])


@pytest.mark.parametrize("kind", ["nptglf", "nglfnk"])
def test_restart_carries_zeta_and_bdot(tmp_path, kind):
    """10 port steps, a checkpoint: the port and the JAX package both
    read the checkpoint's zeta (NPTGLF) or bdot (NGLFNK) back."""
    d = _deck(tmp_path, kind)
    ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                     dtype=torch.float64)
    ts.run(10, print_fn=lambda s: None)
    write_checkpoint(ts, d)
    restart = os.path.join(d, "restart")
    text = open(restart).read()
    assert ("zeta=" in text) == (kind == "nptglf")
    assert ("bdot=" in text) == (kind == "nglfnk")
    back = TSimulation(*t_load(d, restart=restart), run_dir=d, device="cpu",
                       dtype=torch.float64)
    jback = JSimulation(*j_load(d, restart=restart), run_dir=d,
                        dtype=jnp.float64)
    assert back.ss.loop == 10
    for got in (float(back.ss.zeta), float(jback.ss.zeta)):
        assert got == pytest.approx(float(ts.ss.zeta), rel=1e-11, abs=0)
    for got in (back.ss.bdot.numpy(), np.asarray(jback.ss.bdot)):
        np.testing.assert_allclose(got, ts.ss.bdot.numpy(), rtol=1e-11,
                                   atol=0)
    if kind == "nptglf":
        assert float(ts.ss.zeta) != 0.0
    else:
        assert np.all(ts.ss.bdot.numpy() != 0.0)


@pytest.mark.parametrize("itype", ["NVEGLF", "NVEGLF_SIMPLE"])
def test_nveglf_plain_coefficients(tmp_path, itype):
    """The NVE variants kick with plain leapfrog coefficients whatever
    the deck's groups (a LANGEVIN group here), as the JAX package's."""
    d = str(tmp_path)
    chip_smoke.lj_deck(d, 500, printrate=10,
                       edit=lambda t: t.replace("type=NGLF;",
                                                f"type={itype};"))
    js, ts = _pair(d)
    assert len(ts.coeffs) == len(js.coeffs) == 6
    for a, b in zip(js.coeffs, ts.coeffs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert not ts._refresh_coeffs
    np.testing.assert_array_equal(ts.coeffs[0].numpy(), [1.0])
    np.testing.assert_array_equal(ts.coeffs[2].numpy(), [0.0])


def test_jax_first_energy_drops_bdot(tmp_path):
    """A reference fault (ROADMAP queue 3): the JAX package reads a
    deck's (or a restart's) NGLFNK bdot into its StepState, and its
    first_energy_call, which every run() starts with, builds a StepState
    without it (nglf.py:216-225), so the piston restarts at rest.  The
    port's first energy keeps it."""
    d = _deck(tmp_path, "nglfnk")
    js, ts = _pair(d)
    bdot = 2e-5 * np.array([1.0, 1.0, -1.5]) * 100.0   # A/fs -> nm/ps
    np.testing.assert_allclose(np.asarray(js.ss.bdot), bdot, rtol=1e-12)
    np.testing.assert_allclose(ts.ss.bdot.numpy(), bdot, rtol=1e-12)
    js.first_energy()
    ts.first_energy()
    assert not np.asarray(js.ss.bdot).any()
    np.testing.assert_allclose(ts.ss.bdot.numpy(), bdot, rtol=1e-12)
