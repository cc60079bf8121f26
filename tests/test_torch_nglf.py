"""The port's GROUP half-kicks and NGLF step against the JAX package,
fed JAX's own thermostat noise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddcmd_tpu.core.groups import Group as JGroup
from ddcmd_tpu.core.groups import GroupTable as JGroupTable
from ddcmd_tpu.core.groups import velocity_update as j_velocity_update
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_water
from ddcmd_tpu.objects.eq import eq_parse
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.core.groups import Group as TGroup
from ddcmd_tpu_torch.core.groups import GroupTable as TGroupTable
from ddcmd_tpu_torch.core.groups import kick_noise
from ddcmd_tpu_torch.core.groups import velocity_update as t_velocity_update
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)


def _jax_kick_noise(key, shape):
    """The two draws the JAX NGLF step makes (nglf.py:131)."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, 0))
    return (np.asarray(jax.random.normal(k1, shape, dtype=jnp.float32)),
            np.asarray(jax.random.normal(k2, shape, dtype=jnp.float32)))


@pytest.mark.parametrize("mode", ["front", "back"])
def test_kick_matches_jax_with_jax_noise(mode):
    """LANGEVIN + FREE affine half-kick (padding rows included) == the
    JAX velocity_update given the same standard-normal draw."""
    rng = np.random.default_rng(5)
    n_pad, n = 256, 200
    v = rng.standard_normal((n_pad, 3)).astype(np.float32)
    f = (rng.standard_normal((n_pad, 3)) * 50).astype(np.float32)
    mass = rng.uniform(40, 90, n_pad).astype(np.float32)
    gid = rng.integers(0, 2, n_pad)
    mask = np.arange(n_pad) < n
    teq = eq_parse("RAMP(300,340,0,10ps)", "T", "t")
    jt = JGroupTable.build([JGroup("bath", 0, "LANGEVIN", Teq=teq, tau=0.8),
                            JGroup("free", 1, "FREE")])
    tt = TGroupTable.build([TGroup("bath", 0, "LANGEVIN", Teq=teq, tau=0.8),
                            TGroup("free", 1, "FREE")])
    half = 0.01
    jc = jt.coefficients(2.5, half)
    tc = tt.coefficients(2.5, half)
    key = jax.random.PRNGKey(3)
    g = _jax_kick_noise(key, (n_pad, 3))[0 if mode == "front" else 1]
    k1, k2 = jax.random.split(jax.random.fold_in(key, 0))
    jv = j_velocity_update(mode, jnp.asarray(v), jnp.asarray(f),
                           jnp.asarray(mass), jnp.asarray(gid, jnp.int32),
                           jc, half, k1 if mode == "front" else k2,
                           jnp.asarray(mask), has_berendsen=False)
    tv = t_velocity_update(mode, torch.tensor(v), torch.tensor(f),
                           torch.tensor(mass), torch.tensor(gid), tc, half,
                           torch.tensor(g), torch.tensor(mask))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    assert np.all(tv.numpy()[n:] == 0.0)


def test_kick_noise_is_keyed_by_step_and_callsite():
    """Same (seed, step, callsite) -> same draw, whatever came before;
    another step or callsite -> another draw."""
    g = torch.Generator()
    a = kick_noise(g, 7, 120, 0, (64, 3))
    kick_noise(g, 7, 121, 0, (64, 3))
    b = kick_noise(g, 7, 120, 0, (64, 3))
    c = kick_noise(g, 7, 120, 1, (64, 3))
    d = kick_noise(g, 8, 120, 0, (64, 3))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert abs(float(a.mean())) < 0.3 and 0.7 < float(a.std()) < 1.3


def test_one_nglf_step_matches_jax(tmp_path):
    """From an identical state (random velocities, LANGEVIN group), one
    port NGLF step with JAX's noise == one JAX step (cell-block engine)."""
    martini_water(str(tmp_path), n=400)
    jdb, base = j_load(str(tmp_path))
    tdb, _ = t_load(str(tmp_path))
    jsim = JSimulation(jdb, base, run_dir=str(tmp_path), engine="cellblock")
    tsim = TSimulation(tdb, base, run_dir=str(tmp_path), device="cpu")
    n_pad = jsim.ss.state.n_pad
    n = jsim.ss.state.n_local
    v0 = np.zeros((n_pad, 3), np.float32)
    v0[:n] = np.random.default_rng(4).standard_normal((n, 3)) * 0.3
    jsim.ss = jsim.ss.replace(state=jsim.ss.state.replace(v=jnp.asarray(v0)))
    tsim.ss = tsim.ss.replace(state=tsim.ss.state.replace(v=torch.tensor(v0)))
    jsim.first_energy()
    tsim.first_energy()

    key = jax.random.PRNGKey(11)
    g1, g2 = _jax_kick_noise(key, (n_pad, 3))
    jss, jperm, _ = jsim._build_nbr_jit(jsim.ss)
    j1 = jsim.step_fn(jss, jperm, key, jsim.coeffs)
    tss, tperm, _ = tsim._build_nbr(tsim.ss)
    t1 = tsim.step_fn(tss, tperm, tsim.coeffs, torch.tensor(g1),
                      torch.tensor(g2))

    assert t1.loop == int(j1.loop) and t1.time == pytest.approx(float(j1.time))
    np.testing.assert_allclose(t1.state.r.numpy(), np.asarray(j1.state.r),
                               rtol=0, atol=1e-5)
    fj = np.asarray(j1.state.f)
    scale = max(1.0, float(np.abs(fj).max()))
    assert np.abs(t1.state.f.numpy() - fj).max() / scale < 2e-5
    np.testing.assert_allclose(t1.state.v.numpy(), np.asarray(j1.state.v),
                               rtol=1e-4, atol=1e-5)
    assert float(t1.energy.eion) == pytest.approx(float(j1.energy.eion),
                                                  rel=1e-4, abs=1e-2)
    assert float(t1.energy.rk) == pytest.approx(float(j1.energy.rk),
                                                rel=1e-4)
    np.testing.assert_allclose(t1.energy.virial.numpy(),
                               np.asarray(j1.energy.virial), rtol=2e-3,
                               atol=0.5)
