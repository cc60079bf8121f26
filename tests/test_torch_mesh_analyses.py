"""The brick mesh's analyses over 8 gloo ranks: the five sharded evals
(analysis/registry.py eval_sharded) against the gathered eval on view()
and against the JAX package's eval on the same positions, and
run_analyses with its per-class choice of path.

The state is the ORCB-balanced (2,2,2) water box of tests/
torch_mesh_ranks.skewed_water after one 5-step chunk.  g(r), the z
density and the KE histogram are counts and must match exactly; the
centre-of-mass velocity and S(k) sum floats in another order (the
sharded sums in f64 on each rank, then over the mesh; the gathered ones
in numpy over the whole system), so they agree to 1e-6 of their scale.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.analysis.registry import build_analysis as j_build_analysis
from ddcmd_tpu.models import load as j_load

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

SHAPE = (2, 2, 2)
ANALYSES = {
    "gr": "type=PAIRCORRELATION; delta_r=0.02 nm; length=60;",
    "grfar": "type=PAIRCORRELATION; delta_r=0.05 nm; length=40;",
    "vcm": "type=VCMWRITE;",
    "ke": "type=KINETICENERGYDISTN; nBins=50; max=20 kJ/mol;",
    "zd": "type=ZDENSITY; nBins=50;",
    "ssf": "type=SSF; nShells=16; kmax=4 1/nm;",
    "vaf": "type=VELOCITYAUTOCORRELATION;",
}
EXACT = ("gr_hist", "zd_hist", "ke_hist")
FLOAT_TOL = 1e-6


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshan")
    d = str(root / "deck")
    run_dir = str(root / "out")
    import os

    os.makedirs(d)
    os.makedirs(run_dir)
    ranks.skewed_water(d, analyses=ANALYSES)
    ranks.set_loadbalance(d, "BISECTION", update_rate=5)
    out = str(root / "an.npz")
    ranks.run_ranks(ranks.lb_analyses, 8, root, d, SHAPE, 5, run_dir, out)
    return dict(d=d, run_dir=run_dir, z=np.load(out))


def test_sharded_evals_equal_the_gathered_eval(result):
    """Each of the five eval_sharded results against the gathered eval on
    view(): counts exact, floats to 1e-6 of their scale; PAIRCORRELATION
    with rmax = 2.0 nm > rlist = 1.5 nm is not shardable."""
    z = result["z"]
    for name in ("gr", "vcm", "ke", "zd", "ssf"):
        assert bool(z[f"{name}_shardable"]), name
    assert not bool(z["grfar_shardable"])
    assert z["gr_sh_hist"].sum() > 0 and z["zd_sh_hist"].sum() > 0
    for key in EXACT:
        name, field = key.split("_")
        np.testing.assert_array_equal(z[f"{name}_sh_{field}"],
                                      z[f"{name}_ga_{field}"])
    for key in ("vcm_sh_rows", "ssf_sh_acc"):
        a, b = z[key], z[key.replace("_sh_", "_ga_")]
        scale = float(np.abs(b).max())
        assert scale > 0
        assert float(np.abs(a - b).max()) <= FLOAT_TOL * scale, key


def test_sharded_evals_equal_jax(result):
    """The JAX package's eval on the gathered positions and velocities
    (f32, as the mesh holds them) gives the sharded results: the
    histograms exactly, the floats to 1e-6 of their scale."""
    z = result["z"]
    n = len(z["r"])
    L = z["L"]
    state = SimpleNamespace(
        r=jnp.asarray(z["r"], jnp.float32), v=jnp.asarray(z["v"],
                                                          jnp.float32),
        mass=jnp.full((n,), 72.0, jnp.float32),
        fmask=jnp.ones((n,), jnp.float32))
    sim = SimpleNamespace(
        ss=SimpleNamespace(state=state, loop=int(z["loop"]),
                           box=SimpleNamespace(
                               lengths=jnp.asarray(L, jnp.float32),
                               volume=float(np.prod(L)))),
        sysdef=SimpleNamespace(state=SimpleNamespace(n_local=n)))
    db = j_load(result["d"])[0]
    got = {}
    for obj in db.by_class("ANALYSIS"):
        if obj.name in ("gr", "vcm", "ke", "zd", "ssf"):
            a = j_build_analysis(obj.name, obj)
            a.eval(sim)
            got[obj.name] = a.state
    np.testing.assert_array_equal(got["gr"]["hist"], z["gr_sh_hist"])
    np.testing.assert_array_equal(got["zd"]["hist"], z["zd_sh_hist"])
    np.testing.assert_array_equal(got["ke"]["hist"], z["ke_sh_hist"])
    for name, field in (("vcm", "rows"), ("ssf", "acc")):
        b = np.asarray(got[name][field], np.float64)
        scale = float(np.abs(b).max())
        assert float(np.abs(z[f"{name}_sh_{field}"] - b).max()) \
            <= FLOAT_TOL * scale, name


def test_run_analyses_and_view(result):
    """run_analyses evaluates every ANALYSIS object (the far g(r) and the
    VAF on the gathered view) and rank 0 writes each file; view()'s r, v
    and f equal gather_by_gid's."""
    import os

    z = result["z"]
    assert sorted(z["done"].tolist()) == sorted(ANALYSES)
    files = os.listdir(result["run_dir"])
    for name in ("paircorrelation.dat", "vcm.data", "keDistn.dat",
                 "zdensity.dat", "ssf.dat", "vaf.dat"):
        assert name in files, files
    for k in ("r", "v", "f"):
        np.testing.assert_array_equal(z[f"v{k}"], z[k])
    assert np.abs(z["f"]).max() > 0
