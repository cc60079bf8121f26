"""Slice 16, transforms through Simulation (ROADMAP item 24a) against the
JAX package in f64 on the CPU: Simulation.apply_transform on both of
its paths and the transform master through the CLI.  (SIMULATE
transform= at its rate: tests/test_torch_transform_run.py; the rates'
cadence, their rescan, item 29 and the change of kernel:
tests/test_torch_transform_rates.py.)

Tolerances: after apply_transform, n, the box, r, v and the first
energy within 1e-10 relative (r of the box edge, v of the largest |v|),
the gids and names equal; a replica's first energy 2x the original's
within 1e-10; the transform master's checkpoints equal, |p| < 1e-8 after
SETVELOCITY vcm=0."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ddcmd_tpu.io.collection import read_collection as j_read_collection
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.masters import transform_master as j_transform_master
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.collection import read_collection
from ddcmd_tpu_torch.models import martini_water, write_atoms
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.run import cli
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)
RTOL = 1e-10


def _water(tmp_path, n=400):
    d = str(tmp_path / "deck")
    os.makedirs(d)
    martini_water(d, n=n)
    return d


def _append_file(d, k=6):
    """extra/atoms#000000: k beads of the deck's species at the free
    spots of its box (the grid points farthest from every bead)."""
    col = read_collection("atoms#", d)
    L = float(col.header.get_floatv("h")[0])          # Angstrom
    r = col.r * 10.0
    g = (np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / 8 * L - L / 2
    dr = g[:, None, :] - r[None, :, :]
    dr -= L * np.round(dr / L)
    far = np.sqrt((dr ** 2).sum(-1)).min(1)
    pick = []
    for i in np.argsort(-far):
        dp = g[pick] - g[i]
        dp -= L * np.round(dp / L)
        if not pick or np.sqrt((dp ** 2).sum(-1)).min() > 4.0:
            pick.append(i)
        if len(pick) == k:
            break
    os.makedirs(os.path.join(d, "extra"))
    write_atoms(os.path.join(d, "extra", "atoms#000000"), g[pick],
                np.full((k, 3), 1e-3), [col.species_names[0]] * k,
                [col.group_names[0]] * k, np.diag([L] * 3))


def _sims(d, extra):
    """The deck in d with `extra` compiled in, in both packages (f64)."""
    jdb, jb = j_load(d)
    tdb, tb = t_load(d)
    jdb.compile_string(extra)
    tdb.compile_string(extra)
    return (JSimulation(jdb, jb, run_dir=d, dtype=jnp.float64),
            TSimulation(tdb, tb, run_dir=d, device="cpu",
                        dtype=torch.float64))


def _held_to_jax(js, ts, rtol=RTOL):
    """n, box, r, v, gids, names and energy of ts against js."""
    n = ts.sysdef.state.n_local
    assert js.sysdef.state.n_local == n
    h = ts.ss.box.h.numpy()
    np.testing.assert_allclose(h, np.asarray(js.ss.box.h), rtol=rtol)
    edge = float(np.abs(np.diagonal(h)).max())
    np.testing.assert_allclose(ts.ss.state.r[:n].numpy(),
                               np.asarray(js.ss.state.r[:n]), rtol=0,
                               atol=rtol * edge)
    jv = np.asarray(js.ss.state.v[:n])
    np.testing.assert_allclose(ts.ss.state.v[:n].numpy(), jv, rtol=0,
                               atol=rtol * max(np.abs(jv).max(), 1e-30))
    tc, jc = ts.sysdef.collection, js.sysdef.collection
    np.testing.assert_array_equal(ts.ss.state.gid[:n],
                                  js.ss.state.gid64()[:n])
    np.testing.assert_array_equal(tc.gid, jc.gid)
    assert (tc.species_names, tc.group_names, tc.class_names) == (
        jc.species_names, jc.group_names, jc.class_names)
    e_t, e_j = float(ts.ss.energy.eion), float(js.ss.energy.eion)
    assert e_t == pytest.approx(e_j, rel=rtol)
    return n, e_t


def _alchemy_deck(tmp_path):
    d = str(tmp_path / "deck")
    os.makedirs(d)
    chip_smoke.lj_deck(d, 300, printrate=10, two=True)
    return d


# (deck, transform text, particle count after / before; None: the rebuild
# path with the same count)
CASES = {
    "SETVELOCITY": (_water, "type=SETVELOCITY; vcm=0.002 0 -0.001 "
                            "Angstrom/fs;", 1),
    "BOX": (_water, "type=BOX; hNew=39.8 0 0 0 39.5 0 0 0 40.2 Angstrom;",
            1),
    "REPLICATE": (_water, "type=REPLICATE; nx=2; ny=1; nz=1;", 2),
    "SELECTSUBSET": (_water, "type=SELECTSUBSET; zmin=0 Angstrom;", None),
    "APPEND": (_water, "type=APPEND; files=extra/atoms#; base_dir={d};",
               None),
    "ALCHEMY": (_alchemy_deck, "type=ALCHEMY; species_from=Ar; "
                               "species_to=Kr;", None),
}


@pytest.mark.parametrize("ttype", list(CASES))
def test_apply_transform_matches_jax(tmp_path, ttype):
    """Simulation.apply_transform on the 400-bead water box (the
    two-species 300-atom LJ fluid for ALCHEMY) in f64: SETVELOCITY and
    BOX on the fast path, REPLICATE 2x1x1, SELECTSUBSET, APPEND and
    ALCHEMY on the rebuild path; the state and the first energy after it
    held to the JAX package's; the replica's energy is 2x."""
    make, text, ratio = CASES[ttype]
    d = make(tmp_path)
    if ttype == "APPEND":
        _append_file(d)
    js, ts = _sims(d, f"t TRANSFORM {{ {text.format(d=d)} }}\n")
    js.first_energy()
    ts.first_energy()
    n0, e0 = _held_to_jax(js, ts)
    step0 = ts.step_fn
    js.apply_transform(js.db.get("t", "TRANSFORM"))
    ts.apply_transform(ts.db.get("t", "TRANSFORM"))
    n1, e1 = _held_to_jax(js, ts)
    # the fast path keeps the step; the rebuild path derives a new one
    assert (ts.step_fn is step0) == (ttype in ("SETVELOCITY", "BOX"))
    if ratio is not None:
        assert n1 == ratio * n0
    if ttype == "REPLICATE":
        assert e1 == pytest.approx(2.0 * e0, rel=RTOL)
        assert len(set(ts.sysdef.collection.gid)) == n1
    if ttype == "SELECTSUBSET":
        assert 0.4 * n0 < n1 < 0.6 * n0
        assert float(ts.ss.state.r[:n1, 2].min()) >= 0.0
    if ttype == "APPEND":
        assert n1 == n0 + 6
        m = ts.ss.state.mass[:n1].numpy()
        assert np.all(m == m[0])      # the species' mass, not APPEND's 1
    if ttype == "ALCHEMY":
        assert set(ts.sysdef.collection.species_names) == {"Kr"}


def test_transform_master_matches_jax(tmp_path):
    """The transform master through `cli.run(["transform", ...,
    "--device", "cpu", "--f64"])` on the 400-bead water box with a
    THERMALIZE and a SETVELOCITY vcm=0 object, against the JAX package's
    transform_master in f64: the checkpoints' r and v equal, |p| < 1e-8,
    the restart loads."""
    d = _water(tmp_path)
    deck = os.path.join(d, "object.data")
    with open(deck, "a") as f:
        f.write("therm TRANSFORM { type=THERMALIZE; temperature=310 K; "
                "seed=3; }\nvcmkill TRANSFORM { type=SETVELOCITY; "
                "vcm=0 0 0; }\n")
    td, jd = str(tmp_path / "torch"), str(tmp_path / "jax")
    sim = cli.run(["transform", "-o", deck, "--run-dir", td, "--device",
                   "cpu", "--f64"])
    os.makedirs(jd)
    j_transform_master(*j_load(d), run_dir=jd, dtype=jnp.float64)
    snap = "snapshot.000000/atoms#"
    a, b = read_collection(snap, td), j_read_collection(snap, jd)
    np.testing.assert_array_equal(a.r, b.r)
    np.testing.assert_array_equal(a.v, b.v)
    assert float(np.abs(a.v).max()) > 0
    n = sim.sysdef.state.n_local
    m = sim.ss.state.mass[:n].numpy()
    p = (m[:, None] * sim.ss.state.v[:n].numpy()).sum(0)
    assert np.abs(p).max() < 1e-8
    db, _ = t_load(d, restart=os.path.join(td, "restart"))
    back = TSimulation(db, td, run_dir=td, device="cpu", dtype=torch.float64)
    assert back.ss.state.n_local == n
