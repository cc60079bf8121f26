"""Slice 18, items 29 and 30: a particle-count change on a deck with a
topology, and VELOCITYAUTOCORRELATION across it.

Item 29: Simulation.apply_transform builds the topology anew over the
new collection (core/system.build_topology).  The reference is a
periodic replica's invariants in f64, not the JAX package (its rebuild
keeps the old topology: tests/test_torch_transform_rates.py keeps that
finding): a REPLICATE nx x ny x nz multiplies every force term's energy
and virial, every bonded count, the constraint count, the residue
instances and the molecules by nx ny nz.  Held on the 672-bead
martini_bilayer(nx=4, ny=4) shifted so that lipids straddle the x and
the y boundary, replicated in x, y and z, and on the c36 tripeptide
(CHARMM chain links and a CMAP term, cutoff 9 A under half its 20 A box)
shifted so that the peptide straddles x.  A SELECTSUBSET that cuts a
lipid raises ValueError naming the residue and its gid and leaves the
run as it was; one that keeps whole lipids (zmin=0: the upper leaflet)
rebuilds, and its first energy and forces equal those of a deck built
from the kept molecules (the checkpoint of the selection, read back).

Item 30: VELOCITYAUTOCORRELATION keeps v(0) with its gids; across a
REPLICATE inside Simulation.run (transform= at its rate) its rows equal
a direct C(t) over the gids present at both times, and before the
change they equal the JAX package's sum (v v0).sum() / n bit for bit.

Tolerances: f64, energies and virials rel 1e-10 (the virial's against
its largest entry), counts exact, forces 1e-10 of the force scale,
C(t) rel 1e-10."""

import os
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from ddcmd_tpu_torch.io.restart import write_checkpoint
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.models import martini_bilayer
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation
from chip_smoke import term_energies

torch.set_num_threads(2)

REL = 1e-10


def _sim(d, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the c36 deck's demotion
        return TSimulation(*t_load(d), run_dir=d, device="cpu",
                           dtype=torch.float64, **kw)


def _shifted(sim, frac):
    """Move every particle by frac of the box and wrap them one by one,
    as a run's rebuild wraps them; returns the bonds cut by each
    boundary."""
    st, n = sim.ss.state, sim.sysdef.state.n_local
    L = sim.ss.box.lengths
    r = st.r.clone()
    r[:n] += torch.tensor(frac, dtype=r.dtype) * L
    r = sim.ss.box.back_in_box(r)
    sim.ss = sim.ss.replace(state=st.replace(r=r))
    b = sim.sysdef.bonded.bonds
    cut = (r[b[:, 0]] - r[b[:, 1]]).abs() > 0.5 * L
    return cut.sum(0).tolist()


def _counts(sim):
    sd = sim.sysdef
    c = dict(sd.bonded.counts(), n=sd.state.n_local,
             n_constraints_sys=sd.n_constraints,
             residues=len(sd.residue_instances),
             molecules=sim.n_molecules)
    if sd.bonded.chain_links is not None:
        c["chain_links"] = len(sd.bonded.chain_links)
    return c


def _replicate(sim, reps):
    nx, ny, nz = reps
    sim.db.compile_string(f"rep TRANSFORM {{ type=REPLICATE; nx={nx}; "
                          f"ny={ny}; nz={nz}; }}\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim.apply_transform(sim.db.get("rep", "TRANSFORM"))


def _assert_replica(before, after, k):
    (e0, c0), (e1, c1) = before, after
    assert {key: v * k for key, v in c0.items()} == c1
    assert len(e1) == len(e0)
    for (a, va), (b, vb) in zip(e1, e0):
        assert a == pytest.approx(k * b, rel=REL)
        assert np.abs(va - k * vb).max() <= REL * k * np.abs(vb).max()


@pytest.fixture(scope="module")
def bilayer(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bl"))
    martini_bilayer(d, nx=4, ny=4)
    return d


@pytest.mark.parametrize("reps", [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1)])
def test_replicate_bilayer_multiplies_every_term(bilayer, reps):
    """The shifted bilayer (8 bonds cut by the x boundary, 8 by y):
    energies and virials of the pair and the bonded term, every bonded
    count, the constraints, residues and molecules times nx ny nz, the
    first energy too; the run's engine and plan follow the new count."""
    sim = _sim(bilayer)
    assert _shifted(sim, (0.37, 0.41, 0.0))[:2] == [8, 8]
    sim.first_energy()
    e0 = float(sim.ss.energy.eion)
    before = (term_energies(sim), _counts(sim))
    _replicate(sim, reps)
    k = int(np.prod(reps))
    _assert_replica(before, (term_energies(sim), _counts(sim)), k)
    assert float(sim.ss.energy.eion) == pytest.approx(k * e0, rel=REL)
    assert sim.barostat["n_molecules"] == sim.n_molecules
    sim.run(4, print_fn=lambda line: None)
    assert torch.isfinite(sim.ss.state.r).all()


def test_replicate_charmm_chain_links(tmp_path):
    """The c36 tripeptide (ALA-GLY-ALA, two chain links, one CMAP, 24
    TIP3) shifted half a box in x so the chain straddles the boundary,
    replicated 2 x 1 x 1 on the list engine: every term, count, chain
    link and CMAP doubled."""
    d = str(tmp_path)
    chip_smoke.charmm_tripeptide_deck(d)
    sim = _sim(d)
    assert _shifted(sim, (0.5, 0.0, 0.0))[0] > 0
    sim.first_energy()
    before = (term_energies(sim), _counts(sim))
    assert before[1]["chain_links"] == 2 and before[1]["cmaps"] == 1
    _replicate(sim, (2, 1, 1))
    _assert_replica(before, (term_energies(sim), _counts(sim)), 2)


def test_selectsubset_keeps_whole_residues(bilayer, tmp_path):
    """A SELECTSUBSET through a lipid raises ValueError naming DPPC and
    the lipid's first gid, the run untouched; zmin=0 keeps the upper
    leaflet and its water, whole, and rebuilds: its first energy, forces
    and counts equal a deck built from the kept molecules."""
    sim = _sim(bilayer)
    _shifted(sim, (0.37, 0.41, 0.0))
    sim.first_energy()
    sd = sim.sysdef
    rn, rows = next(i for i in sd.residue_instances if i[0] == "DPPC")
    x = np.sort(sim.ss.state.r[rows, 0].numpy())
    assert x[0] < x[-1]
    r0 = sim.ss.state.r.clone()
    sim.db.compile_string(f"cut TRANSFORM {{ type=SELECTSUBSET; "
                          f"xmin={0.5 * (x[0] + x[-1]) * 10.0} Angstrom; }}\n"
                          "top TRANSFORM { type=SELECTSUBSET; zmin=0 "
                          "Angstrom; }\n")
    gid = int(sd.collection.gid[rows].min())
    with pytest.raises(ValueError, match=f"residue DPPC at gid {gid}:"):
        sim.apply_transform(sim.db.get("cut", "TRANSFORM"))
    assert sd.state.n_local == 672 and torch.equal(sim.ss.state.r, r0)
    upper = int((r0[:672, 2] >= 0).sum())
    sim.apply_transform(sim.db.get("top", "TRANSFORM"))
    assert sd.state.n_local == upper and sd.bonded.counts()["bonds"] == 160
    d2 = str(tmp_path)
    with open(os.path.join(bilayer, "object.data")) as f:
        deck = f.read()
    with open(os.path.join(d2, "object.data"), "w") as f:
        f.write(deck.replace("size=672;", f"size={upper};"))
    for name in ("bilayer.data",):
        with open(os.path.join(bilayer, name)) as f, \
                open(os.path.join(d2, name), "w") as g:
            g.write(f.read())
    write_checkpoint(sim, d2)
    ref = TSimulation(*t_load(d2, os.path.join(d2, "restart")), run_dir=d2,
                      device="cpu", dtype=torch.float64)
    ref.first_energy()
    assert _counts(ref) == _counts(sim)
    assert float(sim.ss.energy.eion) == pytest.approx(
        float(ref.ss.energy.eion), rel=REL)
    f, fr = sim.ss.state.f[:upper], ref.ss.state.f[:upper]
    assert (f - fr).abs().max() <= REL * fr.abs().max()


def test_vaf_across_a_replicate_in_the_run(bilayer, tmp_path):
    """VELOCITYAUTOCORRELATION (length 5, eval_rate 4) on the bilayer
    with transform= REPLICATE nx=2 at rate 12, 24 steps: rows 4, 8 and
    12 (an analysis sees the state before its loop's transform) are the
    JAX package's sum bit for bit; after the replica, rows 16 and 20
    average over the 672 gids present at loop 4 and equal a direct C(t)
    over them; the copies' new gids join at the block's restart, loop
    24, whose row is over all 1,344 (the second replica follows it)."""
    d = str(tmp_path)
    for name in os.listdir(bilayer):
        if not os.path.isdir(os.path.join(bilayer, name)):
            with open(os.path.join(bilayer, name)) as f, \
                    open(os.path.join(d, name), "w") as g:
                g.write(f.read())
    chip_smoke.edit_deck(os.path.join(d, "object.data"), lambda s: (
        s.replace("type=MD;", "type=MD; analysis=vaf; transform=rep;", 1)
        .replace("updateRate=12;", "updateRate=4;")
        + "vaf ANALYSIS { type=VELOCITYAUTOCORRELATION; length=5; "
        "eval_rate=4; outputrate=100; }\n"
        "rep TRANSFORM { type=REPLICATE; nx=2; rate=12; }\n"))
    sim = _sim(d)
    vaf = next(a for a in sim.analyses if a.name == "vaf")
    seen, got = [], []
    real = vaf.eval

    def spy(s):
        n = s.sysdef.state.n_local
        seen.append((int(s.ss.loop), s.ss.state.gid[:n].copy(),
                     s.ss.state.v[:n].numpy().copy()))
        real(s)
        got.append(vaf.state["rows"][-1][1])

    vaf.eval = spy
    sim.run(24, print_fn=lambda line: None)
    assert sim.sysdef.state.n_local == 2688
    assert [t for t, _, _ in seen] == [4, 8, 12, 16, 20, 24]
    _, g0, v0 = seen[0]
    for (t, g, v), c in zip(seen[:5], got):
        both, now, then = np.intersect1d(g, g0, return_indices=True)
        assert len(both) == 672
        assert c == pytest.approx((v[now] * v0[then]).sum() / 672, rel=REL)
        if t <= 12:
            assert c == (v * v0).sum() / 672
    v = seen[5][2]
    assert len(v) == 1344 and vaf.state["rows"] == [(24, got[5])]
    assert got[5] == pytest.approx((v * v).sum() / 1344, rel=REL)
