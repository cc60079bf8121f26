"""Slice 17, the analysis registry (ROADMAP item 24b) against the JAX
package's on the CPU in f64: the same seeded inputs in both packages'
State and Box, the same deck object through both build_analysis, eval
and output, and the files compared -- text equal, or every number
within 1e-12 relative.  One case per class (17), then the cases of
tests/test_analysis.py: centrosymmetry and Ackland-Jones on perfect fcc
and bcc, DSF's Bragg peak, QUATERNION's uniform bcc colour, CHOLANALYSIS
on a known geometry, and _knn's cell-list route at 6,912 atoms against
the direct one."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import analysis_files
from ddcmd_tpu.analysis import registry as jreg
from ddcmd_tpu.core.box import Box as JBox
from ddcmd_tpu.core.state import State as JState
from ddcmd_tpu.objects import ObjectDB as JObjectDB
from ddcmd_tpu_torch.analysis import registry as treg
from ddcmd_tpu_torch.core.box import Box as TBox
from ddcmd_tpu_torch.core.state import State as TState
from ddcmd_tpu_torch.objects import ObjectDB as TObjectDB

torch.set_num_threads(2)
REL = 1e-12


def fcc(a, m):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    r = ((cells[:, None] + base[None]) * a).reshape(-1, 3)
    return r - a * m / 2, a * m


def bcc(a, m):
    base = np.array([[0, 0, 0], [.5, .5, .5]])
    cells = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    r = ((cells[:, None] + base[None]) * a).reshape(-1, 3)
    return r - a * m / 2, a * m


def _chol(copies=1):
    """CHOLANALYSIS's hand-built 7-bead ring geometry (the JAX package's
    tests/test_analysis.py), `copies` of it 1.5 nm apart in x."""
    p = np.zeros((7, 3))
    p[1] = [0.3, 0.4, 0.25]
    p[2] = [1.0, 0.0, 0.0]
    p[3] = [0.0, 1.0, 0.0]
    p[4] = [0.0, 1.0, -1.0]
    p[5] = p[4] + [0.1, 0.5, 0.2]
    p[6] = p[4] + [1.0, 0.0, 0.0]
    return np.concatenate([p + [1.5 * i, 0, 0] for i in range(copies)])


def _inputs(kind, seed=0):
    """Seeded f64 inputs: positions of `kind` (a fluid, a thermally
    perturbed fcc, or CHOL rings) and random velocities, forces,
    energies, charges, masses, two species, a virial and a kinetic
    tensor."""
    rng = np.random.default_rng(seed)
    if kind == "fluid":
        L = 3.0
        r = (rng.random((200, 3)) - 0.5) * L
    elif kind == "fcc":
        r, L = fcc(0.36, 3)
        r = r + rng.normal(scale=0.01, size=r.shape)
    else:
        r, L = _chol(2), 50.0
    n = len(r)
    vir, tion = rng.standard_normal((2, 3, 3)) * 1e3
    return dict(
        r=r, L=L, v=rng.standard_normal((n, 3)), f=rng.standard_normal(
            (n, 3)) * 100.0, pe=rng.standard_normal(n),
        q=np.where(rng.random(n) < 0.5, 0.0, rng.choice([-1.0, 1.0], n)),
        mass=rng.uniform(10.0, 72.0, n), species=rng.integers(0, 2, n),
        virial=vir + vir.T, tion=tion @ tion.T,
        rings=[("CHOL", list(range(7 * i, 7 * i + 7))) for i in range(2)]
        if kind == "chol" else None)


def _pad(a, n_pad):
    out = np.zeros((n_pad,) + a.shape[1:])
    out[:len(a)] = a
    return out


def _sims(x):
    """Both packages' stand-in simulations (state, box, energy, loop,
    time, collection, species) on the inputs x."""
    n = len(x["r"])
    args = (x["r"], x["v"], x["q"], x["mass"], x["species"], np.zeros(n),
            np.arange(1, n + 1))
    jst = JState.create(*args, dtype=jnp.float64)
    tst = TState.create(*args, dtype=torch.float64, device="cpu")
    npad = jst.n_pad
    jst = jst.replace(f=jnp.asarray(_pad(x["f"], npad)),
                      pe=jnp.asarray(_pad(x["pe"], npad)))
    tst = tst.replace(f=torch.as_tensor(_pad(x["f"], tst.n_pad)),
                      pe=torch.as_tensor(_pad(x["pe"], tst.n_pad)))
    col = dict(gid=np.arange(1, n + 1, dtype=np.uint64),
               species_names=[("A", "B")[s] for s in x["species"]],
               group_names=["g"] * n, class_names=["c"] * n)
    h = np.diag([x["L"]] * 3)
    sims = []
    for st, box, arr in ((jst, JBox.from_h(h, dtype=jnp.float64),
                          jnp.asarray),
                         (tst, TBox.from_h(h, dtype=torch.float64),
                          torch.as_tensor)):
        energy = SimpleNamespace(virial=arr(x["virial"]),
                                 tion=arr(x["tion"]))
        ss = SimpleNamespace(state=st, box=box, energy=energy, loop=0,
                             time=0.0)
        sd = SimpleNamespace(
            state=st, collection=SimpleNamespace(**{
                k: (v.copy() if k == "gid" else list(v))
                for k, v in col.items()}),
            species=[SimpleNamespace(name="A"), SimpleNamespace(name="B")],
            residue_instances=x["rings"])
        sims.append(SimpleNamespace(ss=ss, sysdef=sd))
    return sims


def _move(sims, x, step, rng):
    """Advance both stand-ins to loop 10 step: the same small random
    moves of r and v, the time 0.02 ps a step."""
    n = len(x["r"])
    x["r"] = x["r"] + rng.normal(scale=1e-3, size=(n, 3))
    x["v"] = x["v"] + rng.normal(scale=1e-2, size=(n, 3))
    for sim, arr in zip(sims, (jnp.asarray, torch.as_tensor)):
        st = sim.ss.state
        npad = st.r.shape[0]
        sim.ss.state = sim.sysdef.state = st.replace(
            r=arr(_pad(x["r"], npad)), v=arr(_pad(x["v"], npad)))
        sim.ss.loop = 10 * step
        sim.ss.time = 0.02 * step


def _analyses(text, name):
    return (jreg.build_analysis(name, JObjectDB().compile_string(text).get(
                name, "ANALYSIS")),
            treg.build_analysis(name, TObjectDB().compile_string(text).get(
                name, "ANALYSIS")))


def same_files(jf, tf, rel=REL, skip=()):
    """Every file of jf ({relative path: text}, chip_smoke.analysis_files)
    in tf and back, text equal or each number within rel relative
    (absolute where both are below 1e-9)."""
    assert sorted(jf) == sorted(tf) and jf
    for name in jf:
        if name in skip or jf[name] == tf[name]:
            continue
        ta, tb = jf[name].split(), tf[name].split()
        assert len(ta) == len(tb), name
        for x, y in zip(ta, tb):
            if x != y:
                fx, fy = float(x), float(y)
                assert abs(fx - fy) <= rel * max(abs(fx), abs(fy), 1e-9), \
                    (name, x, y)


def _same_dirs(jdir, tdir):
    jf = analysis_files(jdir)
    same_files(jf, analysis_files(tdir))
    return jf


# one deck object per class (17), with the input each reads
CLASSES = {
    "PAIRCORRELATION": ("fluid", "delta_r=0.05 nm; length=30;"),
    "VCMWRITE": ("fluid", ""),
    "KINETICENERGYDISTN": ("fluid", "nBins=40; max=400 kJ/mol;"),
    "ZDENSITY": ("fluid", "nBins=12;"),
    "SSF": ("fluid", "nShells=10; kmax=12 1/nm;"),
    "VELOCITYAUTOCORRELATION": ("fluid", "length=3;"),
    "SUBSETWRITE": ("fluid", "species=B;"),
    "STRESSWRITE": ("fluid", ""),
    "FORCEAVERAGE": ("fluid", ""),
    "DSF": ("fcc", "m=1 2 3; weight=charge;"),
    "CENTROSYM": ("fcc", "nNeighbors=12;"),
    "ACKLAND_JONES": ("fcc", ""),
    "COARSEGRAIN": ("fluid", "nx=3; ny=3; nz=2; outputMode=2; "
                             "smearRadius=0.3 nm; smearMethod=hat;"),
    "PAIRANALYSIS": ("fluid", "rmax=0.4 nm;"),
    "QUATERNION": ("fcc", "nPairs=6; NNs=6;"),
    "CHOLANALYSIS": ("chol", "rmin=-10 Angstrom; rmax=10 Angstrom; "
                             "delta=0.5 Angstrom;"),
    "DATASUBSET": ("fluid", "species=A; fields=time nSamples nParticles "
                            "Etotal Ekinetic Epotential Rx Vy Fz;"),
}


def test_registry_names_match_jax():
    """18 names, 17 classes, the same names as the JAX registry's."""
    assert sorted(treg.REGISTRY) == sorted(jreg.REGISTRY)
    assert len(set(treg.REGISTRY.values())) == 17 == len(CLASSES)
    assert {treg.REGISTRY[k].__name__ for k in CLASSES} == {
        c.__name__ for c in treg.REGISTRY.values()}
    db = TObjectDB().compile_string("x ANALYSIS { type=NOPE; }")
    with pytest.raises(treg.DeckError, match="NOPE not implemented"):
        treg.build_analysis("x", db.get("x", "ANALYSIS"))


@pytest.mark.parametrize("atype", sorted(CLASSES))
def test_class_files_equal_jax(tmp_path, atype, capsys):
    """Four evals at loops 10-40 on moving inputs, an output after the
    second and the fourth, in both packages: the same files."""
    kind, keys = CLASSES[atype]
    text = f"a ANALYSIS {{ type={atype}; {keys} }}"
    x = _inputs(kind, seed=sorted(CLASSES).index(atype))
    sims = _sims(x)
    pair = _analyses(text, "a")
    rng = np.random.default_rng(1)
    dirs = [str(tmp_path / w) for w in ("jax", "torch")]
    for d in dirs:
        os.makedirs(d)
    for step in range(1, 5):
        _move(sims, x, step, rng)
        for a, sim, d in zip(pair, sims, dirs):
            a.eval(sim)
            if step % 2 == 0:
                a.output(sim, d)
    files = _same_dirs(*dirs)
    if atype == "PAIRANALYSIS":
        out = capsys.readouterr().out.split()
        assert len(out) == 8 and out[0::2] == out[1::2]
    if atype == "QUATERNION":
        assert len(files) == 2                 # snapshot.*20, snapshot.*40


def test_paircorrelation_blocks_equal_jax(tmp_path, monkeypatch):
    """A budget of a few rows a block (here 7 blocks of 29 rows) gives
    the JAX package's (n, n) bins exactly: the same pairs in the same
    bins, counted in int64."""
    x = _inputs("fluid", seed=3)
    sims = _sims(x)
    pair = _analyses("g ANALYSIS { type=PAIRCORRELATION; delta_r=0.02 nm; "
                     "length=80; rmin=0.05 nm; }", "g")
    monkeypatch.setattr(treg, "PAIR_BLOCK_BYTES", 29 * 200 * (12 * 8 + 16))
    for a, sim in zip(pair, sims):
        a.eval(sim)
    jh, th = (a.state["hist"] for a in pair)
    np.testing.assert_array_equal(th, jh)
    assert th.sum() > 1000 and th.dtype == np.float64


@pytest.mark.parametrize("rows", [29, None])
def test_pairanalysis_blocks_equal_jax(monkeypatch, capsys, rows):
    """PAIRANALYSIS's count on the device in row blocks (7 blocks of 29
    rows, or one block) equals the JAX package's dense (n, n) f64 numpy
    count, at a radius that holds ~800 ordered pairs."""
    x = _inputs("fluid", seed=5)
    sims = _sims(x)
    pair = _analyses("p ANALYSIS { type=PAIRANALYSIS; rmax=0.5 nm; }", "p")
    if rows is not None:
        monkeypatch.setattr(treg, "PAIR_BLOCK_BYTES", rows * 200 * 96)
    for a, sim in zip(pair, sims):
        a.eval(sim)
    j, t = (a.state["cnt"] for a in pair)
    assert t == j and isinstance(t, int) and j > 500
    assert capsys.readouterr().out.split() == [f"cnt={j}"] * 2


@pytest.mark.parametrize("maker,expect", [(fcc, 1), (bcc, 3)],
                         ids=["fcc", "bcc"])
def test_classifiers_on_perfect_crystals(maker, expect):
    """Centrosymmetry is zero on a perfect lattice and Ackland-Jones
    names it (> 90%); both equal the JAX package's arrays."""
    r, L = maker(0.33, 4)
    x = _inputs("fluid")
    x.update(r=r, L=L, v=np.zeros_like(r), f=np.zeros_like(r),
             pe=np.zeros(len(r)), q=np.zeros(len(r)),
             mass=np.ones(len(r)), species=np.zeros(len(r), int))
    sims = _sims(x)
    cs = _analyses("cs ANALYSIS { type=CENTROSYM; nNeighbors=12; }", "cs")
    aj = _analyses("aj ANALYSIS { type=ACKLANDJONES; }", "aj")
    for pair in (cs, aj):
        for a, sim in zip(pair, sims):
            a.eval(sim)
    np.testing.assert_array_equal(cs[1].state["cs"], cs[0].state["cs"])
    np.testing.assert_array_equal(aj[1].state["kinds"], aj[0].state["kinds"])
    if maker is fcc:
        assert cs[1].state["cs"].max() < 1e-6
    assert (aj[1].state["kinds"] == expect).mean() > 0.9


def test_dsf_bragg_peak_equals_jax():
    """The full m = 6 shell on a perfect 3-cell fcc lattice: |rho_k| = 1
    on the three axis triples, far off elsewhere, in both packages."""
    r, L = fcc(0.36, 3)
    x = _inputs("fluid")
    x.update(r=r, L=L, v=np.zeros_like(r), f=np.zeros_like(r),
             pe=np.zeros(len(r)), q=np.zeros(len(r)),
             mass=np.ones(len(r)), species=np.zeros(len(r), int))
    sims = _sims(x)
    pair = _analyses("d ANALYSIS { type=DSF; m=6; weight=number; }", "d")
    for a, sim in zip(pair, sims):
        a.eval(sim)
    j, t = pair
    np.testing.assert_array_equal(t._ktrip, j._ktrip)
    np.testing.assert_allclose(t.state["series"][0], j.state["series"][0],
                               rtol=REL, atol=1e-14)
    rho = np.abs(t.state["series"][0])
    axis = np.array([(k != 0).sum() == 1 for k in t._ktrip])
    assert axis.sum() == 3 and len(t._ktrip) > 3
    np.testing.assert_allclose(rho[axis], 1.0, atol=1e-9)
    assert rho[~axis].max() < 0.05


def test_quaternion_bcc_uniform_colour_equals_jax():
    """BCC with 8 antiparallel (111) pairs: one valid colour for every
    atom, the same as the JAX package's; NNs=12 marks every atom
    unknown."""
    r, L = bcc(1.0, 4)
    r = r + np.random.default_rng(5).standard_normal(r.shape) * 2e-4
    for nns in (8, 12):
        pair = _analyses(f"qa ANALYSIS {{ type=QUATERNION; NNs={nns}; "
                         "rfcut=1.2; rcut=5 Angstrom; }", "qa")
        got = [np.array(a.compute(r, np.array([L] * 3))) for a in pair]
        np.testing.assert_array_equal(got[1], got[0])
        QR, QG, QB = got[1]
        if nns == 8:
            assert (QR >= 0).all() and (QR <= 1).all()
            assert max(np.ptp(QR), np.ptp(QG), np.ptp(QB)) < 0.02
        else:
            assert (QR == -0.1).all()


def test_cholanalysis_known_geometry_equals_jax(tmp_path):
    """dR1 = 0.25 nm and dR5 = -0.5 nm on the hand-built ring
    (cholAnalysis.c:109-163), the same files as the JAX package's."""
    x = _inputs("chol")
    x["rings"] = [("CHOL", list(range(7)))]
    sims = _sims(x)
    pair = _analyses("ch ANALYSIS { type=CHOLANALYSIS; rmin=-10 Angstrom; "
                     "rmax=10 Angstrom; delta=0.5 Angstrom; }", "ch")
    dirs = [str(tmp_path / w) for w in ("jax", "torch")]
    for a, sim, d in zip(pair, sims, dirs):
        os.makedirs(d)
        a.eval(sim)
        assert a.state["acc"][0] == pytest.approx((0.25, -0.5), abs=1e-12)
        a.output(sim, d)
    _same_dirs(*dirs)
    data = (tmp_path / "torch" / "cholAnalysis.data").read_text().split()
    assert float(data[2]) == pytest.approx(2.5)
    assert float(data[5]) == pytest.approx(-5.0)


def test_knn_celllist_route_matches_direct():
    """6,912 atoms (an fcc crystal of 6 cells doubled in each axis, with
    thermal noise) take the cell-list route: its K nearest equal the
    direct route's on 512 rows (the direct selection of a row reads only
    that row) and the JAX package's _knn on every row, in both tie
    orders."""
    rng = np.random.default_rng(5)
    r, L = fcc(0.36, 6)
    r = r + rng.normal(scale=0.01, size=r.shape)
    r = np.concatenate([r + np.array([ix, iy, iz]) * L
                        for ix in (0, 1) for iy in (0, 1)
                        for iz in (0, 1)]) - 0.5 * L
    Lb = np.full(3, 2 * L)
    assert len(r) == 6912
    rows = rng.choice(len(r), 512, replace=False)
    d = r[rows, None, :] - r[None, :, :]
    d -= Lb * np.round(d / Lb)
    d2 = (d ** 2).sum(-1)
    d2[np.arange(512), rows] = np.inf
    for K, tie in ((12, False), (28, True)):
        idx, disp = treg._knn(r, Lb, K, tie_desc_d=tie)
        jidx, jdisp = jreg._knn(r, Lb, K, tie_desc_d=tie)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(disp, jdisp)
        if tie:
            keys = (-d[..., 2], -d[..., 1], -d[..., 0], d2)
        else:
            keys = (np.broadcast_to(np.arange(len(r)), d2.shape), d2)
        order = np.lexsort(keys, axis=1)[:, :K]
        np.testing.assert_array_equal(idx[rows], order)
