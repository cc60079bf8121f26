"""Slice 16, the transform registry (ROADMAP item 24a): each of the 16
TRANSFORM types of transforms/registry.py (a numpy copy of the JAX
package's) on one seeded TransformContext in both packages.  Tolerance:
none -- every array, name list and box of the context is equal to the
bit, and the files CUSTOM and SHOCK write are equal byte for byte."""

import os

import numpy as np
import pytest

from ddcmd_tpu.objects import ObjectDB as JObjectDB
from ddcmd_tpu.transforms import registry as jreg
from ddcmd_tpu_torch.models import write_atoms
from ddcmd_tpu_torch.objects import ObjectDB as TObjectDB
from ddcmd_tpu_torch.transforms import registry as treg

# the state: a simple cubic 4 x 4 x 10 lattice in a 4 x 4 x 10 nm box,
# species A and B alternating, the bottom layer in group piston; the
# material SHOCK and APPEND read: the same columns, 20 layers in 4 x 4 x
# 20 nm (tests/test_transforms.py:test_shock_transform's fixture)
NX, NZ, MZ = 4, 10, 20
L = np.array([4.0, 4.0, 10.0])


def _lattice(nz, Lz):
    g = np.stack(np.meshgrid(np.arange(NX), np.arange(NX), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3)
    box = np.array([L[0], L[1], Lz])
    return (g + 0.5) / [NX, NX, nz] * box - box / 2


def _state():
    r = _lattice(NZ, L[2])
    r = r[np.argsort(r[:, 2], kind="stable")]
    n = len(r)
    rng = np.random.default_rng(16)
    jitter = rng.uniform(-0.01, 0.01, r.shape)
    # SHOCK's reference particle: the topmost, exactly on its column
    jitter[-1] = (0.0, 0.0, 0.02)
    return dict(
        r=r + jitter,
        v=rng.standard_normal((n, 3)) * 0.1,
        gid=np.arange(n, dtype=np.int64) * 3 + 1,
        mass=rng.uniform(10.0, 80.0, n),
        species_names=["A" if i % 2 else "B" for i in range(n)],
        group_names=["piston" if z < -L[2] / 2 + 1.0 else "free"
                     for z in r[:, 2]],
        h=np.diag(L))


def _material(d):
    """newmat#000000: the material column (Angstrom), species A."""
    rm = _lattice(MZ, 20.0)
    write_atoms(os.path.join(d, "newmat#000000"), rm * 10.0,
                np.zeros_like(rm), ["A"] * len(rm), ["free"] * len(rm),
                np.diag([40.0, 40.0, 200.0]))


def _shock():
    st = _state()
    r = st["r"]
    top = int(np.argmax(r[:, 2]))
    rm = _lattice(MZ, 20.0)
    col = np.nonzero((np.abs(rm[:, 0] - r[top, 0]) < 0.05)
                     & (np.abs(rm[:, 1] - r[top, 1]) < 0.05))[0]
    return (f"type=SHOCK; rhoBarTarget=0.001 1/Angstrom^3; "
            f"newMaterial=newmat#; gidRefState={st['gid'][top]}; "
            f"gidRefNew={int(col[np.argmin(rm[col, 2])])}; "
            f"ratioRhoEst=0.002 1/Angstrom^3; piston=piston;")


CASES = {
    "SETVELOCITY": "type=SETVELOCITY; vcm=0.01 -0.02 0.03 Angstrom/fs; "
                   "species=A;",
    "ADDVELOCITY": "type=ADDVELOCITY; velocity=0.001 0 -0.002 Angstrom/fs; "
                   "groups=free;",
    "THERMALIZE": "type=THERMALIZE; temperature=300 K; seed=7; keepVcm=1; "
                  "species=B;",
    "BOX": "type=BOX; hNew=44 0 0 0 42 0 0 0 101 Angstrom;",
    "GIDSHUFFLE": "type=GIDSHUFFLE; seed=5;",
    "PROJECTILE": "type=PROJECTILE; gid=52; velocity=0 0 -0.05 Angstrom/fs;",
    "LINEARISOTROPICV": "type=LINEARISOTROPICV; alpha=0.3;",
    "ASSIGNGROUPS": "type=ASSIGNGROUPS; group=piston; zmin=0 Angstrom; "
                    "zmax=20 Angstrom; species=A;",
    "IMPACT": "type=IMPACT; center=15 15 40 Angstrom; radius=12 Angstrom; "
              "velocity=0 0.01 0 Angstrom/fs;",
    "SELECTSUBSET": "type=SELECTSUBSET; zmin=0 Angstrom; xmax=10 Angstrom; "
                    "species=A;",
    "REPLICATE": "type=REPLICATE; nx=2; ny=1; nz=3;",
    "ALCHEMY": "type=ALCHEMY; species_from=A; species_to=C; groups=free;",
    "APPEND": "type=APPEND; files=newmat#; base_dir={d}; "
              "offset=0 0 5 Angstrom;",
    "TRANSECTMORPH": "type=TRANSECTMORPH; index=2; positionBefore=-20 20; "
                     "positionAfter=-30 30;",
    "CUSTOM": "type=CUSTOM; gid=1 52 4000;",
    "SHOCK": None,
}


def _apply(reg, db_cls, text, run_dir):
    ctx = reg.TransformContext(**_state())
    ctx.time, ctx.dt, ctx.rate = 1.0, 0.01, 10
    ctx.run_dir = ctx.base_dir = run_dir
    obj = db_cls().compile_string(f"t TRANSFORM {{ {text} }}").get(
        "t", "TRANSFORM")
    reg.apply_transform(ctx, obj)
    return ctx


def test_registry_covers_the_16_types():
    assert sorted(treg.REGISTRY) == sorted(jreg.REGISTRY) == sorted(CASES)


@pytest.mark.parametrize("ttype", list(CASES))
def test_transform_equals_jax_to_the_bit(tmp_path, ttype):
    """The transform on the same context in both packages: r, v, gid,
    mass, species and group names and h equal to the bit; the files
    CUSTOM (gidZvals.txt) and SHOCK (shock.data) write equal."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    for d in (jd, td):
        os.makedirs(d)
        _material(d)
    text = CASES[ttype] or _shock()
    j = _apply(jreg, JObjectDB, text.format(d=jd), jd)
    t = _apply(treg, TObjectDB, text.format(d=td), td)
    for k in ("r", "v", "gid", "mass", "h"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert t.species_names == j.species_names
    assert t.group_names == j.group_names
    n0 = len(_state()["gid"])
    moved = {"REPLICATE": 6 * n0, "APPEND": n0 + NX * NX * MZ}
    if ttype in moved:
        assert len(t.gid) == moved[ttype]
    files = sorted(os.listdir(td))
    assert files == sorted(os.listdir(jd))
    out = {"CUSTOM": "gidZvals.txt", "SHOCK": "shock.data"}.get(ttype)
    if out is not None:
        assert out in files
    for f in files:
        with open(os.path.join(td, f), "rb") as a, \
                open(os.path.join(jd, f), "rb") as b:
            assert a.read() == b.read(), f
