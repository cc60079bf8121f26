"""The mesh's brick (N,K)-list engine (parallel/brickstep.BrickStepList)
over gloo ranks, against the JAX package.

The dry run's brick legs (__graft_entry__.py:190-375): its synthetic
two-species system at (2,2,2) through the list engine (first energy
within 1e-4 of the JAX single-device list evaluation, forces by gid, a
step and a migration without overflow), and its dimers with bonds and
constraints (energy and max force within the dry run's 1e-3 in f32,
forces by gid in f64 at 1e-8 of the JAX package's brick list engine).
The resolver and the engine pick: tests/test_torch_mesh_list_engines.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from ddcmd_tpu.nbr.celllist import CellGrid as JCellGrid
from ddcmd_tpu.nbr.celllist import build_neighbor_list as j_build
from ddcmd_tpu.potentials.bonded import BondedTerms as JBondedTerms
from ddcmd_tpu.potentials.bonded import bonded_eval as j_bonded_eval
from ddcmd_tpu.potentials.bonded import device_bonded_tables as j_dbt
from ddcmd_tpu.potentials.martini import martini_nonbond as j_martini

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

SHAPE = (2, 2, 2)
SKIN = 0.15


@pytest.fixture(scope="module")
def system():
    """The dry run's system for 8 devices: L = 6.4 nm, n = 13^3, rcut 0.6
    nm, sigma0 0.4 nm, two species; and its dimers (pairs 2i, 2i+1 bonded
    with b0 = 0.35 nm, kb = 5000, constrained at their start lengths;
    gids mol * 4 + atom, head gid mol * 4)."""
    L = 6.4
    n = int(np.ceil(L / 0.5)) ** 3
    arrays, L, rcut, tables = graft._synthetic_system(n=n, L=L, rcut=0.6,
                                                      sigma0=0.4)
    spec = {k: np.asarray(v) for k, v in arrays.items()}
    spec["gid"] = np.arange(n, dtype=np.int64)
    spec.update({k: np.asarray(v, np.float64) for k, v in tables.items()})
    spec.update(L=L, rcut=rcut, skin=SKIN)
    n_mol = n // 2
    bonds = np.stack([2 * np.arange(n_mol), 2 * np.arange(n_mol) + 1],
                     axis=1).astype(np.int32)
    mol_of = np.minimum(np.arange(n) // 2, n_mol - 1)
    r = spec["r"]
    dvec = r[0:2 * n_mol:2] - r[1:2 * n_mol:2]
    dvec = dvec - L * np.round(dvec / L)
    dimers = dict(spec, gid=mol_of * 4 + (np.arange(n) - 2 * mol_of),
                  hgid=mol_of * 4, bonds=bonds,
                  bond_parms=np.tile([[5000.0, 0.35]], (n_mol, 1)),
                  cons_pairs=np.tile(np.array([[[0, 1]]], np.int32),
                                     (n_mol, 1, 1)),
                  cons_dist=np.linalg.norm(dvec, axis=1)[:, None])
    return spec, dimers


def _jax_reference(spec, dtype, bonded=False):
    """The JAX package's single-device list evaluation of the system (the
    dry run's e_ref0 and, with the bonds, its bonded reference), in one
    jit: (e, f, max |f|)."""
    import jax

    L, n = float(spec["L"]), len(spec["r"])
    grid = JCellGrid.plan([L] * 3, float(spec["rcut"]), SKIN, n, n)
    tables = {k: jnp.asarray(spec[k], dtype)
              for k in ("sigma", "eps", "shift", "rcut2", "krf", "crf",
                        "keR")}
    btab = None
    if bonded:
        bt = JBondedTerms(bonds=spec["bonds"], bond_parms=spec["bond_parms"])
        btab = j_dbt(bt, dtype)

    @jax.jit
    def run(r, q, species):
        Lv = jnp.asarray([L] * 3, dtype)
        ones = jnp.ones(n, dtype)
        nbr, _, ov = j_build(r, ones, Lv, grid)
        f, e, *_ = j_martini(r, q, species, ones, nbr, Lv, tables)
        if btab is not None:
            fb, eb, _, _ = j_bonded_eval(r, Lv, btab, n, dtype)
            f, e = f + fb, e + eb
        return f, e, ov

    f, e, ov = run(jnp.asarray(spec["r"], dtype),
                   jnp.asarray(spec["q"], dtype), jnp.asarray(spec["species"]))
    assert not bool(ov)
    f = np.asarray(f, np.float64)
    return float(e), f, float(np.linalg.norm(f, axis=1).max())


def _jax_mesh_first_forces(spec, shape=SHAPE, move=None):
    """The JAX package's brick list engine (make_brick_step) on the
    system at `shape` in f64, on its CPU devices, with the dimers' bonds
    and constraints when the spec has them, and `move` (gid, x) applied
    after the distribution: (e, forces by gid row)."""
    import jax

    from ddcmd_tpu.core.groups import Group, GroupTable
    from ddcmd_tpu.parallel.bonded_shard import (bonded_gid_tables,
                                                 constraint_gid_tables)
    from ddcmd_tpu.parallel.brick import BrickPlan, distribute_bricks
    from ddcmd_tpu.parallel.brickstep import (FIELD_KEYS, make_brick_mesh,
                                              make_brick_step)
    from jax.sharding import NamedSharding, PartitionSpec as P

    f64 = jnp.float64
    L, n = float(spec["L"]), len(spec["r"])
    plan = BrickPlan(shape=shape, local_cap=n, halo_cap=n // 2,
                     migrate_cap=256, rlist=float(spec["rcut"]) + SKIN)
    grid = JCellGrid.plan([L] * 3, float(spec["rcut"]), SKIN, n,
                          plan.local_cap + plan.ghost_cap)
    mesh = make_brick_mesh(shape)
    kw = {}
    if "bonds" in spec:
        bt = JBondedTerms(bonds=spec["bonds"], bond_parms=spec["bond_parms"])
        btab = bonded_gid_tables(bt, spec["gid"], j_dbt(bt, f64))
        bt.cons_atoms = spec["bonds"].copy()
        bt.cons_pairs = spec["cons_pairs"]
        bt.cons_dist, bt.n_constraints = spec["cons_dist"], len(spec["bonds"])
        kw = dict(bonded_tables=btab, field_keys=FIELD_KEYS + ("hgid",),
                  constraint_tables=constraint_gid_tables(bt, spec["gid"]))
    coeffs = GroupTable.build([Group(name="free", index=0, type="LANGEVIN",
                                     Teq=lambda t: 310.0, tau=1.0)]
                              ).coefficients(0.0, 0.01, dtype=f64)
    tables = {k: jnp.asarray(spec[k], f64)
              for k in ("sigma", "eps", "shift", "rcut2", "krf", "crf",
                        "keR")}
    _, first, _ = make_brick_step(
        mesh, plan, grid, tables, coeffs, dt=0.02, box_lengths=[L] * 3,
        species_lj_type=np.array([0, 1], np.int32), n_global=n, **kw)

    def pair(g):
        return np.stack([(g & 0xFFFFFFFF).astype(np.uint32),
                         (g >> 32).astype(np.uint32)], axis=1)

    arrays = {k: np.asarray(spec[k], np.float64)
              for k in ("r", "v", "q", "mass")}
    arrays.update(species=spec["species"], group=spec["group"],
                  gid=pair(spec["gid"]))
    if "hgid" in spec:
        arrays["hgid"] = pair(spec["hgid"])
    buf, mask, _ = distribute_bricks(arrays, [L] * 3, plan)
    g = buf["gid"][:, 0].astype(np.int64)
    if move is not None:
        buf["r"][mask & (g == move[0]), 0] = move[1]
    shard = lambda a: jax.device_put(                        # noqa: E731
        jnp.asarray(a), NamedSharding(mesh, P(("bx", "by", "bz"))))
    f, e, _, ov = first({k: shard(v) for k, v in buf.items()}, shard(mask),
                        jax.random.PRNGKey(0))
    assert not int(ov)
    out = np.zeros((n, 3))
    out[np.searchsorted(spec["gid"], g[mask])] = np.asarray(f)[mask]
    return float(e), out


def _checked(z, spec, step_flags=False):
    """One leg's results: no overflow of the first forces and the
    migration, the step's flagged exactly when `step_flags` (a row that
    the step carries half the skin or more: the drift guard), finite
    forces, every particle owned once after the migration."""
    assert not (bool(z["ov"]) or bool(z["ov_m"]))
    assert bool(z["ov_s"]) == step_flags
    assert bool(z["finite"])
    assert sorted(z["gids"].tolist()) == sorted(spec["gid"].tolist())
    return z


@pytest.fixture(scope="module")
def legs(system, tmp_path_factory):
    """One spawn of eight ranks (torch_mesh_ranks.run_legs of list_bricks):
    the bricks leg in f32 and the bonded bricks leg in f32 and f64, at
    (2,2,2): {leg name: its results}."""
    spec, dimers = system
    tmp = tmp_path_factory.mktemp("legs")
    paths = {}
    for name, z in (("spec", spec), ("dimers", dimers)):
        paths[name] = str(tmp / f"{name}.npz")
        np.savez(paths[name], **z)
    todo = {"bricks": ("spec", "float32"),
            "bonded_float32": ("dimers", "float32"),
            "bonded_float64": ("dimers", "float64")}
    ranks.run_ranks(ranks.run_legs, 8, tmp, tuple(
        ("list_bricks", (paths[z], SHAPE, dtype, str(tmp / f"{name}.npz")))
        for name, (z, dtype) in todo.items()))
    return {name: _checked(np.load(str(tmp / f"{name}.npz")),
                           spec if z == "spec" else dimers)
            for name, (z, _) in todo.items()}


def _run(tmp_path, spec, dtype, name, shape=SHAPE, move=None,
         step_flags=False):
    p = str(tmp_path / f"{name}_spec.npz")
    np.savez(p, **spec)
    out = str(tmp_path / f"{name}.npz")
    ranks.run_ranks(ranks.list_bricks, int(np.prod(shape)), tmp_path, p,
                    shape, dtype, out, move)
    return _checked(np.load(out), spec, step_flags)


def test_dry_run_bricks_leg(system, legs):
    """The "bricks" leg on the list engine at (2,2,2) in f32: first
    energy within 1e-4 relative of the JAX single-device list evaluation
    (the dry run's gate), forces by gid within 2e-5 of the force scale;
    one step and one migration without overflow."""
    spec, _ = system
    z = legs["bricks"]
    e_ref, f_ref, _ = _jax_reference(spec, jnp.float32)
    assert abs(float(z["e"]) - e_ref) <= 1e-4 * max(abs(e_ref), 1.0)
    scale = np.abs(f_ref).max()
    assert np.abs(z["f"] - f_ref).max() <= 2e-5 * scale
    assert np.isfinite(float(z["e_step"]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dry_run_bonded_bricks_leg(system, legs, dtype):
    """The "bonded bricks" leg (dimers: gid-keyed bonds resolved per
    term, constraints by gid, molecule-coherent migration) on the list
    engine at (2,2,2): in f32 the energy and the max force within the dry
    run's 1e-3 of the JAX single-device evaluation; in f64 the energy
    and the forces by gid within 1e-8 of the JAX package's brick list
    engine on the same bricks (the two meshes miss the same pairs of the
    dimers whose atoms lie far apart: 1.6e-4 of the energy, which is why
    the dry run allows 1e-3)."""
    _, dimers = system
    z = legs[f"bonded_{dtype}"]
    if dtype == "float32":
        e_ref, _, fmax = _jax_reference(dimers, jnp.float32, bonded=True)
        assert abs(float(z["e"]) - e_ref) <= 1e-3 * max(abs(e_ref), 1.0)
        assert abs(float(z["fmax"]) - fmax) <= 1e-3 * max(fmax, 1e-6)
        return
    e_ref, f_ref = _jax_mesh_first_forces(dimers)
    assert abs(float(z["e"]) - e_ref) <= 1e-8 * abs(e_ref)
    assert np.abs(z["f"] - f_ref).max() <= 1e-8 * np.abs(f_ref).max()


def test_seam_crossing_row_keeps_its_pairs(tmp_path, system):
    """On an axis of four bricks, a row of the last brick that drifted
    across the +x seam since the last migration (its x wrapped to the far
    side of the box, still owned by brick 3): the list engine measures
    its windows from each brick's centre across the seam, so the row
    ships to brick 0, and the (4,1,1) mesh's f64 first energy and forces
    equal the JAX package's single-device list evaluation of the same
    positions (1e-10).  The JAX package's brick list engine selects by
    the raw fraction, ships the row to brick 2 and drops brick 0's pairs
    with it: its energy is off by more than 1e-3 and its net force is
    not zero (ROADMAP section 3)."""
    spec, _ = system
    L = float(spec["L"])
    x = spec["r"][:, 0]
    k = int(np.argmax(x))                      # a row of brick 3
    assert x[k] > 0.25 * L
    x_new = 0.5 * L + 0.05 - L                 # 0.05 nm past the seam
    moved = dict(spec, r=spec["r"].copy())
    moved["r"][k, 0] = x_new
    # the moved row lands 0.18 nm from a neighbour (|f| ~1.5e8): the step
    # carries it ~4.4 nm, and the drift guard flags that step
    z = _run(tmp_path, spec, "float64", "seam", (4, 1, 1), (k, x_new),
             step_flags=True)
    e_ref, f_ref, _ = _jax_reference(moved, jnp.float64)
    assert abs(float(z["e"]) - e_ref) <= 1e-10 * abs(e_ref)
    assert np.abs(z["f"] - f_ref).max() <= 1e-10 * np.abs(f_ref).max()
    je, jf = _jax_mesh_first_forces(spec, (4, 1, 1), (k, x_new))
    assert abs(je - e_ref) > 1e-3 * abs(e_ref)
    assert np.abs(jf.sum(axis=0)).max() > 1e-3 * np.abs(f_ref).max()
