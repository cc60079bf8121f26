"""The port's sharded bonded layer (parallel/bonded_shard.py, the gid
keys of build_batched_bonded, the resolved batched evaluator) against
the JAX package's on the same numpy pool gids and masks, and on the
small Martini bilayer (nx = ny = 4, 528 beads)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.core.molecule import build_molecule_class as j_build_mol
from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.integrators import constraints as jc
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.models import martini_bilayer as j_martini_bilayer
from ddcmd_tpu.parallel import bonded_shard as jbs
from ddcmd_tpu.potentials import bonded as jb
from ddcmd_tpu.potentials import bonded_batch as jbb
from ddcmd_tpu_torch.core.molecule import build_molecule_class as t_build_mol
from ddcmd_tpu_torch.core.system import build_system as t_build_system
from ddcmd_tpu_torch.integrators import constraints as tc
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.parallel import bonded_shard as tbs
from ddcmd_tpu_torch.parallel.brick import gid64
from ddcmd_tpu_torch.potentials import bonded_batch as tbb
from ddcmd_tpu_torch.run.forces import bonded_tables

from tests.test_torch_bonded import _bonded_tables

torch.set_num_threads(2)

LOCAL_CAP = 12


def _pool(seed=0):
    """A 24-row pool (12 local rows, 12 ghost rows) of int32-range gids:
    two masked rows, one gid present as a local row and as a ghost image,
    and gids 1000+ absent.  Returns (gids, mask) as numpy."""
    rng = np.random.default_rng(seed)
    gids = rng.permutation(np.arange(100, 100 + 24)).astype(np.int64)
    gids[20] = gids[3]                   # a ghost image of local row 3
    mask = np.ones(24, bool)
    mask[[7, 15]] = False
    return gids, mask


def test_resolve_batched_and_constraints_equal_jax():
    gids, mask = _pool(seed=2)
    rng = np.random.default_rng(3)
    pick = np.concatenate([gids, [1000]])
    plan = {"types": [{"gids": rng.choice(pick, (9, 3))},
                      {"gids": rng.choice(pick, (5, 4))}]}
    jres = jbs.resolve_batched(
        {"types": [{"gids": jnp.asarray(t["gids"])} for t in plan["types"]]},
        jnp.asarray(gids), jnp.asarray(mask), LOCAL_CAP)
    tres = tbs.resolve_batched(
        {"types": [{"gids": torch.as_tensor(t["gids"])}
                   for t in plan["types"]]},
        torch.as_tensor(gids), torch.as_tensor(mask), LOCAL_CAP)
    for (jr, jw), (tr, tw) in zip(jres, tres):
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    cons = rng.choice(pick, (20, 3))
    cons[::3, 2] = -1                    # padded group slots
    cons[1] = [gids[2], gids[14], -1]    # a ghost member
    ja, jw = jbs.resolve_constraints(jnp.asarray(cons), jnp.asarray(gids),
                                     jnp.asarray(mask), LOCAL_CAP)
    ta, tw = tbs.resolve_constraints(torch.as_tensor(cons),
                                     torch.as_tensor(gids),
                                     torch.as_tensor(mask), LOCAL_CAP)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw[1] == 0


def test_gid_key_of_pairs_equals_jax_pack_gid():
    """The port's int64 gid key (parallel/brick.gid64) of the JAX
    package's (n, 2) [lo, hi] layout is its pack_gid's lo + (hi << 32)."""
    pairs = np.array([[5, 0], [7, 3], [0xFFFFFFFF, 1]], np.uint32)
    want = np.array([5, 7 + (3 << 32), 0xFFFFFFFF + (1 << 32)], np.int64)
    np.testing.assert_array_equal(gid64(pairs), want)
    np.testing.assert_array_equal(gid64(want), want)
    np.testing.assert_array_equal(
        gid64(pairs[:2]), np.asarray(jbs.pack_gid(jnp.asarray(pairs[:2]))))


def test_junction_terms_raise_with_gids():
    """A term joining two residue instances (a junction) stays in the
    batched plan's leftover; the mesh's plan no longer raises for it but
    keys the leftover by gid (leftover_gid_tables), and resolve_terms
    maps it to pool rows and ownership weights as the JAX package's
    resolver does, on the same pool."""
    terms = {"bonds": torch.tensor([[0, 1], [2, 3], [1, 2]]),
             "bond_parms": torch.ones((3, 2))}
    inst = [("A", [0, 1]), ("A", [2, 3])]
    gids, mask = _pool(seed=4)
    gid = np.concatenate([gids[[2, 14, 9, 4]], np.arange(4) + 5000])
    plan, left = tbb.build_batched_bonded(terms, inst, 8, gid=gid)
    assert left["bonds"].tolist() == [[1, 2]]
    assert plan["types"][0]["gids"].tolist() == [[gid[0], gid[1]],
                                                 [gid[2], gid[3]]]
    plan, left = tbs.mesh_bonded_plan(terms, inst, 8, gid)
    assert left["bonds_gids"].tolist() == [[gid[1], gid[2]]]
    assert "bonds" not in left
    jleft = jbs.leftover_gid_tables(
        {"bonds": jnp.asarray([[1, 2]]), "bond_parms": jnp.ones((1, 2))},
        gid)
    np.testing.assert_array_equal(left["bonds_gids"].numpy(),
                                  np.asarray(jleft["bonds_gids"]))
    tres = tbs.resolve_terms(left, torch.as_tensor(gids),
                             torch.as_tensor(mask), LOCAL_CAP)
    jres = jbs.resolve_terms(jleft, jnp.asarray(gids), jnp.asarray(mask),
                             LOCAL_CAP)
    np.testing.assert_array_equal(tres["bonds"].numpy(),
                                  np.asarray(jres["bonds"]))
    np.testing.assert_array_equal(tres["bonds_w"].numpy(),
                                  np.asarray(jres["bonds_w"]))
    assert tres["bonds_w"].tolist() == [0.0]      # its anchor is a ghost


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bilayer"))
    os.makedirs(d, exist_ok=True)
    j_martini_bilayer(d, nx=4, ny=4, water_nm=1.2)
    return (j_build_system(j_load(d)[0], d), t_build_system(t_load(d)[0], d),
            d)


def test_gid_tables_equal_jax(systems):
    """build_batched_bonded(gid=) per-type gids, the constraint,
    molecule and RATTLE-template gid tables: equal to the JAX
    package's."""
    jsd, tsd, d = systems
    n = tsd.state.n_local
    gid = np.asarray(tsd.collection.gid, np.int64)
    jplan, _ = jbb.build_batched_bonded(
        _bonded_tables(jsd, jb), jsd.residue_instances, tsd.state.n_pad,
        jnp.float32, gid=gid)
    tplan, _ = tbb.build_batched_bonded(bonded_tables(tsd),
                                     tsd.residue_instances, tsd.state.n_pad,
                                     gid=gid)
    assert [t["name"] for t in tplan["types"]] == \
        [t["name"] for t in jplan["types"]]
    for jt, tt in zip(jplan["types"], tplan["types"]):
        np.testing.assert_array_equal(tt["gids"].numpy(),
                                      np.asarray(jt["gids"]))
    jcons = jbs.constraint_gid_tables(jsd.bonded, gid)
    tcons = tbs.constraint_gid_tables(tsd.bonded, gid)
    np.testing.assert_array_equal(tcons["cons_gids"].numpy(),
                                  np.asarray(jcons["cons_gids"]))
    np.testing.assert_array_equal(tcons["cons_pairs"], jcons["cons_pairs"])
    jdb, tdb = j_load(d)[0], t_load(d)[0]
    jmol = j_build_mol(jdb, jdb.get("system", "SYSTEM"),
                       jsd.collection.species_names, jsd.collection.gid)
    tmol = t_build_mol(tdb, tdb.get("system", "SYSTEM"),
                       tsd.collection.species_names, tsd.collection.gid)
    np.testing.assert_array_equal(
        tbs.molecule_gid_tables(tmol, gid)["mol_gids"].numpy(),
        np.asarray(jbs.molecule_gid_tables(jmol, gid)["mol_gids"]))
    jtm, _ = jc.build_constraint_templates(
        jsd.bonded.cons_atoms, jsd.bonded.cons_pairs, jsd.bonded.cons_dist,
        jsd.residue_instances, gid)
    ttm, _ = tc.build_constraint_templates(
        tsd.bonded.cons_atoms, tsd.bonded.cons_pairs, tsd.bonded.cons_dist,
        tsd.residue_instances, gid)
    for jt, tt in zip(jtm["types"], ttm["types"]):
        np.testing.assert_array_equal(tt["gids"].numpy(),
                                      np.asarray(jt["gids"]))
    assert n == 528


def test_resolved_batched_eval_matches_jax(systems):
    """batched_bonded_eval on a rank's pool (half the residues' rows
    local, the rest split between ghost rows and absent) with the
    resolver's (rows, w): equal to the JAX package's resolved evaluation
    within tests/test_bonded_batch.py's tolerances (f, e, virial 1e-3
    absolute, pe 1e-4), and every disowned row exactly 0."""
    jsd, tsd, _ = systems
    n = tsd.state.n_local
    gid = np.asarray(tsd.collection.gid, np.int64)
    rng = np.random.default_rng(11)
    order = rng.permutation(n)
    pool_rows = order[: n - 40]          # 40 particles absent
    n_l = (n - 40) // 2
    pool_gid = gid[pool_rows]
    pool_mask = np.ones(len(pool_rows), bool)
    r = np.asarray(jsd.state.r, np.float32)[pool_rows]
    r = r + (rng.standard_normal(r.shape) * 0.05).astype(np.float32)
    L = np.asarray(jsd.box.lengths, np.float32)
    jplan, _ = jbb.build_batched_bonded(
        _bonded_tables(jsd, jb), jsd.residue_instances, tsd.state.n_pad,
        jnp.float32, gid=gid)
    tplan, _ = tbb.build_batched_bonded(bonded_tables(tsd),
                                     tsd.residue_instances, tsd.state.n_pad,
                                     gid=gid)
    jres = jbs.resolve_batched(jplan, jnp.asarray(pool_gid),
                               jnp.asarray(pool_mask), n_l)
    tres = tbs.resolve_batched(tplan, torch.as_tensor(pool_gid),
                               torch.as_tensor(pool_mask), n_l)
    for (jr, jw), (tr, tw) in zip(jres, tres):
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    n_pool = len(pool_rows)
    fj, ej, vj, pej = jbb.batched_bonded_eval(
        jnp.asarray(r), jnp.asarray(L), jplan, n_pool, jnp.float32,
        resolved=jres)
    ft, et, vt, pet = tbb.batched_bonded_eval(
        torch.tensor(r), torch.tensor(L), tplan, n_pool, torch.float32,
        resolved=tres)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-3)
    assert float(et) == pytest.approx(float(ej), abs=1e-3)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pet.numpy(), np.asarray(pej), rtol=0,
                               atol=1e-4)
    owned_rows = torch.cat([rows.reshape(len(w), -1)[w > 0].reshape(-1)
                            for rows, w in tres])
    free = torch.ones(n_pool, dtype=torch.bool)
    free[owned_rows] = False
    assert free.any() and not ft[free].any() and not pet[free].any()
    assert 0 < float(sum(w.sum() for _, w in tres)) < sum(
        len(w) for _, w in tres)
