"""Sharded bonded terms: gid-keyed covalent topology on a rank mesh.

Counterpart of ddcmd_tpu/parallel/bonded_shard.py (the reference keeps
covalent term lists on every rank and its MOLECULE ddcRule keeps whole
molecules on one rank, ddcRuleMolecule.c:43; each rank evaluates the
terms whose atoms it owns).  The per-term parameters are row-independent
constants, so the term lists ride along on every rank keyed by global
id; each rank resolves gids to its local + ghost pool rows (a stable
argsort of the pool gids and searchsorted: a pure gather, no
communication) once per rebuild, and weights each term by whether this
rank owns it.  Molecule-coherent migration (parallel/brick.py, the head
bead's position decides) makes every owned term's atoms present.

Keys: a gid is one int64 (parallel/brick.gid64, which also keys the
JAX package's (n, 2) [lo, hi] layout as lo + (hi << 32), its pack_gid).
torch always has int64, so the JAX package's gate on gids above 2^31
without x64 (its bonded_gid_tables) has no counterpart here.

Terms resolve per residue type (resolve_batched, on the plan of
mesh_bonded_plan) and, where they cross residue instances (CHARMM
junctions, CMAP) or break their template, per term (resolve_terms on
the gid-keyed leftover of leftover_gid_tables, the JAX package's
bonded_shard.py:39-111).  A term is owned when all its atoms resolve and
its anchor row is local: the first atom, the N atom (slot 1) of a CMAP
term.  Both mesh engines (parallel/brickstep_cells and
parallel/brickstep) evaluate the two beside each other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..potentials.bonded import FAMILIES
from ..potentials.bonded_batch import build_batched_bonded, has_terms


GID_FAMILIES = tuple(k for k, _ in FAMILIES)


def mesh_bonded_plan(terms: dict, residue_instances, n: int, gid,
                     device="cpu", dtype=torch.float32):
    """The mesh's gid-keyed bonded tables: (plan, leftover).  plan is
    build_batched_bonded(gid=...)'s batched plan (every residue type,
    however few its instances), leftover the gid-keyed tables
    (leftover_gid_tables) of the terms that do not batch, or None when
    every term batches."""
    plan, left = build_batched_bonded(terms, residue_instances, n, dtype,
                                      device, gid=gid)
    return plan, (leftover_gid_tables(left, gid, device)
                  if has_terms(left) else None)


def bonded_gid_tables(bt, gid, device_tables, device="cpu"):
    """device_bonded_tables output with every family's row indices
    replaced by the gids of those rows (<family>_gids, int64): the
    tables each rank resolves per call (resolve_terms).  `bt` is the
    BondedTerms the tables were built from."""
    gid = np.asarray(gid, np.int64)
    out = dict(device_tables)
    for fam in GID_FAMILIES:
        arr = getattr(bt, fam, None)
        if arr is not None and fam in out:
            out[fam + "_gids"] = torch.as_tensor(gid[np.asarray(arr)],
                                                 device=device)
            del out[fam]
    return out


def leftover_gid_tables(leftover: dict, gid, device="cpu"):
    """Gid-key the row-indexed families of a build_batched_bonded
    leftover (junction terms, CMAP), as bonded_gid_tables keys a whole
    topology."""
    gid = np.asarray(gid, np.int64)
    out = dict(leftover)
    for fam in GID_FAMILIES:
        if fam in out:
            rows = out.pop(fam).cpu().numpy()
            out[fam + "_gids"] = torch.as_tensor(gid[rows], device=device)
    return out


def _sorted_pool(pool_gid64, pool_mask):
    """(order, sorted keys) of the pool gids, masked rows keyed past every
    gid.  The argsort is stable, so among equal gids the lowest pool row
    (a local row before its ghost images) is found first, as in the JAX
    package."""
    big = torch.iinfo(torch.int64).max
    keyed = torch.where(pool_mask, pool_gid64,
                        torch.full_like(pool_gid64, big))
    order = torch.argsort(keyed, stable=True)
    return order, keyed[order]


def _lookup(order, sg, g):
    """(rows, found) of gids `g` (any shape) in the sorted pool."""
    n_pool = sg.shape[0]
    pos = torch.searchsorted(sg, g.reshape(-1)).clamp(0, n_pool - 1)
    pos = pos.reshape(g.shape)
    return order[pos], sg[pos] == g


def resolve_terms(tables: dict, pool_gid64, pool_mask, local_cap: int):
    """Per rank: gid-keyed term tables (bonded_gid_tables,
    leftover_gid_tables) -> pool-row tables and per-term weights
    (<family>_w) for bonded.bonded_eval.  A term is owned iff all its
    atoms resolve and its anchor atom is a local row (slot 0, slot 1 for
    CMAP); rows of a term not found are 0 (its weight is 0).  The other
    entries pass through."""
    order, sg = _sorted_pool(pool_gid64, pool_mask)
    out = {}
    for fam in GID_FAMILIES:
        g = tables.get(fam + "_gids")
        if g is None:
            continue
        rows, found = _lookup(order, sg, g)
        anchor = 1 if fam == "cmap_atoms" else 0
        owned = found.all(dim=-1) & (rows[:, anchor] < local_cap)
        out[fam] = torch.where(found, rows, torch.zeros_like(rows))
        out[fam + "_w"] = owned.to(torch.float32)
    for k, v in tables.items():
        if not k.endswith("_gids") and k not in out:
            out[k] = v
    return out


def resolve_batched(plan: dict, pool_gid64, pool_mask, local_cap: int):
    """Per rank: each residue type's (M, A) instance gids (a plan built
    with build_batched_bonded(gid=...) or build_constraint_templates) ->
    pool rows.  An instance is owned iff all its atoms resolve and its
    first atom is a local row.  Returns a list aligned with plan["types"]
    of (rows (M*A,) int64 [missing -> n_pool], w (M,) f32)."""
    order, sg = _sorted_pool(pool_gid64, pool_mask)
    n_pool = sg.shape[0]
    out = []
    for tp in plan["types"]:
        rows, found = _lookup(order, sg, tp["gids"])
        owned = found.all(dim=-1) & (rows[:, 0] < local_cap)
        rows = torch.where(found, rows, torch.full_like(rows, n_pool))
        out.append((rows.reshape(-1), owned.to(torch.float32)))
    return out


def constraint_gid_tables(bt, gid, device="cpu"):
    """Host side: gid-keyed constraint groups, dict(cons_gids (G, m)
    int64 [pad -> -1], cons_pairs, cons_dist), or None without
    constraints."""
    if bt.cons_atoms is None or bt.n_constraints == 0:
        return None
    gid = np.asarray(gid, np.int64)
    ca = np.asarray(bt.cons_atoms)
    cg = np.where(ca >= 0, gid[np.clip(ca, 0, len(gid) - 1)], -1)
    return dict(cons_gids=torch.as_tensor(cg, device=device),
                cons_pairs=np.asarray(bt.cons_pairs),
                cons_dist=np.asarray(bt.cons_dist))


def resolve_constraints(cons_gids, pool_gid64, pool_mask, local_cap: int):
    """Per rank: (G, m) gid-keyed groups -> rows.  A group is owned iff
    every non-pad atom resolves to a LOCAL row, it has at least one, and
    its first atom is local.  Returns (atoms (G, m) int64 [pad or missing
    -> n_pool], group_w (G,) f32)."""
    order, sg = _sorted_pool(pool_gid64, pool_mask)
    n_pool = sg.shape[0]
    pad = cons_gids < 0
    rows, found = _lookup(order, sg, cons_gids)
    found = found & ~pad
    local = found & (rows < local_cap)
    owned = (local | pad).all(dim=-1) & local.any(dim=-1) & local[:, 0]
    atoms = torch.where(local, rows, torch.full_like(rows, n_pool))
    return atoms, owned.to(torch.float32)


def molecule_gid_tables(mol, gid, device="cpu"):
    """Gid-keyed membership of the multi-bead molecules for the sharded
    molecular virial (molecularPressure.c:22-67): dict(mol_gids (M, A)
    int64 [pad -> -1]), or None when no molecule has more than one bead
    (single-bead molecules contribute nothing and are dropped)."""
    if mol is None or mol.is_trivial:
        return None
    amask = np.asarray(mol.atom_mask)
    nz = amask.sum(axis=1) > 1.0
    if not nz.any():
        return None
    gid = np.asarray(gid, np.int64)
    rows = np.asarray(mol.atom_rows)[nz]
    amask = amask[nz]
    A = int(np.count_nonzero(amask, axis=1).max())
    mg = np.where(amask[:, :A] > 0,
                  gid[np.clip(rows[:, :A], 0, len(gid) - 1)], -1)
    return dict(mol_gids=torch.as_tensor(mg, device=device))
