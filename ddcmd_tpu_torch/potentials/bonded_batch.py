"""Residue-template batched bonded evaluation.

Counterpart of ddcmd_tpu/potentials/bonded_batch.py: harmonic bonds,
the three angle kinds, torsions, impropers, bonded LJ pairs and the
`rf_add` exclusion term.  Terms are instantiated from per-residue-type
templates (bonded.instantiate_bonded), so every instance of a type has
the same local topology.  All instances of a type are batched as
(instance, term) arrays:

  * one slice of the type's atoms (builder decks store each type's
    instances contiguously) or one row gather otherwise,
  * term geometry by static local indexing of the (M, A, 3) block, the
    term math that of potentials/bonded.py (torsions and impropers by
    autograd),
  * per-atom force/pe accumulation with index_add_ over the local atom
    index (the JAX package's one-hot MXU matmul),
  * one slice-add (or index_add_) writeback.

Terms that cross residue instances (CHARMM chain junctions, CMAP) and
terms that break a type's template stay in the leftover dict
build_batched_bonded returns beside the plan, for the generic
evaluator bonded.bonded_eval.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import nearest_image
from .bonded import (FAMILIES, angle_term, bond_term, bpair_term,
                     excl_rf_term, outer_sum, torsion_term)

# families batched here, in emission order: key -> (arity R, parm keys)
_FAMS = (
    ("bonds", 2, ("bond_parms",)),
    ("angles", 3, ("angle_parms", "angle_kind")),
    ("torsions", 4, ("torsion_parms",)),
    ("impropers", 4, ("improper_parms",)),
    ("bpairs", 2, ("bpair_parms",)),
    ("exclusions", 2, ("excl_tidx", "excl_qq")),
)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def has_terms(terms: dict) -> bool:
    """True when the term dict holds any family to evaluate."""
    return any(key in terms for key, _ in FAMILIES)


def build_batched_bonded(terms: dict, residue_instances, n_pad: int,
                         dtype=torch.float32, device="cpu", gid=None,
                         min_instances: int = 1):
    """Split the term tables (device_bonded_tables) into per-residue-type
    batches plus a leftover dict for the generic evaluator.

    Returns (plan, leftover): plan is None when nothing batches (no
    instances, or no family with a term inside one instance); leftover
    keeps every non-index entry of `terms` (modes, scalars, LJ flats,
    CMAP tables) and the index and parameter rows of the terms that did
    not batch, on `device`, so bonded.bonded_eval evaluates it as it is.
    With `gid` (rows -> global ids) each type also carries its
    instances' gids, tp["gids"] (M, A) int64, for the sharded resolver
    (parallel/bonded_shard.resolve_batched).  The terms of a type with
    fewer than `min_instances` instances stay in the leftover: a batch
    issues as many small kernels as the generic evaluator's whole family
    (Simulation batches types of 2 or more instances; the mesh, which
    evaluates no leftover, batches every type)."""

    def ten(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)

    def moved(tab):
        return {k: v.to(device) if isinstance(v, torch.Tensor) else v
                for k, v in tab.items()}

    if not residue_instances:
        return None, moved(terms)
    inst_of = np.full(n_pad, -1, np.int64)
    local_of = np.full(n_pad, -1, np.int64)
    type_names = []
    type_id = {}
    inst_type = []
    inst_rows = {}
    for i, (name, rows) in enumerate(residue_instances):
        rows = np.asarray(rows, np.int64)
        inst_of[rows] = i
        local_of[rows] = np.arange(len(rows))
        if name not in type_id:
            type_id[name] = len(type_names)
            type_names.append(name)
            inst_rows[type_id[name]] = []
        inst_type.append(type_id[name])
        inst_rows[type_id[name]].append(rows)
    inst_type = np.asarray(inst_type)

    types: dict[int, dict] = {}
    leftover = dict(terms)
    for key, R, parm_keys in _FAMS:
        if key not in terms:
            continue
        idx = _np(terms[key])
        inst = inst_of[idx[:, 0]]
        ok = inst >= 0
        for rr in range(1, R):
            ok &= inst_of[idx[:, rr]] == inst
        spill = ~ok
        for t in range(len(type_names)):
            sel = ok & (inst_type[np.maximum(inst, 0)] == t) & (inst >= 0)
            tids = np.nonzero(sel)[0]
            if len(tids) == 0:
                continue
            insts = inst[tids]
            # stable sort by instance keeps template term order inside
            order = np.argsort(insts, kind="stable")
            tids = tids[order]
            insts = insts[order]
            uinst, counts = np.unique(insts, return_counts=True)
            M_all = np.sum(inst_type == t)
            if M_all < min_instances:
                spill[tids] = True          # too few instances to batch
                continue
            if len(uinst) != M_all or counts.min() != counts.max():
                spill[tids] = True          # uneven instantiation
                continue
            Tt = int(counts[0])
            loc = local_of[idx[tids]].reshape(M_all, Tt, R)
            if not (loc == loc[0]).all():
                spill[tids] = True          # differing local patterns
                continue
            fam = types.setdefault(t, {}).setdefault(key, {})
            fam["loc"] = [ten(loc[0][:, rr]) for rr in range(R)]
            fam["loc_np"] = loc[0]
            for pk in parm_keys:
                pv = _np(terms[pk])[tids].reshape(M_all, Tt, -1)  # (M, T, P)
                if np.issubdtype(pv.dtype, np.floating):
                    fam[pk] = ten(pv, dtype)
                else:
                    fam[pk] = ten(pv)
        if spill.any():
            rows = torch.as_tensor(np.nonzero(spill)[0])
            for k in (key,) + parm_keys:
                leftover[k] = terms[k][rows.to(terms[k].device)]
        else:
            for k in (key,) + parm_keys:
                leftover.pop(k)
    leftover = moved(leftover)
    if not types:
        return None, leftover

    plan = []
    for t, fams in sorted(types.items()):
        rows = np.stack(inst_rows[t])                    # (M, A)
        M, A = rows.shape
        flat = rows.reshape(-1)
        start = int(flat[0])
        contiguous = bool((flat == start + np.arange(M * A)).all())
        # accumulation map: term-role slot -> local atom
        slots = np.concatenate([fams[k]["loc_np"][:, rr]
                                for k, R, _ in _FAMS if k in fams
                                for rr in range(R)])
        tp = dict(name=type_names[t], fams=fams, M=M, A=A,
                  rows=None if contiguous else ten(flat),
                  start=start if contiguous else None,
                  slots=ten(slots))
        if gid is not None:
            tp["gids"] = ten(np.asarray(gid, np.int64)[rows])
        plan.append(tp)
    meta = {k: terms.get(k) for k in ("excl_mode", "rcut2", "excl_krf",
                                      "excl_crf", "bpair_rcut2")}
    return dict(types=plan, meta=meta), leftover


def batched_bonded_eval(r, box_lengths, plan: dict, n_pad: int, dtype,
                        resolved=None):
    """Evaluate the batched types; returns (f (n_pad, 3), e, virial (3, 3),
    pe (n_pad,)) with e == sum(pe), as the JAX package's
    batched_bonded_eval.

    resolved: None on a single device (rows baked into the plan), or on
    a rank of the mesh a list aligned with plan["types"] of (rows (M*A,)
    pool rows [missing -> n_pad], w (M,) ownership weights) from
    parallel/bonded_shard.resolve_batched.  Instances this rank does not
    own are evaluated on a fixed unit geometry with weight 0 (1/r and
    the torsions' autograd stay finite), so each instance's terms land
    exactly once across the mesh; their rows, the missing ones included,
    receive exact zeros."""
    L = box_lengths.to(dtype)
    meta = plan["meta"]
    dev = r.device
    # one spill row past n_pad takes what missing rows would receive
    n_out = n_pad + (resolved is not None)
    f = torch.zeros((n_out, 3), dtype=dtype, device=dev)
    pe = torch.zeros((n_out,), dtype=dtype, device=dev)
    e = torch.zeros((), dtype=dtype, device=dev)
    virial = torch.zeros((3, 3), dtype=dtype, device=dev)

    for itp, tp in enumerate(plan["types"]):
        M, A = tp["M"], tp["A"]
        w_inst = w = None
        if resolved is not None:
            rows_t, w_inst = resolved[itp]
            w = w_inst[:, None]                          # against (M, T)
            blk = r[rows_t.clamp(max=n_pad - 1)]
        elif tp["start"] is not None:
            blk = r[tp["start"]:tp["start"] + M * A]
        else:
            blk = r[tp["rows"]]
        rm = blk.reshape(M, A, 3)

        def disp(loc, a, b, unit, w_inst=w_inst):
            """min-image rm[:, a] - rm[:, b] of each term; disowned
            instances gather arbitrary rows and get `unit`."""
            d = nearest_image(rm[:, loc[a]] - rm[:, loc[b]], L)
            if w_inst is None:
                return d
            return torch.where((w_inst > 0)[:, None, None], d,
                               torch.tensor(unit, dtype=dtype, device=dev))

        contribs_f = []        # (M, T, 3) per role, in slot order
        contribs_pe = []       # (M, T) per role
        fams = tp["fams"]
        for key, _, _ in _FAMS:
            if key not in fams:
                continue
            fam = fams[key]
            loc = fam["loc"]
            if key == "bonds":
                dr = disp(loc, 0, 1, (1.0, 0.0, 0.0))
                et, fi = bond_term(dr, fam["bond_parms"], w)
                fs, pes = [fi, -fi], [0.5 * et, 0.5 * et]
                virial = virial + outer_sum(fi, dr)
            elif key == "angles":
                rij = disp(loc, 0, 1, (1.0, 0.0, 0.0))
                rkj = disp(loc, 2, 1, (0.0, 1.0, 0.0))
                et, fi, fk = angle_term(rij, rkj, fam["angle_parms"],
                                        fam["angle_kind"][..., 0], w)
                z = torch.zeros_like(et)
                fs, pes = [fi, -(fi + fk), fk], [z, et, z]
                virial = virial + outer_sum(fi, rij) + outer_sum(fk, rkj)
            elif key in ("torsions", "impropers"):
                d0 = disp(loc, 0, 1, (1.0, 0.0, 0.0))
                d2 = disp(loc, 2, 1, (0.0, 1.0, 0.0))
                d3 = disp(loc, 3, 1, (0.0, 1.0, 1.0))
                parm = fam["torsion_parms" if key == "torsions"
                           else "improper_parms"]
                et, fi, fk, fl = torsion_term(d0, d2, d3, parm,
                                              key == "impropers", w)
                z = torch.zeros_like(et)
                fs, pes = [fi, -(fi + fk + fl), fk, fl], [z, et, z, z]
                virial = virial + outer_sum(fi, d0) + outer_sum(fk, d2) \
                    + outer_sum(fl, d3)
            elif key == "bpairs":
                dr = disp(loc, 0, 1, (1.0, 0.0, 0.0))
                et, fi = bpair_term(dr, fam["bpair_parms"],
                                    meta["bpair_rcut2"], w)
                fs, pes = [fi, -fi], [0.5 * et, 0.5 * et]
                virial = virial + outer_sum(fi, dr)
            else:
                dr = disp(loc, 0, 1, (1.0, 0.0, 0.0))
                et, fi = excl_rf_term(dr, fam["excl_qq"][..., 0],
                                      meta["rcut2"], meta["excl_krf"],
                                      meta["excl_crf"], w)
                fs, pes = [fi, -fi], [0.5 * et, 0.5 * et]
                virial = virial + outer_sum(fi, dr)
            contribs_f.extend(fs)
            contribs_pe.extend(pes)
            e = e + et.sum()

        # accumulate term-role slots onto local atoms (segmented sum)
        C = torch.cat(contribs_f, dim=1)                 # (M, S, 3)
        PEc = torch.cat(contribs_pe, dim=1)              # (M, S)
        Fmol = torch.zeros((M, A, 3), dtype=dtype, device=dev)
        Fmol.index_add_(1, tp["slots"], C)
        PEmol = torch.zeros((M, A), dtype=dtype, device=dev)
        PEmol.index_add_(1, tp["slots"], PEc)
        # f and pe are this call's own buffers: add in place
        if resolved is not None:
            f.index_add_(0, rows_t, Fmol.reshape(M * A, 3))
            pe.index_add_(0, rows_t, PEmol.reshape(M * A))
        elif tp["start"] is not None:
            s0, s1 = tp["start"], tp["start"] + M * A
            f[s0:s1] += Fmol.reshape(M * A, 3)
            pe[s0:s1] += PEmol.reshape(M * A)
        else:
            f.index_add_(0, tp["rows"], Fmol.reshape(M * A, 3))
            pe.index_add_(0, tp["rows"], PEmol.reshape(M * A))
    return f[:n_pad], e, virial, pe[:n_pad]
