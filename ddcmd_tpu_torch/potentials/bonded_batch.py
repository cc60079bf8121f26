"""Residue-template batched bonded evaluation.

Counterpart of ddcmd_tpu/potentials/bonded_batch.py for the families
the Martini bilayer uses: harmonic bonds (func 1), angles (harmonic,
G96 cosine func 2 and REB) and the `rf_add` exclusion term.  Terms are
instantiated from per-residue-type templates (bonded.instantiate_bonded),
so every instance of a type has the same local topology.  All instances
of a type are batched as (instance, term) arrays:

  * one slice of the type's atoms (builder decks store each type's
    instances contiguously) or one row gather otherwise,
  * term geometry by static local indexing of the (M, A, 3) block,
  * per-atom force/pe accumulation with index_add_ over the local atom
    index (the JAX package's one-hot MXU matmul),
  * one slice-add (or index_add_) writeback.

Families the port does not evaluate (torsions, impropers, bonded LJ
pairs: ROADMAP queue 1, item 12) and terms that cross residue instances
(which need the generic gather/scatter evaluator, not ported) raise
NotImplementedError when the plan is built.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import nearest_image

# families evaluated here: key -> (arity R, parm keys)
_FAMS = (
    ("bonds", 2, ("bond_parms",)),
    ("angles", 3, ("angle_parms", "angle_kind")),
    ("exclusions", 2, ("excl_tidx", "excl_qq")),
)
_UNPORTED = ("torsions", "impropers", "bpairs", "cmap_atoms")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_batched_bonded(terms: dict, residue_instances, n_pad: int,
                         dtype=torch.float32, device="cpu", gid=None):
    """Split the term tables (device_bonded_tables) into per-residue-type
    batches.  Returns the batch plan, or None when there is nothing to
    evaluate.  With `gid` (rows -> global ids) each type also carries its
    instances' gids, tp["gids"] (M, A) int64, for the sharded resolver
    (parallel/bonded_shard.resolve_batched).  Raises NotImplementedError
    for what the port cannot evaluate (see the module docstring)."""
    for key in _UNPORTED:
        if key in terms:
            raise NotImplementedError(
                f"bonded family {key} has no evaluator in the port yet "
                "(ROADMAP queue 1, item 12)")
    if not any(key in terms for key, _, _ in _FAMS):
        return None
    if not residue_instances:
        raise NotImplementedError(
            "bonded terms without residue instances need the generic "
            "evaluator, not ported yet (ROADMAP queue 1, item 12)")
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

    def ten(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)

    types: dict[int, dict] = {}
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
            raise NotImplementedError(
                f"{int(spill.sum())} {key} terms cross residue instances or "
                "break the residue template; they need the generic bonded "
                "evaluator, not ported yet (ROADMAP queue 1, item 12)")
    if not types:
        return None

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
    meta = dict(excl_mode=terms.get("excl_mode"), rcut2=terms.get("rcut2"),
                excl_krf=terms.get("excl_krf"),
                excl_crf=terms.get("excl_crf"))
    return dict(types=plan, meta=meta)


def batched_bonded_eval(r, box_lengths, plan: dict, n_pad: int, dtype,
                        resolved=None):
    """Evaluate the batched types; returns (f (n_pad, 3), e, virial (3, 3),
    pe (n_pad,)) with e == sum(pe), as the JAX package's
    batched_bonded_eval.

    resolved: None on a single device (rows baked into the plan), or on
    a rank of the mesh a list aligned with plan["types"] of (rows (M*A,)
    pool rows [missing -> n_pad], w (M,) ownership weights) from
    parallel/bonded_shard.resolve_batched.  Instances this rank does not
    own are evaluated on a fixed unit geometry with weight 0 (1/r stays
    finite), so each instance's terms land exactly once across the mesh;
    their rows, the missing ones included, receive exact zeros."""
    L = box_lengths.to(dtype)
    meta = plan["meta"]
    dev = r.device
    # one spill row past n_pad takes what missing rows would receive
    n_out = n_pad + (resolved is not None)
    f = torch.zeros((n_out, 3), dtype=dtype, device=dev)
    pe = torch.zeros((n_out,), dtype=dtype, device=dev)
    e = torch.zeros((), dtype=dtype, device=dev)
    virial = torch.zeros((3, 3), dtype=dtype, device=dev)
    units = torch.eye(3, dtype=dtype, device=dev)

    for itp, tp in enumerate(plan["types"]):
        M, A = tp["M"], tp["A"]
        w_inst = None
        if resolved is not None:
            rows_t, w_inst = resolved[itp]
            blk = r[rows_t.clamp(max=n_pad - 1)]
        elif tp["start"] is not None:
            blk = r[tp["start"]:tp["start"] + M * A]
        else:
            blk = r[tp["rows"]]
        rm = blk.reshape(M, A, 3)

        def san(dr, axis, w_inst=w_inst):
            """Disowned instances gather arbitrary rows: unit geometry."""
            if w_inst is None:
                return dr
            return torch.where((w_inst > 0)[:, None, None], dr, units[axis])

        def wmul(x, w_inst=w_inst):
            if w_inst is None:
                return x
            return x * w_inst.reshape((M,) + (1,) * (x.dim() - 1))

        contribs_f = []        # (M, T, 3) per role, in slot order
        contribs_pe = []       # (M, T) per role

        def emit(fvecs, pevals):
            contribs_f.extend(fvecs)
            contribs_pe.extend(pevals)

        fams = tp["fams"]
        if "bonds" in fams:
            fam = fams["bonds"]
            li, lj = fam["loc"]
            parm = fam["bond_parms"]                     # (M, T, 2)
            dr = san(nearest_image(rm[:, li] - rm[:, lj], L), 0)
            b = torch.sqrt((dr * dr).sum(-1))
            kb, b0 = parm[..., 0], parm[..., 1]
            db = b - b0
            eb = wmul(kb * db * db)                      # no 1/2 (CHARMM)
            fi = wmul(-2.0 * kb * db / b)[..., None] * dr
            emit([fi, -fi], [0.5 * eb, 0.5 * eb])
            virial = virial + torch.einsum("mta,mtc->ac", fi, dr)
            e = e + eb.sum()

        if "angles" in fams:
            fam = fams["angles"]
            li, lj, lk = fam["loc"]
            parm = fam["angle_parms"]                    # (M, T, 2)
            kind = fam["angle_kind"][..., 0]             # (M, T)
            rij = san(nearest_image(rm[:, li] - rm[:, lj], L), 0)
            rkj = san(nearest_image(rm[:, lk] - rm[:, lj], L), 1)
            bij = torch.sqrt((rij * rij).sum(-1))
            bkj = torch.sqrt((rkj * rkj).sum(-1))
            uij = rij / bij[..., None]
            ukj = rkj / bkj[..., None]
            cosA = torch.clamp((uij * ukj).sum(-1), -1.0 + 1e-7, 1.0 - 1e-7)
            kt, t0 = parm[..., 0], parm[..., 1]
            sin2 = 1.0 - cosA * cosA
            sinA = torch.sqrt(sin2)
            aD_h = torch.arccos(cosA) - t0
            aD_c = cosA - t0
            e_k = (kt * aD_h * aD_h, kt * aD_c * aD_c,
                   kt * aD_c * aD_c / sin2)
            coef_k = (2.0 * kt * aD_h / sinA, -2.0 * kt * aD_c,
                      -2.0 * kt * aD_c * (1.0 - cosA * t0) / (sin2 * sin2))
            zero = torch.zeros_like(cosA)
            e_a, coef = zero, zero
            for k in range(3):
                e_a = torch.where(kind == k, e_k[k], e_a)
                coef = torch.where(kind == k, coef_k[k], coef)
            e_a, coef = wmul(e_a), wmul(coef)
            fi = (coef / bij)[..., None] * (ukj - uij * cosA[..., None])
            fk = (coef / bkj)[..., None] * (uij - ukj * cosA[..., None])
            emit([fi, -(fi + fk), fk], [zero, e_a, zero])
            virial = virial + torch.einsum("mta,mtc->ac", fi, rij) \
                + torch.einsum("mta,mtc->ac", fk, rkj)
            e = e + e_a.sum()

        if "exclusions" in fams:
            fam = fams["exclusions"]
            li, lj = fam["loc"]
            qq = fam["excl_qq"][..., 0]                  # (M, T)
            dr = san(nearest_image(rm[:, li] - rm[:, lj], L), 0)
            r2 = (dr * dr).sum(-1)
            w = wmul((r2 < meta["rcut2"]).to(dtype))
            # rf_add: the pair kernel masked these pairs; add back only
            # the RF polarization part (bioMartini.c:1124-1208)
            e_x = qq * (meta["excl_krf"] * r2 - meta["excl_crf"]) * w
            dvdr = qq * (2.0 * meta["excl_krf"]) * w
            fi = -dvdr[..., None] * dr
            emit([fi, -fi], [0.5 * e_x, 0.5 * e_x])
            virial = virial + torch.einsum("mta,mtc->ac", fi, dr)
            e = e + e_x.sum()

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
