"""Holonomic constraints: per-residue velocity projections (RATTLE).

Counterpart of ddcmd_tpu/integrators/constraints.py (reference
nglfconstraint.c, ddcMD src/nglfconstraint.c:122-178, resMoveCons loop
:200-280):

  FRONT (pre-drift):  project velocities so post-drift pair distances
    satisfy (r_ab + v_ab dt)^2 = d_ab^2; nonlinear in lambda, solved by
    iterating the linearized n x n system (fixed iteration count).
  BACK (post-kick):   RATTLE projection r_ab . v_ab = 0 (one solve).

  M[ab,uv] = (r_ab . r_uv) * (((u==a)-(v==a)) /m_a - ((u==b)-(v==b)) /m_b)
  v_a += sum_uv ((u==a)-(v==a)) /m_a * lambda_uv * r_uv

Entry points, as in the JAX package:
  make_constraint_project   -- padded groups, row tables per call;
  build_constraint_fn       -- the generic projector with rows baked in
                               (topologies that are not template-regular);
  build_constraint_fn_batched -- the residue-template batched single-bond
                               RATTLE (every Martini deck: the main path);
  build_constraint_templates -- the per-type templates keyed by gid that
                               a sharded step resolves per call;
  constraint_residual       -- max relative bond-length error (host).

Single-distance groups have a closed form (one quadratic in
s = dt lam mu, Muller's form for the small root); larger groups go
through batched torch.linalg.solve.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import nearest_image


def _closed_form_lambda(a, vab, mu, d2, dt, mode_front):
    """Lagrange multiplier of one distance constraint per row: a (.., 3)
    the current separation, vab (.., 3) the relative velocity, mu the
    summed inverse masses, d2 the squared target length."""
    A = (a * a).sum(-1)
    if mode_front:
        # |a + dt vab + s a|^2 = d2 for s = dt lam mu: A s^2 + 2 B' s + C' = 0
        # with p = a + dt vab; Muller's form picks the small-|s| root (the
        # one Newton from lam = 0 converges to) without cancellation
        p = a + dt * vab
        Bp = (a * p).sum(-1)
        Cp = (p * p).sum(-1) - d2
        sq = torch.sqrt(torch.clamp(Bp * Bp - A * Cp, min=0.0))
        den = Bp + torch.where(Bp >= 0, sq, -sq)
        den = torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
        return (-Cp / den) / (dt * mu)
    return -(a * vab).sum(-1) / (A * mu)


def make_constraint_project(cons_pairs, cons_dist, dtype, m: int,
                            box_lengths=None, n_iter_front: int = 8,
                            device="cpu"):
    """cons_pairs (G,n,2) local atom slots; cons_dist (G,n) targets (pad 0);
    m = atoms per (padded) group.  Returns
    project_all(r_ext, v_ext, rmass_ext, atoms, group_w, dt, mode_front,
    L=None) -> (G,m,3) projected group velocities; `atoms` (G,m) rows into
    the *_ext buffers (pad rows -> a zeroed sentinel row), `group_w` (G,)
    gates whole groups.  The per-call L overrides the baked box_lengths:
    under a barostat the live box differs from the construction-time one."""
    cons_pairs = np.asarray(cons_pairs)
    cons_dist = np.asarray(cons_dist, dtype=np.float64)
    G, n = cons_pairs.shape[:2]
    pairs = torch.as_tensor(cons_pairs.astype(np.int64), device=device)
    dist2 = torch.as_tensor(cons_dist ** 2, dtype=dtype, device=device)
    pair_valid = torch.as_tensor((cons_dist > 0).astype(np.float64),
                                 dtype=dtype, device=device)
    Lv0 = (None if box_lengths is None else
           torch.as_tensor(np.asarray(box_lengths), dtype=dtype,
                           device=device))
    gidx = torch.arange(G, device=device)

    if n == 1:
        # single-distance groups (every Martini constraint): closed form
        gi, gj = pairs[:, 0, 0], pairs[:, 0, 1]
        d2v, pv = dist2[:, 0], pair_valid[:, 0]

        def project_all(r_ext, v_ext, rmass_ext, atoms, group_w, dt,
                        mode_front, L=None):
            Lv = Lv0 if L is None else torch.as_tensor(L, dtype=dtype)
            r_g, v_g, rm_g = r_ext[atoms], v_ext[atoms], rmass_ext[atoms]
            rI, rJ = r_g[gidx, gi], r_g[gidx, gj]            # (G, 3)
            rmI, rmJ = rm_g[gidx, gi], rm_g[gidx, gj]
            a = rI - rJ
            if Lv is not None:
                a = nearest_image(a, Lv)
            w = pv * group_w
            mu = rmI + rmJ
            A = (a * a).sum(-1)
            safe = (w > 0) & (mu > 0) & (A > 0)
            ones = torch.ones_like(mu)
            lam = _closed_form_lambda(
                a, v_g[gidx, gi] - v_g[gidx, gj],
                torch.where(safe, mu, ones), d2v, dt, mode_front)
            lam = torch.where(safe, lam, torch.zeros_like(lam))
            dv = lam[:, None] * a                            # (G, 3)
            v_new = v_g.clone()
            v_new[gidx, gi] += rmI[:, None] * dv
            v_new[gidx, gj] -= rmJ[:, None] * dv
            return v_new

        return project_all

    # sel[g, p, a] = (pair p has atom a as I) - (as J)
    sel = (torch.nn.functional.one_hot(pairs[:, :, 0], m)
           - torch.nn.functional.one_hot(pairs[:, :, 1], m)).to(dtype)

    def project_all(r_ext, v_ext, rmass_ext, atoms, group_w, dt, mode_front,
                    L=None):
        Lv = Lv0 if L is None else torch.as_tensor(L, dtype=dtype)
        r_g, v_g, rm_g = r_ext[atoms], v_ext[atoms], rmass_ext[atoms]
        w = pair_valid * group_w[:, None]                   # (G, n)
        r_ab = sel @ r_g                                     # (G, n, 3)
        if Lv is not None:          # a molecule may straddle the wrapped box
            r_ab = nearest_image(r_ab, Lv)
        selm = sel * rm_g[:, None, :]                        # (G, n, m)
        M = (r_ab @ r_ab.transpose(1, 2)) * (selm @ sel.transpose(1, 2))
        M = M * (w[:, :, None] * w[:, None, :]) + torch.diag_embed(1.0 - w)

        def apply_lambda(v, lam):
            return v + selm.transpose(1, 2) @ (lam[:, :, None] * r_ab)

        if mode_front:
            v_new = v_g
            for _ in range(n_iter_front):
                pab = r_ab + dt * (sel @ v_new)
                rhs = -((pab * pab).sum(-1) - dist2) / (2.0 * dt) * w
                v_new = apply_lambda(
                    v_new, torch.linalg.solve(M, rhs[..., None])[..., 0])
        else:
            rhs = -(r_ab * (sel @ v_g)).sum(-1) * w
            v_new = apply_lambda(
                v_g, torch.linalg.solve(M, rhs[..., None])[..., 0])
        # gate: disowned groups return their input velocities untouched
        return torch.where(group_w[:, None, None] > 0, v_new, v_g)

    return project_all


def build_constraint_fn(cons_atoms, cons_pairs, cons_dist, n_pad: int,
                        dtype, box_lengths=None, n_iter_front: int = 8,
                        device="cpu"):
    """cons_atoms (G,m) state rows (pad -1); cons_pairs (G,n,2) local slots;
    cons_dist (G,n) target distances (pad 0).  Returns
    constraint_fn(state, dt, mode, box_lengths=None) -> state with
    projected velocities."""
    cons_atoms = np.asarray(cons_atoms)
    project_all = make_constraint_project(
        cons_pairs, cons_dist, dtype, cons_atoms.shape[1],
        box_lengths=box_lengths, n_iter_front=n_iter_front, device=device)
    G = cons_atoms.shape[0]
    atoms = torch.as_tensor(np.where(cons_atoms < 0, n_pad, cons_atoms)
                            .astype(np.int64), device=device)
    ones = torch.ones((G,), dtype=dtype, device=device)

    # through an extended buffer so padded atom slots land on the sentinel
    # row and are dropped
    def constraint_fn(state, dt, mode, box_lengths=None):
        zero3 = torch.zeros((1, 3), dtype=dtype, device=state.r.device)
        r_ext = torch.cat([state.r, zero3])
        v_ext = torch.cat([state.v, zero3])
        rm_ext = torch.cat([1.0 / state.mass, zero3[:, 0]])
        v_new = project_all(r_ext, v_ext, rm_ext, atoms, ones, dt,
                            mode == "front", L=box_lengths)
        v_ext[atoms.reshape(-1)] = v_new.reshape(-1, 3)
        return state.replace(v=v_ext[:n_pad])

    return constraint_fn


def _template_types(cons_atoms, cons_pairs, cons_dist, residue_instances,
                    n_rows: int):
    """Per residue type: (M, A, li, lj, d2 (K, M) as float64, rows (M, A))
    of its constraint template, or None when the topology is not
    template-regular (a group with more than one pair, atoms crossing
    instances, uneven instantiation)."""
    if np.asarray(cons_pairs).shape[1] != 1 or not residue_instances:
        return None
    ca = np.asarray(cons_atoms)
    cp = np.asarray(cons_pairs)
    G = ca.shape[0]
    row_i = ca[np.arange(G), cp[:, 0, 0]]
    row_j = ca[np.arange(G), cp[:, 0, 1]]
    dist = np.asarray(cons_dist)[:, 0]

    inst_of = np.full(n_rows, -1, np.int64)
    local_of = np.full(n_rows, -1, np.int64)
    type_names: list[str] = []
    type_id: dict[str, int] = {}
    inst_type = []
    inst_rows: dict[int, list] = {}
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

    inst = inst_of[row_i]
    if (inst < 0).any() or (inst_of[row_j] != inst).any():
        return None
    types = []
    for t in range(len(type_names)):
        gids = np.nonzero(inst_type[inst] == t)[0]
        if len(gids) == 0:
            continue
        gids = gids[np.argsort(inst[gids], kind="stable")]
        uinst, counts = np.unique(inst[gids], return_counts=True)
        M = int(np.sum(inst_type == t))
        if len(uinst) != M or counts.min() != counts.max():
            return None
        K = int(counts[0])
        li = local_of[row_i[gids]].reshape(M, K)
        lj = local_of[row_j[gids]].reshape(M, K)
        if not ((li == li[0]).all() and (lj == lj[0]).all()):
            return None
        rows = np.stack(inst_rows[t])                    # (M, A)
        types.append((M, rows.shape[1], li[0], lj[0],
                      dist[gids].reshape(M, K).T ** 2, rows))
    return types or None


def build_constraint_fn_batched(cons_atoms, cons_pairs, cons_dist,
                                n_pad: int, dtype, residue_instances,
                                box_lengths=None, device="cpu"):
    """Residue-template batched single-bond RATTLE (the main path).

    Constraint groups are batched per residue type like the bonded terms
    (potentials/bonded_batch.py): one contiguous slice (or row gather) of
    the type's atoms, the closed form on (M,) arrays with static local
    indices, one slice writeback.  Returns constraint_fn(state, dt, mode,
    box_lengths=None), or None when the topology is not template-regular
    (callers then use build_constraint_fn)."""
    found = _template_types(cons_atoms, cons_pairs, cons_dist,
                            residue_instances, n_pad)
    if found is None:
        return None
    types = []
    for M, A, li, lj, d2, rows in found:
        flat = rows.reshape(-1)
        start = int(flat[0])
        contiguous = bool((flat == start + np.arange(M * A)).all())
        types.append(dict(
            M=M, A=A, li=[int(x) for x in li], lj=[int(x) for x in lj],
            d2=torch.as_tensor(d2, dtype=dtype, device=device),   # (K, M)
            rows=None if contiguous else torch.as_tensor(flat, device=device),
            start=start if contiguous else None))
    Lv0 = (None if box_lengths is None else
           torch.as_tensor(np.asarray(box_lengths), dtype=dtype,
                           device=device))

    def constraint_fn(state, dt, mode, box_lengths=None):
        mode_front = mode == "front"
        Lv = Lv0 if box_lengths is None else box_lengths
        v = state.v.clone()                  # the projection updates v in place
        for tp in types:
            M, A = tp["M"], tp["A"]
            if tp["start"] is not None:
                s0, s1 = tp["start"], tp["start"] + M * A
                rb = state.r[s0:s1].reshape(M, A, 3)
                vb = v[s0:s1].reshape(M, A, 3)           # a view of v
                rm = (1.0 / state.mass[s0:s1]).reshape(M, A)
            else:
                rb = state.r[tp["rows"]].reshape(M, A, 3)
                vb = v[tp["rows"]].reshape(M, A, 3)
                rm = (1.0 / state.mass[tp["rows"]]).reshape(M, A)
            for k, (li, lj) in enumerate(zip(tp["li"], tp["lj"])):
                a = rb[:, li] - rb[:, lj]                # (M, 3)
                if Lv is not None:
                    a = nearest_image(a, Lv)
                rmI, rmJ = rm[:, li], rm[:, lj]
                lam = _closed_form_lambda(a, vb[:, li] - vb[:, lj],
                                          rmI + rmJ, tp["d2"][k], dt,
                                          mode_front)
                dv = lam[:, None] * a
                vb[:, li] += rmI[:, None] * dv
                vb[:, lj] -= rmJ[:, None] * dv
            if tp["start"] is None:
                v[tp["rows"]] = vb.reshape(M * A, 3)
        return state.replace(v=v)

    return constraint_fn


def build_constraint_templates(cons_atoms, cons_pairs, cons_dist,
                               residue_instances, gid):
    """Sharded analog of build_constraint_fn_batched's host analysis:
    per-residue-type constraint templates keyed by instance gids.

    Returns (plan, project) or None when not template-regular.  plan:
    {"types": [{gids (M, A), M, A, li, lj, d2 (K, M)}]}.  project(rb3,
    vb3, rm2, w, d2, li, lj, dt, mode_front, Lv) applies the closed-form
    single-bond RATTLE to one type in the (3, A, M) layout; the caller
    gathers and scatters the rows."""
    gid = np.asarray(gid, np.int64)
    found = _template_types(cons_atoms, cons_pairs, cons_dist,
                            residue_instances, len(gid))
    if found is None:
        return None
    # d2 in f64: the step engine casts it to the run's dtype (an f32
    # copy here would cap an f64 run's bond lengths at f32 precision)
    types = [dict(M=M, A=A, li=li, lj=lj,
                  d2=torch.as_tensor(d2, dtype=torch.float64),
                  gids=torch.as_tensor(gid[rows]))
             for M, A, li, lj, d2, rows in found]

    def project(rb3, vb3, rm2, w, d2, li, lj, dt, mode_front, Lv):
        """One type: rb3/vb3 (3, A, M), rm2 (A, M), w (M,) ownership; d2
        in any float dtype (taken in rb3's)."""
        vb3 = vb3.clone()
        d2 = d2.to(rb3.dtype)
        unit = torch.tensor([1.0, 0.0, 0.0], dtype=rb3.dtype,
                            device=rb3.device)
        for k in range(len(li)):
            i, j = int(li[k]), int(lj[k])
            a = (rb3[:, i] - rb3[:, j]).T                # (M, 3)
            if Lv is not None:
                a = nearest_image(a, Lv)
            # disowned instances gather arbitrary (possibly coincident)
            # rows: swap in unit geometry so 1/A stays finite
            a = torch.where((w > 0)[:, None], a, unit)
            rmI, rmJ = rm2[i], rm2[j]
            lam = _closed_form_lambda(
                a, (vb3[:, i] - vb3[:, j]).T,
                torch.clamp(rmI + rmJ, min=1e-30), d2[k], dt, mode_front)
            dv = (lam * w)[:, None] * a                  # (M, 3)
            vb3[:, i] += (rmI[:, None] * dv).T
            vb3[:, j] -= (rmJ[:, None] * dv).T
        return vb3

    return dict(types=types), project


def constraint_residual(state, cons_atoms, cons_pairs, cons_dist, dt=None,
                        box_lengths=None):
    """Max |(|r_ab| - d)/d| over all constraints (diagnostic/tests).
    box_lengths, when given, takes the nearest image of each bond (the
    run loop wraps positions at every rebuild)."""
    del dt
    r = state.r
    r = (r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
         else np.asarray(r)).astype(np.float64)
    ca, cp = np.asarray(cons_atoms), np.asarray(cons_pairs)
    cd = np.asarray(cons_dist, dtype=np.float64)
    g = np.arange(len(ca))[:, None]
    i = ca[g, cp[:, :, 0]]
    j = ca[g, cp[:, :, 1]]
    d = r[i] - r[j]
    if box_lengths is not None:
        L = np.asarray(box_lengths, dtype=np.float64)
        d -= L * np.round(d / L)
    b = np.linalg.norm(d, axis=-1)
    ok = cd > 0
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(b[ok] - cd[ok]) / cd[ok]))
