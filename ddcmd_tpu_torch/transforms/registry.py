"""TRANSFORM registry: deck-driven state surgery.

A copy of ddcmd_tpu/transforms/registry.py (numpy only; importing the
JAX package imports jax).  Reference: ddcMD src/transform.c:54-181 (16
types).  Transforms run outside the step loop on host arrays, then the
driver re-uploads and, when the particle count or the species changed,
rebuilds the run (Simulation.apply_transform; the reference likewise
forces a DDC reassign + re-energy after rate-driven transforms,
transform.c:153-181).

Each transform: fn(ctx, obj) where ctx carries numpy views (r, v in
internal units, gid, species/group names, box h, masses) and mutates
in place / returns replacements.  Keywords mirror the reference files
cited per function.
"""

from __future__ import annotations

import numpy as np

from ..objects import DeckError, DeckObject
from ..objects import units as U


class TransformContext:
    """Host-side mutable view of the simulation for transforms."""

    def __init__(self, r, v, gid, mass, species_names, group_names, h):
        self.r = r
        self.v = v
        self.gid = gid
        self.mass = mass
        self.species_names = species_names
        self.group_names = group_names
        self.h = h

    def selection(self, obj: DeckObject):
        sel = np.ones(len(self.gid), dtype=bool)
        sp = obj.get_strv("species")
        if sp:
            sel &= np.isin(np.asarray(self.species_names), sp)
        gr = obj.get_strv("groups")
        if gr:
            sel &= np.isin(np.asarray(self.group_names), gr)
        return sel


def t_setvelocity(ctx, obj):
    """SETVELOCITY: shift selected particles so their COM velocity equals
    vcm (addVelocity.c:136, setVelocity path)."""
    vcm = np.asarray(obj.get_with_unitsv("vcm", "0 0 0", "velocity"))
    sel = ctx.selection(obj)
    m = ctx.mass[sel][:, None]
    p = (m * ctx.v[sel]).sum(axis=0)
    ctx.v[sel] += (vcm - p / m.sum())[None, :]


def t_addvelocity(ctx, obj):
    """ADDVELOCITY: add a constant velocity to selected particles."""
    vel = np.asarray(obj.get_with_unitsv("velocity", "0 0 0", "velocity"))
    sel = ctx.selection(obj)
    ctx.v[sel] += vel[None, :]


def t_thermalize(ctx, obj):
    """THERMALIZE: Maxwell-Boltzmann velocities (thermalizeTransform.c)."""
    T = obj.get_with_units("temperature", "0.0", "T")
    seed = obj.get_int("seed", 385212586)
    if obj.get_int("randomizeSeed", 0):
        seed = int.from_bytes(__import__("os").urandom(4), "little")
    keep_vcm = obj.get_int("keepVcm", 0)
    sel = ctx.selection(obj)
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(U.kB * T / ctx.mass[sel])
    vnew = rng.standard_normal((sel.sum(), 3)) * sigma[:, None]
    m = ctx.mass[sel][:, None]
    vcm_old = (m * ctx.v[sel]).sum(axis=0) / m.sum()
    ctx.v[sel] = vnew
    vcm_new = (m * ctx.v[sel]).sum(axis=0) / m.sum()
    ctx.v[sel] += ((vcm_old if keep_vcm else 0.0) - vcm_new)[None, :]


def t_box(ctx, obj):
    """BOX: affine-rescale everything to a new h (boxTransform.c:24)."""
    h_new = np.asarray(obj.get_with_unitsv("hNew", "1 0 0 0 1 0 0 0 1", "l")).reshape(3, 3)
    hfac = h_new @ np.linalg.inv(ctx.h)
    ctx.r[:] = ctx.r @ hfac.T
    ctx.h[:] = h_new


def t_gidshuffle(ctx, obj):
    """GIDSHUFFLE: randomly permute gids (gidShuffle.c)."""
    seed = obj.get_int("seed", 12345)
    rng = np.random.default_rng(seed)
    ctx.gid[:] = ctx.gid[rng.permutation(len(ctx.gid))]


def t_projectile(ctx, obj):
    """PROJECTILE: launch the particle with the given gid
    (projectileTransform.c)."""
    gid = obj.get_int("gid", 0)
    vel = np.asarray(obj.get_with_unitsv("velocity", "0 0 0", "velocity"))
    idx = np.nonzero(ctx.gid == gid)[0]
    if len(idx) == 0:
        raise DeckError(f"PROJECTILE: gid {gid} not found")
    ctx.v[idx] = vel


def t_linearisotropicv(ctx, obj):
    """LINEARISOTROPICV: radial velocity field v = alpha * r."""
    alpha = obj.get_with_units("alpha", "0.0", "1/t")
    ctx.v += alpha * ctx.r


def t_assigngroups(ctx, obj):
    """ASSIGNGROUPS: reassign selected particles to a group by region."""
    target = obj.get_str("group")
    sel = ctx.selection(obj)
    lo = obj.get_with_unitsv("zmin", "-1e30", "l")[0] if obj.has("zmin") else -np.inf
    hi = obj.get_with_unitsv("zmax", "1e30", "l")[0] if obj.has("zmax") else np.inf
    sel &= (ctx.r[:, 2] >= lo) & (ctx.r[:, 2] < hi)
    for i in np.nonzero(sel)[0]:
        ctx.group_names[i] = target


def t_impact(ctx, obj):
    """IMPACT: velocity kick to all particles within a sphere
    (impactTransform.c)."""
    c = np.asarray(obj.get_with_unitsv("center", "0 0 0", "l"))
    radius = obj.get_with_units("radius", "0.0", "l")
    vel = np.asarray(obj.get_with_unitsv("velocity", "0 0 0", "velocity"))
    d = ctx.r - c
    d -= np.diagonal(ctx.h) * np.round(d / np.diagonal(ctx.h))
    sel = (d ** 2).sum(axis=1) < radius ** 2
    ctx.v[sel] += vel[None, :]


def t_selectsubset(ctx, obj):
    """SELECTSUBSET: keep only the selected particles (selectSubset.c)."""
    sel = ctx.selection(obj)
    for ax, lo_k, hi_k in ((0, "xmin", "xmax"), (1, "ymin", "ymax"), (2, "zmin", "zmax")):
        if obj.has(lo_k):
            sel &= ctx.r[:, ax] >= obj.get_with_units(lo_k, "0", "l")
        if obj.has(hi_k):
            sel &= ctx.r[:, ax] < obj.get_with_units(hi_k, "0", "l")
    idx = np.nonzero(sel)[0]
    ctx.r = ctx.r[idx]
    ctx.v = ctx.v[idx]
    ctx.gid = ctx.gid[idx]
    ctx.mass = ctx.mass[idx]
    ctx.species_names = [ctx.species_names[i] for i in idx]
    ctx.group_names = [ctx.group_names[i] for i in idx]


def t_replicate(ctx, obj):
    """REPLICATE: tile the system nx x ny x nz (replicate.c:42-48)."""
    nx = obj.get_int("nx", 1)
    ny = obj.get_int("ny", 1)
    nz = obj.get_int("nz", 1)
    stride = obj.get_int("stride", 0) or (int(ctx.gid.max()) + 1)
    L = np.diagonal(ctx.h).copy()
    rs, vs, gids, sp, gr = [], [], [], [], []
    copy = 0
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                shift = (np.array([ix, iy, iz]) - 0.5 * np.array([nx - 1, ny - 1, nz - 1])) * L
                rs.append(ctx.r + shift)
                vs.append(ctx.v.copy())
                gids.append(ctx.gid + copy * stride)
                sp += ctx.species_names
                gr += ctx.group_names
                copy += 1
    ctx.r = np.concatenate(rs)
    ctx.v = np.concatenate(vs)
    ctx.gid = np.concatenate(gids)
    ctx.mass = np.tile(ctx.mass, copy)
    ctx.species_names = sp
    ctx.group_names = gr
    ctx.h[:] = ctx.h * np.array([nx, ny, nz])[:, None]


def t_append(ctx, obj):
    """APPEND: merge particles from another collection file
    (appendTransform; deck: files=dir/atoms#, optional offset)."""
    from ..io.collection import read_collection

    files = obj.get_str("files")
    base = obj.get_str("base_dir", ".")
    col = read_collection(files, base)
    off = np.asarray(obj.get_with_unitsv("offset", "0 0 0", "l"))
    gid_base = int(ctx.gid.max()) + 1
    ctx.r = np.concatenate([ctx.r, col.r + off])
    ctx.v = np.concatenate([ctx.v, col.v])
    ctx.gid = np.concatenate([ctx.gid, col.gid + gid_base])
    # appended masses are resolved by the caller from species
    ctx.mass = np.concatenate([ctx.mass, np.ones(col.n)])
    ctx.species_names = list(ctx.species_names) + list(col.species_names)
    ctx.group_names = list(ctx.group_names) + list(col.group_names)


def t_alchemy(ctx, obj):
    """ALCHEMY: transmute selected particles to another species
    (alchemyTransform.c)."""
    target = obj.get_str("species_to", obj.get_str("newSpecies", ""))
    sel = ctx.selection(obj)
    frm = obj.get_str("species_from", "")
    if frm:
        sel &= np.asarray(ctx.species_names) == frm
    for i in np.nonzero(sel)[0]:
        ctx.species_names[i] = target


def t_transectmorph(ctx, obj):
    """TRANSECTMORPH: piecewise-linear remap of one coordinate through N
    transecting planes (transectMorph.c:53-133).  positionBefore/After are
    plane coordinates in Angstrom (transectMorph_parms,
    transectMorph.c:170-179); regions between consecutive planes stretch
    linearly, the wraparound region maps across the periodic boundary."""
    index = obj.get_int("index", 2)
    before = np.asarray(obj.get_floatv("positionBefore")) * U.ANG_TO_LENGTH
    after = np.asarray(obj.get_floatv("positionAfter")) * U.ANG_TO_LENGTH
    if len(before) != len(after) or len(before) < 2:
        raise DeckError("TRANSECTMORPH needs >=2 positionBefore/After pairs")
    if not (np.all(np.diff(before) > 0) and np.all(np.diff(after) > 0)):
        raise DeckError("TRANSECTMORPH planes must be increasing")
    halfL = 0.5 * ctx.h[index, index]
    x = ctx.r[:, index]
    out = x.copy()
    span_b = before[0] + 2 * halfL - before[-1]
    span_a = after[0] + 2 * halfL - after[-1]
    lo = x < before[0]
    out[lo] = after[0] + (x[lo] - before[0]) / span_b * span_a
    hi = x > before[-1]
    out[hi] = after[-1] + (x[hi] - before[-1]) / span_b * span_a
    for j in range(1, len(before)):
        m = (x >= before[j - 1]) & (x < before[j])
        s = (x[m] - before[j - 1]) / (before[j] - before[j - 1])
        out[m] = after[j - 1] + s * (after[j] - after[j - 1])
    ctx.r[:, index] = out


def t_custom(ctx, obj):
    """CUSTOM: the reference's grab-bag of single-use transforms
    (customTransform.c:43-61); the only enabled branch is grepForGid
    (customTransform.c:232-275): dump z (Angstrom) of the listed gids
    to gidZvals.txt."""
    gids = obj.get_floatv("gid") if obj.has("gid") else []
    if not gids:
        return
    run_dir = getattr(ctx, "run_dir", ".")
    import os

    with open(os.path.join(run_dir, "gidZvals.txt"), "w") as f:
        for g in gids:
            idx = np.nonzero(ctx.gid == int(g))[0]
            z = float(ctx.r[idx[0], 2]) / U.ANG_TO_LENGTH if len(idx) else 0.0
            f.write(f" {int(g)}   {z:.10f}\n")


def t_shock(ctx, obj):
    """SHOCK: conveyor-belt shock drive (shockTransform, shock.c:789-908).

    Every `rate` steps: shift the whole system down so the mean density
    tracks rhoBarTarget (slab-binned search, findShift shock.c:113-143),
    feed fresh material from the newMaterial file in at the top
    (fillBox shock.c:685-724), delete what left the box, renumber and
    sort by gid.  The reference-pair (gidRefState, gidRefNew) anchors
    the material column to the state column across applications.
    """
    import os

    from ..io.collection import read_collection

    st = getattr(obj, "_shock", None)
    if st is None:
        files = obj.get_str("newMaterial", "./newMaterial/atoms#")
        base = getattr(ctx, "base_dir", ".")
        col = read_collection(files, base)
        hzz = col.header.get_floatv("h")[8] * U.ANG_TO_LENGTH
        st = dict(
            z=np.asarray(col.r[:, 2], dtype=np.float64),
            x=np.asarray(col.r[:, 0], dtype=np.float64),
            y=np.asarray(col.r[:, 1], dtype=np.float64),
            gid=np.asarray(col.gid),
            species=list(col.species_names),
            group=list(col.group_names),
            hzz=hzz, pbc=int(col.header.get_int("pbc", 7)),
            time_last=float(getattr(ctx, "time", 0.0)),
            gidRefState=obj.get_int("gidRefState", -1),
            gidRefNew=obj.get_int("gidRefNew", -1))
        if st["gidRefState"] < 0 or st["gidRefNew"] < 0:
            raise DeckError("SHOCK requires gidRefState and gidRefNew")
        obj._shock = st

    rho_target = obj.get_with_units("rhoBarTarget", "0.0", "1/l^3")
    if rho_target <= 0:
        raise DeckError("SHOCK requires rhoBarTarget > 0")
    ratio_rho = obj.get_with_units("ratioRhoEst", "0.0", "1/l^3") or 2.0
    piston_name = obj.get_str("piston", "piston")

    L = float(ctx.h[2, 2])
    z0, z1 = -0.5 * L, 0.5 * L
    vol = float(np.prod(np.diagonal(ctx.h)))
    nglobal = len(ctx.gid)

    # material relative to its reference particle (refTranformNewMaterial,
    # shock.c:245-259): keep only z > 0, sorted by (z, gid)
    iref = np.nonzero(st["gid"] == st["gidRefNew"])[0]
    if len(iref) != 1:
        raise DeckError(f"SHOCK: gidRefNew {st['gidRefNew']} not unique in "
                        "material")
    zref = st["z"][iref[0]]
    z = st["z"] - zref
    if st["pbc"] & 4:
        z = np.where(z <= 0.0, z + st["hzz"], z)
    keep = z > 0.0
    order = np.lexsort((st["gid"][keep], z[keep]))
    mat = {k: (np.asarray(st[k])[keep][order] if k in
               ("x", "y", "gid") else
               [st[k][i] for i in np.nonzero(keep)[0][order]])
           for k in ("x", "y", "gid", "species", "group")}
    mat_z = z[keep][order]

    # reference particle in the state
    jref = np.nonzero(ctx.gid == st["gidRefState"])[0]
    if len(jref) != 1:
        raise DeckError(f"SHOCK: gidRefState {st['gidRefState']} not found")
    r_ref = ctx.r[jref[0]].copy()
    i_mat_ref = np.nonzero(st["gid"] == st["gidRefNew"])[0][0]
    dxy = np.hypot(r_ref[0] - st["x"][i_mat_ref],
                   r_ref[1] - st["y"][i_mat_ref])
    if dxy / L >= 1e-10:
        raise DeckError("SHOCK: reference pair not in the same column")

    # slab width from the lowest piston particle (minMax, shock.c:462-522)
    piston = np.asarray(ctx.group_names) == piston_name
    if not piston.any():
        raise DeckError(f"SHOCK: no particles in piston group {piston_name!r}")
    d_slab = float(ctx.r[piston, 2].min()) - z0
    if d_slab <= 0:
        raise DeckError("SHOCK: piston already below the box bottom")
    dt = float(getattr(ctx, "dt", 1.0))
    rate = int(getattr(ctx, "rate", 1)) or 1
    time = float(getattr(ctx, "time", 0.0))
    v_particle = d_slab / (dt * rate)
    v_shock_est = v_particle * ratio_rho / max(ratio_rho - 1.0, 1e-12)
    shift_est = v_shock_est * max(time - st["time_last"], dt * rate)
    n_bin = max(10, int(4.0 * shift_est / d_slab + 1.0))

    # density bins: +material entering from the top, -state leaving at the
    # bottom (shockUpdateBin*, shock.c:145-182)
    bins = np.zeros(n_bin)
    jm = np.floor(mat_z / d_slab).astype(int)
    np.add.at(bins, jm[(jm >= 0) & (jm < n_bin)], 1.0)
    js = np.floor((ctx.r[:, 2] - z0) / d_slab).astype(int)
    np.add.at(bins, js[(js >= 0) & (js < n_bin)], -1.0)

    # findShift (shock.c:113-143)
    n_target = rho_target * vol
    n = nglobal + bins[0]
    shift = -d_slab
    if n_target <= n:
        for i in range(1, n_bin):
            shift -= d_slab
            n += bins[i]
            if n < n_target:
                shift += -(n_target - n) * d_slab / bins[i]
                break
        else:
            raise DeckError("SHOCK: no shift found; improve ratioRhoEst")

    ctx.r[:, 2] += shift
    offset = r_ref[2] + shift

    # fillBox (shock.c:685-724)
    n_fill = int(np.searchsorted(mat_z + offset, z1, side="right"))
    max_label = int(ctx.gid.max())
    if n_fill > 0:
        new_gid = max_label + 1 + np.arange(n_fill, dtype=ctx.gid.dtype)
        # new reference pair: topmost filled particle (selectRefPair,
        # shock.c:636-684)
        ztop = mat_z[:n_fill].max()
        cand = np.nonzero(mat_z[:n_fill] == ztop)[0]
        pick = cand[np.argmax(mat["gid"][cand])]
        st["gidRefNew"] = int(mat["gid"][pick])
        st["gidRefState"] = int(new_gid[pick])
        ctx.r = np.concatenate([
            ctx.r, np.stack([mat["x"][:n_fill], mat["y"][:n_fill],
                             mat_z[:n_fill] + offset], axis=1)])
        ctx.v = np.concatenate([ctx.v, np.zeros((n_fill, 3))])
        ctx.gid = np.concatenate([ctx.gid, new_gid])
        ctx.mass = np.concatenate([ctx.mass, np.ones(n_fill)])
        ctx.species_names = list(ctx.species_names) + mat["species"][:n_fill]
        ctx.group_names = list(ctx.group_names) + mat["group"][:n_fill]

    # markForDeletion + gid sort (shock.c:588-600,866-869)
    inside = (ctx.r[:, 2] >= z0) & (ctx.r[:, 2] <= z1)
    order = np.argsort(ctx.gid[inside])
    idx = np.nonzero(inside)[0][order]
    ctx.r = ctx.r[idx]
    ctx.v = ctx.v[idx]
    ctx.gid = ctx.gid[idx]
    ctx.mass = ctx.mass[idx]
    ctx.species_names = [ctx.species_names[i] for i in idx]
    ctx.group_names = [ctx.group_names[i] for i in idx]
    st["time_last"] = time
    # consume the filled material
    st_keep = np.ones(len(st["gid"]), bool)
    st_keep[np.isin(st["gid"], mat["gid"][:n_fill])] = False
    for k in ("z", "x", "y", "gid"):
        st[k] = np.asarray(st[k])[st_keep]
    st["species"] = [s for s, kf in zip(st["species"], st_keep) if kf]
    st["group"] = [g for g, kf in zip(st["group"], st_keep) if kf]

    run_dir = getattr(ctx, "run_dir", ".")
    with open(os.path.join(run_dir, "shock.data"), "a") as f:
        f.write(f"{time:.6f} {st['gidRefState']} {st['gidRefNew']} "
                f"{n_fill} {int((~inside).sum())} {len(ctx.gid)} "
                f"{shift / U.ANG_TO_LENGTH:.6f}\n")


REGISTRY = {
    "SETVELOCITY": t_setvelocity,
    "ADDVELOCITY": t_addvelocity,
    "THERMALIZE": t_thermalize,
    "BOX": t_box,
    "GIDSHUFFLE": t_gidshuffle,
    "PROJECTILE": t_projectile,
    "LINEARISOTROPICV": t_linearisotropicv,
    "ASSIGNGROUPS": t_assigngroups,
    "IMPACT": t_impact,
    "SELECTSUBSET": t_selectsubset,
    "REPLICATE": t_replicate,
    "ALCHEMY": t_alchemy,
    "APPEND": t_append,
    "TRANSECTMORPH": t_transectmorph,
    "CUSTOM": t_custom,
    "SHOCK": t_shock,
}


def apply_transform(ctx: TransformContext, obj: DeckObject):
    ttype = obj.get_str("type").upper()
    fn = REGISTRY.get(ttype)
    if fn is None:
        raise DeckError(f"TRANSFORM type {ttype} not implemented "
                        f"(have: {sorted(REGISTRY)})")
    fn(ctx, obj)
    return ctx
