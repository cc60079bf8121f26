"""ORDERSH: Steinhardt spherical-harmonic order-parameter potential.

Counterpart of ddcmd_tpu/potentials/ordersh.py (reference ddcMD
src/orderSH.c, sph.c): a biasing "potential" whose energy is a function
of the global bond-orientational order parameter

    phi = (4 pi / (2L+1)) sum_m |q_lm|^2 / W^2,
    q_lm = sum_pairs w(r_ij) Y_lm(r_ij-hat),   W = sum_pairs w(r_ij)

with a smooth weight w(r): 1 for r < r1o, cosine-smoothed to 0 at r2o
(deck keys L, r1o, r2o, lamda, Vo; orderSH.c:81-96).  E = N lamda
f(phi) with f LINEAR by default.  The forces are the gradient of the
same phi expression, by torch.autograd.grad where the JAX package takes
jax.value_and_grad (the reference hand-derives dY/dr, sph.c).

Y_lm is evaluated pole-safely as N_lm * Q_l^m(u_z) * (u_x + i u_y)^m,
where Q_l^m(t) = (-1)^m d^m P_l / dt^m is a plain polynomial.

The local order analysis (ordersh_local, ordersh_clusters) and the
q{L} snapshot files (write_qlocal_files) are host numpy, copied from the
JAX package, on the port's build_neighbor_list.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import nearest_image_pbc
from ..nbr.celllist import CellGrid, build_neighbor_list
from ..objects import ObjectDB


def _legendre_qlm(L: int):
    """Coefficients of Q_l^m(t) = (-1)^m d^m P_L/dt^m, m = 0..L (ascending
    powers), and the real-harmonic normalisations."""
    c = np.zeros(L + 1)
    c[L] = 1.0
    pl = np.polynomial.legendre.leg2poly(c)
    out = []
    norms = []
    for m in range(L + 1):
        q = np.polynomial.polynomial.polyder(pl, m) if m > 0 else pl.copy()
        q = q * ((-1.0) ** m)
        out.append(q)
        norms.append(math.sqrt((2 * L + 1) / (4 * math.pi)
                               * math.factorial(L - m) / math.factorial(L + m)))
    return out, norms


@dataclass
class OrderSHParms:
    L: int                       # biasing L = first of L_list
    r1o: float
    r2o: float
    lamda: float
    Vo: float
    function: str
    L_list: tuple = (6,)         # up to 16 L values (orderSH.c:83)
    cluster_write: bool = False  # enable the (reference-disabled) cluster dump


def compile_ordersh(db: ObjectDB, name: str) -> OrderSHParms:
    pot = db.get(name, "POTENTIAL")
    # L may be a list of up to 16 values (orderSH.c:83); the first drives
    # the biasing energy, the rest only the local order analysis and the
    # q{L} snapshot files
    Lv = [int(x) for x in pot.get_strv("L")] or [6]
    if len(Lv) > 16:
        raise ValueError("ORDERSH takes at most 16 L values")
    return OrderSHParms(
        L=Lv[0],
        r1o=pot.get_with_units("r1o", "0.0", "l"),
        r2o=pot.get_with_units("r2o", "0.0", "l"),
        lamda=pot.get_with_units("lamda", "0.0", "m*l^2/t^2"),
        Vo=pot.get_float("Vo", 0.0),
        function=pot.get_str("function", "LINEAR").upper(),
        L_list=tuple(Lv),
        cluster_write=pot.get_int("clusterWrite", 0) != 0,
    )


def make_ordersh_eval(parms: OrderSHParms, n_global: int,
                      dtype=torch.float32):
    """eval_fn(r, fmask, nbr_idx, geom, pbc_mask=None) -> (f, e, virial,
    pe, phi) (pbc_mask as in martini_nonbond): the
    bias energy N lamda f(phi), its forces -dE/dr, a zero virial and the
    energy spread evenly over the particles (pe = e / N), as the JAX
    package returns them."""
    L = parms.L
    qcoeffs, norms = _legendre_qlm(L)

    def rounded(x):
        return float(torch.tensor(x, dtype=dtype))

    qc = [[rounded(a) for a in q] for q in qcoeffs]
    nm = [rounded(x) for x in norms]
    r1, r2 = parms.r1o, parms.r2o
    pref = 4.0 * math.pi / (2 * L + 1)

    def phi_of(r, fmask, nbr_idx, geom, pbc_mask=None):
        sentinel = r.shape[0]
        # a sentinel slot gathers its row's own position (a zero bond,
        # masked below) where the JAX package gathers a zero padding row:
        # the gradient's scatter then meets no index repeated over the
        # whole list (the backward of a gather serialises on repeats)
        rows = torch.arange(sentinel, device=r.device)[:, None]
        idx = torch.where(nbr_idx == sentinel, rows, nbr_idx)
        r_j = torch.index_select(r, 0, idx.reshape(-1)).view(*idx.shape, 3)
        dr = nearest_image_pbc(r[:, None, :] - r_j, geom, pbc_mask)
        d2 = torch.sum(dr * dr, dim=-1)
        valid = ((nbr_idx != sentinel) & (d2 > 0) & (d2 < r2 * r2)
                 & (fmask[:, None] > 0))
        dist = torch.sqrt(torch.where(valid, d2, 1.0))
        # smooth weight: 1 below r1, cosine roll-off to 0 at r2
        t = torch.clamp((dist - r1) / max(r2 - r1, 1e-9), 0.0, 1.0)
        w = torch.where(valid, 0.5 * (1.0 + torch.cos(math.pi * t)), 0.0)

        u = dr / dist[..., None]
        uz = u[..., 2]
        cxy = torch.complex(u[..., 0], u[..., 1])

        W = torch.sum(w)
        acc = r.new_zeros(())
        cpow = torch.ones_like(cxy)
        for m in range(L + 1):
            # Horner on uz
            q = qc[m][-1] * torch.ones_like(uz)
            for k in range(len(qc[m]) - 2, -1, -1):
                q = q * uz + qc[m][k]
            qlm = torch.sum(w * (nm[m] * q * cpow))
            mult = 1.0 if m == 0 else 2.0       # the +-m pairs
            acc = acc + mult * (qlm.real ** 2 + qlm.imag ** 2)
            if m < L:
                cpow = cpow * cxy
        Ws = torch.clamp(W, min=1e-12)
        return pref * acc / (Ws * Ws), W

    def eval_fn(r, fmask, nbr_idx, geom, pbc_mask=None):
        with torch.enable_grad():
            rg = r.detach().requires_grad_(True)
            phi, _ = phi_of(rg, fmask, nbr_idx, geom, pbc_mask)
            f_phi = phi - parms.Vo if parms.function == "LINEAR" else phi
            e = n_global * parms.lamda * f_phi
            (g,) = torch.autograd.grad(e, rg)
        e, phi = e.detach(), phi.detach()
        virial = r.new_zeros((3, 3))
        pe = e / torch.clamp(fmask.sum(), min=1.0) * fmask
        return -g, e, virial, pe, phi

    return eval_fn


# ---------------------------------------------------------------------------
# local order analysis (orderSHlocal) + q{L} snapshot files (writeqlocal)
# ---------------------------------------------------------------------------

def _ylm_pairs(u, L):
    """(N, K, L+1) complex Y_lm over unit bond vectors u (N, K, 3)."""
    qcoeffs, norms = _legendre_qlm(L)
    uz = u[..., 2]
    cxy = u[..., 0] + 1j * u[..., 1]
    out = np.empty(u.shape[:2] + (L + 1,), np.complex128)
    cpow = np.ones_like(cxy)
    for m in range(L + 1):
        q = np.full_like(uz, qcoeffs[m][-1])
        for k in range(len(qcoeffs[m]) - 2, -1, -1):
            q = q * uz + qcoeffs[m][k]
        out[..., m] = norms[m] * q * cpow
        cpow = cpow * cxy
    return out


def _order_dot(a, b):
    """orderDot (orderSH.c:336-349): real inner product over m with the
    +-m multiplicity.  a, b: (..., L+1) complex."""
    re = (a.real * b.real + a.imag * b.imag)
    return re[..., 0] + 2.0 * re[..., 1:].sum(axis=-1)


def ordersh_local(r, box_lengths, parms: OrderSHParms):
    """orderSHlocal analog (ddcMD src/orderSH.c:358-470) on the host:
    per-particle bond-averaged spherical harmonics for every L in
    parms.L_list, on an f32 list of r2o (orthorhombic box).

    Returns dict(qlocal={L: (n, L+1) complex unit-normalised},
    qnorm={L: (n,)}, Q (n,), C (n,) int, W (n,), nbr, dot, w).  Q is the
    W-normalised mean bond alignment dot(q_i, q_j); C counts bonds with
    dot*w > 0.5 (the crystal-connection count).  Bond directions are the
    per-row u_ij of a full list; for even L this matches the reference's
    half-list accumulation exactly (Y_lm(-u) = (-1)^L Y_lm(u))."""
    r = np.asarray(r, np.float64)
    L3 = np.asarray(box_lengths, np.float64)
    n = len(r)
    rw = r - L3 * np.round(r / L3)
    grid = CellGrid.plan(L3, parms.r2o, 0.0, n, n)
    nbr, _, ov = build_neighbor_list(
        torch.tensor(rw, dtype=torch.float32), torch.ones(n),
        torch.tensor(L3, dtype=torch.float32), grid)
    if bool(ov):
        raise RuntimeError("ordersh_local: neighbor overflow")
    nbr = nbr.numpy()
    r_ext = np.concatenate([r, np.zeros((1, 3))])
    d = r[:, None, :] - r_ext[nbr]
    d -= L3 * np.round(d / L3)
    d2 = (d * d).sum(-1)
    valid = (nbr != n) & (d2 > 0) & (d2 < parms.r2o ** 2)
    d2 = np.where(valid, d2, 1.0)
    dist = np.sqrt(d2)
    # wfunc (orderSH.c:161-172)
    t = np.clip((dist - parms.r1o) / max(parms.r2o - parms.r1o, 1e-12),
                0.0, 1.0)
    w = np.where(valid, 0.5 + 0.5 * np.cos(np.pi * t), 0.0)
    u = -d / dist[..., None]        # displacement to the neighbor

    qlocal, qnorm = {}, {}
    for L in parms.L_list:
        y = _ylm_pairs(u, L)                       # (n, K, L+1)
        q = (w[..., None] * y).sum(axis=1)         # (n, L+1)
        mag = np.sqrt(np.maximum(_order_dot(q, q), 1e-300))
        qlocal[L] = q / mag[:, None]
        qnorm[L] = mag * math.sqrt(4.0 * math.pi / (2 * L + 1))

    # Q / C / W against the first L (orderSH.c:430-457)
    L0 = parms.L_list[0]
    qh = qlocal[L0]
    qh_ext = np.concatenate([qh, np.zeros((1, L0 + 1), np.complex128)])
    dot = np.zeros_like(w)
    for m in range(L0 + 1):
        a = qh[:, m][:, None]
        b = qh_ext[:, m][nbr]
        mult = 1.0 if m == 0 else 2.0
        dot += mult * (a.real * b.real + a.imag * b.imag)
    Wl = w.sum(axis=1)
    Q = (dot * w).sum(axis=1) / np.maximum(Wl, 1e-30)
    C = ((dot * w) > 0.5).sum(axis=1).astype(np.int32)
    for L in parms.L_list:
        qnorm[L] = qnorm[L] / np.maximum(Wl, 1e-30)
    return dict(qlocal=qlocal, qnorm=qnorm, Q=Q, C=C, W=Wl, nbr=nbr,
                dot=dot, w=w)


# classification thresholds Qc (orderSH.c:473, a block the open release
# compiles out; clusterWrite=1 enables this re-implementation)
_QC = {"LIQUID": -0.5, "INTERFACE": 0.75, "CRYSTAL": 0.87,
       "HIGHORDER": 0.95}


def ordersh_clusters(r, box_lengths, parms: OrderSHParms, loc, gid):
    """orderCluster analog (orderSH.c:572-700): greedy orientation
    clustering of high-order atoms.  Returns (rows, clusters): per-member
    records (gid, group, r, dot, Q, C, qnorm per L) and per-cluster
    (label, size, Rave, Rrms)."""
    L3 = np.asarray(box_lengths, np.float64)
    r = np.asarray(r, np.float64)
    L0 = parms.L_list[0]
    qh = loc["qlocal"][L0]
    Q, C, nbr, dot, w = loc["Q"], loc["C"], loc["nbr"], loc["dot"], loc["w"]
    n = len(r)
    # qAccum: add aligned high-order neighbors' q (dot > 0.95, both ends
    # high-order), then renormalise (orderSH.c:585-607); w == 1 rows are
    # exactly r < r1
    qa = qh.copy()
    sel = (dot > 0.95) & (w >= 1.0) & (Q[:, None] > _QC["HIGHORDER"])
    qh_ext = np.concatenate([qh, np.zeros((1, L0 + 1), np.complex128)])
    nbrq = np.where(Q[nbr.clip(0, n - 1)] > _QC["HIGHORDER"], 1.0, 0.0)
    sel = sel & (nbrq > 0) & (nbr != n)
    qa += (sel[..., None] * qh_ext[nbr]).sum(axis=1)
    qa /= np.sqrt(np.maximum(_order_dot(qa, qa), 1e-300))[:, None]

    G = np.full(n, -1, np.int64)                    # NOGROUP
    rows, clusters = [], []
    ngroup = 0
    order = np.nonzero(Q > _QC["HIGHORDER"])[0]
    for i in order:
        if ngroup >= 64:
            break
        if G[i] != -1:
            continue
        cand = (Q > _QC["HIGHORDER"]) & (G == -1)
        ali = _order_dot(qa[i][None, :], qh) > 0.95
        qave = (qh[cand & ali]).sum(axis=0)
        mag = math.sqrt(max(_order_dot(qave, qave), 1e-300))
        qave = qave / mag
        mem = (Q > _QC["CRYSTAL"]) & (G == -1)
        dsel = _order_dot(qave[None, :], qh)
        mem = mem & (dsel > 0.85)
        if not mem.any():
            continue
        G[mem] = ngroup
        dd = r[mem] - r[i]
        dd -= L3 * np.round(dd / L3)
        nm = int(mem.sum())
        rave = dd.mean(axis=0)
        r2m = (dd * dd).sum(axis=1).mean()
        rrms = math.sqrt(max(nm * (r2m - (rave * rave).sum())
                             / max(nm - 1, 1), 0.0))
        for j in np.nonzero(mem)[0]:
            rows.append((int(gid[j]), ngroup, *r[j], float(dsel[j]),
                         float(Q[j]), int(C[j]),
                         [float(loc["qnorm"][L][j]) for L in parms.L_list]))
        clusters.append(dict(label=ngroup, size=nm,
                             Rave=(rave + r[i]).tolist(), Rrms=rrms))
        ngroup += 1
    return rows, clusters


def write_qlocal_files(sim, snapdir: str):
    """writeqlocal analog (ddcMD src/orderSH.c:832-886): one pio shard
    q{L}#000000 per L with FIXRECORDBINARY per-atom records
    [checksum u4 | q{L}r[m] q{L}i[m] f4 ...] of the unit-normalised
    qlocal components; plus cluster.000000 when clusterWrite=1."""
    from ..io.fastio import crc32_rows

    sd = sim.sysdef
    pots = [p[2] for p in sd.potentials if p[0] == "ORDERSH"]
    if not pots:
        return
    n = sd.state.n_local
    r = sim.ss.state.r[:n].detach().cpu().numpy().astype(np.float64)
    Lbox = sim.ss.box.lengths.cpu().numpy().astype(np.float64)
    gid = sd.collection.gid
    for parms in pots:
        loc = ordersh_local(r, Lbox, parms)
        for L in parms.L_list:
            q = loc["qlocal"][L].astype(np.complex64)
            nfields = 1 + 2 * (L + 1)
            lrec = 4 * nfields
            recs = np.zeros((n, lrec), np.uint8)
            flat = np.empty((n, 2 * (L + 1)), "<f4")
            flat[:, 0::2] = q.real
            flat[:, 1::2] = q.imag
            recs[:, 4:] = flat.view(np.uint8).reshape(n, -1)
            recs[:, 0:4] = crc32_rows(recs, skip=4).astype("<u4").view(
                np.uint8).reshape(n, 4)
            names = "checksum " + " ".join(
                f"q{L}r[{m}] q{L}i[{m}]" for m in range(L + 1))
            types = "u4 " + "f4 f4 " * (L + 1)
            hdr = (f"q{L} FILEHEADER {{ datatype=FIXRECORDBINARY; "
                   f"checksum=CRC32;\nrecordLength={lrec}; "
                   f"endian_key=875770417;\nloop={int(sim.ss.loop)}; "
                   f"nfiles=1; nrecord={n}; nfields={nfields};\n"
                   f"field_names={names.strip()};\n"
                   f"field_types={types.strip()};\n}}\n\n")
            with open(os.path.join(snapdir, f"q{L}#000000"), "wb") as f:
                f.write(hdr.encode())
                f.write(recs.tobytes())
        if parms.cluster_write:
            rows, clusters = ordersh_clusters(r, Lbox, parms, loc, gid)
            with open(os.path.join(snapdir, "cluster.000000"), "w") as f:
                for (g, grp, x, y, z, dot, Qv, Cv, qn) in rows:
                    f.write(f"{g} {grp} {x:f} {y:f} {z:f} {dot:f} {Qv:f} "
                            f"{Cv} {len(parms.L_list)}"
                            + "".join(f" {v:f}" for v in qn) + "\n")
                for c in clusters:
                    f.write(f"# cluster {c['label']} size={c['size']} "
                            f"Rave={c['Rave']} Rrms={c['Rrms']:f}\n")
